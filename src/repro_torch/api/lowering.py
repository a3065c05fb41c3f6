"""Spec lowering: rewrite non-native ConvSpecs onto the SFC fast path.

The port of the JAX package's ``repro.api.lowering``.  The SFC transform
algebra is stride-1 by construction; before algorithm selection, ``plan()``
asks :func:`maybe_lower` to rewrite a strided or grouped spec into a
composite of native SFC sub-problems, and only specs that neither run
natively nor lower profitably fall back to direct.

Two lowerings compose (and recurse through ``plan()`` itself):

  * **polyphase**: a stride-s RxR convolution splits into s^2 even/odd
    phases.  Decimating the padded input ``xp[a::s, b::s]`` and the kernel
    ``w[a::s, b::s]`` turns each phase into a *stride-1* VALID convolution
    with ceil((R-a)/s) taps, and the strided output is the sum of the
    phase outputs.  For stride-2 3x3 the phases are three 2-tap sub-convs
    (the registered 2-tap SFC algorithms) plus one 1x1 pointwise (direct);
    the stride-2 7x7 stem lowers onto the 4- and 3-tap algorithms.  Phase
    kernels are zero-padded up to the square ``max(taps_h, taps_w)`` so
    each sub-problem is a plain square ConvSpec.
  * **grouped**: a ``groups=g`` convolution splits into g per-group dense
    sub-specs with C_in/g -> C_out/g channels.  All groups share ONE
    memoized sub-plan; only the per-group weight slices differ.

2-D depthwise (groups == C) is not a composite: it plans natively and
runs the transform-domain elementwise path.  A strided depthwise spec
lowers by polyphase into stride-1 depthwise sub-specs.

Cost honesty: under ``algo="auto"`` a lowering is selected only when the
composite beats one strided direct conv.  Measured wall clock takes
precedence, as everywhere in the planner: an ``autotune`` sweep of the
strided or grouped spec (which times the composite per algorithm name
plus the direct baseline, under the original spec's key) overrides the
BOPs verdict in either direction once both sides have been timed on this
device.  An explicitly requested fast algorithm lowers whenever any
sub-problem resolves fast.

The glue is torch: each phase is cut from the input in one copy into a
contiguous tensor (the kernels take no strided views), the zero padding
written only where a phase reaches past the input; the phase outputs are
summed in ``sub_meta`` order and the bias added once, at the end.
Sub-plans inherit the backend and consult the tuning cache under their
own sub-spec keys; nothing here catches a sub-plan's failure.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.api.plan import PrepCache, PreparedWeights
from repro_torch.api.spec import ConvSpec

# test/debug escape hatch: `with lowering.disabled(): ...` plans as if
# there were no lowering pass (stride-2 and grouped specs go direct)
_DISABLED = False


@contextlib.contextmanager
def disabled():
    """Context manager: suspend lowering.

    Plans memoized while disabled are dropped on both edges so a direct
    plan minted here can never serve a later lowerable call (and vice
    versa).
    """
    global _DISABLED
    from repro_torch.api import planner
    prev = _DISABLED
    _DISABLED = True
    planner.invalidate_plan_cache()
    try:
        yield
    finally:
        _DISABLED = prev
        planner.invalidate_plan_cache()


# --------------------------------------------------------------------------
# polyphase geometry
# --------------------------------------------------------------------------
def phase_taps(R: int, a: int, stride: int) -> int:
    """Taps of phase ``a`` of an R-tap stride-``stride`` kernel."""
    return max(0, -(-(R - a) // stride))


def strided_lo_out(size: int, R: int, stride: int, padding: str
                   ) -> Tuple[int, int]:
    """(lo_pad, out_size) of one strided dim, XLA SAME/VALID convention."""
    if padding == "SAME":
        out = -(-size // stride)
        total = max((out - 1) * stride + R - size, 0)
        return total // 2, out
    if padding == "VALID":
        return 0, (size - R) // stride + 1
    raise ValueError(f"padding must be SAME or VALID, got {padding}")


def _phase_layout(spec: ConvSpec):
    """[(a, b, Rk)] for every phase with at least one tap per dim.

    ``Rk = max(taps_h, taps_w)`` is the square sub-kernel size the phase
    kernel is zero-padded to.
    """
    s, R = spec.stride, spec.kernel_size
    out = []
    for a in range(s):
        ra = phase_taps(R, a, s)
        if ra == 0:
            continue
        for b in range(s):
            rb = phase_taps(R, b, s)
            if rb == 0:
                continue
            out.append((a, b, max(ra, rb)))
    return out


def _phase_weights(w, a: int, b: int, stride: int, Rk: int):
    """Decimate + zero-pad one phase of an HWIO(-like) weight tensor."""
    wp = w[a::stride, b::stride]
    if wp.shape[:2] == (Rk, Rk):
        return wp
    out = wp.new_zeros((Rk, Rk) + tuple(wp.shape[2:]))
    out[:wp.shape[0], :wp.shape[1]] = wp
    return out


def _phase_span(size: int, lo: int, a: int, stride: int, n: int):
    """(r0, r1, i0): rows r0 <= r < r1 of an n-row phase (padded rows
    a + stride r) come from input rows i0, i0 + stride, ...; the others
    are padding."""
    r0 = max(0, -(-(lo - a) // stride))
    r1 = max(r0, min(n, (size - 1 + lo - a) // stride + 1))
    return r0, r1, a + stride * r0 - lo


def _phase_input(x, a: int, b: int, stride: int, lo_h: int, lo_w: int,
                 n_h: int, n_w: int):
    """Phase (a, b) of the padded input, ``xp[:, a::s, b::s][:, :n_h,
    :n_w]``, as one contiguous tensor, without padding the whole input."""
    B, H, W, C = x.shape
    h0, h1, ih = _phase_span(H, lo_h, a, stride, n_h)
    w0, w1, iw = _phase_span(W, lo_w, b, stride, n_w)
    rows = x[:, ih::stride, iw::stride][:, :h1 - h0, :w1 - w0]
    if (h0, h1, w0, w1) == (0, n_h, 0, n_w):
        return rows.contiguous()
    out = x.new_zeros((B, n_h, n_w, C))
    out[:, h0:h1, w0:w1] = rows
    return out


# --------------------------------------------------------------------------
# composite plan
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CompositePrepared:
    """Offline-processed weights of a lowered plan: one entry per
    sub-problem (``PreparedWeights`` or a nested ``CompositePrepared``)."""

    w: Any                                   # raw weights as passed in
    subs: Tuple[Any, ...]

    @property
    def quantized(self) -> bool:
        return any(getattr(s, "quantized", False) for s in self.subs)


@dataclasses.dataclass(eq=False)
class CompositePlan:
    """A lowered spec: native sub-plans plus the glue to fan out over them.

    Duck-types the :class:`ConvPlan` surface (``apply`` /
    ``prepare_weights`` / ``path`` / ``cost`` / ``with_config``);
    ``algorithm`` is None because no single bilinear algorithm covers the
    composite: check ``path == "direct"``, not ``algorithm is None``, to
    detect degradation.
    """

    spec: ConvSpec
    backend: str
    kind: str                                 # 'polyphase' | 'grouped'
    sub_plans: Tuple[Any, ...]                # ConvPlan | CompositePlan
    sub_meta: Tuple[Any, ...]                 # polyphase: (a, b, Rk) per sub
    cost: Optional[float] = None              # comparable to direct estimate
    config: Optional[Any] = None              # set on every sub-plan
    _prep: PrepCache = dataclasses.field(default_factory=PrepCache,
                                         repr=False)

    # ---- ConvPlan surface ----
    @property
    def algorithm(self):
        return None

    @property
    def path(self) -> str:
        return "lowered"

    @property
    def algo_name(self) -> str:
        names = []
        for p in self.sub_plans:
            n = p.algo_name
            if n not in names:
                names.append(n)
        return f"{self.kind}[{'+'.join(names)}]"

    def with_config(self, config) -> "CompositePlan":
        """Propagate one kernel config to every sub-plan (``autotune``
        sweeps the fused and staged variants through this)."""
        subs = tuple(p.with_config(config) for p in self.sub_plans)
        return dataclasses.replace(self, sub_plans=subs, config=config)

    # ------------------------------------------------------------------
    # sub-problem operand routing
    # ------------------------------------------------------------------
    def _sub_inputs(self, x) -> Sequence[Any]:
        """Slice the full input into one contiguous operand per sub-plan."""
        if self.kind == "grouped":
            g = self.spec.groups
            cg = x.shape[-1] // g
            return [x[..., i * cg:(i + 1) * cg].contiguous()
                    for i in range(g)]
        s, R = self.spec.stride, self.spec.kernel_size
        _, H, W, _ = x.shape
        lo_h, out_h = strided_lo_out(H, R, s, self.spec.padding)
        lo_w, out_w = strided_lo_out(W, R, s, self.spec.padding)
        # each phase reads past the SAME-padded extent only where its
        # zero-padded kernel taps are zero, so the zeros written there
        # leave the kept outputs untouched
        return [_phase_input(x, a, b, s, lo_h, lo_w, out_h + Rk - 1,
                             out_w + Rk - 1)
                for a, b, Rk in self.sub_meta]

    def _sub_weights(self, w) -> Sequence[Any]:
        if self.kind == "grouped":
            g = self.spec.groups
            og = w.shape[-1] // g
            return [w[..., i * og:(i + 1) * og] for i in range(g)]
        return [_phase_weights(w, a, b, self.spec.stride, Rk)
                for a, b, Rk in self.sub_meta]

    @staticmethod
    def _per_sub(value, n: int):
        """Broadcast None or split a per-sub sequence of scales."""
        if value is None:
            return [None] * n
        if len(value) != n:
            raise ValueError(
                f"lowered plan has {n} sub-problems; got {len(value)} "
                "per-sub scale entries (pass one per sub-plan, e.g. from "
                "CompositePlan.calibrate)")
        return list(value)

    # ------------------------------------------------------------------
    # offline: weight preparation + calibration
    # ------------------------------------------------------------------
    def prepare_weights(self, w, *, act_scale=None, w_scale=None
                        ) -> CompositePrepared:
        """Fan ``prepare_weights`` out over the sub-plans.

        ``act_scale`` / ``w_scale`` are per-sub sequences (one entry per
        sub-plan, nested for nested composites): each sub-problem has its
        own algorithm, tile size and input distribution, so a single
        (t, t) scale cannot serve the composite.  :meth:`calibrate` builds
        the activation-scale sequence from a sample batch.  Memoized on
        the weights and every scale tensor, each by identity and version.
        """
        operands = (w, act_scale, w_scale)
        key = PrepCache.key_for(operands)
        cached = self._prep.get(key, operands)
        if cached is not None:
            return cached
        n = len(self.sub_plans)
        acts = self._per_sub(act_scale, n)
        wss = self._per_sub(w_scale, n)
        subs = tuple(
            p.prepare_weights(ws, act_scale=a, w_scale=s)
            for p, ws, a, s in zip(self.sub_plans, self._sub_weights(w),
                                   acts, wss))
        prep = CompositePrepared(w=w, subs=subs)
        self._prep.put(key, operands, prep)
        return prep

    def calibrate(self, x) -> Tuple[Any, ...]:
        """Per-sub absmax activation scales from one batch (the composite
        analogue of ``tuning.calibrate_act_scale``); feed the result to
        :meth:`prepare_weights` as ``act_scale``."""
        from repro_torch.api import tuning
        scales = []
        for p, xs in zip(self.sub_plans, self._sub_inputs(x)):
            if isinstance(p, CompositePlan):
                scales.append(p.calibrate(xs))
            elif p.algorithm is None:
                scales.append(None)
            else:
                scales.append(tuning.calibrate_act_scale(
                    xs, p.algorithm, self.spec.quant, p.spec.padding))
        return tuple(scales)

    # ------------------------------------------------------------------
    # online: execution
    # ------------------------------------------------------------------
    def apply(self, x, w, *, bias=None, elementwise_hook=None):
        """Run the lowered convolution; same contract as ``ConvPlan.apply``.

        ``elementwise_hook`` is forwarded to every sub-plan that has a
        transform domain; direct sub-problems (the 1x1 centre phase of a
        stride-2 3x3) have none and are skipped.
        """
        prep = w if isinstance(w, (PreparedWeights, CompositePrepared)) \
            else self.prepare_weights(w)
        y = None
        for p, xs, pr in zip(self.sub_plans, self._sub_inputs(x), prep.subs):
            if elementwise_hook is not None and p.path != "direct":
                yi = p.apply(xs, pr, elementwise_hook=elementwise_hook)
            else:
                yi = p.apply(xs, pr)
            if self.kind == "grouped":
                y = [yi] if y is None else y + [yi]
            else:
                y = yi if y is None else y + yi
        if self.kind == "grouped":
            y = torch.cat(y, dim=-1)
        return y if bias is None else y + bias

    def __call__(self, x, w, **kwargs):
        return self.apply(x, w, **kwargs)


# --------------------------------------------------------------------------
# the lowering pass
# --------------------------------------------------------------------------
def _sub_algo(algo: str, sub_spec: ConvSpec) -> str:
    """Algorithm request to forward to a sub-plan: an explicitly requested
    algorithm is kept only when its tap count fits the sub-kernel;
    otherwise the sub-problem auto-selects."""
    if algo == "auto":
        return "auto"
    from repro_torch.api import registry
    for e in registry.entries():
        if e.name == algo:
            return algo if e.taps == sub_spec.kernel_size else "auto"
    return "auto"


def _hinted(spec: ConvSpec) -> bool:
    return spec.in_channels is not None and spec.out_channels is not None \
        and spec.spatial is not None


def _measured_override(spec, backend) -> Optional[bool]:
    """Measured wall-clock verdict on lower-vs-direct, or None.

    ``autotune`` on a strided or grouped spec times the composite under
    each requested algorithm name plus the direct baseline, all keyed on
    the ORIGINAL spec.  As ``select_algorithm``'s partial-sweep rule, the
    measurement overrides the BOPs decision only when both sides have been
    timed on this device: True = the fastest measured lowered entry beats
    direct, False = direct wins, None = no (or one-sided) measurements.
    """
    from repro_torch.api import registry, tuning
    measured = tuning.lookup(spec, backend)
    fast = {n: m["time_s"] for n, m in measured.items()
            if n != registry.DIRECT}
    if not fast or registry.DIRECT not in measured:
        return None
    return min(fast.values()) < measured[registry.DIRECT]["time_s"]


def _auto_accepts(spec, backend, total: float) -> bool:
    """The ``algo='auto'`` gate: measured wall clock ahead of BOPs."""
    from repro_torch.api import planner, registry
    override = _measured_override(spec, backend)
    if override is not None:
        return override
    return total < planner.estimate_cost(spec, registry.DIRECT)


def _measured_config(spec, backend, algo):
    """Winning KernelConfig that ``autotune`` measured for the composite
    under the ORIGINAL (strided or grouped) spec key, or None.

    An end-to-end measurement of the whole composite outranks the
    per-sub-spec configs the sub-plans resolved individually, so
    :func:`maybe_lower` propagates it over every sub-plan.  The requested
    algorithm's own entry wins when it was timed; otherwise the fastest
    measured lowered entry.
    """
    from repro_torch.api import registry, tuning
    measured = tuning.lookup(spec, backend)
    fast = {n: m for n, m in measured.items() if n != registry.DIRECT}
    if not fast:
        return None
    name = algo if algo in fast \
        else min(fast, key=lambda n: fast[n]["time_s"])
    return tuning.get_config(spec, backend, name)


def _sub_spatial(spec: ConvSpec, Rk: int) -> Optional[Tuple[int, int]]:
    if spec.spatial is None:
        return None
    outs = [strided_lo_out(n, spec.kernel_size, spec.stride,
                           spec.padding)[1] for n in spec.spatial]
    return (outs[0] + Rk - 1, outs[1] + Rk - 1)


def _lower_polyphase(spec, backend, algo):
    from repro_torch.api import planner
    layout = _phase_layout(spec)
    if not layout:
        return None
    subs, plans = [], []
    for a, b, Rk in layout:
        sub = dataclasses.replace(spec, stride=1, padding="VALID",
                                  kernel_size=Rk,
                                  spatial=_sub_spatial(spec, Rk))
        subs.append(sub)
        plans.append(planner.plan(sub, backend=backend,
                                  algo=_sub_algo(algo, sub)))
    if all(p.path == "direct" for p in plans):
        return None                    # nothing fast to gain: stay direct
    if _hinted(spec):
        total = sum(p.cost for p in plans)
    else:
        # surrogate frame: sub costs are relative to *their own* direct
        # (Rk^2 * K mults per output); rescale into the original R^2 frame
        total = sum(p.cost * (s.kernel_size / spec.kernel_size) ** 2
                    for p, s in zip(plans, subs))
    if algo == "auto" and not _auto_accepts(spec, backend, total):
        return None                    # polyphase loses to strided direct
    return CompositePlan(spec=spec, backend=backend, kind="polyphase",
                         sub_plans=tuple(plans), sub_meta=tuple(layout),
                         cost=total)


def _lower_grouped(spec, backend, algo):
    from repro_torch.api import planner
    g = spec.groups
    sub = dataclasses.replace(
        spec, groups=1,
        in_channels=None if spec.in_channels is None
        else spec.in_channels // g,
        out_channels=None if spec.out_channels is None
        else spec.out_channels // g)
    sub_plan = planner.plan(sub, backend=backend, algo=_sub_algo(algo, sub))
    if sub_plan.path == "direct":
        return None        # one grouped direct call beats g direct sub-calls
    total = g * sub_plan.cost if _hinted(spec) else sub_plan.cost
    if algo == "auto" and not _auto_accepts(spec, backend, total):
        return None
    # all groups share the one memoized sub-plan; only the weight slices
    # differ per group
    return CompositePlan(spec=spec, backend=backend, kind="grouped",
                         sub_plans=(sub_plan,) * g, sub_meta=(None,) * g,
                         cost=total)


def maybe_lower(spec: ConvSpec, *, backend: str,
                algo: str) -> Optional[CompositePlan]:
    """Lower ``spec`` into a :class:`CompositePlan`, or None when the spec
    is native, not lowerable, or the lowering is not profitable.

    Called by the planner for every non-``direct`` algorithm request;
    grouped splitting runs first so a grouped *strided* spec lowers to
    per-group sub-specs whose own ``plan()`` recursion applies the
    polyphase step.
    """
    if _DISABLED or spec.rank != 2 or spec.kernel_size < 1:
        return None
    if spec.groups > 1:
        comp = _lower_grouped(spec, backend, algo)
    elif spec.stride > 1 and spec.kernel_size > 1:
        comp = _lower_polyphase(spec, backend, algo)
    else:
        return None
    if comp is not None:
        # the plan carries the measured winning kernel config, as a native
        # ConvPlan does: autotune times the composite end to end under the
        # original spec's key
        cfg = _measured_config(spec, backend, algo)
        if cfg is not None:
            comp = comp.with_config(cfg)
    return comp


__all__ = ["CompositePlan", "CompositePrepared", "maybe_lower", "disabled",
           "phase_taps", "strided_lo_out"]
