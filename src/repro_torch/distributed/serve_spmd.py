"""The sharded serve and prefill steps: what GSPMD does for the JAX
package's ``make_serve_step`` and ``make_prefill_step`` over a (data,
model) mesh, in one process.

The JAX dry run jits the decode step with the parameters placed by
``params_pspecs``, the cache placed by ``cache_pspecs`` and donated, and
the tokens and positions over the batch axes (``launch/dryrun.py``); the
softmax over the sequence-sharded key axis lowers to an all-reduce of the
online max and sum.  The port has no compiler to do that, so this module
does it by hand, in the single-controller design of the sharded train
step (``lm_spmd``): one process drives every block, each on its mesh
coordinate's device, and a mesh may repeat one device.

  * **Weights are gathered at use** onto each data row's first coordinate
    (``lm_spmd._Leaf.gather``): a stacked leaf layer by layer where the
    layer runs, the others once a step.  Each data row runs the unsharded
    layer walk (``decode.decode_layers``) on its slice of the batch, rows
    in ascending order; a batch the data axes do not divide is computed
    whole by the first row.
  * **A cache block is read and written only on its own device**; no
    cache block is gathered or copied.  Per layer the step moves only
    per-token tensors:

      - attention (``attention.decode_attention``, ``mla.mla_decode``,
        ``decode._cross_decode``): the row's query and the step's new key
        and value (or latent and RoPE key) go to each ``'model'`` block's
        device; the block whose slot range holds the step's slot writes it
        in place; each block returns its partial max, sum and weighted
        values over its valid keys (global slot indices, the ring buffer's
        rule too), and the row merges them in ascending block order (a
        block with no valid key: max -inf, sum 0);
      - SSM (``ssm.mamba2_decode``): each ``conv`` block convolves its
        channels' window, each ``state`` block updates its heads and
        returns their ``y``; the row computes the projections, the gate,
        the norm and the output projection;
      - a block that a sanitized spec replicates onto another device is
        written there from the same per-token tensors.

    Where a layer's cache is one block, read and written only at the
    row's coordinate, the unsharded code runs unchanged on it.
  * The logits come back to the mesh's first device in batch order; the
    cache is updated in place (the JAX step donates it).

:func:`copied` counts the bytes the steps move between mesh coordinates,
as ``weights``, ``activations`` and ``cache``; the cache's count stays 0.
On a mesh of distinct devices these are device copies; on a mesh that
repeats one device, the copies the same mesh would make over distinct
ones.  Compute over the model axis (tensor and expert parallel) is not
here: each layer is gathered whole onto its row's device.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tree_util
from repro_torch.core.precision import full_fp32_matmul
from repro_torch.distributed import act_sharding
from repro_torch.distributed.lm_spmd import (_compute_coords, _empty_stack,
                                             _Leaf, _Placer)
from repro_torch.distributed.sharding import (
    _STACK_KEYS, NamedSharding, Sharded, _axes, batch_axes, cache_pspecs,
    params_pspecs, sanitize_pspec, sanitized_shardings, tree_map_with_path)
from repro_torch.models import attention as attn
from repro_torch.models import decode as decode_mod
from repro_torch.models import layers, mla
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dtype_of

# the top-level entries a decode step reads; a prefill also the encoder's
_DECODE_KEYS = ("embed", "final_norm", "lm_head", "blocks", "dense_blocks",
                "cross_blocks", "shared_block")
_PREFILL_KEYS = _DECODE_KEYS + ("enc_blocks", "enc_norm")

_COPIED = {"weights": 0, "activations": 0, "cache": 0}


def copied() -> Dict[str, int]:
    """Bytes moved between mesh coordinates since :func:`reset_copied`."""
    return dict(_COPIED)


def reset_copied() -> None:
    for k in _COPIED:
        _COPIED[k] = 0


def is_placed(tree) -> bool:
    """The tree's leaves are placed on a mesh (``Sharded``)."""
    first = tree_util.leaves(tree)
    return bool(first) and isinstance(first[0], Sharded)


def _mesh_of(tree):
    return tree_util.leaves(tree)[0].mesh


def _same_mesh(a, b) -> bool:
    return a is b or (a.axis_names == b.axis_names
                      and a.devices.shape == b.devices.shape
                      and list(a.devices.flat) == list(b.devices.flat))


def param_shardings(model, mesh):
    """The parameters' ``NamedSharding``s: ``params_pspecs`` sanitized
    against each leaf's shape, as the dry run places them."""
    abstract = model.init_abstract()
    return sanitized_shardings(params_pspecs(abstract, model.cfg, mesh),
                               abstract, mesh)


def init_params(model, seed: int, shardings, device):
    """``Model.init``'s parameters from a generator on ``device`` seeded
    with ``seed``, each entry placed by ``shardings`` as it is drawn
    (a stack layer by layer): the unsharded draws, whose whole tree no
    device need hold."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tfm.init_lm(gen, model.cfg, placer=_Placer(shardings))


# --------------------------------------------------------------------------
# a data row: its coordinate, its copies
# --------------------------------------------------------------------------
def _rows(mesh, batch: int) -> Tuple[int, int]:
    """(rows that compute, the data axes' size): one row a data coordinate
    where the data axes divide the batch, else the first row alone."""
    n_data = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    return (n_data if batch % n_data == 0 else 1), n_data


class _Row:
    """One data row's compute: its first coordinate and device, the
    coordinates of its line along ``'model'``, and the copies to and from
    them (counted in :data:`_COPIED`)."""

    def __init__(self, mesh, coord, index: int):
        self.mesh, self.coord, self.index = mesh, tuple(coord), index
        self.device = mesh.device(coord)
        self.origin = (0,) * len(mesh.axis_names)
        keep = [i for i, a in enumerate(mesh.axis_names) if a != "model"]
        self.line = {c for c in mesh.coords()
                     if all(c[i] == self.coord[i] for i in keep)}

    def send(self, t, src, dst, kind="activations"):
        if tuple(src) != tuple(dst):
            _COPIED[kind] += t.numel() * t.element_size()
        return t.to(self.mesh.device(dst))

    def to(self, t, coord, kind="activations"):
        return self.send(t, self.coord, coord, kind)

    def back(self, ts, coord):
        return tuple(self.send(t, coord, self.coord) for t in ts)

    def take(self, t):
        """An input of the step (held at the mesh's first coordinate)."""
        return self.send(t, self.origin, self.coord)

    def give(self, t):
        """An output, to the mesh's first coordinate."""
        return self.send(t, self.coord, self.origin)

    def gather(self, leaf: _Leaf, index, dtype, pin=None) -> torch.Tensor:
        """The leaf (layer ``index`` of a stacked one) whole on the row's
        device in ``dtype`` (floating leaves); ``pin`` rides on the result,
        so a cache that keeps it keeps ``pin`` alive."""
        for idx, coords in leaf.unique.items():
            if self.coord not in coords:
                b = leaf.sh.shards[coords[0]]
                b = b if index is None else b[index]
                _COPIED["weights"] += b.numel() * b.element_size()
        t = leaf.gather(index, self.device)
        t = t.to(dtype) if t.is_floating_point() else t
        if pin is not None:
            t.pinned_by = pin
        return t

    def tree(self, leaves, dtype, keys):
        """The row's parameter tree over ``keys``: stacked leaves gathered
        a layer at a time where indexed (:class:`_Layers`), the others
        now."""
        def use(leaf):
            if leaf.stacked:
                return _Layers(leaf, self, dtype)
            return self.gather(leaf, None, dtype)
        return {k: tree_util.tree_map(use, leaves[k]) for k in keys
                if k in leaves}

    def cache(self, cache):
        return tree_util.tree_map(lambda sh: _CacheStack(sh, self), cache)


class _Layers:
    """A stacked parameter leaf in a row's tree: indexing it gathers the
    layer (``transformer.layer``).  The gathered layer carries this object
    (``pinned_by``), so the serving cache's key of a conv layer
    (``ssm.conv_cache_key``: this object's identity and version) names it
    while the cache's entry lives."""

    def __init__(self, leaf: _Leaf, row: _Row, dtype):
        self.leaf, self.row, self.dtype = leaf, row, dtype

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.row.gather(self.leaf, i, self.dtype, pin=self)

    @property
    def _version(self) -> int:
        return self.leaf.sh.shards.flat[0]._version


def _param_leaves(params):
    return tree_map_with_path(
        lambda path, sh: _Leaf(sh, any(k in _STACK_KEYS for k in path)),
        params)


# --------------------------------------------------------------------------
# a placed cache, as a row sees it
# --------------------------------------------------------------------------
class _Part(NamedTuple):
    """One block of a layer's cache entry: its offset along the dimension
    ``'model'`` cuts (0 where none is cut), and the coordinates and
    tensors that hold it: the one read first (the row's own where it holds
    one), then each other copy (another memory, on its own device)."""
    offset: int
    writes: Tuple[Tuple[Tuple[int, ...], torch.Tensor], ...]

    @property
    def coord(self):
        return self.writes[0][0]

    @property
    def read(self) -> torch.Tensor:
        return self.writes[0][1]


class _Blocks:
    """One cache entry of one layer for one row: its blocks in ascending
    order along the cut dimension, and the entry's global shape."""

    def __init__(self, parts: List[_Part], shape, row: _Row):
        self.parts, self.shape, self.row = parts, shape, row

    def one(self) -> bool:
        """One block, read at the row's coordinate."""
        return len(self.parts) == 1 and self.parts[0].coord == self.row.coord

    def alone(self) -> bool:
        """:meth:`one`, and written nowhere else."""
        return self.one() and len(self.parts[0].writes) == 1


class _CacheStack:
    """A stacked cache leaf (L, B, ...) for one row: indexing it gives
    layer ``i``'s :class:`_Blocks` (views of the blocks)."""

    def __init__(self, sh: Sharded, row: _Row):
        spec = tuple(sh.spec) + (None,) * (len(sh.shape) - len(sh.spec))
        cut = next((d for d, e in enumerate(spec) if "model" in _axes(e)),
                   None)
        self.shape, self.row, self.parts = tuple(sh.shape[1:]), row, []
        for idx, coords in sh.unique().items():
            if spec[1] is not None and idx[1] != row.index:
                continue              # another row's slice of the batch
            first = next((c for c in coords if c in row.line), coords[0])
            writes, seen = [], set()
            for c in [first] + list(coords):
                t = sh.shards[c]
                if (t.device, t.data_ptr()) not in seen:
                    seen.add((t.device, t.data_ptr()))
                    writes.append((c, t))
            offset = 0 if cut is None \
                else idx[cut] * sh.shards[first].shape[cut]
            self.parts.append((offset, writes))
        self.parts.sort(key=lambda p: p[0])

    def __getitem__(self, i: int) -> _Blocks:
        return _Blocks([_Part(off, tuple((c, t[i]) for c, t in writes))
                        for off, writes in self.parts], self.shape, self.row)


def init_cache(model, params, batch: int, max_len: int,
               memory: Optional[torch.Tensor] = None, shardings=None):
    """``decode.init_cache``'s zero caches placed by ``shardings``
    (``sharding.cache_shardings``; by default ``cache_pspecs`` on the
    parameters' mesh), each entry made as blocks on their devices, so
    nothing is held beside them; the vlm's and encdec's cross K/V
    computed on each data row's device from the gathered cross blocks,
    then written into their blocks."""
    cfg = model.cfg
    if not is_placed(params):
        raise ValueError("serve_spmd.init_cache takes parameters placed on "
                         "a mesh (sharding.place or init_params)")
    mesh = _mesh_of(params)
    meta = None if memory is None else torch.empty(
        memory.shape, dtype=memory.dtype, device="meta")
    abstract = decode_mod.init_cache(model.init_abstract(), cfg, batch,
                                     max_len, meta)
    if shardings is None:
        shardings = sanitized_shardings(cache_pspecs(abstract, cfg, mesh),
                                        abstract, mesh)

    def place(path, leaf, s):
        if not _same_mesh(s.mesh, mesh):
            raise ValueError(f"the cache's mesh {s.mesh} is not the "
                             f"parameters' {mesh}")
        spec = sanitize_pspec(s.spec, tuple(leaf.shape), mesh)
        sh = _empty_stack(NamedSharding(mesh, spec), tuple(leaf.shape),
                          leaf.dtype)["sharded"]
        for block in sh.shards.flat:
            block.zero_()
        return sh
    cache = tree_map_with_path(place, abstract, shardings)
    if cfg.family not in ("vlm", "encdec"):
        return cache
    n, _ = _rows(mesh, batch)
    b, cdtype = batch // n, dtype_of(cfg.compute_dtype)
    leaves = _param_leaves(params)
    with torch.no_grad(), full_fp32_matmul():
        for r, coord in enumerate(_compute_coords(mesh, n)):
            row = _Row(mesh, coord, r)
            mem = row.take(memory[r * b:(r + 1) * b])
            if cfg.family == "vlm":
                mem = tfm._compute(mem, cfg)
            else:
                mem = tfm.encoder_forward(
                    row.tree(leaves, cdtype, ("enc_blocks", "enc_norm")),
                    cfg, mem)
            xattn = row.tree(leaves, cdtype,
                             ("cross_blocks",))["cross_blocks"]["xattn"]
            views = row.cache({"cross_k": cache["cross_k"],
                               "cross_v": cache["cross_v"]})
            for g in range(cache["cross_k"].shape[0]):
                for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
                    t = attn._heads(mem, xattn[w][g])
                    for part in views[name][g].parts:
                        n_s = part.read.shape[1]
                        piece = t[:, part.offset:part.offset + n_s]
                        for c, blk in part.writes:
                            blk.copy_(row.to(piece, c))
    return cache


# --------------------------------------------------------------------------
# the operations over a placed cache
# --------------------------------------------------------------------------
def _softmax_part(s: torch.Tensor, valid: Optional[torch.Tensor]):
    """A block's partial softmax over its last axis: (max, weights, sum);
    a row with no valid key has max -inf, weights 0, sum 0."""
    if valid is not None:
        s = torch.where(valid, s, float("-inf"))
    m = s.amax(-1)
    w = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
    return m, w, w.sum(-1)


def _merge(parts) -> torch.Tensor:
    """The blocks' (max, sum, weighted values), merged in order: the
    softmax-weighted values over every block's keys, float32."""
    top = parts[0][0]
    for m, _, _ in parts[1:]:
        top = torch.maximum(top, m)
    den = num = None
    for m, l, o in parts:
        a = torch.exp(m - top)
        den = a * l if den is None else den + a * l
        t = a[..., None] * o.float()
        num = t if num is None else num + t
    return num / den[..., None]


def _slot(pos, length: int, ring: bool) -> torch.Tensor:
    slot = (pos % length) if ring else pos
    # a start past the end clamps, as lax.dynamic_update_slice's does
    return torch.clamp(slot, max=length - 1).long()


def _valid(offset: int, n: int, pos, length: int, ring: bool):
    """Which of a block's keys (global slots offset..offset+n) a query at
    ``pos`` sees: ``attention.decode_attention``'s rule."""
    idx = torch.arange(offset, offset + n, device=pos.device)[None, :]
    if ring:
        return (idx <= (pos % length)[:, None]) | (pos[:, None] >= length)
    return idx <= pos[:, None]


class _Ops(decode_mod.DecodeOps):
    """``decode.DecodeOps`` over a placed cache, for one row."""

    def __init__(self, row: _Row):
        self.row = row

    def _write(self, part: _Part, new: torch.Tensor, slot: torch.Tensor):
        """``new`` (B, ...) at global slots ``slot`` into each copy of the
        block, on the copy's device, where the slot falls in its range."""
        n = part.read.shape[1]
        for c, blk in part.writes:
            nd, sd = self.row.to(new, c), self.row.to(slot, c)
            local = sd - part.offset
            inside = ((local >= 0) & (local < n)).view(
                (-1,) + (1,) * (nd.dim() - 1))
            at = local.clamp(0, n - 1)
            rows = torch.arange(blk.shape[0], device=blk.device)
            blk[rows, at] = torch.where(inside, nd.to(blk.dtype),
                                        blk[rows, at])

    def attention(self, p, cfg, h, cache_l, pos):
        kb, vb = cache_l["k"], cache_l["v"]
        if kb.alone() and vb.alone():
            return decode_mod.DecodeOps.attention(
                p, cfg, h, {"k": kb.parts[0].read, "v": vb.parts[0].read},
                pos)
        B = h.shape[0]
        q, k, v = attn._project_qkv(p, cfg, h, pos[:, None])
        length, ring = kb.shape[1], bool(cfg.sliding_window)
        slot = _slot(pos, length, ring)
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qg = q[:, :, :hq, :].reshape(B, 1, hkv, hq // hkv, hd)
        partials = []
        for pk, pv in zip(kb.parts, vb.parts):
            self._write(pk, k[:, 0], slot)
            self._write(pv, v[:, 0], slot)
            kc, vc, c = pk.read, pv.read, pk.coord
            qd, posd = self.row.to(qg, c), self.row.to(pos, c)
            s = torch.einsum("bqhgd,bkhd->bhgk", qd.float(),
                             kc.float()) / np.sqrt(hd)
            valid = _valid(pk.offset, kc.shape[1], posd, length, ring)
            m, w, l = _softmax_part(s, valid[:, None, None, :])
            o = torch.einsum("bhgk,bkhd->bhgd", w.to(vc.dtype), vc)
            partials.append(self.row.back((m, l, o), c))
        o = _merge(partials).to(vb.parts[0].read.dtype)
        return attn.attention_output(p, cfg, o[:, None])

    def mla(self, p, cfg, h, cache_l, pos):
        cb, rb = cache_l["c_kv"], cache_l["k_rope"]
        if cb.alone() and rb.alone():
            return decode_mod.DecodeOps.mla(
                p, cfg, h, {"c_kv": cb.parts[0].read,
                            "k_rope": rb.parts[0].read}, pos)
        B, H = h.shape[0], cfg.n_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
            cfg.v_head_dim
        q_nope, q_rope = mla._mla_q(p, cfg, h, pos[:, None])
        c_new, r_new = mla._mla_kv_latent(p, cfg, h, pos[:, None])
        length = cb.shape[1]
        slot = _slot(pos, length, False)
        w_uk, w_uv = mla._split_wkv_b(p, cfg)
        q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
        partials = []
        for pc, pr in zip(cb.parts, rb.parts):
            self._write(pc, c_new[:, 0], slot)
            self._write(pr, r_new[:, 0], slot)
            cc, rc, c = pc.read, pr.read, pc.coord
            qe, qr, posd = (self.row.to(t, c)
                            for t in (q_eff, q_rope[:, 0], pos))
            s = (torch.einsum("bhr,bkr->bhk", qe.float(), cc.float())
                 + torch.einsum("bhd,bkd->bhk", qr.float(), rc.float())) \
                / np.sqrt(dn + dr)
            valid = _valid(pc.offset, cc.shape[1], posd, length, False)
            m, w, l = _softmax_part(s, valid[:, None, :])
            o = torch.einsum("bhk,bkr->bhr", w.to(cc.dtype), cc)
            partials.append(self.row.back((m, l, o), c))
        o_lat = _merge(partials).to(cb.parts[0].read.dtype)
        o = torch.einsum("bhr,rhd->bhd", o_lat, w_uv)
        return o.reshape(B, 1, H * dv) @ p["wo"]

    def cross(self, x, ln, xattn, cfg, ck, cv):
        if ck.one() and cv.one():
            return decode_mod._cross_decode(x, ln, xattn, cfg,
                                            ck.parts[0].read,
                                            cv.parts[0].read)
        B = x.shape[0]
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        h = layers.rmsnorm(x, ln, cfg.norm_eps)
        qg = attn._heads(h, xattn["wq"])[:, :, :hq, :].reshape(
            B, 1, hkv, hq // hkv, hd)
        partials = []
        for pk, pv in zip(ck.parts, cv.parts):
            kc, vc, c = pk.read, pv.read, pk.coord
            s = torch.einsum("bqhgd,bkhd->bhgk", self.row.to(qg, c).float(),
                             kc.float()) / np.sqrt(hd)
            m, w, l = _softmax_part(s, None)
            o = torch.einsum("bhgk,bkhd->bhgd", w.to(vc.dtype), vc)
            partials.append(self.row.back((m, l, o), c))
        o = _merge(partials).to(cv.parts[0].read.dtype)
        return attn.attention_output(xattn, cfg, o[:, None])

    def mamba(self, p, cfg, h, cache_l):
        st, cv = cache_l["state"], cache_l["conv"]
        if st.alone() and cv.alone():
            return decode_mod.DecodeOps.mamba(
                p, cfg, h, {"state": st.parts[0].read,
                            "conv": cv.parts[0].read})
        row = self.row
        B = h.shape[0]
        di, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_headdim)
        zxbcdt = (h @ p["in_proj"])[:, 0]
        z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
        outs = []
        for part in cv.parts:            # the conv over its channels
            lo, C = part.offset, part.read.shape[2]
            for j, (c, blk) in enumerate(part.writes):
                xd = row.to(xbc[:, lo:lo + C], c)
                window = torch.cat([blk, xd[:, None, :].to(blk.dtype)], dim=1)
                if j == 0:
                    w = row.to(p["conv_w"][:, lo:lo + C], c, "weights")
                    out = torch.einsum("brc,rc->bc", window,
                                       w.to(window.dtype))
                blk.copy_(window[:, 1:, :])
            outs.append(row.back((out,), part.coord)[0])
        xbc_c = F.silu(torch.cat(outs, dim=-1) + p["conv_b"])
        xs, Bm, Cm = torch.split(xbc_c, [di, N, N], dim=-1)
        dt = F.softplus(dt.float() + p["dt_bias"])                # (B,H)
        A = -torch.exp(p["A_log"])
        xh = xs.reshape(B, H, P).float()
        decay = torch.exp(dt * A)
        ys = []
        for part in st.parts:            # the state over its heads
            lo, nh = part.offset, part.read.shape[1]
            for j, (c, blk) in enumerate(part.writes):
                dec, dtm, xm, Bd, Cd = (row.to(t, c) for t in (
                    decay[:, lo:lo + nh], dt[:, lo:lo + nh],
                    xh[:, lo:lo + nh], Bm.float(), Cm.float()))
                state = blk * dec[:, :, None, None] \
                    + (dtm[:, :, None] * xm)[..., None] * Bd[:, None, None, :]
                if j == 0:
                    y = torch.einsum("bn,bhpn->bhp", Cd, state)
                blk.copy_(state)
            ys.append(row.back((y,), part.coord)[0])
        y = torch.cat(ys, dim=1) + p["D"][None, :, None] * xh
        y = (y.reshape(B, di) * F.silu(z)).to(h.dtype)
        y = layers.rmsnorm(y, p["norm"], cfg.norm_eps)
        return (y @ p["out_proj"])[:, None, :]


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------
def decode_step(model, params, cache, tokens: torch.Tensor,
                pos: torch.Tensor):
    """tokens (B, 1) int, pos (B,) int over placed ``params`` and
    ``cache`` -> (logits (B, 1, V) f32 on the mesh's first device, the
    cache, updated in place)."""
    cfg = model.cfg
    if not (is_placed(params) and is_placed(cache)):
        raise ValueError("the sharded decode step takes parameters and a "
                         "cache both placed on a mesh (init_cache(..., "
                         "shardings=...) places the cache)")
    mesh = _mesh_of(params)
    if not _same_mesh(_mesh_of(cache), mesh):
        raise ValueError("the cache and the parameters lie on different "
                         "meshes")
    B = tokens.shape[0]
    if tree_util.leaves(cache)[0].shape[1] != B:
        raise ValueError(f"a cache of batch "
                         f"{tree_util.leaves(cache)[0].shape[1]} takes no "
                         f"batch of {B}")
    n, n_data = _rows(mesh, B)
    b, cdtype = B // n, dtype_of(cfg.compute_dtype)
    leaves = _param_leaves(params)
    out = []
    with torch.no_grad(), act_sharding.local(1 if n > 1 else n_data), \
            full_fp32_matmul():
        for r, coord in enumerate(_compute_coords(mesh, n)):
            row = _Row(mesh, coord, r)
            tree = row.tree(leaves, cdtype, _DECODE_KEYS)
            tok = row.take(tokens[r * b:(r + 1) * b])
            at = row.take(pos[r * b:(r + 1) * b])
            x = tfm._compute(tree["embed"][tok], cfg)
            x = decode_mod.decode_layers(tree, cfg, row.cache(cache), x, at,
                                         _Ops(row))
            x = layers.rmsnorm(x, tree["final_norm"], cfg.norm_eps)
            out.append(row.give(tfm.lm_logits(tree, cfg, x)))
    return (out[0] if len(out) == 1 else torch.cat(out)), cache


def prefill_step(model, params, tokens: torch.Tensor,
                 memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``model.forward`` over placed ``params``: each data row's slice of
    the batch on its device, weights gathered at use; the logits on the
    mesh's first device in batch order."""
    if not is_placed(params):
        raise ValueError("the sharded prefill step takes parameters placed "
                         "on a mesh")
    mesh = _mesh_of(params)
    B = tokens.shape[0]
    n, n_data = _rows(mesh, B)
    b, cdtype = B // n, dtype_of(model.cfg.compute_dtype)
    leaves = _param_leaves(params)
    out = []
    with torch.no_grad(), act_sharding.local(1 if n > 1 else n_data):
        for r, coord in enumerate(_compute_coords(mesh, n)):
            row = _Row(mesh, coord, r)
            mem = None if memory is None \
                else row.take(memory[r * b:(r + 1) * b])
            logits = model.forward(row.tree(leaves, cdtype, _PREFILL_KEYS),
                                   row.take(tokens[r * b:(r + 1) * b]), mem)
            out.append(row.give(logits))
    return out[0] if len(out) == 1 else torch.cat(out)
