"""Mamba2 SSD (state-space duality) block, arXiv:2405.21060.

The counterpart of the JAX package's ``repro.models.ssm``.
Chunked SSD: within chunks of length Q the recurrence is a masked
attention-like quadratic form; across chunks a linear state recurrence
(the JAX package's ``lax.scan``, here a loop over the chunks) carries
(H, P, N) states.  The depthwise causal conv1d (R = ``ssm_conv`` = 4)
runs the paper's SFC 1-D fast path when ``cfg.use_sfc_conv`` is set,
through the ``repro_torch.api`` serving cache: the only convolution of the
LM pool.

Decode is O(1) per token: a (B, H, P, N) state and an (R-1)-deep conv
window per layer.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.layers import Params


def init_mamba2(generator, cfg, dtype) -> Params:
    d = cfg.d_model
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * N
    device = generator.device
    return {
        "in_proj": layers.dense_init(generator, d, 2 * di + 2 * N + H, dtype),
        "conv_w": layers.normal(generator, (cfg.ssm_conv, conv_ch), 0.2,
                                dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "norm": layers.init_rmsnorm(di, dtype, device),
        "out_proj": layers.dense_init(generator, di, d, dtype),
    }


def conv_cache_key(path: Tuple, layer: int, stacked: torch.Tensor) -> tuple:
    """The serving-cache key of layer ``layer``'s conv weights, sliced from
    the stacked (L, R, C) tensor at tree path ``path``.

    The path and the index name the layer, as the JAX launcher's warm-up
    keys do; the stacked tensor's identity and in-place version name the
    weights, so another tree, or the same tree after an in-place update,
    misses and is prepared anew.  The entry holds the slice, which holds
    the stacked tensor as its base, so the identity stays valid while the
    entry lives.
    """
    return tuple(path) + (layer, id(stacked), layers.version(stacked))


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   use_sfc: bool, key: Optional[tuple] = None
                   ) -> torch.Tensor:
    from repro_torch.api import ConvSpec, serving_cache
    # auto planning picks the SFC fast path where an algorithm of the tap
    # count is registered (SFC-6(6,4) for R=4: 12 multiplications per 6
    # outputs against 24 direct).  The serving cache keys (spec, weights)
    # -> (plan, prepared weights); a layer sliced out of a stacked tensor
    # passes ``key`` (``conv_cache_key``), as its slice is a new object on
    # every call.
    spec = ConvSpec.for_conv1d_depthwise(x.shape, w.shape)
    p, prep = serving_cache.get(spec, w, algo="auto" if use_sfc else "direct",
                                key=key)
    return F.silu(p.apply(x, prep, bias=b))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                chunk: int, init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan.  x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,N); D (H,).

    Returns (y (B,S,H,P), final_state (B,H,P,N)).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        # ragged sequence lengths: zero-pad to a chunk multiple; padded
        # steps have dt = 0, so they neither decay nor inject state
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    S_pad = nc * chunk
    xc = x.reshape(Bsz, nc, chunk, H, P).float()
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = Bm.reshape(Bsz, nc, chunk, N).float()
    Cc = Cm.reshape(Bsz, nc, chunk, N).float()

    dA = dtc * A[None, None, None, :]                      # (B,nc,Q,H) <= 0
    dA_cum = torch.cumsum(dA, dim=2)
    # intra-chunk: the decay kernel L[q,s] = exp(dAcum_q - dAcum_s), q >= s.
    # Above the diagonal seg grows with the chunk and exp(seg) overflows
    # (at chunk 256): select before the exponential, exp(-inf) = 0, so the
    # forward keeps its bits and the gradient never meets 0 * inf
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))
    L = torch.exp(torch.where(mask[None, None, :, :, None], seg,
                              float("-inf")))
    scores = torch.einsum("bcqn,bcsn->bcqs", Cc, Bc)
    # pairwise contraction: the explicit (B,nc,Q,Q,H) kernel contracts
    # straight into (B,nc,Q,H,P), never a 6-D (B,nc,Q,H,Q,P) intermediate
    kern = scores[..., None] * L * dtc[:, :, None, :, :]   # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", kern, xc)

    # chunk -> state contribution and the inter-chunk recurrence
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)  # (B,nc,Q,H)
    states = torch.einsum("bcsn,bcshp->bchpn", Bc,
                          xc * (decay_to_end * dtc)[..., None])
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])            # (B,nc,H)

    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                  # (B,nc,H,P,N)

    y_inter = torch.einsum("bcqn,bchpn->bcqhp", Cc, prev_states) \
        * torch.exp(dA_cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S_pad, H, P)
    y = y + D[None, None, :, None] * x.float()
    return y[:, :S].to(x.dtype), state


def mamba2_block(p: Params, cfg, x: torch.Tensor,
                 conv_key: Optional[tuple] = None) -> torch.Tensor:
    """Prefill Mamba2 block. x (B,S,d) -> (B,S,d).  ``conv_key`` is the
    serving-cache key of the conv weights (``conv_cache_key``) when they
    are a slice of a stacked tensor."""
    B, S, d = x.shape
    di, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_headdim)
    zxbcdt = x @ p["in_proj"]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    xbc = _causal_conv1d(xbc, p["conv_w"], p["conv_b"], cfg.use_sfc_conv,
                         conv_key)
    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, _ = ssd_chunked(xs.reshape(B, S, H, P), dt, A, Bm, Cm, p["D"],
                       min(cfg.ssm_chunk, S))
    y = y.reshape(B, S, di) * F.silu(z)
    y = layers.rmsnorm(y, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"]


# --------------------------------------------------------------------------
# decode (O(1) per token)
# --------------------------------------------------------------------------
def init_mamba2_cache(cfg, batch: int, dtype, device="cuda") -> Params:
    di, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_headdim)
    conv_ch = di + 2 * N
    return {
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def mamba2_decode(p: Params, cfg, x: torch.Tensor, cache: Params
                  ) -> Tuple[torch.Tensor, Params]:
    """One-token step. x (B,1,d).  Updates ``cache`` in place (the JAX
    launcher donates its cache to the step) and returns it."""
    B = x.shape[0]
    di, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                   cfg.ssm_headdim)
    zxbcdt = (x @ p["in_proj"])[:, 0]
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    window = torch.cat([cache["conv"], xbc[:, None, :].to(
        cache["conv"].dtype)], dim=1)
    conv_out = torch.einsum("brc,rc->bc", window,
                            p["conv_w"].to(window.dtype))
    xbc_c = F.silu(conv_out + p["conv_b"])
    xs, Bm, Cm = torch.split(xbc_c, [di, N, N], dim=-1)
    dt = F.softplus(dt.float() + p["dt_bias"])                    # (B,H)
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, H, P).float()
    decay = torch.exp(dt * A)                                     # (B,H)
    state = cache["state"] * decay[:, :, None, None] \
        + (dt[:, :, None] * xh)[..., None] * Bm.float()[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Cm.float(), state)
    y = y + p["D"][None, :, None] * xh
    y = (y.reshape(B, di) * F.silu(z)).to(x.dtype)
    y = layers.rmsnorm(y, p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"])[:, None, :]
    cache["state"].copy_(state)
    cache["conv"].copy_(window[:, 1:, :])
    return out, cache
