"""The sharded serve and prefill steps: what GSPMD does for the JAX
package's ``make_serve_step`` and ``make_prefill_step`` over a (data,
model) mesh, in one process.

The JAX dry run jits the decode step with the parameters placed by
``params_pspecs``, the cache placed by ``cache_pspecs`` and donated, and
the tokens and positions over the batch axes (``launch/dryrun.py``);
GSPMD computes each weight block where it lies (tensor parallel over
``'model'``: heads, FFN columns, vocab; expert parallel where the expert
count divides the axis) and the softmax over the sequence-sharded key
axis lowers to an all-reduce of the online max and sum.  The port has no
compiler to do that, so this module does it by hand, in the
single-controller design of the sharded train step (``lm_spmd``): one
process drives every block, each on its mesh coordinate's device, and a
mesh may repeat one device.

A data row is one coordinate of the data axes and its line of
``'model'`` coordinates; each row runs the unsharded layer walk
(``decode.decode_layers``) on its slice of the batch, rows in ascending
order (a batch the data axes do not divide is computed whole by the
first row), with the operations of :class:`_Ops`:

  * **Weights are computed where they lie** (:func:`decode_step`).  A
    leaf whose sanitized spec keeps ``'model'`` runs on each of its model
    blocks' coordinates, (row, m): coordinate (r, m) gathers only its own
    model block over the data axes, from the coordinates (r', m) of the
    other rows (a stacked leaf layer by layer, the others once a step),
    so on one data row no weight byte moves.  A leaf that ``'model'``
    does not cut runs at the row's first coordinate, gathered over the
    data axes there.  No model-split leaf is ever gathered whole.  Per
    layer only per-token tensors move:

      - the embedding's vocab blocks look up their tokens (zeros
        elsewhere) and the row sums them; the head's vocab columns go to
        the mesh's first coordinate, joined in order;
      - attention: each ``wq`` head block's query comes back to the row,
        joined; ``wk``, ``wv`` (replicated over ``'model'``) run at the
        row; each ``wo`` head block takes its heads' output and returns a
        partial (B, 1, d);
      - MLA: ``wq_a``, ``wq_b``, ``wkv_a`` column blocks, joined;
        ``wkv_b``'s blocks absorb their columns of ``w_uk`` into the
        query (a head cut by a block edge is summed over its blocks) and
        of ``w_uv`` into the output; ``wo`` row blocks return partials;
      - SwiGLU (dense, shared expert, the vlm's cross FFN) and the SSM's
        ``in_proj`` / ``out_proj``: column blocks, then row blocks (where
        they line up, the hidden columns stay on their coordinate);
        ``in_proj``'s columns come back to the row, where
        ``[z | xBC | dt]`` is cut again;
      - MoE: the row routes (``router`` runs there) and sends each block
        its tokens and the sorted dispatch; expert parallel blocks run
        their experts' rows, tensor parallel ones their ``f`` slice of
        every expert; the rows come back and the row combines them in the
        unsharded order;
      - partial sums are added at the row's first coordinate in ascending
        block order, with no atomics, so a step replays bit for bit; the
        residual stream stays there.

  * **A cache block is read and written only on its own device**; no
    cache block is gathered or copied.  Per layer the step moves only
    per-token tensors:

      - attention (``attention.decode_attend``, ``mla.latent_attend``,
        ``decode.cross_attend``): the row's joined query and the step's
        new key and value (or latent and RoPE key) go to each ``'model'``
        block's device; the block whose slot range holds the step's slot
        writes it in place; each block returns its partial max, sum and
        weighted values over its valid keys (global slot indices, the
        ring buffer's rule too), and the row merges them in ascending
        block order (a block with no valid key: max -inf, sum 0);
      - SSM (``ssm.mamba2_decode``): each ``conv`` block convolves its
        channels' window with ``conv_w``'s block on its coordinate, each
        ``state`` block updates its heads and returns their ``y``; the
        row computes the gate and the norm;
      - a block that a sanitized spec replicates onto another device is
        written there from the same per-token tensors.

    Where a layer's cache is one block, read and written only at the
    row's coordinate, the unsharded attention runs on it.
  * The logits come to the mesh's first device in batch order; the cache
    is updated in place (the JAX step donates it).

:func:`prefill_step` and the encoder and cross K/V of :func:`init_cache`
run the training forward (``transformer.forward``, ``encoder_forward``)
with ``model_split.Forward``'s operations under ``torch.no_grad``: each
weight block computes where it lies there too, as in the sharded train
step.  The rows, the weights' fetches, the per-token copies and the
block arithmetic live in ``distributed/model_split.py``, which the three
steps share.

``model_split.copied`` counts the bytes the steps move between mesh
coordinates, as ``weights``, ``activations`` and ``cache``; the cache's
count stays 0, and a step's weights are the all-gather over the data axes of its
model-split and data-split leaves.  On a mesh of distinct devices these
are device copies; on a mesh that repeats one device, the copies the same
mesh would make over distinct ones.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tree as tree_util
from repro_torch.core.precision import full_fp32_matmul
from repro_torch.distributed import act_sharding
from repro_torch.distributed.lm_spmd import (_compute_coords, _empty_stack,
                                             _Placer)
from repro_torch.distributed.model_split import (
    Forward, Split, _Cut, _head_runs, _Row, _run_cols, param_leaves)
from repro_torch.distributed.sharding import (
    NamedSharding, Sharded, _axes, batch_axes, cache_pspecs, params_pspecs,
    sanitize_pspec, sanitized_shardings, tree_map_with_path)
from repro_torch.models import attention as attn
from repro_torch.models import decode as decode_mod
from repro_torch.models import layers, mla
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dtype_of

# the top-level entries a decode step reads; a prefill also the encoder's
_DECODE_KEYS = ("embed", "final_norm", "lm_head", "blocks", "dense_blocks",
                "cross_blocks", "shared_block")
_PREFILL_KEYS = _DECODE_KEYS + ("enc_blocks", "enc_norm")

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
    device need hold; beside the blocks ``device`` holds one drawn layer
    at a time."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return tfm.init_lm(gen, model.cfg, placer=_Placer(shardings))


def _rows(mesh, batch: int) -> Tuple[int, int]:
    """(rows that compute, the data axes' size): one row a data coordinate
    where the data axes divide the batch, else the first row alone."""
    n_data = math.prod(mesh.shape[a] for a in batch_axes(mesh))
    return (n_data if batch % n_data == 0 else 1), n_data


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


def _cache_views(row: _Row, cache):
    return tree_util.tree_map(lambda sh: _CacheStack(sh, row), cache)


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
    computed on each data row's device (the encoder by weight block,
    ``model_split.Forward``; ``wk``, ``wv``, which ``'model'`` does not
    cut, at the row), then written into their blocks."""
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
    leaves = param_leaves(params)
    with torch.no_grad(), full_fp32_matmul():
        for r, coord in enumerate(_compute_coords(mesh, n)):
            row = _Row(mesh, coord, r)
            ops = Forward(row)
            mem = row.take(memory[r * b:(r + 1) * b])
            if cfg.family == "vlm":
                mem = tfm._compute(mem, cfg)
            else:
                mem = tfm.encoder_forward(
                    row.weights(leaves, cdtype, ("enc_blocks", "enc_norm")),
                    cfg, mem, ops)
            xattn = row.weights(leaves, cdtype,
                                ("cross_blocks",))["cross_blocks"]["xattn"]
            views = _cache_views(row, {"cross_k": cache["cross_k"],
                                       "cross_v": cache["cross_v"]})
            for g in range(cache["cross_k"].shape[0]):
                for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
                    t = attn._heads(mem, ops._whole(xattn[w][g]))
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


class _Ops(Split, decode_mod.DecodeOps):
    """``decode.DecodeOps`` over weights and a cache placed on a mesh, for
    one row (the module's docstring); the block arithmetic is
    ``model_split.Split``'s."""

    def moe(self, p, cfg, h):
        """``moe.moe_block`` at capacity T (lossless)."""
        return self._moe(p, cfg, h, cfg.n_experts / cfg.n_experts_active)[0]

    # ---- attention ------------------------------------------------------
    def _pos(self, pos, c) -> torch.Tensor:
        """The step's positions on coordinate ``c`` (sent once a step)."""
        return self.row.once(("pos", c), lambda: self.row.to(pos, c))

    def _slots(self, pos, part: _Part, c, length: int, ring: bool):
        """Where the step's entry falls in a block (offset, n) on ``c``:
        (rows, local slot, inside (B,)), made once a step."""
        n = part.read.shape[1]

        def make():
            local = _slot(self._pos(pos, c), length, ring) - part.offset
            return (torch.arange(local.shape[0], device=local.device),
                    local.clamp(0, n - 1), (local >= 0) & (local < n))
        return self.row.once(("slots", c, part.offset, n, length, ring),
                             make)

    def _valid(self, pos, part: _Part, length: int, ring: bool):
        """The keys of a block its query sees, on the block's coordinate,
        made once a step."""
        n, c = part.read.shape[1], part.coord
        return self.row.once(
            ("valid", c, part.offset, n, length, ring),
            lambda: _valid(part.offset, n, self._pos(pos, c), length, ring))

    def _write(self, part: _Part, new, pos, length: int, ring: bool):
        """The step's entry (B, ...), ``new(c)`` on coordinate ``c``, at
        the step's slots into each copy of the block, on the copy's
        device, where the slot falls in its range."""
        for c, blk in part.writes:
            nd = new(c)
            rows, at, inside = self._slots(pos, part, c, length, ring)
            inside = inside.view((-1,) + (1,) * (nd.dim() - 1))
            blk[rows, at] = torch.where(inside, nd.to(blk.dtype),
                                        blk[rows, at])

    def _partial(self, m, l, o, c):
        """A block's (max, sum, weighted values) back at the row in one
        copy (float32, as ``_merge`` takes them)."""
        t = self.row.send(torch.cat([m[..., None], l[..., None], o.float()],
                                    dim=-1), c, self.row.coord)
        return t[..., 0], t[..., 1], t[..., 2:]

    def attention(self, p, cfg, h, cache_l, pos):
        x = _Cut.at_row(self.row, h)
        q, k, v = attn.finish_qkv(p, cfg, self._heads(p["wq"], x),
                                  self._heads(p["wk"], x),
                                  self._heads(p["wv"], x), pos[:, None])
        kb, vb = cache_l["k"], cache_l["v"]
        if kb.alone() and vb.alone():
            o = attn.decode_attend(cfg, q, k, v, {"k": kb.parts[0].read,
                                                  "v": vb.parts[0].read},
                                   pos)
            return self._heads_out(p["wo"], cfg, o)
        B = h.shape[0]
        length, ring = kb.shape[1], bool(cfg.sliding_window)
        hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qg = _Cut.at_row(self.row, q[:, :, :hq, :].reshape(
            B, 1, hkv, hq // hkv, hd))
        kv = _Cut.at_row(self.row, torch.stack([k[:, 0], v[:, 0]]), axis=0)
        partials = []
        for pk, pv in zip(kb.parts, vb.parts):
            self._write(pk, lambda c: kv.take(0, 2, c)[0], pos, length, ring)
            self._write(pv, lambda c: kv.take(0, 2, c)[1], pos, length, ring)
            kc, vc, c = pk.read, pv.read, pk.coord
            s = torch.einsum("bqhgd,bkhd->bhgk", qg.take(0, qg.n, c).float(),
                             kc.float()) / np.sqrt(hd)
            valid = self._valid(pos, pk, length, ring)
            m, w, l = _softmax_part(s, valid[:, None, None, :])
            o = torch.einsum("bhgk,bkhd->bhgd", w.to(vc.dtype), vc)
            partials.append(self._partial(m, l, o, c))
        o = _merge(partials).to(vb.parts[0].read.dtype)
        return self._heads_out(p["wo"], cfg, o)

    def _absorb_q(self, w, cfg, q_nope: torch.Tensor) -> torch.Tensor:
        """q_eff (B, H, kr) = q_nope (B, H, dn) against ``w_uk``, by
        ``wkv_b``'s column blocks; a head cut by a block edge is summed
        over its blocks in order."""
        row = self.row
        B, H, dn = q_nope.shape
        width = dn + cfg.v_head_dim
        pieces = []
        for b in row.blocks(w, 1):
            runs = [r for r in _head_runs(b.lo, b.hi, width) if r[2] < dn]
            if not runs:
                continue
            h_lo, h_hi = runs[0][0], runs[-1][1]
            qc = row.to(q_nope[:, h_lo:h_hi], b.coord)
            for r in runs:
                h0, h1, e0, e1, _ = r
                eu = min(e1, dn)
                piece = torch.einsum(
                    "bhd,rhd->bhr", qc[:, h0 - h_lo:h1 - h_lo, e0:eu],
                    _run_cols(b.t, r)[..., :eu - e0])
                pieces.append((h0, h1, row.send(piece, b.coord, row.coord)))
        if len(pieces) == 1:
            return pieces[0][2]
        out = torch.zeros((B, H, pieces[0][2].shape[-1]),
                          dtype=pieces[0][2].dtype, device=row.device)
        for h0, h1, t in pieces:
            out[:, h0:h1] += t
        return out

    def _absorb_o(self, w, cfg, o_lat: torch.Tensor) -> torch.Tensor:
        """o (B, H, dv) = o_lat (B, H, kr) through ``w_uv``, by
        ``wkv_b``'s column blocks, each giving its heads' columns."""
        row = self.row
        B, H, _ = o_lat.shape
        dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        pieces = []
        for b in row.blocks(w, 1):
            runs = [r for r in _head_runs(b.lo, b.hi, dn + dv) if r[3] > dn]
            if not runs:
                continue
            h_lo, h_hi = runs[0][0], runs[-1][1]
            oc = row.to(o_lat[:, h_lo:h_hi], b.coord)
            for r in runs:
                h0, h1, e0, e1, _ = r
                ev = max(e0, dn)
                piece = torch.einsum("bhr,rhd->bhd",
                                     oc[:, h0 - h_lo:h1 - h_lo],
                                     _run_cols(b.t, r)[..., ev - e0:])
                pieces.append((h0, h1, ev - dn, e1 - dn,
                               row.send(piece, b.coord, row.coord)))
        if len(pieces) == 1:
            return pieces[0][4]
        out = torch.empty((B, H, dv), dtype=pieces[0][4].dtype,
                          device=row.device)
        for h0, h1, a, z, t in pieces:
            out[:, h0:h1, a:z] = t
        return out

    def mla(self, p, cfg, h, cache_l, pos):
        row = self.row
        B, H, dv = h.shape[0], cfg.n_heads, cfg.v_head_dim
        x = _Cut.at_row(row, h)
        q_lat = layers.rmsnorm(self._cols(p["wq_a"], x).whole(),
                               p["q_a_norm"], cfg.norm_eps)
        q_nope, q_rope = mla.q_heads(
            cfg, self._cols(p["wq_b"], _Cut.at_row(row, q_lat)).whole(),
            pos[:, None])
        c_new, r_new = mla.kv_latent(p, cfg, self._cols(p["wkv_a"],
                                                        x).whole(),
                                     pos[:, None])
        q_eff = self._absorb_q(p["wkv_b"], cfg, q_nope[:, 0])
        cb, rb = cache_l["c_kv"], cache_l["k_rope"]
        if cb.alone() and rb.alone():
            o_lat = mla.latent_attend(
                cfg, q_eff, q_rope[:, 0], c_new, r_new,
                {"c_kv": cb.parts[0].read, "k_rope": rb.parts[0].read}, pos)
        else:
            dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
            kr = cfg.kv_lora_rank
            length = cb.shape[1]
            # the query's latent and RoPE parts, and the step's latent and
            # RoPE key, each in one copy a coordinate
            q = _Cut.at_row(row, torch.cat([q_eff, q_rope[:, 0].to(
                q_eff.dtype)], dim=-1))
            new = _Cut.at_row(row, torch.cat([c_new[:, 0], r_new[:, 0].to(
                c_new.dtype)], dim=-1))
            partials = []
            for pc, pr in zip(cb.parts, rb.parts):
                self._write(pc, lambda c: new.take(0, new.n, c)[..., :kr],
                            pos, length, False)
                self._write(pr, lambda c: new.take(0, new.n, c)[..., kr:],
                            pos, length, False)
                cc, rc, c = pc.read, pr.read, pc.coord
                qc = q.take(0, q.n, c)
                s = (torch.einsum("bhr,bkr->bhk", qc[..., :kr].float(),
                                  cc.float())
                     + torch.einsum("bhd,bkd->bhk", qc[..., kr:].float(),
                                    rc.float())) / np.sqrt(dn + dr)
                valid = self._valid(pos, pc, length, False)
                m, w, l = _softmax_part(s, valid[:, None, :])
                o = torch.einsum("bhk,bkr->bhr", w.to(cc.dtype), cc)
                partials.append(self._partial(m, l, o, c))
            o_lat = _merge(partials).to(cb.parts[0].read.dtype)
        o = self._absorb_o(p["wkv_b"], cfg, o_lat)
        return self._rows(p["wo"], _Cut.at_row(row, o.reshape(B, 1, H * dv)))

    def cross(self, x, ln, xattn, cfg, ck, cv):
        h = layers.rmsnorm(x, ln, cfg.norm_eps)
        qg = decode_mod.cross_query(
            cfg, self._heads(xattn["wq"], _Cut.at_row(self.row, h)))
        if ck.one() and cv.one():
            o = decode_mod.cross_attend(cfg, qg, ck.parts[0].read,
                                        cv.parts[0].read)
            return self._heads_out(xattn["wo"], cfg, o)
        partials = []
        for pk, pv in zip(ck.parts, cv.parts):
            kc, vc, c = pk.read, pv.read, pk.coord
            s = torch.einsum("bqhgd,bkhd->bhgk", self.row.to(qg, c).float(),
                             kc.float()) / np.sqrt(cfg.head_dim)
            m, w, l = _softmax_part(s, None)
            o = torch.einsum("bhgk,bkhd->bhgd", w.to(vc.dtype), vc)
            partials.append(self._partial(m, l, o, c))
        o = _merge(partials).to(cv.parts[0].read.dtype)
        return self._heads_out(xattn["wo"], cfg, o)

    # ---- SSM ------------------------------------------------------------
    def mamba(self, p, cfg, h, cache_l):
        """``ssm.mamba2_decode``: ``in_proj``'s columns joined and cut
        again at the row into [z | xBC | dt]; each ``conv`` block with
        ``conv_w``'s channels on its coordinate; each ``state`` block's
        heads; the gate and norm at the row; ``out_proj``'s row
        blocks."""
        st, cv = cache_l["state"], cache_l["conv"]
        row = self.row
        B = h.shape[0]
        di, N, H, P = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_headdim)
        zxbcdt = self._cols(p["in_proj"], _Cut.at_row(row, h)).whole()[:, 0]
        z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
        conv_w = _Cut(row, row.blocks(p["conv_w"], 1), axis=1,
                      kind="weights")
        outs = []
        for part in cv.parts:            # the conv over its channels
            lo, C = part.offset, part.read.shape[2]
            for j, (c, blk) in enumerate(part.writes):
                xd = row.to(xbc[:, lo:lo + C], c)
                window = torch.cat([blk, xd[:, None, :].to(blk.dtype)], dim=1)
                if j == 0:
                    w = conv_w.take(lo, lo + C, c)
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
        return self._rows(p["out_proj"], _Cut.at_row(row, y))[:, None, :]


# --------------------------------------------------------------------------
# the steps
# --------------------------------------------------------------------------
def decode_step(model, params, cache, tokens: torch.Tensor,
                pos: torch.Tensor):
    """tokens (B, 1) int, pos (B,) int over placed ``params`` and
    ``cache`` -> (logits (B, 1, V) f32 on the mesh's first device, the
    cache, updated in place).  Each weight block computes on its own
    coordinate; only per-token tensors and the data axes' all-gather of
    a row's model blocks move (the module's docstring)."""
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
    leaves = param_leaves(params)
    out = []
    with torch.no_grad(), act_sharding.local(1 if n > 1 else n_data), \
            full_fp32_matmul():
        for r, coord in enumerate(_compute_coords(mesh, n)):
            row = _Row(mesh, coord, r)
            ops = _Ops(row)
            tree = row.weights(leaves, cdtype, _DECODE_KEYS)
            tok = row.take(tokens[r * b:(r + 1) * b])
            at = row.take(pos[r * b:(r + 1) * b])
            x = tfm._compute(ops.embed(tree["embed"], tok), cfg)
            x = decode_mod.decode_layers(tree, cfg, _cache_views(row, cache),
                                         x, at, ops)
            x = layers.rmsnorm(x, tree["final_norm"], cfg.norm_eps)
            out.append(ops.logits(tree, cfg, x))
    return (out[0] if len(out) == 1 else torch.cat(out)), cache


def prefill_step(model, params, tokens: torch.Tensor,
                 memory: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``model.forward`` over placed ``params``: each data row's slice of
    the batch on its device, each weight block computed on its own
    coordinate (``model_split.Forward``); the logits on the mesh's first
    device in batch order."""
    if not is_placed(params):
        raise ValueError("the sharded prefill step takes parameters placed "
                         "on a mesh")
    mesh = _mesh_of(params)
    cfg = model.cfg
    B = tokens.shape[0]
    n, n_data = _rows(mesh, B)
    b, cdtype = B // n, dtype_of(cfg.compute_dtype)
    leaves = param_leaves(params)
    out = []
    with torch.no_grad(), act_sharding.local(1 if n > 1 else n_data):
        for r, coord in enumerate(_compute_coords(mesh, n)):
            row = _Row(mesh, coord, r)
            mem = None if memory is None \
                else row.take(memory[r * b:(r + 1) * b])
            logits = tfm.forward(row.weights(leaves, cdtype, _PREFILL_KEYS),
                                 cfg, row.take(tokens[r * b:(r + 1) * b]),
                                 mem, Forward(row))
            out.append(row.give(logits))
    return out[0] if len(out) == 1 else torch.cat(out)
