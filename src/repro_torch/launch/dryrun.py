"""The dry run: every (arch x shape) cell on the production mesh of H100s,
without a card, with the per-device cost analysis of one step.

The counterpart of the JAX package's ``launch/dryrun.py``.  A cell places
its state on ``make_production_mesh(device="meta")`` (meta tensors, no
allocation; each coordinate a card of its own) by the JAX package's
rules: ``lm_spmd.state_shardings`` for a train cell,
``serve_spmd.param_shardings`` and ``sharding.cache_shardings`` for a
prefill or decode cell; then it runs one ``make_train_step``,
``make_prefill_step`` or ``make_serve_step`` call under
``hlo_analysis.analyze``.  The record keeps the JAX record's keys where
they mean the same:

  * ``arch``, ``shape``, ``mesh`` (``"32x8"``/``"2x32x8"``), ``n_chips``,
    ``kind``, ``n_params``, ``active_params`` and ``model_flops`` (the JAX
    formula: 6 N D for a train step, 2 N D for a prefill, 2 N B for a
    decode step);
  * ``memory``: the argument, output and temp bytes per device (the max
    over coordinates), and ``peak_size_in_bytes``, arguments plus the most
    bytes live at once, with ``fits`` against the card's 80 GB;
  * ``la_flops``, ``la_traffic_bytes``, ``la_collective_bytes``,
    ``la_collective_counts``, ``la_param_bytes``: the max over
    coordinates, the mean beside each (``la_mean``); ``la_link_bytes``
    splits the bytes a coordinate moves by the link they cross and
    ``copied`` gives the whole mesh's by kind;
  * ``t_compute_ms``, ``t_memory_ms`` and ``t_link_ms`` (by link) against
    the peaks of ``launch/mesh.py``, ``bound_by`` the largest, and the
    card they assume (``"card"``): a data-sheet reckoning, not a
    measurement;
  * ``seconds``: the dry run's own time.

The JAX record's ``hlo_flops``, ``hlo_bytes``, its HLO-text
``collective_bytes``/``collective_counts`` and its HLO archive have no
counterpart (there is no compiled module) and are left out.  The rows of
the batch axes run alike (``rows_alike``): one row of each class runs and
the analysis replays it for the others (``hlo_analysis``), which
``tests/test_torch_dryrun.py`` holds equal to running every row.

  PYTHONPATH=src python -m repro_torch.launch.dryrun                # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes

Records are JSON under ``experiments/dryrun_torch/`` (kept, so the sweep
resumes; ``--force`` redoes them); a cell that fails writes
``FAIL_<mesh>_<arch>_<shape>.txt`` with its traceback.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import sys
import time
import traceback
from typing import Dict, Tuple

import torch

from repro_torch import tree as tree_util
from repro_torch.configs import ARCH_IDS, SHAPES, cells, get_config
from repro_torch.distributed import lm_spmd, serve_spmd, sharding
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.registry import build
from repro_torch.optim.optimizers import AdamW
from repro_torch.train import steps as steps_lib

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" \
    / "dryrun_torch"


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.devices.shape)


def placed_bytes(tree) -> Dict[Tuple[int, ...], int]:
    """The bytes each mesh coordinate holds of a placed tree."""
    out: Dict[Tuple[int, ...], int] = {}
    for leaf in tree_util.leaves(tree):
        if isinstance(leaf, sharding.Sharded):
            for c in leaf.mesh.coords():
                t = leaf.shards[c]
                out[c] = out.get(c, 0) + t.numel() * t.element_size()
    return out


def place_cell(model, shape, mesh):
    """The cell's step and its arguments, placed on ``mesh`` by the JAX
    package's rules (no step runs): ``(step, args, placed)``, ``placed``
    the arguments that are the state.  A prefill's tokens and memory and
    a decode step's tokens and positions lie over the batch axes (the
    train batch at the first coordinate)."""
    if shape.kind == "train":
        opt = AdamW(lr=3e-4)
        state = sharding.place(steps_lib.abstract_train_state(model, opt),
                               lm_spmd.state_shardings(model, opt, mesh))
        batch = model.batch_specs(shape)
        return steps_lib.make_train_step(model, opt), (state, batch), state
    params = sharding.place(model.init_abstract(),
                            serve_spmd.param_shardings(model, mesh))
    if shape.kind == "prefill":
        batch = model.batch_specs(shape)
        memory = batch.get("vision", batch.get("frames"))
        return steps_lib.make_prefill_step(model), \
            (params, serve_spmd.place_input(batch["tokens"], mesh, own=True),
             None if memory is None
             else serve_spmd.place_input(memory, mesh, own=True)), params
    abstract = model.cache_abstract(shape)
    cache = sharding.place(abstract, sharding.cache_shardings(
        model, shape, mesh, abstract))
    dec = model.decode_specs(shape)
    return steps_lib.make_serve_step(model), \
        (params, cache, serve_spmd.place_input(dec["tokens"], mesh, own=True),
         serve_spmd.place_input(dec["pos"], mesh, own=True)), (params, cache)


def model_flops(cfg, shape) -> float:
    """The JAX dry run's ``model_flops``: 6 N D for a train step, 2 N D
    for a prefill, 2 N B for one decode step (N the active parameters)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


def times(summary) -> Dict:
    """Data-sheet times of one step on the card (``launch/mesh.py``):
    compute, HBM traffic and each link, in ms, and the largest."""
    t = {"t_compute_ms": summary.flops / mesh_lib.PEAK_BF16_FLOPS * 1e3,
         "t_memory_ms": summary.traffic_bytes / mesh_lib.HBM_BW * 1e3,
         "t_link_ms": {
             "nvlink": summary.link_bytes["nvlink"] / mesh_lib.NVLINK_BW
             * 1e3,
             "network": summary.link_bytes["network"] / mesh_lib.NET_BW
             * 1e3}}
    terms = {"compute": t["t_compute_ms"], "memory": t["t_memory_ms"],
             "nvlink": t["t_link_ms"]["nvlink"],
             "network": t["t_link_ms"]["network"]}
    t["bound_by"] = max(terms, key=terms.get)
    t["bound_ms"] = terms[t["bound_by"]]
    t["card"] = mesh_lib.CARD
    return t


def memory_record(summary, out_bytes) -> Dict:
    """Argument, output and temp bytes per device (the max over
    coordinates), the predicted peak, and whether it fits the card."""
    per = summary.per_coord
    out = {c: out_bytes.get(c, 0) for c in per}
    return {"argument_size_in_bytes": summary.param_bytes,
            "output_size_in_bytes": max(out.values()),
            "temp_size_in_bytes": max(max(st.peak - out[c], 0)
                                      for c, st in per.items()),
            "peak_size_in_bytes": summary.peak_bytes,
            "fits": summary.peak_bytes <= mesh_lib.HBM_BYTES}


def record(summary, out_bytes) -> Dict:
    """The analysis's keys of a dry-run record."""
    rec = {"memory": memory_record(summary, out_bytes),
           "la_flops": summary.flops,
           "la_traffic_bytes": summary.traffic_bytes,
           "la_collective_bytes": summary.collective_bytes,
           "la_collective_counts": summary.collective_counts,
           "la_param_bytes": summary.param_bytes,
           "la_link_bytes": summary.link_bytes,
           "la_mean": summary.mean,
           "copied": summary.copied}
    rec.update(times(summary))
    return rec


def _outputs(result, args) -> Dict[Tuple[int, ...], int]:
    """The bytes each coordinate holds of what a step returns that is not
    one of its arguments (an in-place cache is not counted twice)."""
    held = {id(t) for t in tree_util.leaves(args)
            if isinstance(t, sharding.Sharded)}
    fresh = [t for t in tree_util.leaves(result)
             if isinstance(t, sharding.Sharded) and id(t) not in held]
    return placed_bytes(fresh)


def lower_cell(arch: str, shape_name: str, multi_pod: bool, mesh=None,
               cfg=None, rows_alike: bool = True) -> Dict:
    """One cell's record (the module's docstring); ``mesh`` and ``cfg``
    default to the production mesh and the arch's full config."""
    t0 = time.time()
    cfg = cfg if cfg is not None else get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    model = build(cfg)
    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device="meta")
    step, args, placed = place_cell(model, shape, mesh)
    result, summary = hlo_analysis.analyze(step, *args, mesh=mesh,
                                           rows_alike=rows_alike)
    n_params = sum(math.prod(t.shape) for t in
                   tree_util.leaves(model.init_abstract()))
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name(mesh),
           "n_chips": mesh.size, "kind": shape.kind,
           "n_params": int(n_params),
           "active_params": int(cfg.active_param_count()),
           "model_flops": model_flops(cfg, shape)}
    rec.update(record(summary, _outputs(result, args)))
    rec["seconds"] = time.time() - t0
    return rec


def run_cell(arch, shape_name, multi_pod, force=False):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    tag = "pod2" if multi_pod else "pod1"
    out = OUT_DIR / f"{tag}_{arch}_{shape_name}.json"
    fail = OUT_DIR / f"FAIL_{tag}_{arch}_{shape_name}.txt"
    if out.exists() and not force:
        print(f"[skip] {out.name} (cached)")
        return json.loads(out.read_text())
    print(f"[dry run] {tag} {arch} {shape_name} ...", flush=True)
    try:
        rec = lower_cell(arch, shape_name, multi_pod)
    except Exception:
        err = traceback.format_exc()
        print(f"[FAIL] {tag} {arch} {shape_name}\n{err}", flush=True)
        fail.write_text(err)
        return None
    out.write_text(json.dumps(rec, indent=1))
    if fail.exists():
        fail.unlink()
    print(f"[ok] {out.name} flops/device={rec['la_flops']:.3e} "
          f"bound {rec['bound_by']} {rec['bound_ms']:.1f} ms "
          f"({rec['seconds']:.0f}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    torch.set_grad_enabled(True)

    todo = cells()
    if args.arch:
        todo = [(a, s) for a, s in todo if a == args.arch]
    if args.shape:
        todo = [(a, s) for a, s in todo if s == args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    ok = fail = 0
    for multi_pod in meshes:
        for arch, shape_name in todo:
            rec = run_cell(arch, shape_name, multi_pod, force=args.force)
            ok += rec is not None
            fail += rec is None
    print(f"\ndry-run: {ok} ok, {fail} failed")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
