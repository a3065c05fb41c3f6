"""Fault-tolerant checkpointing on npz + JSON, in the JAX package's format.

  * **atomic**: write to a temp dir, fsync, rename — a crash mid-save never
    corrupts the latest checkpoint;
  * **async**: the device-to-host copy happens on the caller's thread,
    file IO on a one-worker pool so the train loop is not blocked;
  * **self-describing**: ``arrays.npz`` beside ``manifest.json`` (step,
    keys, dtypes, shapes, the arrays' sha256);
  * **the JAX package's layout**: a leaf's key is its path as the JAX
    package names it (dict keys and NamedTuple fields by name, sequence
    items as ``#i``: ``opt/mu/stem/w``), bf16 is stored as its uint16
    bits, so a checkpoint either package writes restores in the other;
  * retention: keep the last ``keep`` checkpoints, delete older ones only
    after a newer one is fully committed.

A state placed on a mesh (``distributed.sharding.Sharded`` leaves) is
written gathered, in the same format; ``restore(..., shardings=)``
places each leaf by its ``NamedSharding`` (elastic restore: a checkpoint
written from one mesh restores onto another, or onto one device).
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import pathlib
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, unflatten

_SEP = "/"


def _path_part(part) -> str:
    return f"#{part}" if isinstance(part, int) else str(part)


def _flatten(tree) -> Dict[str, Any]:
    return {_SEP.join(_path_part(p) for p in path): leaf
            for path, leaf in flatten_with_path(tree)}


def _to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host; bf16 as its uint16 bits (npz
    has no bfloat16), the dtype kept in the manifest; a sharded leaf
    gathered."""
    from repro_torch.distributed.sharding import Sharded
    if isinstance(leaf, Sharded):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().copy()
    return np.asarray(leaf)


def _dtype_name(leaf, host: np.ndarray) -> str:
    if getattr(leaf, "dtype", None) == torch.bfloat16:
        return "bfloat16"
    return str(host.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[concurrent.futures.Future] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Snapshot ``tree`` at ``step``. Non-blocking by default."""
        flat = _flatten(tree)
        host = {k: _to_host(v) for k, v in flat.items()}
        dtypes = {k: _dtype_name(flat[k], v) for k, v in host.items()}
        self.wait()
        self._pending = self._pool.submit(self._write, step, host, dtypes)
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        """Finish the pending write and stop the writer thread."""
        self.wait()
        self._pool.shutdown()

    def _write(self, step: int, host: Dict[str, np.ndarray],
               dtypes: Dict[str, str]) -> None:
        tmp = self.dir / f".tmp-{step}-{os.getpid()}"
        final = self.dir / f"step_{step:012d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays_path = tmp / "arrays.npz"
        np.savez(arrays_path, **{k.replace("/", "|"): v
                                 for k, v in host.items()})
        digest = hashlib.sha256(arrays_path.read_bytes())
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(host.keys()),
            "dtypes": dtypes,
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "sha256": digest.hexdigest(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        with open(tmp / "manifest.json") as f:
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic commit
        self._gc()

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*"))
        for old in ckpts[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # ------------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_*"))
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def restore(self, tree_like, step: Optional[int] = None,
                shardings=None, verify: bool = True):
        """Restore into the structure of ``tree_like``; each tensor leaf
        comes back in its template leaf's dtype, on its device, or placed
        by ``shardings`` (a tree of ``NamedSharding`` like
        ``tree_like``'s: the elastic-restore path, whatever mesh wrote
        the checkpoint; the template may then be abstract, meta tensors).
        Returns ``(tree, step)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:012d}"
        manifest = json.loads((d / "manifest.json").read_text())
        if verify:
            got = hashlib.sha256((d / "arrays.npz").read_bytes()).hexdigest()
            if got != manifest["sha256"]:
                raise IOError(f"checkpoint {d} digest mismatch")
        from repro_torch.distributed.sharding import Sharded
        flat_like = _flatten(tree_like)
        placing = None if shardings is None \
            else list(_flatten(shardings).values())
        out = []
        with np.load(d / "arrays.npz") as data:
            for i, (key, like) in enumerate(flat_like.items()):
                arr = data[key.replace("/", "|")]
                bf16 = manifest["dtypes"].get(key) == "bfloat16"
                if not isinstance(like, (torch.Tensor, Sharded)):
                    out.append(arr)
                    continue
                t = torch.from_numpy(arr.view(np.int16) if bf16 else arr)
                if bf16:
                    t = t.view(torch.bfloat16)
                if placing is not None:
                    s = placing[i]
                    out.append(Sharded.place(t.to(like.dtype), s.spec,
                                             s.mesh, own=True))
                else:
                    out.append(t.to(device=like.device, dtype=like.dtype))
        return unflatten(tree_like, out), step
