"""Full float32 for the library calls the port makes on the card.

cuBLAS computes a float32 product, and cuDNN a float32 convolution, in
TF32 (about three decimal digits) when the process allows it: PyTorch's
default allows it for cuDNN's convolutions and not for cuBLAS's products,
and a caller may change either.  TF32 misses the port's 1e-4 contract
(rel L2 3.7e-4 on VGG-16's fp products, PERF.md), so the port's float32
library calls run inside these guards, which set IEEE float32 for the
block and restore the caller's setting after it.

Each guard uses the API this PyTorch has: ``fp32_precision`` where it
exists (mixing it with the older ``allow_tf32`` makes reads of the latter
raise), else ``allow_tf32``.  PyTorch reads the setting on the host when a
call is enqueued, so the call keeps IEEE float32 whenever the card runs
it.  The settings are process-wide: a lock per guard serialises its
blocks, so two threads inside one guard cannot restore each other's
setting before the other's call is enqueued.  The lock is re-entrant: a
block may hold a block of the same guard (a language model's forward
holds one around its products, and its convolutions take theirs
inside).  A thread outside the guard that changes the setting during a
block defeats it, and float32 calls that other threads enqueue during a
block run in IEEE float32 too.

A backward pass is one block that other threads join: autograd runs a
card's backward functions on a thread of its own while the caller waits,
and a function there that enters the guard (a rematerialised layer, a
guarded product's backward) would wait forever on the caller's lock.
``full_fp32_backward`` holds the cuBLAS guard and lets every thread join
it without the lock until it ends; it restores the caller's setting only
after the last thread that joined has left.
"""
from __future__ import annotations

import contextlib
import threading

import torch


class _Guard:
    """One process-wide float32 setting: blocks that set IEEE float32 and
    restore the caller's setting, serialised by a re-entrant lock, and
    shared blocks (a backward pass) that other threads join."""

    def __init__(self, resolve):
        self._resolve = resolve          # () -> (object, attribute, IEEE)
        self._lock = threading.RLock()
        self._shared = threading.Condition()
        self._open = False               # a shared block holds the lock
        self._joined = 0                 # threads inside it without it

    def _join(self) -> bool:
        with self._shared:
            if self._open:
                self._joined += 1
            return self._open

    def _leave(self) -> None:
        with self._shared:
            self._joined -= 1
            self._shared.notify_all()

    @contextlib.contextmanager
    def block(self, shared: bool = False):
        if self._join():
            try:
                yield
            finally:
                self._leave()
            return
        obj, name, full = self._resolve()
        with self._lock:
            previous = getattr(obj, name)
            setattr(obj, name, full)
            try:
                if not shared:
                    yield
                    return
                with self._shared:
                    self._open = True
                try:
                    yield
                finally:
                    with self._shared:
                        self._open = False
                        self._shared.wait_for(lambda: self._joined == 0)
            finally:
                setattr(obj, name, previous)


def _ieee(new_api, legacy_api):
    """Where the setting lives: ``new_api.fp32_precision`` = "ieee" where
    the attribute exists, else ``legacy_api.allow_tf32`` = False."""
    def resolve():
        if hasattr(new_api, "fp32_precision"):
            return new_api, "fp32_precision", "ieee"
        return legacy_api, "allow_tf32", False
    return resolve


_MATMUL = _Guard(_ieee(torch.backends.cuda.matmul, torch.backends.cuda.matmul))
_CONV = _Guard(_ieee(getattr(torch.backends.cudnn, "conv", None),
                     torch.backends.cudnn))


def full_fp32_matmul():
    """Run the float32 products (cuBLAS) inside in full float32."""
    return _MATMUL.block()


def full_fp32_backward():
    """Run a backward pass inside in full float32 on cuBLAS: the block of
    ``full_fp32_matmul`` that autograd's threads join (the module's
    docstring)."""
    return _MATMUL.block(shared=True)


def full_fp32_conv():
    """Run the float32 convolutions (cuDNN) inside in full float32."""
    return _CONV.block()
