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
setting before the other's call is enqueued.  A thread outside the guard
that changes the setting during a block defeats it, and float32 calls
that other threads enqueue during a block run in IEEE float32 too.
"""
from __future__ import annotations

import contextlib
import threading

import torch

_MATMUL_LOCK = threading.Lock()
_CONV_LOCK = threading.Lock()


@contextlib.contextmanager
def _ieee(new_api, legacy_api, lock):
    """``new_api.fp32_precision = "ieee"`` where the attribute exists, else
    ``legacy_api.allow_tf32 = False``, for the block, under ``lock``."""
    obj, name, full = (new_api, "fp32_precision", "ieee") \
        if hasattr(new_api, "fp32_precision") \
        else (legacy_api, "allow_tf32", False)
    with lock:
        previous = getattr(obj, name)
        setattr(obj, name, full)
        try:
            yield
        finally:
            setattr(obj, name, previous)


def full_fp32_matmul():
    """Run the float32 products (cuBLAS) inside in full float32."""
    matmul = torch.backends.cuda.matmul
    return _ieee(matmul, matmul, _MATMUL_LOCK)


def full_fp32_conv():
    """Run the float32 convolutions (cuDNN) inside in full float32."""
    cudnn = torch.backends.cudnn
    return _ieee(getattr(cudnn, "conv", None), cudnn, _CONV_LOCK)
