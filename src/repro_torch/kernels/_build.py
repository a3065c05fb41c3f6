"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

The kernels are plain C entry points compiled with ``nvcc`` for
``sm_90a`` into one shared library and loaded with ``ctypes``: a build
takes seconds, where one that includes PyTorch's headers takes minutes.
The build runs at first use, one ``nvcc`` per source started together,
into ``build/repro_torch_kernels/<hash of sources and flags>/`` at the
root of the checkout, and is reused while the sources are unchanged.

Every entry point returns the ``cudaError_t`` of its launch; :func:`check`
raises on anything but ``cudaSuccess``.  There is no fallback: a missing
``nvcc``, a failed build or a refused launch raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libsfc_kernels.so"
# largest tile the kernels take: kMaxL, kMaxT, kMaxM in csrc/sfc_common.cuh
MAX_L = MAX_T = MAX_M = 12

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# argtypes of every C entry point; pointers and the stream are c_void_p
SIGNATURES = {
    "sfc_transform_quantize_launch": (_P,) * 5 + (_I,) * 18 + (_F, _I, _P),
    "sfc_transform_launch": (_P, _P, _P) + (_I,) * 18 + (_P,),
    "tdmm_int8_launch": (_P,) * 5 + (_I,) * 10 + (_P,),
    "tdmm_int8_depthwise_launch": (_P,) * 5 + (_I,) * 6 + (_P,),
    "sfc_inverse_launch": (_P, _P, _P) + (_I,) * 4 + (_LL, _LL)
    + (_I,) * 5 + (_P,),
    "sfc_fused_conv2d_launch": (_P,) * 7 + (_I,) * 27 + (_F, _P),
    "sfc_fused_conv2d_depthwise_launch": (_P,) * 7 + (_I,) * 20 + (_F, _P),
    "sfc_error_string": (_I,),
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, headers = _sources()
    for path in cus + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels build with the CUDA "
        "toolkit on a machine with an sm_90 card")


def _compile(out_dir: pathlib.Path) -> pathlib.Path:
    nvcc = _nvcc()
    cus, _ = _sources()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / (cu.stem + ".o") for cu in cus]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(cu), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cu, obj in zip(cus, objs)]
    errors = []
    for cu, proc in zip(cus, procs):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{cu.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
         str(tmp / LIB_NAME)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    if out_dir.exists():          # another process finished first
        shutil.rmtree(tmp)
    else:
        tmp.replace(out_dir)
    return out_dir / LIB_NAME


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is not None:
            return _LIB
        out_dir = BUILD_ROOT / _digest()
        path = out_dir / LIB_NAME
        if not path.exists():
            t0 = time.perf_counter()
            path = _compile(out_dir)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.sfc_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned anything but ``cudaSuccess``."""
    if err != 0:
        what = library().sfc_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {what} "
                           f"(cudaError_t {err})")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream


def runs_plain(kernel: str, *tensors) -> bool:
    """Whether ``kernel``'s wrapper runs its plain version.

    True when every tensor lies on the CPU; False when all lie on one CUDA
    device, where the wrapper launches the kernel.  Anything else raises:
    a CUDA tensor never reaches a plain version.
    """
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise ValueError(f"{kernel}: tensors must all lie on the CPU or all on "
                     f"one CUDA device, got {sorted(map(str, devices))}")


def require(kernel: str, tensor, name: str, dtype, ndim: int) -> None:
    """Raise unless ``tensor`` is a contiguous ``dtype`` tensor of ``ndim``."""
    if tensor.dtype != dtype or tensor.dim() != ndim \
            or not tensor.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {ndim}-d {dtype} tensor, "
            f"got {tensor.dtype} of shape {tuple(tensor.shape)}"
            f"{'' if tensor.is_contiguous() else ' (not contiguous)'}")
