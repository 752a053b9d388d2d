"""Build and load the port's CUDA kernels (``csrc/``) on first use.

``nvcc`` compiles ``csrc/dp_kernels.cu`` (which includes the shared step body
``csrc/dp_step.cuh``) for ``sm_90a`` into a shared library with a plain C
interface, under ``build/kernels/`` at the repository root, named by a hash
of the sources and flags so an edit rebuilds. The library is loaded with
``ctypes`` with typed entry points (``c_void_p`` for every pointer and
the stream, so ctypes passes tensor addresses as 64-bit values).

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

__all__ = ["CSRC", "BUILD_DIR", "build", "load", "check", "check_tensor", "stream"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
SOURCES = ("dp_step.cuh", "dp_kernels.cu")
# --fmad=false: no multiply-add contraction, so the kernels' elementwise math
# (demapper metric, Adam) rounds op for op like the plain PyTorch versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    # x, w, h, amps, P, var, nu_sc, n_sym, m, n_lev, stats, gw, gh, q, out, stream
    "vae_dp_step_launch": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    # R, m_max, n_sym, m, n_lev, n_total, rx, w, h, mw, vw, mh, vh (in),
    # w, h, mw, vw, mh, vh (out), losses, var_est, out, dec, eq, mm, s1,
    # amps, P, var, nu_sc, lr, step0, lr_half_step, stream
    "vae_dp_frame_launch": [_I, _I, _I, _I, _I, _LL] + [_P] * 7 + [_P] * 6 + [_P] * 7
    + [_P, _P, _P, _F, _F, _LL, _D, _P],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from csrc/ with the CUDA toolkit")
    return path


def _tag() -> str:
    hsh = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        hsh.update((CSRC / name).read_bytes())
    return hsh.hexdigest()[:16]


def build() -> tuple[pathlib.Path, float, str]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, seconds spent compiling (0.0 if cached), ptxas log).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libvae_dp_{_tag()}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "dp_kernels.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}\n{res.stdout}")
    log.write_text(res.stderr + res.stdout)
    os.replace(tmp, lib)
    return lib, dt, res.stderr + res.stdout


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with typed entry points."""
    path, _, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def check_tensor(name: str, t, shape, device) -> None:
    """A kernel argument must be a contiguous float32 tensor of ``shape`` on ``device``."""
    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous float32 tensor on {device}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def stream(device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device``, for the launchers."""
    return torch.cuda.current_stream(device).cuda_stream
