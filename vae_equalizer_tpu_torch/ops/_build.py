"""Build and load the port's CUDA kernels (``csrc/``) on first use.

Each library is one ``nvcc`` compile of one ``.cu`` source for ``sm_90a`` into
a shared library with a plain C interface, under ``build/kernels/`` at the
repository root, named by a hash of its sources and flags so an edit
rebuilds:

  * ``dp``  — ``csrc/dp_kernels.cu`` (+ ``dp_step.cuh``): kernels A and B;
  * ``cma`` — ``csrc/cma_kernels.cu`` (+ ``cma_step.cuh``): kernels C, D and I;
  * ``siso`` — ``csrc/siso_kernels.cu`` (+ ``siso_step.cuh``): kernels F and G;
  * ``nn``  — ``csrc/nn_kernels.cu`` (+ ``nn_step.cuh``, ``siso_step.cuh``): kernel H;
  * ``butterfly`` — ``csrc/butterfly_kernel.cu``: kernel E;
  * ``dfe`` — ``csrc/dfe_kernel.cu`` (+ ``dfe_step.cuh``): kernel J;
  * ``eval`` — ``csrc/dp_eval_kernel.cu`` (+ ``dp_eval_step.cuh``): kernel K.

The compiles of all libraries that need one start together and run in
parallel. The libraries are loaded with ``ctypes`` with typed entry points
(``c_void_p`` for every pointer and the stream, so ctypes passes tensor
addresses as 64-bit values).

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
import types

import torch

__all__ = ["CSRC", "BUILD_DIR", "COUNTED", "build", "load", "check", "check_tensor", "counted",
           "device_scalar", "stream"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
# library -> (compiled source, headers it includes)
LIBRARIES = {
    "dp": ("dp_kernels.cu", ("dp_step.cuh",)),
    "cma": ("cma_kernels.cu", ("cma_step.cuh",)),
    "siso": ("siso_kernels.cu", ("siso_step.cuh",)),
    "nn": ("nn_kernels.cu", ("nn_step.cuh", "siso_step.cuh")),
    "butterfly": ("butterfly_kernel.cu", ()),
    "dfe": ("dfe_kernel.cu", ("dfe_step.cuh",)),
    "eval": ("dp_eval_kernel.cu", ("dp_eval_step.cuh",)),
}
# --fmad=false: no multiply-add contraction, so the kernels' elementwise math
# (demapper metric, Adam / AMSGrad, CMA updates) rounds op for op like the plain
# PyTorch versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _LL, _F, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_double
_SIGNATURES = {
    "dp": {
        # R, x, x_run, x_row, w, h, amps, P, var, nu_sc, n_sym, m, n_lev, stats, gw,
        # gh, q, out, stream
        "vae_dp_step_launch": [_I, _P, _LL, _LL] + [_P] * 5 + [_F, _I, _I, _I] + [_P] * 6,
        # R, m_max, n_sym, stride_sym, m, n_lev, n_total, rx, w, h, mw, vw, mh,
        # vh (in), w, h, mw, vw, mh, vh (out), losses, var_est, out, dec, eq, mm,
        # s1, amps, P (R, n), var (R, 2), nu_sc (R,), lr (R,), step0 (one int64 on
        # the card), lr_half_step, stream_bf16, clocks (int64 per phase, or null),
        # stream
        "vae_dp_frame_launch": [_I] * 6 + [_LL] + [_P] * 7 + [_P] * 6 + [_P] * 7
        + [_P] * 5 + [_P, _D, _I, _P, _P],
    },
    "cma": {
        # R, n_sym, m, sps, lp, y, h_in, h_out, out, e, big_r, lr (one float32 on
        # the card), update, clocks (int64 per phase, or null), stream
        "cma_dp_launch": [_I, _I, _I, _I, _LL, _P, _P, _P, _P, _P, _F, _P, _I, _P, _P],
        # R, n_sym, m, sps, lp, j0, S, n_full, n_slots, tail, y, h_in, h_out, out,
        # e, big_r, lr (one float32 on the card), clocks (int64 per phase, or
        # null), stream
        "cma_chunked_launch": [_I, _I, _I, _I, _LL] + [_I] * 5 + [_P] * 5 + [_F, _P, _P, _P],
        # R, n_epochs, m, sps, n_total, epe, n_evals, rx, h_in, h_out, h_ev, loss,
        # big_r, lr2, clocks (int64 per phase, or null), stream
        "cma_siso_experiment_launch": [_I] * 4 + [_LL, _I, _I] + [_P] * 5 + [_F, _F, _P, _P],
    },
    "siso": {
        # R, n_sym, m, n_lev, x, w, h, amps, P, amp_mean, var, loss, gw, gh, q, out,
        # clocks (int64 per phase, or null), stream
        "vae_siso_step_launch": [_I, _I, _I, _I] + [_P] * 5 + [_F, _F] + [_P] * 7,
        # R, n_epochs, n_batches, n_sym, m, n_lev, n_total, epe, n_evals, rx, w, h,
        # mw, vw, xw, mh, vh, xh (in), w, h, mw, vw, xw, mh, vh, xh (out), losses,
        # w_ev, h_ev, amps, P, amp_mean, var, lr, step0, clocks (int64 per phase, or
        # null), stream
        "vae_siso_experiment_launch": [_I] * 6 + [_LL, _I, _I] + [_P] * 9 + [_P] * 8
        + [_P] * 3 + [_P, _P, _F, _F, _F, _LL, _P, _P],
    },
    "nn": {
        # R, n_epochs, n_batches, n_sym, m, n_lev, k1, n_total, epe, n_evals, batchnorm,
        # pointer table (csrc/nn_kernels.cu), lr, momentum, step0, clocks (int64 per
        # phase, or null), stream
        "vae_nn_experiment_launch": [_I] * 7 + [_LL, _I, _I, _I, _P, _F, _F, _LL, _P, _P],
    },
    "butterfly": {
        # n_out, m, sps, n_lev, l_in, w, x, amps, var, nu_sc, q, out, clocks (int64
        # per phase, or null), stream
        "butterfly_demap_launch": [_I] * 5 + [_P] * 4 + [_F, _P, _P, _P, _P],
        # blocks, threads, stream: an empty kernel (the launch floor)
        "butterfly_empty_launch": [_I, _I, _P],
    },
    "dfe": {
        # B, n, k2, n_points, grid_l (L of an L x L grid table, or 0: the
        # general route), ff, fb, points, init, idx, clocks (int64 per phase, or
        # null), stream
        "dfe_decide_launch": [_I] * 5 + [_P] * 7,
    },
    "eval": {
        # R, m_max, L, n_lev, corr_len, stream_bf16, out, dec, eq, mm, s1, their
        # strides (mb, run, pol, comp), eq's (mb, run, pol), tx, its strides (run,
        # pol, comp), amps, P, P's run stride, var, var's run stride, nu_sc, nu_sc
        # per run (or null), inv_step, half, mask (kind, a, b, c, margin), res_f,
        # res_i, clocks (int64 per phase, or null), stream
        "vae_dp_eval_launch": [_I] * 6 + [_P] * 5 + [_LL] * 7 + [_P] + [_LL] * 3
        + [_P, _P, _LL, _P, _LL, _F, _P, _F, _F] + [_I] * 5 + [_P] * 4,
    },
}


# every kernel wrapper with a launch count (``counted``): the wrapper adds one to
# its ``launches`` where it launches its kernel; a CUDA graph that captured the
# launch adds its captured count at each replay (``train/harness.py: StepGraphs``)
COUNTED: list = []


def counted(wrapper):
    """Give a kernel wrapper its ``launches`` count (0) and list it in ``COUNTED``."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from csrc/ with the CUDA toolkit")
    return path


def _lib_path(name: str) -> pathlib.Path:
    src, headers = LIBRARIES[name]
    hsh = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *headers):
        hsh.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"libvae_{name}_{hsh.hexdigest()[:16]}.so"


def build() -> tuple[dict[str, pathlib.Path], float, str]:
    """Compile every library whose source hash has none yet, all in parallel.

    Returns ({library: path}, seconds spent compiling (0.0 if all cached),
    the ptxas logs of all libraries).
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in LIBRARIES}
    t0 = time.perf_counter()
    jobs = {}
    for name, lib in paths.items():
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / LIBRARIES[name][0])]
            jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True))
    failed = []
    for name, (tmp, proc) in jobs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{stderr}\n{stdout}")
            continue
        paths[name].with_suffix(".log").write_text(stderr + stdout)
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    dt = time.perf_counter() - t0 if jobs else 0.0
    logs = [p.with_suffix(".log") for p in paths.values()]
    return paths, dt, "".join(log.read_text() for log in logs if log.exists())


@functools.lru_cache(maxsize=1)
def load() -> types.SimpleNamespace:
    """Build (if needed) and load every kernel library; returns their typed
    entry points by name (the libraries stay referenced by the namespace)."""
    paths, _, _ = build()
    entry = {"libraries": {}}
    for lib_name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        entry["libraries"][lib_name] = lib
        for name, argtypes in _SIGNATURES[lib_name].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            entry[name] = fn
    return types.SimpleNamespace(**entry)


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


def device_scalar(name: str, v, dtype: torch.dtype, device) -> torch.Tensor:
    """A launcher's per-call scalar as the one-element tensor on ``device`` that
    the kernel reads by pointer. A one-element tensor is used as it is, with no
    copy, so a launch captured in a CUDA graph reads the value that the replayed
    step wrote there; a Python number is filled in on the device."""
    if not torch.is_tensor(v):
        return torch.full((1,), v, dtype=dtype, device=device)
    if v.numel() != 1 or v.dtype != dtype or v.device != device:
        raise ValueError(f"{name}: needs a Python number or a one-element {dtype} tensor on "
                         f"{device}, got {tuple(v.shape)} {v.dtype} on {v.device}")
    return v.reshape(1)


def stream(device) -> int:
    """Handle of PyTorch's current CUDA stream on ``device``, for the launchers."""
    return torch.cuda.current_stream(device).cuda_stream
