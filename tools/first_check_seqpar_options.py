"""First check of the sharded runners' options on the card: build the
kernels, make phase 4b's kernel-B frame (R = 8, after 20 trained frames),
then chip_smoke.py's phase 33c (``utils.profiling``'s ``timed`` and
``trace`` on kernel B), 32 (the sharded step and runners on two gloo ranks
sharing the card) and 33a-b (``compiled`` and ``chunk_frames`` against 32b's
sharded loop, a checkpointed run SIGKILLed in a child and resumed) alone.

    PYTHONPATH=. python tools/first_check_seqpar_options.py

About 4-5 minutes of command on the card (phase 32's VAEflex takes ~70 s);
exits non-zero if a phase fails.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

import chip_smoke
from vae_equalizer_tpu_torch.ops import _build
from vae_equalizer_tpu_torch.ops.frame_kernel import vae_dp_frame_train
from vae_equalizer_tpu_torch.train import dp as train_dp
from vae_equalizer_tpu_torch.utils import DpConfig


def main() -> int:
    if not torch.cuda.is_available():
        print("first_check_seqpar_options: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _, build_s, _ = _build.build()
    _build.load()
    chip_smoke._line("build", seconds=f"{build_s:.1f}", torch=torch.__version__)
    dev = torch.device("cuda")
    cfg = DpConfig()
    const, var, sim, amps, P = train_dp._setup(cfg, cfg.n_frame_max // cfg.batch_len
                                               * cfg.batch_len, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    _, f_args = chip_smoke._warm_frame_args(cfg, sim, gen, const, amps, var, P, 8, dev)
    ms_b = chip_smoke._time_ms(lambda: vae_dp_frame_train(*f_args, bl_sym=cfg.batch_len))
    chip_smoke._line("4b kernel B 100 steps", ms=f"{ms_b:.3f}")
    chip_smoke._profiling_phase(card, f_args, ms_b)
    sp_loop = chip_smoke._seqpar_phases(card)
    chip_smoke._seqpar_option_phases(card, sp_loop)
    print(f"{card} total_s={time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
