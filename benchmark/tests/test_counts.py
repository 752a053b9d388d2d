"""The frozen counts against their originals (``chip_smoke.py``'s for the
DP kinds' kernel B) at every hand kernel each cell times, as its kind's
support file lists them."""

import pytest
import torch

from benchmark.harness import core, counts
from benchmark.tests import cells


@pytest.mark.parametrize("workload", cells.names(core))
def test_counts_equal_chip_smoke(workload):
    cells.check_counts(core, workload)


@pytest.mark.parametrize("runs,steps", [(1, 20), (8, 100)])
def test_bytes_equal_chip_smoke(runs, steps):
    """Kernel B's bytes from shapes against ``chip_smoke._nbytes`` of a plain
    launch's arguments and outputs (the stream's R = 1 block; the flagship's
    frame), its run constants in their shared form."""
    import chip_smoke

    from vae_equalizer_tpu_torch.models import butterfly_init, dirac_taps_dp
    from vae_equalizer_tpu_torch.ops.frame_kernel import frame_opt_init, vae_dp_frame_train_plain

    torch.set_num_threads(min(4, torch.get_num_threads()))
    m, bl, n_lev = 25, 100, 8
    w = butterfly_init(m).expand(runs, 2, 4, m).contiguous()
    h = dirac_taps_dp(m).expand(runs, 2, 2, 2, m).contiguous()
    opt = frame_opt_init({"w": w, "h": h})
    rx = torch.randn((runs, 2, 2, 2 * bl * steps), generator=torch.Generator().manual_seed(0))
    amps, P, var = torch.linspace(-1, 1, n_lev), torch.full((n_lev,), 1 / n_lev), torch.ones(2)
    args = (w, h, opt, rx, amps, var, 0.0, P, 2.5e-3, 0, float("inf"))
    got = vae_dp_frame_train_plain(*args, bl_sym=bl)
    assert counts.b_launch_bytes(runs, steps, bl, 2 * bl * steps, m, n_lev) == \
        chip_smoke._nbytes(args, got)
