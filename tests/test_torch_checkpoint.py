"""Checkpoint/resume inside a grid point (``train/harness.py: Checkpoint``).

Every runner that takes ``checkpoint`` in the JAX package is killed after a
save (frame or epoch 5, a save every 3), resumed from its state file, and
held against its uninterrupted run bit for bit: every history and the final
parameters or taps. The port's default draws come from one sequential
``torch.Generator``, so its state travels in the file. Also: a resumed
``train_vae_dp("frame")`` on the JAX package's draws against JAX's
uninterrupted run, the refusals (another mode's file, frame-mode AWGN VAE
runners, a file with no generator state for default draws) and the atomic
write.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_train_dp import RUNS, SMALL, _interpret_frame_kernel, _jax_draws
from vae_equalizer_tpu.train.dp import train_vae_dp as j_train_vae_dp
from vae_equalizer_tpu.utils.config import DpConfig as JDpConfig
from vae_equalizer_tpu_torch.train import (
    run_cma_awgn,
    run_cma_dp,
    train_vae_dp,
    train_vae_flex_dp,
    train_vae_le_awgn,
    train_vae_nn_awgn,
)
from vae_equalizer_tpu_torch.train import awgn as train_awgn
from vae_equalizer_tpu_torch.train.dp import _setup
from vae_equalizer_tpu_torch.train.harness import Checkpoint
from vae_equalizer_tpu_torch.utils import AwgnCmaConfig, AwgnVaeLeConfig, AwgnVaeNnConfig, DpConfig

torch.set_num_threads(1)

KILL, EVERY = 5, 3  # killed in frame / epoch 5's progress, a save every 3
# where the last save before the kill lies: a frame loop saves before
# ``progress`` (after frame 5, at 6), an epoch loop after it (at 3), as in JAX
FRAMES, EPOCHS = 6, 3
DP = dict(mod="4-QAM", snr_db=20.0, num_frames=10, n_frame_max=1000, lr=2.5e-3, m_est=9)
CMA = dict(DP, n_frame_max=600, m_est=5, lr=1e-4)
AWGN = dict(mod="4-QAM", snr_db=14.0, num_epochs=10, epe=1, n_train=256, batch_len=128,
            n_valid=1000, m_est=9)
NN = dict(mod="4-QAM", snr_db=10.0, lr=4e-3, num_epochs=10, epe=1, n_train=200, batch_len=100,
          n_valid=1000, m_est=9, kernel_1=7, batchnorm=True)

CASES = {  # name -> (runner, config, kwargs, the frame or epoch resumed from)
    "vae-autograd": (train_vae_dp, DpConfig(**DP), {"use_pallas": False}, FRAMES),
    "vae-kernel-A": (train_vae_dp, DpConfig(**DP), {"use_pallas": True}, FRAMES),
    "vae-kernel-B": (train_vae_dp, DpConfig(**DP), {"use_pallas": "frame"}, FRAMES),
    "vaeflex-kernel-B": (train_vae_flex_dp, DpConfig(**{**DP, "flex_step": 50}),
                         {"use_pallas": "frame"}, FRAMES),
    "cma-kernel-C": (run_cma_dp, DpConfig(loss_type="CMA", **CMA), {"use_pallas": True}, FRAMES),
    "cmabatch-kernel-D": (run_cma_dp, DpConfig(loss_type="CMAbatch", **CMA),
                          {"use_pallas": "frame"}, FRAMES),
    "vaele-autograd": (train_vae_le_awgn, AwgnVaeLeConfig(**AWGN), {"use_pallas": False}, EPOCHS),
    "vaele-kernel-F": (train_vae_le_awgn, AwgnVaeLeConfig(**AWGN), {"use_pallas": True}, EPOCHS),
    "vaenn-bn-loop": (train_vae_nn_awgn, AwgnVaeNnConfig(**NN), {}, EPOCHS),
}


class Boom(RuntimeError):
    pass


def _killer(at):
    def progress(i, m):
        if i == at:
            raise Boom()
    return progress


def _saved_frame(path) -> int:
    with np.load(path) as d:
        return int(d["frame"])


def _assert_same(got, want, where=""):
    """Every array, tensor and number of a runner's result, bit for bit."""
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same(g, w, f"{where}{k}.")
        else:
            np.testing.assert_array_equal(torch.as_tensor(g).numpy(), torch.as_tensor(w).numpy(),
                                          err_msg=where + k)


@pytest.mark.parametrize("case", list(CASES))
def test_killed_run_resumes_bit_for_bit(case, tmp_path):
    runner, cfg, kw, saved = CASES[case]
    kw = dict(kw, device="cpu", runs=2)
    full = runner(cfg, 7, **kw)
    ckpt = tmp_path / "state.npz"
    with pytest.raises(Boom):
        runner(cfg, 7, checkpoint=ckpt, checkpoint_every=EVERY, progress=_killer(KILL), **kw)
    assert _saved_frame(ckpt) == saved
    assert not list(tmp_path.glob("*.tmp"))
    seen = []
    resumed = runner(cfg, 7, checkpoint=ckpt, checkpoint_every=EVERY,
                     progress=lambda i, m: seen.append(i), **kw)
    assert seen == list(range(saved, 10))  # only the frames after the save ran
    _assert_same(resumed, full)
    assert not list(tmp_path.glob("*.tmp"))


def test_cma_awgn_resumes_by_segments(monkeypatch, tmp_path):
    """run_cma_awgn runs kernel I (its plain version here) in segments that
    end at the save points rounded up to a multiple of epe; segmented and
    whole give the same bits, and a run killed in its second segment resumes
    with the launches of the segments left."""
    cfg = AwgnCmaConfig(mod="4-QAM", snr_db=12.0, lr=1e-3, num_epochs=10, epe=2, n_train=500,
                        n_valid=2000)
    real, epochs = train_awgn.cma_siso_experiment, []

    def counted(rx_epochs, *a):
        epochs.append(rx_epochs.shape[1])
        if len(epochs) == 2 and fail:
            raise Boom()
        return real(rx_epochs, *a)

    monkeypatch.setattr(train_awgn, "cma_siso_experiment", counted)
    fail = False
    whole = run_cma_awgn(cfg, 4, device="cpu", runs=2)
    assert epochs == [10]
    segmented = run_cma_awgn(cfg, 4, device="cpu", runs=2, checkpoint=tmp_path / "a.npz",
                             checkpoint_every=3)
    assert epochs[1:] == [4, 2, 4]  # ends 3 -> 4, 6, 9 -> 10
    _assert_same(segmented, whole)

    epochs.clear()
    fail = True
    ckpt = tmp_path / "state.npz"
    with pytest.raises(Boom):
        run_cma_awgn(cfg, 4, device="cpu", runs=2, checkpoint=ckpt, checkpoint_every=3)
    assert _saved_frame(ckpt) == 4
    epochs.clear()
    fail = False
    resumed = run_cma_awgn(cfg, 4, device="cpu", runs=2, checkpoint=ckpt, checkpoint_every=3)
    assert epochs == [2, 4]
    _assert_same(resumed, whole)


def test_resumed_frame_run_matches_jax(monkeypatch, tmp_path):
    """train_vae_dp("frame") on the JAX package's draws, killed and resumed,
    equals the port's uninterrupted run bit for bit and JAX's uninterrupted
    run at tests/test_torch_train_dp.py's tolerances."""
    _interpret_frame_kernel(monkeypatch)
    small = {**SMALL, "num_frames": 4, "mod": "4-QAM"}
    key = jax.random.PRNGKey(5)
    res_j = j_train_vae_dp(JDpConfig(**small), key, runs=RUNS, use_pallas="frame")

    cfg = DpConfig(**small)
    sim = _setup(cfg, cfg.n_frame_max // cfg.batch_len * cfg.batch_len, "cpu")[2]
    draws = _jax_draws(cfg, key, sim)
    kw = dict(device="cpu", runs=RUNS, use_pallas="frame", draws=lambda frame, r: draws[frame])
    full = train_vae_dp(cfg, 0, **kw)
    ckpt = tmp_path / "state.npz"
    with pytest.raises(Boom):
        train_vae_dp(cfg, 0, checkpoint=ckpt, checkpoint_every=2, progress=_killer(3), **kw)
    resumed = train_vae_dp(cfg, 0, checkpoint=ckpt, checkpoint_every=2, **kw)
    _assert_same(resumed, full)
    np.testing.assert_allclose(resumed["ser"], res_j["ser"], atol=0.05)
    np.testing.assert_allclose(resumed["mi"], res_j["mi"], rtol=5e-2)
    np.testing.assert_allclose(resumed["var_est"], res_j["var_est"], rtol=5e-2)
    np.testing.assert_allclose(resumed["params"]["w"].numpy(), np.asarray(res_j["params"]["w"]),
                               atol=0.05)


@pytest.mark.parametrize("write,read", [
    ((train_vae_dp, DpConfig(**DP), {"use_pallas": "frame"}),
     (train_vae_dp, DpConfig(**DP), {"use_pallas": True})),
    ((train_vae_le_awgn, AwgnVaeLeConfig(**AWGN), {"use_pallas": False}),
     (train_vae_le_awgn, AwgnVaeLeConfig(**AWGN), {"use_pallas": True})),
    ((train_vae_dp, DpConfig(**DP), {"use_pallas": "frame"}),
     (train_vae_dp, DpConfig(**{**DP, "m_est": 11}), {"use_pallas": "frame"})),
    ((train_vae_le_awgn, AwgnVaeLeConfig(**AWGN), {}),
     (train_vae_nn_awgn, AwgnVaeNnConfig(**NN), {})),
], ids=["dp-frame-vs-kernel-A", "vaele-autograd-vs-kernel-F", "dp-other-M", "vaele-vs-vaenn"])
def test_state_file_of_another_mode_raises(write, read, tmp_path):
    ckpt = tmp_path / "state.npz"
    runner, cfg, kw = write
    with pytest.raises(Boom):
        runner(cfg, 0, device="cpu", checkpoint=ckpt, checkpoint_every=EVERY,
               progress=_killer(KILL), **kw)
    before = ckpt.read_bytes()
    runner, cfg, kw = read
    with pytest.raises(ValueError, match="different runner mode"):
        runner(cfg, 0, device="cpu", checkpoint=ckpt, checkpoint_every=EVERY, **kw)
    assert ckpt.read_bytes() == before


@pytest.mark.parametrize("runner,cfg", [(train_vae_le_awgn, AwgnVaeLeConfig(**AWGN)),
                                        (train_vae_nn_awgn, AwgnVaeNnConfig(**NN))],
                         ids=["vaele", "vaenn"])
def test_frame_mode_refuses_a_checkpoint(runner, cfg, tmp_path):
    """JAX's words (train/awgn.py:371-373, 567-569): one call has no epoch
    boundary to save at."""
    with pytest.raises(ValueError, match="runs the whole experiment in one call; "
                                         "checkpointing is unavailable"):
        runner(cfg, 0, device="cpu", use_pallas="frame", checkpoint=tmp_path / "s.npz")
    assert not list(tmp_path.iterdir())


def test_default_draws_need_the_generator_state(tmp_path):
    """A file written on caller-supplied draws holds no generator state: a
    resume on the default draws refuses it instead of drawing from a fresh
    generator; caller draws resume from a file with or without one."""
    cfg = DpConfig(**DP)
    sim = _setup(cfg, cfg.n_frame_max, "cpu")[2]
    gen = torch.Generator().manual_seed(3)
    draws = [sim.draws(gen, 1) for _ in range(cfg.num_frames)]
    kw = dict(device="cpu", use_pallas="frame", checkpoint=tmp_path / "s.npz",
              checkpoint_every=EVERY)
    with pytest.raises(Boom):
        train_vae_dp(cfg, 0, draws=lambda f, r: draws[f], progress=_killer(KILL), **kw)
    with pytest.raises(ValueError, match="no draw-generator state"):
        train_vae_dp(cfg, 0, **kw)
    full = train_vae_dp(cfg, 0, device="cpu", use_pallas="frame", draws=lambda f, r: draws[f])
    _assert_same(train_vae_dp(cfg, 0, draws=lambda f, r: draws[f], **kw), full)


def test_state_file_round_trip_and_atomic_write(monkeypatch, tmp_path):
    """Nested dicts and tuples by position, a Python int, None, device and
    dtype restored from the fresh carry, histories filled in place, the
    generator state set; a write that dies leaves the previous file whole."""
    rng = torch.Generator().manual_seed(11)
    carry = ({"w": torch.arange(6.0).reshape(2, 3), "b": None},
             (torch.ones(2, dtype=torch.int32), 7))
    ck = Checkpoint(tmp_path / "s.npz", 2, rng, "test")
    assert not ck.due(1, 5) and ck.due(2, 5) and not ck.due(4, 4)
    ck.save(2, carry, {"ser": np.full((2, 5), 0.5, np.float32)})
    want_next = torch.rand(3, generator=rng)

    fresh = ({"w": torch.zeros(2, 3, dtype=torch.float64), "b": None},
             (torch.zeros(2, dtype=torch.int32), 0))
    hist = {"ser": np.zeros((2, 5), np.float32)}
    rng2 = torch.Generator().manual_seed(0)
    start, (p, (t, count)) = Checkpoint(tmp_path / "s.npz", 2, rng2, "test").resume(fresh, hist)
    assert start == 2 and count == 7 and isinstance(count, int) and p["b"] is None
    assert p["w"].dtype == torch.float64 and torch.equal(p["w"], carry[0]["w"].double())
    assert t.dtype == torch.int32 and np.all(hist["ser"] == 0.5)
    assert torch.equal(torch.rand(3, generator=rng2), want_next)
    assert Checkpoint().resume(fresh, hist) == (0, fresh)  # no file: a fresh start

    class CudaGenerator:  # a card's generator, as far as the device check sees
        device = torch.device("cuda")

        def set_state(self, state):
            raise AssertionError("a CPU generator's state reached a CUDA generator")

    with pytest.raises(ValueError, match="no draw-generator state for a cuda generator"):
        Checkpoint(tmp_path / "s.npz", 2, CudaGenerator(), "test").resume(fresh, hist)

    def dies(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", dies)
    with pytest.raises(OSError):
        ck.save(4, carry, {"ser": np.zeros((2, 5), np.float32)})
    monkeypatch.undo()
    assert _saved_frame(tmp_path / "s.npz") == 2  # the old state, whole
