"""The port's small public functions against the JAX package's, on the same
seeded numpy inputs: ``core.cplx`` (atol 1e-6; ``conv_valid`` rtol 1e-5),
``metrics.mutual_information`` with and without a weight on DP-shaped
posteriors (rtol 1e-5), ``train.eval_utils.roll_dp`` (exact), the ``viz``
figures (the same scatter offsets, line data and titles, from numpy arrays
and from tensors) and ``utils.profiling``'s ``timed`` and ``trace``.
"""

import json

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from vae_equalizer_tpu import viz as j_viz  # noqa: E402
from vae_equalizer_tpu.core import cplx as j_cplx  # noqa: E402
from vae_equalizer_tpu.metrics import mutual_information as j_mutual_information  # noqa: E402
from vae_equalizer_tpu.train.eval_utils import roll_dp as j_roll_dp  # noqa: E402
from vae_equalizer_tpu_torch import viz  # noqa: E402
from vae_equalizer_tpu_torch.core import cplx, make_constellation  # noqa: E402
from vae_equalizer_tpu_torch.metrics import mutual_information  # noqa: E402
from vae_equalizer_tpu_torch.train.eval_utils import roll_dp  # noqa: E402
from vae_equalizer_tpu_torch.utils import profiling  # noqa: E402


def _planes(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


CPLX_CASES = {
    "to_planes": lambda rng: ((rng.normal(size=(3, 40)) + 1j * rng.normal(size=(3, 40)))
                              .astype(np.complex64), {"axis": 1}),
    "from_planes": lambda rng: (_planes(rng, 3, 2, 40), {"axis": 1}),
    "cmul": lambda rng: ((_planes(rng, 2, 2, 40), _planes(rng, 2, 2, 40)), {"axis": 1}),
    "cconj": lambda rng: (_planes(rng, 2, 2, 40), {"axis": 1}),
    "cabs2": lambda rng: (_planes(rng, 2, 3, 40), {}),
    "conv_valid": lambda rng: ((_planes(rng, 2, 300), _planes(rng, 2, 25)), {}),
}


@pytest.mark.parametrize("name", sorted(CPLX_CASES))
def test_cplx_matches_jax(name):
    """Each stacked-plane op on the same arrays as JAX's (complex results
    compared as planes); conv_valid also against np.convolve."""
    args, kw = CPLX_CASES[name](np.random.default_rng(sorted(CPLX_CASES).index(name)))
    args = args if isinstance(args, tuple) else (args,)
    got = getattr(cplx, name)(*(torch.from_numpy(a) for a in args), **kw)
    want = np.asarray(getattr(j_cplx, name)(*(jnp.asarray(a) for a in args), **kw))
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    if name == "conv_valid":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        x, h = (a[0] + 1j * a[1] for a in args)
        ref = np.convolve(x, h, mode="valid")
        np.testing.assert_allclose(got[0] + 1j * got[1], ref, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_mutual_information_matches_jax(weighted):
    """DP-shaped posteriors (runs 3, pol 2, 2n levels, N): per run and pol,
    against JAX within rtol 1e-5; the perfect posterior gives the sample's
    empirical entropy, the prior 0."""
    rng = np.random.default_rng(11)
    const = make_constellation("64-QAM", 0.0270955)
    amps, P = const.amps.astype(np.float32), np.asarray(const.P, np.float32)
    n, N = amps.shape[0], 500
    logits = rng.normal(size=(3, 2, 2 * n, N)).astype(np.float32) * 2.0
    q = np.exp(logits)
    q[..., :n, :] /= q[..., :n, :].sum(-2, keepdims=True)
    q[..., n:, :] /= q[..., n:, :].sum(-2, keepdims=True)
    tx_idx = rng.choice(n, size=(3, 2, 2, N), p=P)
    tx = amps[tx_idx]
    weight = (rng.random(N) > 0.3).astype(np.float32) if weighted else None
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    got = mutual_information(t(q), t(tx), t(amps), t(P), weight=t(weight)).numpy()
    want = np.asarray(j_mutual_information(j(q), j(tx), j(amps), j(P), weight=j(weight)))
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    onehot = np.concatenate([tx_idx[..., 0, None, :] == np.arange(n)[:, None],
                             tx_idx[..., 1, None, :] == np.arange(n)[:, None]], -2)
    mi1 = mutual_information(torch.from_numpy(onehot.astype(np.float32)), t(tx), t(amps), t(P),
                             weight=t(weight)).numpy()
    w = np.ones(N) if weight is None else weight
    emp = -(np.log2(P[tx_idx[..., 0, :]]) + np.log2(P[tx_idx[..., 1, :]]))
    np.testing.assert_allclose(mi1, (emp * w).sum(-1) / w.sum(), rtol=1e-5)
    prior = np.broadcast_to(np.concatenate([P, P])[:, None], q.shape).copy()
    assert np.abs(mutual_information(torch.from_numpy(prior), t(tx), t(amps), t(P),
                                     weight=t(weight)).numpy()).max() < 1e-5


@pytest.mark.parametrize("r", [0, 1])
def test_roll_dp_matches_jax(r):
    """Every shift pair of a small grid, for both pol assignments: exact."""
    x = np.random.default_rng(r).normal(size=(2, 3, 2, 64)).astype(np.float32)
    for s0, s1 in [(0, 0), (3, -2), (-4, 5), (7, 7), (63, -63), (70, -1)]:
        got = roll_dp(torch.from_numpy(x), torch.tensor([s0, s1]), torch.tensor(r))
        want = np.asarray(j_roll_dp(jnp.asarray(x), jnp.asarray([s0, s1]), jnp.int32(r)))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{(s0, s1)}")


def _offsets(fig):
    return [c.get_offsets().data for c in fig.axes[0].collections]


LAYOUTS = {  # tests/test_viz.py's four layouts
    "planes": lambda rng: rng.normal(size=(2, 100)).astype(np.float32),
    "pol_planes": lambda rng: rng.normal(size=(2, 2, 100)).astype(np.float32),
    "complex": lambda rng: (rng.normal(size=100) + 1j * rng.normal(size=100)).astype(np.complex64),
    "complex_pols": lambda rng: (rng.normal(size=(2, 100))
                                 + 1j * rng.normal(size=(2, 100))).astype(np.complex64),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_constellation_plot_carries_jaxs_data(layout, tmp_path):
    """The port's figure from the numpy array and from a tensor holds JAX's
    scatter offsets, labels and axis labels; ``save`` writes the file."""
    arr = LAYOUTS[layout](np.random.default_rng(0))
    want = j_viz.constellation_plot(arr)
    out = tmp_path / "c.png"
    figs = [viz.constellation_plot(arr, save=str(out)), viz.constellation_plot(torch.from_numpy(arr))]
    try:
        assert out.exists()
        for fig in figs:
            assert len(_offsets(fig)) == len(_offsets(want))
            for a, b in zip(_offsets(fig), _offsets(want)):
                np.testing.assert_array_equal(a, b)
            ax, wax = fig.axes[0], want.axes[0]
            assert [c.get_label() for c in ax.collections] == [c.get_label() for c in wax.collections]
            assert (ax.get_xlabel(), ax.get_ylabel()) == (wax.get_xlabel(), wax.get_ylabel())
    finally:
        plt.close("all")


def test_expectation_and_correlation_plots_carry_jaxs_data():
    """tests/test_viz.py's inputs: E_q[x]'s scatter offsets, the correlation
    line's y-data and its peak title equal JAX's, from numpy and tensors."""
    rng = np.random.default_rng(1)
    amps = np.linspace(-1, 1, 8).astype(np.float32)
    q = rng.random((2, 16, 50)).astype(np.float32)
    q /= q.sum(axis=1, keepdims=True)
    x, tx = rng.normal(size=200), rng.normal(size=200)
    try:
        want = j_viz.expectation_constellation(q, amps)
        for got in (viz.expectation_constellation(q, amps),
                    viz.expectation_constellation(torch.from_numpy(q), torch.from_numpy(amps))):
            for a, b in zip(_offsets(got), _offsets(want), strict=True):
                np.testing.assert_allclose(a, b, rtol=1e-6)
        want = j_viz.correlation_plot(x, tx)
        for got in (viz.correlation_plot(x, tx),
                    viz.correlation_plot(torch.from_numpy(x), torch.from_numpy(tx))):
            np.testing.assert_array_equal(got.axes[0].lines[0].get_ydata(),
                                          want.axes[0].lines[0].get_ydata())
            assert got.axes[0].get_title() == want.axes[0].get_title()
            assert "peak" in got.axes[0].get_title()
    finally:
        plt.close("all")


def test_timed_returns_the_median_and_the_last_result(monkeypatch):
    """warmup + reps calls; the median of the reps' times (a fake clock) and
    the last call's result; a CPU result waits for no card."""
    calls = []
    ticks = iter([0.0, 3.0, 10.0, 11.0, 20.0, 25.0])  # reps of 3, 1, 5 s

    def fn(a, scale=1):
        calls.append(a)
        return torch.full((2,), float(len(calls) * scale))

    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(ticks))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: pytest.fail("synchronized on the CPU"))
    t, res = profiling.timed(fn, "x", warmup=2, reps=3, scale=10)
    assert len(calls) == 5 and t == 3.0
    assert torch.equal(res, torch.full((2,), 50.0))


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """The block's CPU ops land in one Chrome trace file in the directory."""
    with profiling.trace(tmp_path / "prof") as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    (path,) = (tmp_path / "prof").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any("matmul" in k.key for k in prof.key_averages())
