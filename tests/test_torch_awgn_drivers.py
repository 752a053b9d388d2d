"""The port's AWGN drivers (``drivers/eval_run_shaping_cma.py``,
``eval_run_shaping_vaele.py``, ``eval_run_vaenn.py``, ``eval_run_dfe.py``)
against the JAX package's, and the sweeps they and ``eval_run_dp`` drive.

* ``--quick --device cpu``: each driver writes the JAX driver's .mat (the
  same name, keys, shapes and types as JAX's own ``--quick`` run, the same
  axis values) and its JSONL; the VAE-LE and VAE-NN drivers with
  ``--pallas-frame`` (kernels G and H's plain versions on the CPU);
* the JAX drivers' refusals and the options the runners defer;
* ``run_sweep("CMA-AWGN", ...)``: one ``run_cma_awgn`` call per grid point
  with the iters as runs, each point from its own seed;
* the lr and nu axes of the DP sweep batched together: one runner call for
  the 2 x 2 grid, each point with its own lr and demapper variance.
"""

import pathlib
import re

import numpy as np
import pytest
import scipy.io as sio
import torch

from vae_equalizer_tpu.drivers import eval_run_dfe as j_eval_run_dfe
from vae_equalizer_tpu.drivers import eval_run_shaping_cma as j_eval_run_shaping_cma
from vae_equalizer_tpu.drivers import eval_run_shaping_vaele as j_eval_run_shaping_vaele
from vae_equalizer_tpu.drivers import eval_run_vaenn as j_eval_run_vaenn
from vae_equalizer_tpu_torch.core import demapper_noise_var, make_constellation
from vae_equalizer_tpu_torch.drivers import (
    eval_run_dfe,
    eval_run_shaping_cma,
    eval_run_shaping_vaele,
    eval_run_vaenn,
)
from vae_equalizer_tpu_torch.parallel import sweep
from vae_equalizer_tpu_torch.parallel.sweep import assemble_mat, point_seed, run_sweep
from vae_equalizer_tpu_torch.utils import AwgnCmaConfig, DpConfig

torch.set_num_threads(1)

# driver -> (port module, JAX module, the port's extra flags, .mat name, JSONL glob)
DRIVERS = {
    "shaping_cma": (eval_run_shaping_cma, j_eval_run_shaping_cma, [],
                    "SERvsSNR_CMA_shaping_0.0_h1_4-QAM", "sweep_CMA_shaping_4-QAM_*.jsonl"),
    "shaping_vaele": (eval_run_shaping_vaele, j_eval_run_shaping_vaele, ["--pallas-frame"],
                      "SERvsSNR_VAELE_shaping_0.0_h1_4-QAM", "sweep_VAELE_shaping_4-QAM_*.jsonl"),
    "vaenn": (eval_run_vaenn, j_eval_run_vaenn, ["--pallas-frame"], "SERvsSNR_Net_h1_4-QAM",
              "sweep_Net_4-QAM_*.jsonl"),
    "dfe": (eval_run_dfe, j_eval_run_dfe, [], "SERvsSNR_LMMSE_DFE_h1_64-QAM", "lmmse_dfe.jsonl"),
}


def _mat(path):
    d = sio.loadmat(path)["dict"]
    return {k: d[k][0, 0] for k in d.dtype.names}


@pytest.mark.parametrize("driver", list(DRIVERS), ids=list(DRIVERS))
def test_quick_run_writes_jaxs_mat_layout(driver, tmp_path):
    port, jax_mod, extra, mat_name, jsonl = DRIVERS[driver]
    name = port.main(["--quick", "--device", "cpu", "--no-mesh", *extra,
                      "--out", str(tmp_path / "port")])
    jax_mod.main(["--quick", "--no-mesh", "--out", str(tmp_path / "jax")])
    (j_name,) = (tmp_path / "jax").glob("*.mat")
    assert pathlib.Path(name).parent == tmp_path / "port"
    strip = lambda p: re.sub(r"_\d{12}\.mat$", "", pathlib.Path(p).name)  # noqa: E731
    assert strip(name) == strip(j_name) == mat_name
    got, want = _mat(name), _mat(j_name)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    ser_keys = [k for k in want if k.startswith("SER")]
    for k in want:
        if k in ser_keys:
            assert np.all(np.isfinite(got[k])) and np.all((got[k] >= 0) & (got[k] <= 1)), k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(list((tmp_path / "port").glob(jsonl))) == 1


def test_cli_refusals_equal_jaxs(capsys):
    argv = ["--pallas", "--pallas-frame", "--out", "unused"]
    lines = []
    for main in (eval_run_shaping_vaele.main, j_eval_run_shaping_vaele.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        lines.append([ln for ln in capsys.readouterr().err.splitlines() if "error:" in ln])
    assert lines[0] and lines[0] == lines[1]


@pytest.mark.parametrize("driver", ["shaping_cma", "shaping_vaele", "vaenn"])
@pytest.mark.parametrize("flag", [["--compiled"], ["--checkpoint-every", "2"]],
                         ids=["compiled", "checkpoint"])
def test_deferred_options_raise(driver, flag, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        DRIVERS[driver][0].main(["--quick", "--device", "cpu", *flag, "--out", str(tmp_path)])


TINY_CMA = dict(mod="4-QAM", snr_db=14.0, num_epochs=4, epe=2, n_train=600, n_valid=1500)


def _counting(monkeypatch, name):
    calls = []
    real = sweep.RUNNERS[name]

    def counting(cfg, seed, **kw):
        calls.append((cfg, seed, kw))
        return real(cfg, seed, **kw)

    monkeypatch.setitem(sweep.RUNNERS, name, counting)
    return calls


def test_run_sweep_cma_awgn(monkeypatch, tmp_path):
    calls = _counting(monkeypatch, "CMA-AWGN")
    results, axes_values, jsonl = run_sweep(
        "CMA-AWGN", AwgnCmaConfig(**TINY_CMA), {"lr": [1e-3, 3e-3]}, iters=2, seed=4,
        out_dir=tmp_path, tag="cma", device="cpu", save_params=True)
    assert [c[1] for c in calls] == [point_seed(4, 0), point_seed(4, 1)]
    assert all(c[2]["runs"] == 2 and c[2]["device"] == "cpu" for c in calls)
    assert len(results) == 2 and len(jsonl.read_text().splitlines()) == 2
    for rec, lr in zip(results, [1e-3, 3e-3]):
        assert rec["config"]["lr"] == lr
        assert np.asarray(rec["ser"]).shape == np.asarray(rec["mi"]).shape == (2, 2)
        assert np.all(np.isfinite(rec["ser"])) and pathlib.Path(rec["checkpoint"]).exists()
    assert not np.allclose(results[0]["ser"], results[1]["ser"])
    assert assemble_mat(results, axes_values, 2, ()).shape == (2, 2, 2)


TINY_DP = dict(mod="16-QAM", snr_db=20.0, num_frames=2, n_frame_max=200, batch_len=50, m_est=9,
               n_lrhalf=10**6)


def test_batch_lr_and_nu_axes_compose(monkeypatch, tmp_path):
    calls = _counting(monkeypatch, "VAE")
    results, axes_values, _ = run_sweep(
        "VAE", DpConfig(**TINY_DP), {"nu": [0.0, 0.0270955], "lr": [2.5e-3, 1e-3]}, iters=2,
        seed=6, out_dir=tmp_path, tag="lrnu", runner_kwargs={"use_pallas": "frame"},
        batch_lr_axis=True, batch_nu_axis=True, device="cpu")
    assert len(calls) == 1 and calls[0][2]["runs"] == 8  # the 2 x 2 grid x 2 iters in one call
    kw = calls[0][2]
    assert list(kw["lr_vec"]) == [2.5e-3] * 2 + [1e-3] * 2 + [2.5e-3] * 2 + [1e-3] * 2
    np.testing.assert_array_equal(kw["nu_vec"], np.float32([0.0] * 4 + [0.0270955] * 4))
    assert len(results) == 4
    for rec in results:
        want = demapper_noise_var(make_constellation("16-QAM", rec["config"]["nu"]), 20.0)
        np.testing.assert_array_equal(rec["var"], np.full(2, np.float32(want)))
        assert np.asarray(rec["ser"]).shape == (2, 4, 2) and np.all(np.isfinite(rec["ser"]))
    assert assemble_mat(results, axes_values, 2, (4,)).shape == (4, 2, 2, 2, 2)
