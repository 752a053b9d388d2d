"""The port's ``Eval_run_DP`` driver (``drivers/eval_run_dp.py``) against the
JAX package's: the same .mat keys, shapes and types from a ``--quick`` run
(the port's ``--pallas-frame`` on the CPU, i.e. kernel B's plain version;
JAX's default mode), the same ``p.error`` refusals, ``--sp 2`` on two gloo
ranks of the CPU writing JAX's layout, and ``--compiled`` /
``--frames-per-call`` (with and without ``--sp 2``) and ``--sp 2
--checkpoint-every`` giving the loop's SER. Also: no module of the port imports
JAX or the JAX package (a grep of its sources).
"""

import pathlib
import re

import numpy as np
import pytest
import scipy.io as sio
import torch

from vae_equalizer_tpu.drivers import eval_run_dp as j_eval_run_dp
from vae_equalizer_tpu_torch.drivers import eval_run_dp

torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parent.parent / "vae_equalizer_tpu_torch"


def _mat(path):
    d = sio.loadmat(path)["dict"]
    return {k: d[k][0, 0] for k in d.dtype.names}


def test_quick_run_writes_jaxs_mat_layout(tmp_path):
    name = eval_run_dp.main(["--quick", "--pallas-frame", "--device", "cpu", "--no-mesh",
                             "--out", str(tmp_path / "port")])
    j_eval_run_dp.main(["--quick", "--no-mesh", "--out", str(tmp_path / "jax")])
    (j_name,) = (tmp_path / "jax").glob("*.mat")
    assert pathlib.Path(name).parent == tmp_path / "port"
    strip = lambda p: re.sub(r"_\d{12}\.mat$", "", pathlib.Path(p).name)
    assert strip(name) == strip(j_name) == "SERvsSNR_VAE_DP_4-QAM_N_lrhalf_170_N_train_2000"
    got, want = _mat(name), _mat(j_name)
    assert list(got) == list(want)
    assert list(got)[:3] == ["SER", "Var_est", "var_real"]
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert got["SER"].shape == (4, 1, 1, 1, 1, 1, 1, 1, 1, 2, 4)  # 4 rows x 8 axes x 2 iters x 4 frames
    for k in ("SNR", "nu", "theta_diff", "theta", "M", "lr", "batch_len", "symb_rate", "symb_step"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert np.all(np.isfinite(got["SER"])) and np.all(got["var_real"] > 0)
    np.testing.assert_array_equal(got["var_real"], want["var_real"])  # the same demapper variance
    assert len(list((tmp_path / "port").glob("sweep_VAE_DP_4-QAM_*.jsonl"))) == 1


REFUSALS = [
    ["--pallas", "--pallas-frame"],
    ["--runs-batch", "2"],
    ["--batch-lr-axis"],
    ["--batch-snr-axis", "--pallas-frame", "--loss-type", "CMAbatch"],
    ["--batch-nu-axis", "--loss-type", "VAEflex"],
    ["--stream-bf16"],
    ["--pallas-frame", "--loss-type", "CMA"],
    ["--pallas-frame", "--loss-type", "VAEflex", "--batch-len", "100", "--flex-step", "30"],
    ["--pallas", "--loss-type", "CMAbatch"],
    ["--sp", "2", "--loss-type", "CMA"],
    ["--sp", "2", "--pallas"],
    ["--sp", "2", "--loss-type", "VAEflex", "--batch-len", "100", "--flex-step", "30"],
]


def _error_line(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv + ["--out", "unused"])
    assert e.value.code == 2
    return [ln for ln in capsys.readouterr().err.splitlines() if "error:" in ln]


@pytest.mark.parametrize("argv", REFUSALS, ids=lambda a: " ".join(a))
def test_cli_refusals_equal_jaxs(argv, capsys):
    got = _error_line(eval_run_dp.main, argv, capsys)
    assert got and got == _error_line(j_eval_run_dp.main, argv, capsys)


SP_QUICK = ["--quick", "--device", "cpu", "--no-mesh", "--sp", "2"]


@pytest.fixture(scope="module")
def sp_alone(tmp_path_factory):
    """``--sp 2 --quick --device cpu``'s .mat (two gloo ranks on the CPU)."""
    return _mat(eval_run_dp.main(SP_QUICK + ["--out", str(tmp_path_factory.mktemp("sp"))]))


@pytest.mark.parametrize("argv", [["--sp", "2"], ["--compiled"], ["--frames-per-call", "2"],
                                  ["--sp", "2", "--compiled"], ["--sp", "2", "--frames-per-call", "2"],
                                  ["--sp", "2", "--checkpoint-every", "1"]])
def test_unported_options_raise(argv, tmp_path, sp_alone):
    """``--sp 2 --device cpu`` runs the sharded VAE on two gloo ranks and
    writes JAX's .mat layout (keys, shapes, dtypes of JAX's ``--quick``),
    its SER on frames 0-1 that of the unsharded autograd run (the same
    seeds, so the same draws) and the same var_real; ``--compiled`` and
    ``--frames-per-call K`` (CUDA-graph replay) run, every point's SER equal
    to the run without the flag; with ``--sp 2``, ``--compiled``,
    ``--frames-per-call 2`` and ``--checkpoint-every 1`` (the point's state
    file saved every frame, then removed) each give the .mat SER of
    ``--sp 2`` alone bit for bit."""
    if argv == ["--sp", "2"]:
        quick = ["--quick", "--device", "cpu", "--no-mesh"]
        got = sp_alone
        want = _mat(eval_run_dp.main(quick + ["--out", str(tmp_path / "plain")]))
        j_eval_run_dp.main(["--quick", "--no-mesh", "--out", str(tmp_path / "jax")])
        j_want = _mat(next((tmp_path / "jax").glob("*.mat")))
        assert list(got) == list(j_want)
        for k in j_want:
            assert got[k].shape == j_want[k].shape and got[k].dtype == j_want[k].dtype, k
        np.testing.assert_allclose(got["SER"][..., :2], want["SER"][..., :2], atol=1e-6)
        np.testing.assert_array_equal(got["var_real"], want["var_real"])
        assert np.all(np.isfinite(got["SER"]))
        return
    if argv[0] == "--sp":
        got = _mat(eval_run_dp.main(SP_QUICK + argv[2:] + ["--out", str(tmp_path / "sp")]))
        assert not list((tmp_path / "sp").glob("state_*"))
        for k in ("SER", "Var_est", "var_real"):
            np.testing.assert_array_equal(got[k], sp_alone[k], err_msg=k)
        return
    quick = ["--quick", "--pallas-frame", "--device", "cpu", "--no-mesh"]
    got = _mat(eval_run_dp.main(quick + argv + ["--out", str(tmp_path / "graph")]))
    want = _mat(eval_run_dp.main(quick + ["--out", str(tmp_path / "loop")]))
    np.testing.assert_array_equal(got["SER"], want["SER"])
    np.testing.assert_array_equal(got["Var_est"], want["Var_est"])


def test_port_sources_import_no_jax():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|optax|vae_equalizer_tpu)(\s|\.|$)", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert any(f.parent.name == "parallel" for f in files) and any(f.parent.name == "drivers" for f in files)
    hits = [f"{f.relative_to(PORT)}: {m.group(0).strip()}" for f in files for m in bad.finditer(f.read_text())]
    assert not hits, hits
