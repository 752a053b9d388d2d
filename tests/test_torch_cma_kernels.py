"""Kernels C and D: their wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain version; it is held against JAX
``cma_dp_pallas`` and ``cma_chunked_frame_pallas(_rb)`` run in interpret
mode (as tests/test_pallas_ops.py and tests/test_cma_frame_kernel.py run
them), at the tolerances those tests state for kernel vs scan engine. The
single-run call is R = 1 of the batched one. The CUDA cases compare each
kernel with its plain version on the card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_equalizer_tpu.ops.cma_frame_kernel import cma_chunked_frame_pallas as j_chunked
from vae_equalizer_tpu.ops.cma_frame_kernel import cma_chunked_frame_pallas_rb as j_chunked_rb
from vae_equalizer_tpu.ops.cma_kernel import cma_dp_pallas as j_cma_dp_pallas
from vae_equalizer_tpu_torch.models import dirac_taps_dp
from vae_equalizer_tpu_torch.ops import (
    cma_chunked_frame,
    cma_chunked_frame_plain,
    cma_dp_kernel,
    cma_dp_plain,
)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

T = torch.from_numpy


def _frame(R, n, m=25, seed=11):
    rng = np.random.default_rng(seed)
    rx = rng.normal(size=(R, 2, 2, n)).astype(np.float32)
    h0 = (np.asarray(dirac_taps_dp(m)) + 0.01 * rng.normal(size=(R, 2, 2, 2, m))).astype(np.float32)
    return rx, h0


@pytest.mark.parametrize("update", [True, False])
def test_cma_kernel_matches_pallas_interpret(golden, update):
    g = golden("cma_dp")
    lr = float(g["lr"])
    rng = np.random.default_rng(2)
    rx = np.stack([g["Rx"], (g["Rx"] + 0.1 * rng.normal(size=g["Rx"].shape)).astype(np.float32)])
    h0 = np.stack([g["h0"], g["h0"][::-1].copy()])
    out, h, e = cma_dp_kernel(T(rx), 1.0, T(h0), lr, 2, update)
    assert out.shape == (2, 2, 2, 60) and h.shape == (2, 2, 2, 2, 11) and e.shape == (2, 60, 2)
    for r in range(2):
        jo, jh, je = j_cma_dp_pallas(jnp.asarray(rx[r]), 1.0, jnp.asarray(h0[r]), lr, 2, update,
                                     interpret=True)
        np.testing.assert_allclose(out[r].numpy(), np.asarray(jo), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(h[r].numpy(), np.asarray(jh), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(e[r].numpy(), np.asarray(je), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("B,S,lr", [(100, 100, 1e-4), (60, 20, 1e-4)])
def test_chunked_frame_matches_pallas_interpret(B, S, lr):
    """Single-run and runs-batched JAX kernels (tests/test_cma_frame_kernel.py
    tolerances: out rtol 1e-4 / atol 2e-6, h atol 1e-7, e atol 5e-6)."""
    rx, h0 = _frame(2, 1200)
    out, h, e = cma_chunked_frame(T(rx), 1.0, T(h0), lr, B, S, 2)
    jo, jh, je = j_chunked_rb(jnp.asarray(rx), 1.0, jnp.asarray(h0), lr, B, S, 2, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jo), rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-4, atol=5e-6)
    jo, jh, je = j_chunked(jnp.asarray(rx[1]), 1.0, jnp.asarray(h0[1]), lr, B, S, 2, interpret=True)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(jo), rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(h[1].numpy(), np.asarray(jh), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("kernel", ["C", "D"])
def test_single_run_is_r1_of_batched(kernel):
    rx, h0 = _frame(1, 800)
    call = {
        "C": lambda x, h: cma_dp_kernel(x, 1.0, h, 1e-3, 2),
        "D": lambda x, h: cma_chunked_frame(x, 1.0, h, 5e-5, 100, 10, 2),
    }[kernel]
    single = call(T(rx[0]), T(h0[0]))
    batched = call(T(rx), T(h0))
    for a, b in zip(single, batched):
        assert a.shape == b.shape[1:]
        np.testing.assert_array_equal(a.numpy(), b[0].numpy())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels are CUDA C++ for sm_90a)")
    return torch.device("cuda")


def _close(got, want, name):
    """rtol 1e-4 with an absolute floor of 1e-6 of the tensor's scale (float32
    sums in another order)."""
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6 * np.abs(w).max(), err_msg=name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("update", [True, False])
def test_cma_kernel_matches_plain_on_card(cuda, update):
    rx, h0 = _frame(3, 2000)
    rx, h0 = T(rx).to(cuda), T(h0).to(cuda)
    n0 = cma_dp_kernel.launches
    got = cma_dp_kernel(rx, 1.0, h0, 1e-3, 2, update)
    torch.cuda.synchronize()
    assert cma_dp_kernel.launches == n0 + 1
    want = cma_dp_plain(rx, 1.0, h0, 1e-3, 2, update)
    for name, a, b in zip(("out", "h", "e"), got, want):
        _close(a, b, name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,S,lr", [(100, 100, 1e-4), (100, 10, 5e-5), (60, 20, 1e-4)])
def test_chunked_frame_matches_plain_on_card(cuda, B, S, lr):
    rx, h0 = _frame(3, 4000)
    rx, h0 = T(rx).to(cuda), T(h0).to(cuda)
    n0 = cma_chunked_frame.launches
    got = cma_chunked_frame(rx, 1.0, h0, lr, B, S, 2)
    torch.cuda.synchronize()
    assert cma_chunked_frame.launches == n0 + 1
    want = cma_chunked_frame_plain(rx, 1.0, h0, lr, B, S, 2)
    for name, a, b in zip(("out", "h", "e"), got, want):
        _close(a, b, name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,sps,n_sym,B,S", [
    (25, 2, 1207, 100, 100), (25, 2, 1206, 100, 10), (25, 2, 1207, 60, 20),  # tails 1, S, 1
    (41, 2, 900, 100, 20), (9, 1, 700, 40, 8), (25, 2, 112, 100, 10),  # n_full = 0
    (25, 2, 1206, 400, 10), (25, 2, 500, 30, 1),
], ids=["batch_tail1", "flex_tailS", "b60_tail1", "m41", "sps1", "no_full", "ring40", "S1"])
def test_chunked_frame_shapes_on_card(cuda, m, sps, n_sym, B, S):
    """Kernel D at the shapes of tests/test_torch_cma_step_emulation.py (the
    prefix stages, tails of 1 and S, taps per lane 1-8, a large ring) against
    its plain version; two launches give the same bits."""
    rx, h0 = _frame(2, n_sym * sps, m)
    rx, h0 = T(rx).to(cuda), T(h0).to(cuda)
    got = cma_chunked_frame(rx, 1.0, h0, 1e-4, B, S, sps)
    again = cma_chunked_frame(rx, 1.0, h0, 1e-4, B, S, sps)
    torch.cuda.synchronize()
    want = cma_chunked_frame_plain(rx, 1.0, h0, 1e-4, B, S, sps)
    for name, a, b, c in zip(("out", "h", "e"), got, again, want):
        assert torch.equal(a, b), name
        _close(a, c, name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,sps", [(41, 2), (9, 1)], ids=["m41", "sps1"])
def test_cma_kernel_shapes_on_card(cuda, m, sps):
    """Kernel C with two taps per lane (M > 32) and at sps 1 against its plain
    version; two launches give the same bits."""
    rx, h0 = _frame(2, 1206 * sps, m)
    rx, h0 = T(rx).to(cuda), T(h0).to(cuda)
    got = cma_dp_kernel(rx, 1.0, h0, 1e-3, sps)
    again = cma_dp_kernel(rx, 1.0, h0, 1e-3, sps)
    torch.cuda.synchronize()
    want = cma_dp_plain(rx, 1.0, h0, 1e-3, sps)
    for name, a, b, c in zip(("out", "h", "e"), got, again, want):
        assert torch.equal(a, b), name
        _close(a, c, name)
