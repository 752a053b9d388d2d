"""vae_equalizer_tpu_torch — the PyTorch + CUDA port of ``vae_equalizer_tpu``.

Mirrors the JAX package's layout (``core/ channels/ models/ ops/ metrics/
train/ utils/``) so each counterpart is found by path. Public functions keep
the JAX package's argument order and array layouts (stacked real/imag planes,
``(pol, I/Q, time)``) with an optional leading runs axis ``R`` written out
where JAX used ``vmap``.

The hot path is the DP VAE online-training frame: ``ops/frame_kernel.py``
runs a whole frame of minibatch steps (butterfly -> PCS soft demapper -> DP
ELBO -> closed-form backward -> Adam) as one hand-written CUDA kernel for
Hopper (``csrc/``), built with ``nvcc`` on first use. The other paths — the
DP CMA baselines, the AWGN VAE-LE and VAE-NN experiments and the streaming
receiver (``models/streaming.py``) — run the other kernels of ``ops/``
(A-H, one for each TPU kernel of the JAX package). Every kernel has a plain
PyTorch version beside it, taken for CPU tensors; the entry points run on
the card unless the caller passes ``device="cpu"``.

Layer map (bottom to top): ``core`` -> ``channels`` -> ``models``/``ops`` ->
``metrics`` -> ``train``.
"""

__version__ = "0.1.0"
