"""vae_equalizer_tpu_torch — the PyTorch + CUDA port of ``vae_equalizer_tpu``.

Mirrors the JAX package's layout (``core/ channels/ models/ ops/ metrics/
train/ utils/``) so each counterpart is found by path. Public functions keep
the JAX package's argument order and array layouts (stacked real/imag planes,
``(pol, I/Q, time)``) with an optional leading runs axis ``R`` written out
where JAX used ``vmap``.

The hot path is the DP VAE online-training frame: ``ops/frame_kernel.py``
runs a whole frame of minibatch steps (butterfly -> PCS soft demapper -> DP
ELBO -> closed-form backward -> Adam) as one hand-written CUDA kernel for
Hopper (``csrc/``), built with ``nvcc`` on first use. Every kernel has a plain
PyTorch version beside it, taken for CPU tensors.

Layer map (bottom to top): ``core`` -> ``channels`` -> ``models``/``ops`` ->
``metrics`` -> ``train``.
"""

__version__ = "0.1.0"
