"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
PyTorch versions: kernel A (one DP minibatch step, ``elbo_kernel``), kernel
B (a whole training frame for R runs, ``frame_kernel``), kernel C (the
per-symbol CMA recurrence, ``cma_kernel``) and kernel D (the CMAbatch /
CMAflex chunk engine, ``cma_frame_kernel``)."""

from .cma_frame_kernel import cma_chunked_frame, cma_chunked_frame_plain
from .cma_kernel import cma_dp_kernel, cma_dp_plain
from .elbo_kernel import VaeDpLoss, vae_dp_loss_and_grad, vae_dp_loss_and_grad_plain
from .frame_kernel import frame_opt_init, vae_dp_frame_train, vae_dp_frame_train_plain

__all__ = [
    "VaeDpLoss",
    "cma_chunked_frame",
    "cma_chunked_frame_plain",
    "cma_dp_kernel",
    "cma_dp_plain",
    "frame_opt_init",
    "vae_dp_frame_train",
    "vae_dp_frame_train_plain",
    "vae_dp_loss_and_grad",
    "vae_dp_loss_and_grad_plain",
]
