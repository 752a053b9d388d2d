"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
PyTorch versions: kernel A (one DP minibatch step, ``elbo_kernel``) and
kernel B (a whole training frame for R runs, ``frame_kernel``)."""

from .elbo_kernel import VaeDpLoss, vae_dp_loss_and_grad, vae_dp_loss_and_grad_plain
from .frame_kernel import frame_opt_init, vae_dp_frame_train, vae_dp_frame_train_plain

__all__ = [
    "VaeDpLoss",
    "frame_opt_init",
    "vae_dp_frame_train",
    "vae_dp_frame_train_plain",
    "vae_dp_loss_and_grad",
    "vae_dp_loss_and_grad_plain",
]
