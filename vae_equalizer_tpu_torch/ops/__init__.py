"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) with their plain
PyTorch versions: kernel A (one DP minibatch step, ``elbo_kernel``), kernel
B (a whole training frame for R runs, ``frame_kernel``), kernel C (the
per-symbol CMA recurrence, ``cma_kernel``), kernel D (the CMAbatch /
CMAflex chunk engine, ``cma_frame_kernel``), kernel E (the DP inference
pass, ``butterfly_kernel``), kernels F and G (the SISO VAE-LE step and whole
experiment, ``elbo_siso_kernel``, ``siso_frame_kernel``), kernel H (the
whole VAE-NN experiment, ``nn_frame_kernel``), and three kernels with no TPU
counterpart: I (the whole AWGN CMA experiment, ``cma_siso_kernel``), J
(the DFE's decision-feedback loop, ``dfe_kernel``) and K (the DP VAE frame's
eval, ``eval_kernel``)."""

from .butterfly_kernel import vae_le_dp_forward_fused, vae_le_dp_forward_plain
from .cma_frame_kernel import cma_chunked_frame, cma_chunked_frame_plain
from .cma_kernel import cma_dp_kernel, cma_dp_plain
from .cma_siso_kernel import cma_siso_experiment, cma_siso_experiment_plain
from .dfe_kernel import dfe_decide, dfe_decide_plain
from .elbo_kernel import VaeDpLoss, vae_dp_loss_and_grad, vae_dp_loss_and_grad_plain
from .elbo_siso_kernel import vae_siso_loss_and_grad, vae_siso_loss_and_grad_plain
from .eval_kernel import vae_dp_frame_eval
from .frame_kernel import frame_opt_init, vae_dp_frame_train, vae_dp_frame_train_plain
from .nn_frame_kernel import (
    flatten_nn_params,
    nn_frame_opt_init,
    nn_net,
    unflatten_nn_params,
    vae_nn_experiment_train,
    vae_nn_experiment_train_plain,
)
from .siso_frame_kernel import (
    amsgrad,
    siso_frame_opt_init,
    vae_siso_experiment_train,
    vae_siso_experiment_train_plain,
)

__all__ = [
    "VaeDpLoss",
    "amsgrad",
    "cma_chunked_frame",
    "cma_chunked_frame_plain",
    "cma_dp_kernel",
    "cma_dp_plain",
    "cma_siso_experiment",
    "cma_siso_experiment_plain",
    "dfe_decide",
    "dfe_decide_plain",
    "flatten_nn_params",
    "frame_opt_init",
    "nn_frame_opt_init",
    "nn_net",
    "siso_frame_opt_init",
    "unflatten_nn_params",
    "vae_dp_frame_eval",
    "vae_dp_frame_train",
    "vae_dp_frame_train_plain",
    "vae_dp_loss_and_grad",
    "vae_dp_loss_and_grad_plain",
    "vae_le_dp_forward_fused",
    "vae_le_dp_forward_plain",
    "vae_nn_experiment_train",
    "vae_nn_experiment_train_plain",
    "vae_siso_experiment_train",
    "vae_siso_experiment_train_plain",
    "vae_siso_loss_and_grad",
    "vae_siso_loss_and_grad_plain",
]
