// Kernel H for NVIDIA Hopper (sm_90a), behind a plain C interface loaded with
// ctypes (vae_equalizer_tpu_torch/ops/_build.py).
//
// H (vae_nn_experiment_kernel) replaces vae_equalizer_tpu/ops/
//   nn_frame_kernel.py: vae_nn_experiment_train_pallas — the whole AWGN
//   VAE-NN experiment (Net or Net_BN) for R runs: grid = R, one 512-thread
//   block per run; a loop over the E x n_batches minibatches inside the block
//   takes the place of the TPU's sequential grid (the JAX package vmaps R
//   runs over the kernel call), with the parameters, their AMSGrad moments
//   and one minibatch's activations resident in shared memory, each
//   minibatch read straight from rx in device memory and each eval slot
//   written when its epoch ends. The step body is nn_step.cuh.
//
// The launcher returns cudaGetLastError() so the wrapper can raise on a
// refused launch.
#include <cuda_runtime.h>

#include "nn_step.cuh"

namespace {

__global__ void __launch_bounds__(nn::kBlock) vae_nn_experiment_kernel(nn::Args args) {
  extern __shared__ float smem[];
  nn::experiment_block(smem, threadIdx.x, blockDim.x, blockIdx.x, args);
}

}  // namespace

extern "C" {

// ptrs: the pointer table of nn::make_args (ops/nn_frame_kernel.py: _launch
// builds it); clocks: nn::N_PHASES int64 phase cycles of block 0, or null.
int vae_nn_experiment_launch(int R, int n_epochs, int n_batches, int n_sym, int m, int n_lev, int k1,
                             long long n_total, int epe, int n_evals, int batchnorm,
                             void* const* ptrs, float lr, float momentum, long long step0,
                             long long* clocks, void* stream) {
  nn::Args a;
  if (!nn::make_args(&a, R, n_epochs, n_batches, n_sym, m, n_lev, k1, n_total, epe, n_evals,
                     batchnorm, ptrs, lr, momentum, step0, clocks))
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (size_t)nn::smem_floats(n_sym, m, n_lev, k1, batchnorm != 0);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(vae_nn_experiment_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  vae_nn_experiment_kernel<<<R, nn::kBlock, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
