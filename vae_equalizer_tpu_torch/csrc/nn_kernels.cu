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

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads) vae_nn_experiment_kernel(nn::Args args) {
  extern __shared__ float smem[];
  nn::experiment_block(smem, threadIdx.x, blockDim.x, blockIdx.x, args);
}

}  // namespace

extern "C" {

// ptrs: rx, the N_STATE inputs, the N_STATE outputs, losses, the N_EVAL eval
// slot arrays, amps (ops/nn_frame_kernel.py: _launch builds the table).
int vae_nn_experiment_launch(int R, int n_epochs, int n_batches, int n_sym, int m, int n_lev, int k1,
                             long long n_total, int epe, int n_evals, int batchnorm,
                             void* const* ptrs, float lr, float momentum, long long step0,
                             void* stream) {
  if (R < 1 || n_epochs < 1 || n_batches < 1 || epe < 1 || n_lev < 1 ||
      n_lev > siso::MAX_LEV || m % 2 != 1 || 2 * n_sym <= m || k1 < 1 ||
      n_total < (long long)n_batches * 2 * n_sym)
    return (int)cudaErrorInvalidValue;
  nn::Args a;
  a.R = R;
  a.n_epochs = n_epochs;
  a.n_batches = n_batches;
  a.n_sym = n_sym;
  a.m = m;
  a.n_lev = n_lev;
  a.k1 = k1;
  a.epe = epe;
  a.n_evals = n_evals;
  a.batchnorm = batchnorm;
  a.n_total = n_total;
  a.step0 = step0;
  a.lr = lr;
  a.momentum = momentum;
  int p = 0;
  a.rx = (const float*)ptrs[p++];
  for (int i = 0; i < nn::N_STATE; ++i) a.in[i] = (const float*)ptrs[p++];
  for (int i = 0; i < nn::N_STATE; ++i) a.out[i] = (float*)ptrs[p++];
  a.losses = (float*)ptrs[p++];
  for (int i = 0; i < nn::N_EVAL; ++i) a.ev[i] = (float*)ptrs[p++];
  a.amps = (const float*)ptrs[p++];

  const nn::Layout L = nn::make_layout(nn::make_dims(n_sym, m, n_lev, k1, batchnorm != 0), kThreads);
  const size_t bytes = sizeof(float) * (size_t)L.total;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(vae_nn_experiment_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  vae_nn_experiment_kernel<<<R, kThreads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
