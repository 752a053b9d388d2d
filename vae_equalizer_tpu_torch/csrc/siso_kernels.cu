// Kernels F and G for NVIDIA Hopper (sm_90a), behind a plain C interface
// loaded with ctypes (vae_equalizer_tpu_torch/ops/_build.py).
//
// F (vae_siso_step_kernel) replaces vae_equalizer_tpu/ops/elbo_siso_kernel.py:
//   vae_siso_loss_and_grad_pallas — one SISO minibatch: loss, gw, gh, q, out.
//   Grid = R, one block per run (the TPU kernel takes one run per call).
// G (vae_siso_experiment_kernel) replaces vae_equalizer_tpu/ops/
//   siso_frame_kernel.py: vae_siso_experiment_train_pallas(_rb) — the whole
//   AWGN VAE-LE experiment for R runs: grid = R, one block per run; a loop
//   over the E x n_batches minibatches inside the block takes the place of
//   the TPU's sequential grid, with w, h and the six AMSGrad moments resident
//   in shared memory for the whole experiment, each minibatch read straight
//   from rx in device memory (copied a step ahead) and each eval slot
//   written when its epoch ends.
//   The step count is an integer (step0 + k), so no float32 step-counter
//   limit applies.
//
// Both run the shared step body of siso_step.cuh in blocks of siso::kThreads
// (512) threads, instantiated for 8 levels (64-QAM) and for any other level
// count, each with and without the phase clocks (`clocks`, measurement
// only). Each launcher returns cudaGetLastError() so the wrapper can raise
// on a refused launch.
#include <cuda_runtime.h>

#include "siso_step.cuh"

namespace {

template <int NL, bool CLK>
__global__ void __launch_bounds__(siso::kThreads, 1)
vae_siso_step_kernel(int n_sym, int m, int n_lev, const float* x, const float* w, const float* h,
                     const float* amps, const float* P, float amp_mean, float var, float* loss,
                     float* gw, float* gh, float* q, float* out, long long* clocks) {
  extern __shared__ float smem[];
  siso::step_block<NL, CLK>(smem, threadIdx.x, blockDim.x, blockIdx.x, n_sym, m, n_lev, x, w, h,
                            amps, P, amp_mean, var, loss, gw, gh, q, out, clocks);
}

template <int NL, bool CLK>
__global__ void __launch_bounds__(siso::kThreads, 1)
vae_siso_experiment_kernel(int R, int n_epochs, int n_batches, int n_sym, int m, int n_lev,
                           long long n_total, int epe, int n_evals, const float* rx,
                           const float* w_in, const float* h_in, const float* mw_in,
                           const float* vw_in, const float* xw_in, const float* mh_in,
                           const float* vh_in, const float* xh_in, float* w_out, float* h_out,
                           float* mw_out, float* vw_out, float* xw_out, float* mh_out,
                           float* vh_out, float* xh_out, float* losses, float* w_ev, float* h_ev,
                           const float* amps, const float* P, float amp_mean, float var, float lr,
                           long long step0, long long* clocks) {
  extern __shared__ float smem[];
  siso::experiment_block<NL, CLK>(smem, threadIdx.x, blockDim.x, blockIdx.x, R, n_epochs,
                                  n_batches, n_sym, m, n_lev, n_total, epe, n_evals, rx, w_in,
                                  h_in, mw_in, vw_in, xw_in, mh_in, vh_in, xh_in, w_out, h_out,
                                  mw_out, vw_out, xw_out, mh_out, vh_out, xh_out, losses, w_ev,
                                  h_ev, amps, P, amp_mean, var, lr, step0, clocks);
}

// The instance for n_lev (8 levels, 64-QAM, unrolled; any other count up to
// MAX_LEV through the generic one) and the clocks.
decltype(&vae_siso_step_kernel<0, false>) step_kernel(int n_lev, bool clk) {
  if (n_lev == 8) return clk ? vae_siso_step_kernel<8, true> : vae_siso_step_kernel<8, false>;
  return clk ? vae_siso_step_kernel<0, true> : vae_siso_step_kernel<0, false>;
}
decltype(&vae_siso_experiment_kernel<0, false>) experiment_kernel(int n_lev, bool clk) {
  if (n_lev == 8) return clk ? vae_siso_experiment_kernel<8, true> : vae_siso_experiment_kernel<8, false>;
  return clk ? vae_siso_experiment_kernel<0, true> : vae_siso_experiment_kernel<0, false>;
}

// Dynamic shared memory for one block, with the opt-in above 48 KB.
template <typename K>
cudaError_t prepare(K kernel, int n_sym, int m, int n_lev, size_t* bytes) {
  if (n_lev < 1 || n_lev > siso::MAX_LEV || m % 2 != 1 || 2 * n_sym <= m) return cudaErrorInvalidValue;
  const siso::Layout L = siso::make_layout(siso::make_dims(n_sym, m, n_lev));
  *bytes = sizeof(float) * (size_t)L.total;
  if (*bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int vae_siso_step_launch(int R, int n_sym, int m, int n_lev, const float* x, const float* w,
                         const float* h, const float* amps, const float* P, float amp_mean,
                         float var, float* loss, float* gw, float* gh, float* q, float* out,
                         long long* clocks, void* stream) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const auto kernel = step_kernel(n_lev, clocks != nullptr);
  cudaError_t err = prepare(kernel, n_sym, m, n_lev, &bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, siso::kThreads, bytes, (cudaStream_t)stream>>>(n_sym, m, n_lev, x, w, h, amps, P,
                                                             amp_mean, var, loss, gw, gh, q, out,
                                                             clocks);
  return (int)cudaGetLastError();
}

int vae_siso_experiment_launch(int R, int n_epochs, int n_batches, int n_sym, int m, int n_lev,
                               long long n_total, int epe, int n_evals, const float* rx,
                               const float* w_in, const float* h_in, const float* mw_in,
                               const float* vw_in, const float* xw_in, const float* mh_in,
                               const float* vh_in, const float* xh_in, float* w_out,
                               float* h_out, float* mw_out, float* vw_out, float* xw_out,
                               float* mh_out, float* vh_out, float* xh_out, float* losses,
                               float* w_ev, float* h_ev, const float* amps, const float* P,
                               float amp_mean, float var, float lr, long long step0,
                               long long* clocks, void* stream) {
  if (R < 1 || n_epochs < 1 || n_batches < 1 || epe < 1 ||
      n_total < (long long)n_batches * 2 * n_sym)
    return (int)cudaErrorInvalidValue;
  size_t bytes = 0;
  const auto kernel = experiment_kernel(n_lev, clocks != nullptr);
  cudaError_t err = prepare(kernel, n_sym, m, n_lev, &bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, siso::kThreads, bytes, (cudaStream_t)stream>>>(
      R, n_epochs, n_batches, n_sym, m, n_lev, n_total, epe, n_evals, rx, w_in, h_in, mw_in, vw_in,
      xw_in, mh_in, vh_in, xh_in, w_out, h_out, mw_out, vw_out, xw_out, mh_out, vh_out, xh_out,
      losses, w_ev, h_ev, amps, P, amp_mean, var, lr, step0, clocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
