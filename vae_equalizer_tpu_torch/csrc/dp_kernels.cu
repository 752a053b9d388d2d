// Kernels A and B for NVIDIA Hopper (sm_90a), behind a plain C interface
// loaded with ctypes (vae_equalizer_tpu_torch/ops/_build.py).
//
// A (vae_dp_step_kernel) replaces vae_equalizer_tpu/ops/elbo_kernel.py:
//   vae_dp_loss_and_grad_pallas — one DP minibatch: loss, var_est, gw, gh,
//   q, out — for R runs in one launch: grid = R, one block per run (the JAX
//   package vmaps one pallas_call per run). Each run's minibatch is read in
//   place from its frame row (run stride, row stride), so the per-step loop
//   slices no copy.
// B (vae_dp_frame_kernel) replaces vae_equalizer_tpu/ops/frame_kernel.py:
//   vae_dp_frame_train_pallas_rb — one frame of online training for R runs:
//   grid = R, one block per run; a loop over the m_max minibatches inside
//   the block takes the place of the TPU's sequential grid, with w, h and
//   the four Adam moments resident in shared memory for the whole frame and
//   each minibatch read straight from rx in device memory, window mb at
//   symbol mb * stride_sym (VAEflex: overlapping windows). Each run reads
//   its own lr, demapper variance, nu_sc and prior P (the sweep's lr / SNR /
//   nu axes batched as runs). The out / dec / eq streams are float32 / int32,
//   or bfloat16 with stream_bf16. The step count is an integer (step0 + mb),
//   so no float32 step-counter limit applies. step0 is read from device
//   memory (one int64), so a launch captured in a CUDA graph trains each
//   replay's frame at the step that the replayed graph has advanced it to.
//
// Both run the shared step body of dp_step.cuh (its notes say what bounds a
// step and how the design answers it), 512 threads per block, in one of two
// instances picked by n_lev: 8 levels (64-QAM), or any n_lev up to MAX_LEV
// (the same arithmetic, so the same bits). B also takes
// `clocks` (N_PHASES int64, or null): block 0's clock64() cycles per phase,
// summed over the frame, for measurement. Each launcher returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
#include <cuda_runtime.h>

#include <type_traits>

#include "dp_step.cuh"

namespace {

// 16 warps per run: every phase of the flagship step (at most ~400 items)
// fits in one pass.
constexpr int kThreads = 512;

template <int NL>
__global__ void __launch_bounds__(kThreads)
vae_dp_step_kernel(const float* x, long long x_run, long long x_row, const float* w,
                   const float* h, const float* amps, const float* P, const float* var,
                   float nu_sc, int n_sym, int m, int n_lev, float* stats, float* gw, float* gh,
                   float* q, float* out) {
  extern __shared__ __align__(16) float smem[];
  const long long r = blockIdx.x, np = 8 * m;
  dp::step_block<NL>(smem, threadIdx.x, blockDim.x, x + r * x_run, x_row, w + r * np, h + r * np,
                 amps, P, var, nu_sc, n_sym, m, n_lev, stats + r * 3, gw + r * np, gh + r * np,
                 q + r * 4 * n_lev * n_sym, out + r * 4 * n_sym);
}

// out / dec / eq as float / int32, or all three as bfloat16 (stream_bf16).
template <bool BF16, int NL>
__global__ void __launch_bounds__(kThreads)
vae_dp_frame_kernel(int R, int m_max, int n_sym, int stride_sym, int m, int n_lev,
                    long long n_total, const float* rx, const float* w_in, const float* h_in,
                    const float* mw_in, const float* vw_in, const float* mh_in,
                    const float* vh_in, float* w_out, float* h_out, float* mw_out,
                    float* vw_out, float* mh_out, float* vh_out, float* losses, float* var_est,
                    void* out, void* dec, void* eq, float* mm, float* s1, const float* amps,
                    const float* P, const float* var, const float* nu_sc, const float* lr,
                    const long long* step0, double lr_half_step, long long* clocks) {
  using SF = typename std::conditional<BF16, dp::bf16, float>::type;
  using SD = typename std::conditional<BF16, dp::bf16, int>::type;
  extern __shared__ __align__(16) float smem[];
  dp::frame_block<NL, SF, SD>(smem, threadIdx.x, blockDim.x, blockIdx.x, R, m_max, n_sym, stride_sym,
                              m, n_lev, n_total, rx, w_in, h_in, mw_in, vw_in, mh_in, vh_in,
                              w_out, h_out, mw_out, vw_out, mh_out, vh_out, losses, var_est,
                              static_cast<SF*>(out), static_cast<SD*>(dec), static_cast<SF*>(eq),
                              mm, s1, amps, P, var, nu_sc, lr, *step0, lr_half_step, clocks);
}

// Dynamic shared memory for one block, with the opt-in above 48 KB.
template <typename K>
cudaError_t prepare(K kernel, int n_sym, int m, int n_lev, size_t* bytes) {
  if (n_lev < 1 || n_lev > dp::MAX_LEV || m % 2 != 1 || 2 * n_sym <= m)
    return cudaErrorInvalidValue;
  const dp::Layout L = dp::make_layout(dp::make_dims(n_sym, m, n_lev), kThreads);
  *bytes = sizeof(float) * (size_t)L.total;
  if (*bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
  return cudaSuccess;
}

}  // namespace

extern "C" {

int vae_dp_step_launch(int R, const float* x, long long x_run, long long x_row, const float* w,
                       const float* h, const float* amps, const float* P, const float* var,
                       float nu_sc, int n_sym, int m, int n_lev, float* stats, float* gw,
                       float* gh, float* q, float* out, void* stream) {
  if (R < 1 || x_run < 0 || x_row < 2 * n_sym) return (int)cudaErrorInvalidValue;
  auto kernel = n_lev == 8 ? vae_dp_step_kernel<8> : vae_dp_step_kernel<0>;
  size_t bytes = 0;
  cudaError_t err = prepare(kernel, n_sym, m, n_lev, &bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, bytes, (cudaStream_t)stream>>>(
      x, x_run, x_row, w, h, amps, P, var, nu_sc, n_sym, m, n_lev, stats, gw, gh, q, out);
  return (int)cudaGetLastError();
}

int vae_dp_frame_launch(int R, int m_max, int n_sym, int stride_sym, int m, int n_lev,
                        long long n_total, const float* rx, const float* w_in,
                        const float* h_in, const float* mw_in, const float* vw_in,
                        const float* mh_in, const float* vh_in, float* w_out, float* h_out,
                        float* mw_out, float* vw_out, float* mh_out, float* vh_out,
                        float* losses, float* var_est, void* out, void* dec, void* eq, float* mm,
                        float* s1, const float* amps, const float* P, const float* var,
                        const float* nu_sc, const float* lr, const long long* step0,
                        double lr_half_step, int stream_bf16, long long* clocks, void* stream) {
  // the last window, samples [2 stride_sym (m_max - 1), + 2 n_sym), must lie in the row
  if (R < 1 || m_max < 1 || stride_sym < 1 ||
      n_total < 2 * ((long long)stride_sym * (m_max - 1) + n_sym))
    return (int)cudaErrorInvalidValue;
  auto kernel = stream_bf16 ? (n_lev == 8 ? vae_dp_frame_kernel<true, 8> : vae_dp_frame_kernel<true, 0>)
                            : (n_lev == 8 ? vae_dp_frame_kernel<false, 8> : vae_dp_frame_kernel<false, 0>);
  size_t bytes = 0;
  cudaError_t err = prepare(kernel, n_sym, m, n_lev, &bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, kThreads, bytes, (cudaStream_t)stream>>>(
      R, m_max, n_sym, stride_sym, m, n_lev, n_total, rx, w_in, h_in, mw_in, vw_in, mh_in, vh_in,
      w_out, h_out, mw_out, vw_out, mh_out, vh_out, losses, var_est, out, dec, eq, mm, s1, amps, P,
      var, nu_sc, lr, step0, lr_half_step, clocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
