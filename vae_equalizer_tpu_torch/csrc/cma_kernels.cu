// Kernels C, D and I for NVIDIA Hopper (sm_90a): the CMA family's 2x2
// butterfly equalizers and the SISO CMA experiment, behind a plain C
// interface loaded with ctypes (vae_equalizer_tpu_torch/ops/_build.py). The
// block bodies are in cma_step.cuh.
//
// C (cma_dp_kernel) replaces vae_equalizer_tpu/ops/cma_kernel.py:
//   cma_dp_pallas — the per-symbol CMA recurrence over a whole frame, for R
//   runs. One warp per run, the taps in registers (TPL per lane: 1 for
//   M <= 32, 2 up to 64), the next window read through L1 a symbol ahead.
//   Bound by the latency of the dependent per-symbol chain (~10^4 symbols a
//   frame: the lane partials, a 32-lane butterfly of 4 trees, the errors,
//   the tap updates), not by bytes or FLOPs; R runs fill R SMs.
//
// D (cma_chunked_kernel) replaces vae_equalizer_tpu/ops/cma_frame_kernel.py:
//   cma_chunked_frame_pallas(_rb) — the CMAbatch / CMAflex chunk engine over
//   the whole frame (prefix, every chunk, tail) for R runs, one 512-thread
//   block per run, the taps, the ring of B/S per-chunk partial sums, the
//   chunk's outputs and its window span resident in shared memory. Bound by
//   the chain of 3 barrier-separated phases per chunk (~10^3 chunks a frame),
//   each at the instruction rate of one SM.
//
// I (cma_siso_experiment_kernel) has no TPU kernel to replace: it is the
//   JAX package's per-epoch lax.scan of models/cma.py: cma_siso, run over
//   every epoch of the AWGN CMA experiment (train/awgn.py: run_cma_awgn).
//   One warp per run, for the whole experiment (E x n_sym dependent symbol
//   steps: 2 M at the defaults), the taps in registers. Bound by that latency
//   chain (per symbol the lane partials, a butterfly of 2 trees, the error,
//   the tap updates), not by bytes or FLOPs; R runs fill R SMs.
//
// Layouts (float32, contiguous): y (R, 4, lp) rows nu*2 + c of the
// normalized, zero-padded signal; taps (R, 8, m) rows chi*4 + nu*2 + c
// (= h (R, 2, 2, 2, m)); out (R, 4, n_sym) and e (R, n_sym, 2) in the
// reference's rolled storage order. C and D read their learning rate from
// device memory (one float32; the update's 2 lr is formed in the kernel, an
// exact doubling), so a launch captured in a CUDA graph adapts each replay's
// frame at the rate the replayed graph has looked up for it. `clocks` (int64 per phase, or null): run
// 0's clock64() cycles per phase, summed over the frame (measurement only; a
// launch without it runs the body compiled without clocks). Each launcher
// returns cudaGetLastError() so the wrapper can raise on a refused launch.

#include "cma_step.cuh"

namespace {

template <bool CLK, int TPL, bool UPD>
__global__ void __launch_bounds__(32) cma_dp_kernel(cma::CArgs a, const float* lr) {
  const long long r = blockIdx.x;
  a.lr2 = 2.0f * *lr;
  a.y += r * 4 * a.lp;
  a.h_in += r * 8 * a.m;
  a.h_out += r * 8 * a.m;
  a.out += r * 4 * a.n_sym;
  a.e += r * 2 * a.n_sym;
  if (r != 0) a.clocks = nullptr;
  cma::cma_symbols_run<CLK, TPL, UPD>(threadIdx.x, a);
}

template <bool CLK, int TPL>
__global__ void __launch_bounds__(32) cma_siso_experiment_kernel(cma::IArgs a) {
  const long long r = blockIdx.x;
  a.rx += r * a.n_epochs * 2 * a.n_total;
  a.h_in += r * 2 * a.m;
  a.h_out += r * 2 * a.m;
  a.h_ev += r * 2 * a.m;
  a.loss += r * a.n_epochs;
  if (r != 0) a.clocks = nullptr;
  cma::cma_siso_run<CLK, TPL>(threadIdx.x, a);
}

template <bool CLK, int KA>
__global__ void __launch_bounds__(cma::kChunkThreads, 1) cma_chunked_kernel(cma::DArgs a,
                                                                              const float* lr) {
  extern __shared__ float4 smem_d[];
  const long long r = blockIdx.x;
  a.lr2 = 2.0f * *lr;
  a.y += r * 4 * a.lp;
  a.h_in += r * 8 * a.m;
  a.h_out += r * 8 * a.m;
  a.out += r * 4 * a.n_sym;
  a.e += r * 2 * a.n_sym;
  if (r != 0) a.clocks = nullptr;
  cma::chunked_block<CLK, KA>(reinterpret_cast<float*>(smem_d), threadIdx.x, blockDim.x, a);
}

// Dynamic shared memory above 48 KB needs the opt-in; a block that does not
// fit is refused (the error is returned, nothing falls back).
template <typename K>
cudaError_t fit_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

int cma_dp_launch(int R, int n_sym, int m, int sps, long long lp, const float* y,
                  const float* h_in, float* h_out, float* out, float* e, float big_r,
                  const float* lr, int update, long long* clocks, void* stream) {
  if (R < 1 || n_sym < 1 || m < 1 || m > cma::MAX_M || sps < 1 ||
      lp < (long long)(n_sym - 1) * sps + m)
    return (int)cudaErrorInvalidValue;
  const int mh = m / 2;
  const cma::CArgs a = {y,   lp, n_sym, m,     sps,   mh - mh / sps, h_in, h_out, out,
                        e, big_r, 0.0f, update, clocks};  // lr2 = 2 *lr, set in the kernel
  // kernels[clocks][taps per lane - 1][update]
  static void (*const kernels[2][2][2])(cma::CArgs, const float*) = {
      {{cma_dp_kernel<false, 1, false>, cma_dp_kernel<false, 1, true>},
       {cma_dp_kernel<false, 2, false>, cma_dp_kernel<false, 2, true>}},
      {{cma_dp_kernel<true, 1, false>, cma_dp_kernel<true, 1, true>},
       {cma_dp_kernel<true, 2, false>, cma_dp_kernel<true, 2, true>}}};
  kernels[clocks != nullptr][m > 32][update != 0]<<<R, 32, 0, (cudaStream_t)stream>>>(a, lr);
  return (int)cudaGetLastError();
}

int cma_chunked_launch(int R, int n_sym, int m, int sps, long long lp, int j0, int S, int n_full,
                       int n_slots, int tail, const float* y, const float* h_in, float* h_out,
                       float* out, float* e, float big_r, const float* lr, long long* clocks,
                       void* stream) {
  if (R < 1 || m < 1 || m > cma::MAX_M || sps < 1 || S < 1 || n_slots < 1 || n_full < 0 ||
      tail < 1 || tail > S || j0 < n_slots * S || n_sym != j0 + n_full * S + tail ||
      lp < (long long)(n_sym - 1) * sps + m)
    return (int)cudaErrorInvalidValue;
  const int mh = m / 2;
  const cma::DArgs a = {y,    lp,      n_sym, m,    sps,   mh - mh / sps,        j0,  S,
                        n_full, n_slots, tail, cma::d_split(m, S), h_in, h_out, out, e,
                        big_r,  0.0f,    clocks};  // lr2 = 2 *lr, set in the kernel
  const size_t bytes = sizeof(float) * (size_t)cma::d_smem_floats(m, sps, S, n_slots);
  // kernels[clocks][log2(taps per lane in A)]
  static void (*const kernels[2][4])(cma::DArgs, const float*) = {
      {cma_chunked_kernel<false, 1>, cma_chunked_kernel<false, 2>, cma_chunked_kernel<false, 4>,
       cma_chunked_kernel<false, 8>},
      {cma_chunked_kernel<true, 1>, cma_chunked_kernel<true, 2>, cma_chunked_kernel<true, 4>,
       cma_chunked_kernel<true, 8>}};
  const int ka = cma::d_taps_per_lane(m);
  auto kernel = kernels[clocks != nullptr][ka == 1 ? 0 : ka == 2 ? 1 : ka == 4 ? 2 : 3];
  cudaError_t err = fit_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<R, cma::kChunkThreads, bytes, (cudaStream_t)stream>>>(a, lr);
  return (int)cudaGetLastError();
}

// rx (R, E, 2, n_total) every epoch's frame; h_in / h_out (R, 2, m); h_ev
// (n_evals, R, 2, m) the taps after epoch i*epe; loss (R, E) each epoch's
// mean |e|.
int cma_siso_experiment_launch(int R, int n_epochs, int m, int sps, long long n_total, int epe,
                               int n_evals, const float* rx, const float* h_in, float* h_out,
                               float* h_ev, float* loss, float big_r, float lr2,
                               long long* clocks, void* stream) {
  const long long n_sym = n_total / sps;
  if (R < 1 || n_epochs < 1 || m < 1 || m > cma::MAX_M || sps < 1 || n_sym < 1 ||
      n_sym > 0x7fffffff || epe < 1 || n_evals < 0 || n_evals > n_epochs / epe)
    return (int)cudaErrorInvalidValue;
  const cma::IArgs a = {rx,    n_total, n_epochs, (int)n_sym, m,    sps,   m / 2,
                        epe,   n_evals, (long long)R * 2 * m, h_in, h_out, h_ev,
                        loss, big_r, lr2, clocks};
  // kernels[clocks][taps per lane - 1]
  static void (*const kernels[2][2])(cma::IArgs) = {
      {cma_siso_experiment_kernel<false, 1>, cma_siso_experiment_kernel<false, 2>},
      {cma_siso_experiment_kernel<true, 1>, cma_siso_experiment_kernel<true, 2>}};
  kernels[clocks != nullptr][m > 32]<<<R, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
