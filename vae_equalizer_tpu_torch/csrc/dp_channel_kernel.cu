// Kernel L for NVIDIA Hopper (sm_90a), behind a plain C interface loaded with
// ctypes (vae_equalizer_tpu_torch/ops/_build.py, library "channel"): the DP
// channel's level draw, FFT input, 2x2 response and noise pass around cuFFT
// (ops/channel_kernel.py), one thread an element (L1, L2), a frequency bin and
// up to ch::kMixRuns runs (L3), or a window sample of one pol (L4). The bodies
// and the note on what bounds them are in dp_channel_step.cuh. Each launcher
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
#include <cuda_runtime.h>

#include "dp_channel_step.cuh"

namespace {

unsigned blocks(long long n) { return (unsigned)((n + ch::kThreads - 1) / ch::kThreads); }

__global__ void __launch_bounds__(ch::kThreads)
levels_kernel(long long n, long long per_run, int n_lev, const float* __restrict__ u, float amp0,
              const float* __restrict__ steps, const float* __restrict__ edges, long long e_run,
              float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * ch::kThreads + threadIdx.x;
  if (i < n) ch::level(i, per_run, n_lev, u, amp0, steps, edges, e_run, out);
}

__global__ void __launch_bounds__(ch::kThreads)
fft_input_kernel(long long n, int n_conv, int sps, int up_len, int fft_len,
                 const float* __restrict__ levels, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * ch::kThreads + threadIdx.x;
  if (i < n) ch::fft_input(i, n_conv, sps, up_len, fft_len, levels, out);
}

template <bool F>
__global__ void __launch_bounds__(ch::kThreads)
mix_kernel(int R, int fft_len, const float* __restrict__ theta, ch::cf e0, ch::cf e1,
           const float* __restrict__ d0, const float* __restrict__ d1,
           const float* __restrict__ cd, float* z) {
  const int k = blockIdx.x * ch::kThreads + threadIdx.x;
  if (k >= fft_len) return;
  const float th = *theta;
  const ch::H h = ch::response<F>(cosf(th), sinf(th), e0, e1, ch::ld(d0 + 2 * k), ch::ld(d1 + 2 * k));
  const int r0 = blockIdx.y * ch::kMixRuns, r1 = r0 + ch::kMixRuns < R ? r0 + ch::kMixRuns : R;
  ch::mix<F>(k, r0, r1, fft_len, h, ch::ld(cd + 2 * k), z);
}

__global__ void __launch_bounds__(ch::kThreads)
power_kernel(ch::Window w, double* __restrict__ partial) {
  __shared__ double s[ch::kThreads];
  const int g = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  s[tid] = ch::power_partial(w, r, g, tid);
  __syncthreads();
  for (int width = ch::kThreads / 2; width > 0; width /= 2) {
    ch::tree_step(s, width, tid);
    __syncthreads();
  }
  if (tid == 0) partial[r * ch::kPowerBlocks + g] = s[0];
}

__global__ void __launch_bounds__(ch::kThreads)
noise_kernel(ch::Window w, int n_rx, const double* __restrict__ partial, double inv_n, int sps,
             float snr, const float* __restrict__ snr_runs, int recip,
             const float* __restrict__ noise, float* __restrict__ rx, float* __restrict__ sigma) {
  const int t = blockIdx.x * ch::kThreads + threadIdx.x, p = blockIdx.y, r = blockIdx.z;
  const float sig = ch::sigma(partial, r, inv_n, sps, snr, snr_runs, recip);
  if (blockIdx.x == 0 && p == 0 && threadIdx.x == 0) sigma[r] = sig;
  if (t < n_rx) ch::add_noise(w, r, p, t, n_rx, sig, noise, rx);
}

}  // namespace

extern "C" {

// L1: R, per_run, n_lev, u (R, per_run), amps[0], steps (n_lev - 1), edges
// (n_lev, or R x n_lev at e_run), e_run, out (R, per_run), stream
int dp_levels_launch(int R, long long per_run, int n_lev, const float* u, float amp0,
                     const float* steps, const float* edges, long long e_run, float* out,
                     void* stream) {
  if (R < 1 || per_run < 1 || n_lev < 2 || n_lev > ch::kMaxLev || e_run < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * per_run;
  levels_kernel<<<blocks(n), ch::kThreads, 0, (cudaStream_t)stream>>>(n, per_run, n_lev, u, amp0,
                                                                      steps, edges, e_run, out);
  return (int)cudaGetLastError();
}

// L2: R, n_conv, sps, up_len, fft_len, levels (R, 4, n_conv), out (R, 2,
// fft_len) complex, stream
int dp_fft_input_launch(int R, int n_conv, int sps, int up_len, int fft_len, const float* levels,
                        float* out, void* stream) {
  if (R < 1 || sps < 1 || up_len < 1 || up_len > sps * (n_conv - 1) + 1 || fft_len < up_len)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)R * 2 * fft_len;
  fft_input_kernel<<<blocks(n), ch::kThreads, 0, (cudaStream_t)stream>>>(n, n_conv, sps, up_len,
                                                                        fft_len, levels, out);
  return (int)cudaGetLastError();
}

// L3: R, fft_len, theta (one float32), e0, e1 (re, im), d0, d1, cd (fft_len)
// complex, z (R, 2, fft_len) complex in place, fused (ch::cmul), stream
int dp_mix_launch(int R, int fft_len, const float* theta, float e0r, float e0i, float e1r,
                  float e1i, const float* d0, const float* d1, const float* cd, float* z, int fused,
                  void* stream) {
  if (R < 1 || fft_len < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(blocks(fft_len), (R + ch::kMixRuns - 1) / ch::kMixRuns);
  const ch::cf e0{e0r, e0i}, e1{e1r, e1i};
  auto* kernel = fused ? mix_kernel<true> : mix_kernel<false>;
  kernel<<<grid, ch::kThreads, 0, (cudaStream_t)stream>>>(R, fft_len, theta, e0, e1, d0, d1, cd, z);
  return (int)cudaGetLastError();
}

// L4 (two launches): R, fft_len, start, sig_len, n_rx, scale, z (R, 2,
// fft_len) complex, partial (R, kPowerBlocks) float64 scratch, inv_n, sps,
// snr, snr_runs (R, or null), recip, noise (R, 2, 2, sig_len), rx (R, 2, 2,
// n_rx), sigma (R), stream
int dp_noise_launch(int R, int fft_len, int start, int sig_len, int n_rx, float scale,
                    const float* z, double* partial, double inv_n, int sps, float snr,
                    const float* snr_runs, int recip, const float* noise, float* rx, float* sigma,
                    void* stream) {
  if (R < 1 || R > 65535 || sig_len < 1 || start < 0 || start + sig_len > fft_len || n_rx < 1 ||
      n_rx > sig_len)
    return (int)cudaErrorInvalidValue;
  const ch::Window w{z, fft_len, start, sig_len, scale};
  power_kernel<<<dim3(ch::kPowerBlocks, R), ch::kThreads, 0, (cudaStream_t)stream>>>(w, partial);
  noise_kernel<<<dim3(blocks(n_rx), 2, R), ch::kThreads, 0, (cudaStream_t)stream>>>(
      w, n_rx, partial, inv_n, sps, snr, snr_runs, recip, noise, rx, sigma);
  return (int)cudaGetLastError();
}

}  // extern "C"
