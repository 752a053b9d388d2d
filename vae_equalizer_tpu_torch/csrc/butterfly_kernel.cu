// Kernel E for NVIDIA Hopper (sm_90a): the DP VAE-LE inference pass, the 2x2
// butterfly strided FIR fused with the PCS softmin demapper, behind a plain C
// interface loaded with ctypes (vae_equalizer_tpu_torch/ops/_build.py).
//
// Replaces vae_equalizer_tpu/ops/butterfly_kernel.py:
// vae_le_dp_forward_pallas (pallas_call at :135). The plain PyTorch version
// is vae_equalizer_tpu_torch/models/vae_le.py: vae_le_dp_forward.
//
// One thread per output symbol n: it computes the four butterfly outputs
// (x_I, x_Q, y_I, y_Q), each a sum over 4 input rows x M taps at stride sps
// (the I output reads (x_I^x, x_I^y, -x_Q^x, -x_Q^y), the Q output (x_Q^x,
// x_Q^y, x_I^x, x_I^y), zero outside [0, L)), then the four softmin
// demappers over the levels: metric (o - a)^2 / (2 var_pol) + nu_sc a^2,
// q = exp(min - metric) / sum (max-subtraction), in float32 op for op like
// the plain version (--fmad=false). The taps and levels sit in shared memory.
// The TPU design (polyphase de-interleave on the host side, one (8, 8) matmul
// per tap on zero-padded tiles) answered Mosaic's constraints and is not
// carried over.
//
// Bound: a 2,012-symbol block moves ~0.33 MB (x in, q and out out) and does
// ~2 MFLOP, well under a microsecond on the card either way; a launch costs
// more, so the call is bound by its launch latency.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLev = 16;

__global__ void __launch_bounds__(kThreads)
butterfly_demap_kernel(int n_out, int m, int sps, int n_lev, int l_in, const float* __restrict__ w,
                       const float* __restrict__ x, const float* __restrict__ amps,
                       const float* __restrict__ var, float nu_sc, float* __restrict__ q,
                       float* __restrict__ out) {
  extern __shared__ float sh[];  // w (2, 4, m), then amps (n_lev)
  float* ws = sh;
  float* as = sh + 8 * m;
  for (int i = threadIdx.x; i < 8 * m; i += blockDim.x) ws[i] = w[i];
  for (int l = threadIdx.x; l < n_lev; l += blockDim.x) as[l] = amps[l];
  __syncthreads();
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_out) return;

  const int pad = m / 2;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // (pol o, comp): o * 2 + comp
  for (int k = 0; k < m; ++k) {
    const int smp = n * sps + k - pad;
    if (smp < 0 || smp >= l_in) continue;
    const float xi0 = x[smp], xq0 = x[l_in + smp], xi1 = x[2 * l_in + smp], xq1 = x[3 * l_in + smp];
    for (int o = 0; o < 2; ++o) {
      const float* wo = ws + o * 4 * m + k;
      acc[2 * o] += wo[0] * xi0 + wo[m] * xi1 + wo[2 * m] * -xq0 + wo[3 * m] * -xq1;
      acc[2 * o + 1] += wo[0] * xq0 + wo[m] * xq1 + wo[2 * m] * xi0 + wo[3 * m] * xi1;
    }
  }
  for (int r = 0; r < 4; ++r) {
    const int o = r >> 1;
    const float ov = acc[r];
    out[r * n_out + n] = ov;
    const float tv = 2.f * var[o];
    float met[kMaxLev];
    float mn = 0.f;
    for (int l = 0; l < n_lev; ++l) {
      const float d = ov - as[l];
      met[l] = d * d / tv + nu_sc * (as[l] * as[l]);
      mn = l == 0 ? met[0] : fminf(mn, met[l]);
    }
    float sum = 0.f;
    for (int l = 0; l < n_lev; ++l) {
      met[l] = expf(mn - met[l]);
      sum += met[l];
    }
    // q (2 pol, 2 n_lev, N): row o * 2 n_lev + comp * n_lev + l
    float* qr = q + (long long)(r * n_lev) * n_out + n;
    for (int l = 0; l < n_lev; ++l) qr[(long long)l * n_out] = met[l] / sum;
  }
}

}  // namespace

extern "C" {

// w (2, 4, m); x (2, 2, l_in); amps (n_lev); var (2); q (2, 2 n_lev, n_out);
// out (2, 2, n_out). Returns cudaGetLastError().
int butterfly_demap_launch(int n_out, int m, int sps, int n_lev, int l_in, const float* w,
                           const float* x, const float* amps, const float* var, float nu_sc, float* q,
                           float* out, void* stream) {
  if (n_out < 1 || m < 1 || sps < 1 || n_lev < 1 || n_lev > kMaxLev || l_in < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (size_t)(8 * m + n_lev);
  const int blocks = (n_out + kThreads - 1) / kThreads;
  butterfly_demap_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      n_out, m, sps, n_lev, l_in, w, x, amps, var, nu_sc, q, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
