// Kernel E for NVIDIA Hopper (sm_90a): the DP VAE-LE inference pass, the 2x2
// butterfly strided FIR fused with the PCS softmin demapper, behind a plain C
// interface loaded with ctypes (vae_equalizer_tpu_torch/ops/_build.py).
//
// Replaces vae_equalizer_tpu/ops/butterfly_kernel.py:
// vae_le_dp_forward_pallas (pallas_call at :135). The plain PyTorch version
// is vae_equalizer_tpu_torch/models/vae_le.py: vae_le_dp_forward.
//
// Each of the four butterfly outputs (x_I, x_Q, y_I, y_Q) of symbol n is a
// sum over 4 input rows x M taps at stride sps (the I output reads (x_I^x,
// x_I^y, -x_Q^x, -x_Q^y), the Q output (x_Q^x, x_Q^y, x_I^x, x_I^y), zero
// outside [0, L)), followed by its softmin demapper over the levels: metric
// (o - a)^2 / (2 var_pol) + nu_sc a^2, q = exp(min - metric) / sum.
//
// What bounds it: a 2,012-symbol streaming pass moves ~0.33 MB and does ~2
// MFLOP, well under a microsecond on the card either way, so its floor is a
// launch. Measured per phase with clock64() (the launcher's `clocks`,
// PERF.md §6), the first design (one thread per symbol, 8 blocks of 256)
// spent 35k cycles in one thread: 60 % in the normalization, whose IEEE
// divisions of tiny posteriors took the division's software path, and 22 %
// in a FIR of 100 guarded global loads. So:
//   * One thread per (output, symbol): a block holds kSym = 32 symbols, its
//     warp r the output r of each, so the pass spreads over 63 blocks for
//     2,012 symbols, and each thread's chain is one output and its demapper
//     (16 or 64 symbols a block measured slower).
//   * The block's taps, levels and input window are staged into shared
//     memory by cp.async, all copies in flight at once; the window is
//     zero-padded and split by phase (sample s0 + i sps + p at plane p,
//     index i), so the tap loop has no branch and a warp reads consecutive
//     words. The I output's -x_Q terms multiply the product by -1 (exact),
//     so the four outputs run one loop.
//   * The level count and sps are template parameters (8 or 16 levels, sps
//     2, or generic instances: up to kMaxLev levels, the ones past n_lev
//     predicated off, and any sps), so the level arrays live in registers
//     and the sps-2 tap loop unrolls.
//   * Divisions without a software path: the metric's division by 2 var is
//     Markstein's float correction of x * RN(1 / (2 var)), the normalization
//     a double multiply by an accurate reciprocal of the sum (fdiv); both
//     give the IEEE quotient (csrc/siso_step.cuh holds the argument and
//     tests/test_torch_siso_step_emulation.py the check on 10^7 pairs), so
//     no level waits on a branch.
// No sum is split over lanes: each output's 100-term sum runs in one
// thread in the first design's order (tap by tap, the four rows left to
// right), the minimum is exact in any order, and the level sum is one
// thread's chain in level order. So the pass gives the first design's bits,
// and the plain comparison on the card is its check (no host emulation).
// The TPU design (polyphase de-interleave on the host side, one (8, 8)
// matmul per tap on zero-padded tiles) answered Mosaic's constraints and is
// not carried over. The library is built with --fmad=false (ops/_build.py),
// so products and sums round as the plain version's do.
#include <cuda_runtime.h>

namespace {

constexpr int kSym = 32;            // symbols per block
constexpr int kThreads = 4 * kSym;  // one thread per (output, symbol)
constexpr int kMaxLev = 16;         // up to 256-QAM (16 levels per dimension)
// phases of block 0's thread 0, in the order of ops/butterfly_kernel.py: CLOCK_PHASES
enum Phase { PH_STAGE, PH_FIR, PH_METRIC, PH_EXP, PH_NORM, N_PHASES };

// 1 / b in double to within ~2 ulps, without a branch: the approximate
// reciprocal and two Newton steps (csrc/siso_step.cuh: recip).
__device__ __forceinline__ double recip(double b) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(b));
  y = __fma_rn(y, __fma_rn(-b, y, 1.0), y);
  return __fma_rn(y, __fma_rn(-b, y, 1.0), y);
}

// a / b as the IEEE float, with y within a few double ulps of 1 / b
// (csrc/siso_step.cuh: fdiv).
__device__ __forceinline__ float fdiv(float a, double y) { return (float)((double)a * y); }

// One float from device to shared memory, in flight until copy_wait; a
// zero where !valid (src is then not read).
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// NL: the level count, or 0 for the generic instance (n_lev <= kMaxLev).
// SPS: the samples per symbol, or 0 for the generic instance.
// CLK: block 0's thread 0 adds its clock64() cycles per phase into clocks.
template <int NL, int SPS, bool CLK>
__global__ void __launch_bounds__(kThreads)
butterfly_demap_kernel(int n_out, int m, int sps_rt, int n_lev_rt, int l_in,
                       const float* __restrict__ w, const float* __restrict__ x,
                       const float* __restrict__ amps, const float* __restrict__ var, float nu_sc,
                       float* __restrict__ q, float* __restrict__ out, long long* clocks) {
  constexpr int NA = NL ? NL : kMaxLev;
  const int n_lev = NL ? NL : n_lev_rt, sps = SPS ? SPS : sps_rt;
  const int tid = threadIdx.x, r = tid / kSym, j = tid % kSym;
  const bool ck = CLK && blockIdx.x == 0 && tid == 0;
  long long c[N_PHASES] = {0, 0, 0, 0, 0}, t = 0;
  if (ck) t = clock64();
#define E_MARK(ph)                     \
  if (ck) {                            \
    const long long now = clock64();   \
    c[ph] += now - t;                  \
    t = now;                           \
  }

  // ---- stage, all copies in flight at once: the taps (2, 4, m), the levels,
  // and the block's input window as 4 rows x sps phases of wp samples, zero
  // outside [0, l_in)
  extern __shared__ __align__(16) float sh[];
  const int wp = kSym + (m - 1) / sps, win = sps * wp;
  float* ws = sh;
  float* as = ws + 8 * m;
  float* xs = as + NA;
  const int n0 = blockIdx.x * kSym;
  const long long s0 = (long long)n0 * sps - m / 2;  // the window's first sample
  for (int pl = tid / 32; pl < 4 * sps; pl += kThreads / 32) {  // a warp per plane
    const int row = pl / sps, ph = pl - row * sps;
    for (int i = tid % 32; i < wp; i += 32) {
      const long long smp = s0 + (long long)i * sps + ph;
      const bool in = smp >= 0 && smp < l_in;
      copy_async(xs + pl * wp + i, x + (in ? (long long)row * l_in + smp : 0), in);
    }
  }
  for (int i = tid; i < 8 * m; i += kThreads) copy_async(ws + i, w + i, true);
  for (int l = tid; l < NA; l += kThreads) copy_async(as + l, amps + (l < n_lev ? l : 0), l < n_lev);
  const int o = r >> 1, comp = r & 1;
  const float tv = 2.f * var[o], ytv = __frcp_rn(tv);
  copy_wait();
  __syncthreads();
  E_MARK(PH_STAGE)

  // ---- FIR: output r = (pol o, comp) of symbol n0 + j, tap by tap, the rows
  // left to right: I = w0 x_I^x + w1 x_I^y + w2 (-x_Q^x) + w3 (-x_Q^y), Q =
  // w0 x_Q^x + w1 x_Q^y + w2 x_I^x + w3 x_I^y (w (-x) = -(w x), exact)
  const float* xa = xs + comp * win + j;        // x_I^x or x_Q^x
  const float* xb = xs + (comp + 2) * win + j;  // x_I^y or x_Q^y
  const float* xc = xs + (comp ^ 1) * win + j;
  const float* xd = xs + ((comp ^ 1) + 2) * win + j;
  const float* wa = ws + o * 4 * m;
  const float sg = comp ? 1.f : -1.f;
  float acc = 0.f;
  int ph = 0, kk = 0;  // tap k = kk sps + ph (generic sps)
#pragma unroll 5
  for (int k = 0; k < m; ++k) {
    const int off = SPS ? (k % SPS) * wp + k / SPS : ph * wp + kk;  // sample (n0 + j) sps + k - m / 2
    acc += wa[k] * xa[off] + wa[m + k] * xb[off] + sg * (wa[2 * m + k] * xc[off]) +
           sg * (wa[3 * m + k] * xd[off]);
    if (!SPS && ++ph == sps) {
      ph = 0;
      ++kk;
    }
  }
  const int n = n0 + j;
  const bool live = n < n_out;
  if (live) out[(long long)r * n_out + n] = acc;
  E_MARK(PH_FIR)

  // ---- demapper: metric (Markstein's x / (2 var)) + nu_sc a^2 and its
  // minimum (exact in any order)
  float e[NA];
  float mn = 0.f;
#pragma unroll
  for (int l = 0; l < NA; ++l)
    if (l < n_lev) {
      const float a = as[l], d = acc - a, xx = d * d, q0 = xx * ytv;
      e[l] = __fmaf_rn(__fmaf_rn(-q0, tv, xx), ytv, q0) + nu_sc * (a * a);
      mn = l == 0 ? e[0] : fminf(mn, e[l]);
    }
  E_MARK(PH_METRIC)
  float sum = 0.f;
#pragma unroll
  for (int l = 0; l < NA; ++l)
    if (l < n_lev) {
      e[l] = expf(mn - e[l]);
      sum += e[l];
    }
  E_MARK(PH_EXP)
  // q (2 pol, 2 n_lev, N): row o * 2 n_lev + comp * n_lev + l = r * n_lev + l
  const double rs = recip((double)sum);
  float* qr = q + (long long)r * n_lev * n_out + n;
#pragma unroll
  for (int l = 0; l < NA; ++l)
    if (l < n_lev && live) qr[(long long)l * n_out] = fdiv(e[l], rs);
  E_MARK(PH_NORM)
  if (ck)
    for (int p = 0; p < N_PHASES; ++p) clocks[p] += c[p];
#undef E_MARK
}

__global__ void empty_kernel() {}

template <int NL, int SPS>
cudaError_t launch(int n_out, int m, int sps, int n_lev, int l_in, const float* w, const float* x,
                   const float* amps, const float* var, float nu_sc, float* q, float* out,
                   long long* clocks, cudaStream_t stream) {
  constexpr int NA = NL ? NL : kMaxLev;
  const int wp = kSym + (m - 1) / sps;
  const size_t bytes = sizeof(float) * (size_t)(8 * m + NA + 4 * sps * wp);
  auto kernel = clocks ? butterfly_demap_kernel<NL, SPS, true> : butterfly_demap_kernel<NL, SPS, false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(n_out + kSym - 1) / kSym, kThreads, bytes, stream>>>(n_out, m, sps, n_lev, l_in, w, x,
                                                                  amps, var, nu_sc, q, out, clocks);
  return cudaGetLastError();
}

template <int NL>
cudaError_t launch_sps(int n_out, int m, int sps, int n_lev, int l_in, const float* w,
                       const float* x, const float* amps, const float* var, float nu_sc, float* q,
                       float* out, long long* clocks, cudaStream_t stream) {
  return (sps == 2 ? launch<NL, 2> : launch<NL, 0>)(n_out, m, sps, n_lev, l_in, w, x, amps, var,
                                                    nu_sc, q, out, clocks, stream);
}

}  // namespace

extern "C" {

// w (2, 4, m); x (2, 2, l_in); amps (n_lev); var (2); q (2, 2 n_lev, n_out);
// out (2, 2, n_out); clocks (N_PHASES int64, or null). Returns
// cudaGetLastError().
int butterfly_demap_launch(int n_out, int m, int sps, int n_lev, int l_in, const float* w,
                           const float* x, const float* amps, const float* var, float nu_sc, float* q,
                           float* out, long long* clocks, void* stream) {
  if (n_out < 1 || m < 1 || sps < 1 || n_lev < 1 || n_lev > kMaxLev || l_in < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const auto a = [&](auto fn) {
    return (int)fn(n_out, m, sps, n_lev, l_in, w, x, amps, var, nu_sc, q, out, clocks, s);
  };
  if (n_lev == 8) return a(launch_sps<8>);
  if (n_lev == 16) return a(launch_sps<16>);
  return a(launch_sps<0>);
}

// An empty kernel of `blocks` x `threads` (the launch floor E is measured
// against). Returns cudaGetLastError().
int butterfly_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
