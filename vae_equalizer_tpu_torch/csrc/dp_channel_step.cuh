// Kernel L's body: the DP channel's elementwise and reduction work around its
// two FFTs (channels/optical_dp.py: DpSimulator.draws / physics on the card).
//
// Replaces no TPU kernel: the JAX package writes the channel in plain jnp and
// leaves its FFTs to XLA. On this card the port's plain version of it is
// ~110 small PyTorch kernels a frame (~30 for the level draw's edges, ~44 for
// the 2x2 response H, the rest the upsampling, the stacks, the float64 power
// and the noise); the FFTs stay with cuFFT (torch.fft), and four kernels do
// the rest, each one pass over its data:
//   L1 (levels): uniforms -> PCS levels, amps[0] plus one float32 step per
//      crossed CDF edge, in the plain version's order (core/constellation.py:
//      levels_from_uniform), the edges shared or one row per run;
//   L2 (fft_input): levels (R, 4, n_conv) -> the zero-stuffed, zero-padded
//      complex FFT input (R, 2, fft_len), as the plain version's zeros,
//      strided copy, complex() and fft(n=)'s pad leave it;
//   L3 (mix): per frequency bin H = R^T diag(d0, d1) R from the frame's
//      theta, the PMD and the IQ phases, composed once per bin and thread in
//      the plain version's operation order, then (H zf) * CD for each run,
//      in place;
//   L4 (noise, two launches): per run the float64 sum of the valid window's
//      squares in a fixed order (16 blocks a run, each a fixed tree), then
//      sigma = sqrt(mean * 2 * sps / 2 / snr) and rx = window + sigma * noise
//      for the first sps * N samples. The inverse FFT comes unnormalized
//      (torch.fft.ifft(norm="forward")) and L4 applies the float32 1/fft_len
//      that the plain ifft's own scaling multiplies by.
// Every product and sum rounds as the plain version's separate elementwise
// kernels round it on the same device (--fmad=false, explicit fused
// multiply-adds): a complex product is (a.r b.r - a.i b.i, a.r b.i + a.i
// b.r), a real factor one with a zero imaginary part, as PyTorch promotes
// it, with each product rounded alone on the host (PyTorch's vectorized CPU
// product) and with one product of each part fused on the card (nvcc
// contracts PyTorch's c10::complex product so). The levels, the FFT input,
// H z CD, the scaling and so rx are the plain version's bits, and sigma too
// but at a float32 rounding tie of the float64 sum, whose order differs.
//
// What bounds it: bytes. A flagship frame of 8 runs moves ~21 MB through L1-L4
// (~6 us at 3.35 TB/s); the launches, not the arithmetic, were the plain
// version's cost. A run's sum reads only that run's data in an order fixed
// by kPowerBlocks and kThreads, so sigma does not depend on how many runs
// share the launch (core/reduce.py, run sharding).
//
// The body also compiles as plain C++ (VAE_HOST_EMULATION): the shim
// (csrc/dp_channel_host_emulation.cpp) runs every index of every kernel, and
// each block's tree in the card's order.
#pragma once

#include "portable.cuh"

namespace ch {

constexpr int kThreads = 256;     // threads a block, every kernel
constexpr int kPowerBlocks = 16;  // L4's blocks a run for the power sum
constexpr int kMixRuns = 8;       // L3's runs a thread
constexpr int kMaxLev = 16;       // up to 256-QAM

struct cf {
  float r, i;
};
// A complex product: (a.r b.r - a.i b.i, a.r b.i + a.i b.r), each product
// and sum rounded alone (kFused false, PyTorch's CPU product), or as
// fma(a.r, b.r, -(a.i b.i)) and fma(a.r, b.i, a.i b.r) (kFused, its CUDA
// product).
template <bool kFused>
VAE_DEV cf cmul(cf a, cf b) {
  if (kFused) return cf{VAE_FMA(a.r, b.r, -(a.i * b.i)), VAE_FMA(a.r, b.i, a.i * b.r)};
  return cf{a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}
VAE_HD cf cadd(cf a, cf b) { return cf{a.r + b.r, a.i + b.i}; }
VAE_HD cf real(float x) { return cf{x, 0.0f}; }
VAE_HD cf ld(const float* p) { return cf{p[0], p[1]}; }
VAE_HD void st(float* p, cf v) {
  p[0] = v.r;
  p[1] = v.i;
}

// L1: element i of the uniforms u (R, per_run) to its level: amps[0] plus
// steps[l] for each CDF edge l that u reaches, in order; edges (n_lev) per
// run at e_run, 0 where shared.
VAE_HD void level(long long i, long long per_run, int n_lev, const float* u, float amp0,
                  const float* steps, const float* edges, long long e_run, float* out) {
  const float x = u[i];
  const float* e = edges + (i / per_run) * e_run;
  float a = amp0;
  for (int l = 0; l < n_lev - 1; ++l) a = a + (x >= e[l] ? steps[l] : 0.0f);
  out[i] = a;
}

// L2: element i of the FFT input (R, 2, fft_len) complex: sample k of pol p is
// the level pair (2p, 2p + 1) of symbol k / sps where sps divides k and k <
// up_len, else 0.
VAE_HD void fft_input(long long i, int n_conv, int sps, int up_len, int fft_len,
                      const float* levels, float* out) {
  const long long rp = i / fft_len;
  const int k = (int)(i - rp * fft_len);
  cf v{0.0f, 0.0f};
  if (k < up_len && k % sps == 0) {
    const float* lv = levels + rp * 2 * n_conv + k / sps;  // row (r, 2p) of (R, 4, n_conv)
    v = cf{lv[0], lv[n_conv]};
  }
  st(out + 2 * i, v);
}

// L3: the 2x2 response of bin k, H = R^T diag(d0, d1) R with R = [[ct e0, st
// e0], [-st e1, ct e1]], in the plain version's order of products
// (channels/optical_dp.py: physics).
struct H {
  cf h00, h01, h10, h11;
};
template <bool F>
VAE_DEV H response(float ct, float sn, cf e0, cf e1, cf d0, cf d1) {
  const cf c = real(ct), s = real(sn), ms = real(-sn);
  auto cmul = [](cf a, cf b) { return ch::cmul<F>(a, b); };
  H h;
  h.h00 = cadd(cmul(cmul(cmul(cmul(c, e0), d0), c), e0), cmul(cmul(cmul(ms, e0), d1), cmul(ms, e1)));
  h.h01 = cadd(cmul(cmul(cmul(cmul(c, e0), d0), s), e0), cmul(cmul(cmul(cmul(ms, e0), d1), c), e1));
  h.h10 = cadd(cmul(cmul(cmul(cmul(s, e1), d0), c), e0), cmul(cmul(cmul(c, e1), d1), cmul(ms, e1)));
  h.h11 = cadd(cmul(cmul(cmul(cmul(s, e1), d0), s), e0), cmul(cmul(cmul(cmul(c, e1), d1), c), e1));
  return h;
}

// L3 for bin k and runs [r0, r1): z (R, 2, fft_len) <- ((H z) * cd), in place;
// every run's input is read before any output is written.
template <bool F>
VAE_DEV void mix(int k, int r0, int r1, int fft_len, const H& h, cf cd, float* z) {
  auto cmul = [](cf a, cf b) { return ch::cmul<F>(a, b); };
  cf z0[kMixRuns], z1[kMixRuns];
#pragma unroll
  for (int j = 0; j < kMixRuns; ++j) {
    if (r0 + j < r1) {
      const long long row = (long long)(r0 + j) * 2 * fft_len;
      z0[j] = ld(z + 2 * (row + k));
      z1[j] = ld(z + 2 * (row + fft_len + k));
    }
  }
#pragma unroll
  for (int j = 0; j < kMixRuns; ++j) {
    if (r0 + j < r1) {
      const long long row = (long long)(r0 + j) * 2 * fft_len;
      st(z + 2 * (row + k), cmul(cadd(cmul(h.h00, z0[j]), cmul(h.h01, z1[j])), cd));
      st(z + 2 * (row + fft_len + k), cmul(cadd(cmul(h.h10, z0[j]), cmul(h.h11, z1[j])), cd));
    }
  }
}

// L4's window: z (R, 2, fft_len) the unnormalized inverse transform; sample t
// of the window is bin start + t, scaled by the float32 1 / fft_len.
struct Window {
  const float* z;
  int fft_len, start, sig_len;
  float scale;
  VAE_HD cf at(int r, int p, int t) const {
    const cf v = ld(z + 2 * (((long long)r * 2 + p) * fft_len + start + t));
    return cf{v.r * scale, v.i * scale};
  }
};

// L4, power: thread tid of block g of run r sums the squares (float32, as
// sig ** 2 rounds them) of its items of the run's 2 * sig_len window samples
// in float64: items g * chunk + tid + j * kThreads of block g's chunk.
VAE_HD double power_partial(const Window& w, int r, int g, int tid) {
  const int n = 2 * w.sig_len, chunk = (n + kPowerBlocks - 1) / kPowerBlocks;
  const int end = (g + 1) * chunk < n ? (g + 1) * chunk : n;
  double acc = 0.0;
  for (int i = g * chunk + tid; i < end; i += kThreads) {
    const int p = i / w.sig_len;
    const cf v = w.at(r, p, i - p * w.sig_len);
    const float a = v.r * v.r, b = v.i * v.i;
    acc += (double)a;
    acc += (double)b;
  }
  return acc;
}

// One level of a block's tree over kThreads partials: s[tid] += s[tid + width].
VAE_HD void tree_step(double* s, int width, int tid) {
  if (tid < width) s[tid] += s[tid + width];
}

// L4, sigma of run r from its kPowerBlocks partials, in block order:
// sqrt(mean * 2 * sps / 2 / snr), the mean rounded to float32 as run_mean
// does; snr per run (snr_runs, divided), or shared: divided by, or (recip)
// multiplied by the scalar snr, as PyTorch divides by a host scalar on that
// device.
VAE_HD float sigma(const double* partial, int r, double inv_n, int sps, float snr,
                   const float* snr_runs, int recip) {
  double sum = 0.0;
  for (int g = 0; g < kPowerBlocks; ++g) sum += partial[r * kPowerBlocks + g];
  float t = (float)(sum * inv_n);
  t = t * 2.0f;
  t = t * (float)sps;
  t = t * 0.5f;
  t = snr_runs != nullptr ? t / snr_runs[r] : (recip ? t * snr : t / snr);
  return sqrtf(t);
}

// L4, noise: rx (R, 2, 2, n_rx) at (r, p, t) from the window and noise (R, 2,
// 2, sig_len): window + sigma * noise, per component.
VAE_HD void add_noise(const Window& w, int r, int p, int t, int n_rx, float sig, const float* noise,
                      float* rx) {
  const cf v = w.at(r, p, t);
  const long long row = ((long long)r * 2 + p) * 2;
  const float nr = sig * noise[row * w.sig_len + t], ni = sig * noise[(row + 1) * w.sig_len + t];
  rx[row * n_rx + t] = v.r + nr;
  rx[(row + 1) * n_rx + t] = v.i + ni;
}

}  // namespace ch
