// One SISO VAE minibatch step (twoFIR -> per-component mean-|.| normalization
// -> d^2/var softmin demapper -> shaped SISO ELBO -> closed-form backward),
// shared by kernel F (one step for R runs) and kernel G (a whole experiment
// of steps with AMSGrad), for NVIDIA Hopper (sm_90a).
//
// Replaces the per-step body of the TPU kernels
// vae_equalizer_tpu/ops/elbo_siso_kernel.py:_kernel and
// ops/siso_frame_kernel.py:_kernel / _kernel_rb; the plain PyTorch version is
// vae_equalizer_tpu_torch/ops/elbo_siso_kernel.py: siso_step_plain, whose
// index conventions this file follows: samples are indexed directly (the TPU
// kernels' parity-split planes, polyphase rows and im2col were Mosaic
// layouts), D[c, n] = sum_j h[j] EqUp[n + Mh - j] for n in [0, n_eff) and
// C aligns rx[mh + n] with D[n].
//
// What bounds a step: not bytes or FLOPs (~0.5 MFLOP on a ~79 KB working
// set) but the chain of dependent passes on one SM per run; measured per
// phase with clock64() (the launchers' `clocks`, PERF.md §5), the time goes
// to the per-level loops of the demapper and of dL/dq and to the sums over
// time. So, one block of kThreads = 512 threads per run:
//   * Six passes a step, one barrier each: the FIR; the demapper; D, C and
//     the E-term window totals S; dL/dq (with gh); the normalization VJP;
//     gw (with AMSGrad).
//   * The level count is a template parameter (8 for 64-QAM, or a generic
//     instance up to MAX_LEV with the levels past n_lev predicated off), so
//     the per-level arrays live in registers.
//   * Divisions are a multiply by the divisor's reciprocal in double (fdiv:
//     the same float as the IEEE division, with no branch), the reciprocal
//     taken once per block, step, item or level, or, for the metric's
//     division by var, Markstein's float correction (the same float too);
//     the KL's gradient term is formed in the demapper, where its log
//     already is.
//   * The demapper and dL/dq take one symbol per thread, both components
//     in straight-line code (no branch in an item), so the two chains
//     overlap; D takes two samples per thread (the even and odd taps read
//     the same E_q[x]).
//   * The long sums over time (S, gh, gw) are split over lanes of one warp
//     and closed by a fixed xor-shuffle tree; block totals (sum |out|, C,
//     the KL, the normalization dots) close each warp by shuffles and are
//     summed over the 16 warps in a fixed order by every thread that needs
//     them, so no thread waits on another's result past the barrier.
//   * The input rows are held zero-padded and split by sample parity, so the
//     FIR's and gw's reads are branch-free and a warp reads consecutive
//     words; the Q output's (x_Q, -x_I) arrangement multiplies the tap by
//     the sign (exact). dL/dD is kept unscaled (u = 2 D - 2 rx), parity-
//     split the same way, and multiplied by n_eff / C where it is read.
//   * Passes that need few threads share theirs: S with D, gh with dL/dq,
//     h's AMSGrad with gw.
//   * Kernel G copies the next minibatch into a second input buffer with
//     cp.async while a step runs, one thread forms AMSGrad's bias
//     corrections per step, and the parameters are updated in the pass that
//     forms their gradients.
// Sums run in a fixed order (in-thread chains, fixed shuffle trees, a fixed
// cross-warp order) without atomics, so a run repeats bit for bit and does
// not depend on the other blocks. The demapper, KL, the scalars and AMSGrad
// keep the plain version's elementwise operations (the library is built
// with --fmad=false, ops/_build.py; the dot products' fused multiply-adds
// are explicit).
//
// The body also compiles as plain C++ (VAE_HOST_EMULATION), where one
// "thread" (tid 0, nt 1) runs every item of every phase in order, computes
// every lane's partial of a split sum and closes them with the card's
// butterfly, and forms each block total from the card's per-thread and
// per-warp partials in the card's order; barriers are no-ops and cp.async a
// copy. That is how its arithmetic, in the card's summation order, is
// checked against the plain version without a GPU
// (csrc/siso_host_emulation.cpp).
//
// Kernel H (nn_step.cuh) includes this file for MAX_LEV, EPS_KL and amsgrad;
// it has its own ELBO back end.
#pragma once

#include "portable.cuh"
#ifdef VAE_HOST_EMULATION
#include <vector>  // Tot
#endif

namespace siso {

using namespace vae;  // copy_async, copy_async_wait

constexpr int MAX_LEV = 16;       // up to 256-QAM (16 levels per dimension)
constexpr float EPS_KL = 1e-12f;  // KL log guard (elbo_siso's eps)
constexpr float AMS_B1 = 0.9f;
constexpr float AMS_B2 = 0.999f;
constexpr float AMS_EPS = 1e-8f;

// Threads per block (siso_kernels.cu launches exactly this many; the
// emulation reproduces their partition), a warp, and the lanes that share
// one item of a split sum. The card's warp in emulation too (kept here, not
// in portable.cuh: dp, dp_eval and nn emulate a one-lane warp instead).
constexpr int kThreads = 512;
constexpr int kWarp = 32;
constexpr int kWarps = kThreads / kWarp;
constexpr int GS = 4;   // S[j]: ~n_sym terms
constexpr int GH = 4;   // gh (re, im) at tap j: ~n_eff / 2 terms, 4 chains
constexpr int GW = 16;  // gw (c = 0, 1) at tap k: n_sym terms, 4 chains
#ifdef VAE_HOST_EMULATION
constexpr bool kEmu = true;
#else
constexpr bool kEmu = false;
#endif

VAE_HD int warp_round(int n) { return (n + kWarp - 1) / kWarp * kWarp; }
// a plane stride >= n and = 16 mod 32: planes read by one warp in one access
// start 16 banks apart
VAE_HD int plane_stride(int n) { return (n + 15) / 32 * 32 + 16; }

// Phase clocks (measurement only): thread 0 of run 0's block adds the
// clock64() cycles of each phase into c[phase]; the launcher's `clocks`
// receives them summed over the call (ops/elbo_siso_kernel.py:
// SISO_CLOCK_PHASES names them). Compiled in only for CLK = true (kept per
// kernel: dp and nn switch theirs at run time instead).
enum Phase { PH_LOAD, PH_FIR, PH_DEMAP, PH_DSC, PH_BACK, PH_GOUT, PH_GW, N_PHASES };
template <bool CLK>
struct Clock {
  bool on;
  long long t, c[N_PHASES];
  VAE_DEV void start(bool enable) {
    on = CLK && enable;
    for (int p = 0; p < N_PHASES; ++p) c[p] = 0;
    if (CLK && on) t = VAE_CLOCK();
  }
  VAE_DEV void mark(int ph) {
    if (CLK && on) {
      const long long now = VAE_CLOCK();
      c[ph] += now - t;
      t = now;
    }
  }
  VAE_DEV void store(long long* out) const {
    if (CLK && on)
      for (int p = 0; p < N_PHASES; ++p) out[p] = c[p];
  }
};

// Shapes of one minibatch: n_sym symbols, n_samp = 2 n_sym samples (sps 2),
// m taps (odd), mh = m / 2, mh2 = 2 mh = m - 1, n_eff = n_samp - mh2. The
// padded input row (sample s at ps = s + mh, zeros outside) is split by the
// parity of ps into two planes of xn = n_sym + mh words, xs apart; dL/dD's
// rows by the parity of n into planes of (n_eff + 1) / 2 words, us apart.
struct Dims {
  int n_sym, m, n_lev, n_samp, mh, mh2, n_eff, xn, xs, us;
};

VAE_HD Dims make_dims(int n_sym, int m, int n_lev) {
  Dims d;
  d.n_sym = n_sym;
  d.m = m;
  d.n_lev = n_lev;
  d.n_samp = 2 * n_sym;
  d.mh = m / 2;
  d.mh2 = 2 * (m / 2);
  d.n_eff = 2 * n_sym - 2 * (m / 2);
  d.xn = n_sym + m / 2;
  d.xs = plane_stride(d.xn);
  d.us = plane_stride((d.n_eff + 1) / 2);
  return d;
}

// Block totals: each a slot of kWarps per-warp partials in `red`.
enum Total { T_ABS0, T_ABS1, T_KL, T_C, T_DOT0, T_DOT1, N_TOTALS };
// rd (doubles): 1 / P per level, then 1 / var, and AMSGrad's 1 / bc1, 1 / bc2
// (kernel G, per step)
enum Recip { RD_VAR = MAX_LEV, RD_BC1, RD_BC2, N_RD };

// Shared-memory layout in 4-byte words.
//   rd   (N_RD doubles)       reciprocals for fdiv (first: 8-byte aligned)
//   x    (2, 2, 2, xs)        input buffers (buffer, row I/Q, parity plane)
//   w mw vw xw (2, m)         filter taps (input row c, tap k), AMSGrad mu,
//                             nu, nu_max
//   h mh vh xh gh (2, m)      channel estimate (re/im, tap j), ..., gradient
//   hab S (m)                 |h[j]|^2; E-term window totals S[j]
//   out gn eq v (2, n_sym)    filter output, dL/dnorm, E_q[x], Var_q[x] per
//                             component (I, Q)
//   go   (n_sym, 2)           dL/dout (t, I/Q)
//   q kq (2, n_lev, n_sym)    posteriors; at inner t the KL's gradient term
//                             log(r + eps) + r / (r + eps), r = q / P
//   u    (2, 2, us)           2 D - 2 rx_w (re/im, parity plane of n)
//   amps a2 P (n_lev)         level constants
//   red  (N_TOTALS, kWarps)   per-warp partials of the block totals
struct Layout {
  int rd, x, w, mw, vw, xw, h, mh, vh, xh, gh, hab, S, out, gn, eq, v, go, q, kq, u, amps, a2, P, red;
  int total;
};

VAE_HD Layout make_layout(const Dims& D) {
  Layout L;
  int o = 0;
  const int n2 = 2 * D.n_sym, pm = 2 * D.m;
  L.rd = o; o += 2 * N_RD;
  L.x = o; o += 8 * D.xs;
  L.w = o; o += pm;
  L.mw = o; o += pm;
  L.vw = o; o += pm;
  L.xw = o; o += pm;
  L.h = o; o += pm;
  L.mh = o; o += pm;
  L.vh = o; o += pm;
  L.xh = o; o += pm;
  L.gh = o; o += pm;
  L.hab = o; o += D.m;
  L.S = o; o += D.m;
  L.out = o; o += n2;
  L.gn = o; o += n2;
  L.eq = o; o += n2;
  L.v = o; o += n2;
  L.go = o; o += n2;
  L.q = o; o += n2 * D.n_lev;
  L.kq = o; o += n2 * D.n_lev;
  L.u = o; o += 4 * D.us;
  L.amps = o; o += D.n_lev;
  L.a2 = o; o += D.n_lev;
  L.P = o; o += D.n_lev;
  L.red = o; o += N_TOTALS * kWarps;
  L.total = o;
  return L;
}

struct Smem {
  float *x, *w, *mw, *vw, *xw, *h, *mh, *vh, *xh, *gh, *hab, *S, *out, *gn, *eq, *v, *go, *q, *kq, *u;
  float *amps, *a2, *P, *red;
  double* rd;
};

VAE_DEV Smem carve(float* base, const Layout& L) {
  Smem s;
  s.rd = reinterpret_cast<double*>(base + L.rd);
  s.x = base + L.x;
  s.w = base + L.w;
  s.mw = base + L.mw;
  s.vw = base + L.vw;
  s.xw = base + L.xw;
  s.h = base + L.h;
  s.mh = base + L.mh;
  s.vh = base + L.vh;
  s.xh = base + L.xh;
  s.gh = base + L.gh;
  s.hab = base + L.hab;
  s.S = base + L.S;
  s.out = base + L.out;
  s.gn = base + L.gn;
  s.eq = base + L.eq;
  s.v = base + L.v;
  s.go = base + L.go;
  s.q = base + L.q;
  s.kq = base + L.kq;
  s.u = base + L.u;
  s.amps = base + L.amps;
  s.a2 = base + L.a2;
  s.P = base + L.P;
  s.red = base + L.red;
  return s;
}

// a / b for float a and float b > 0, to the same float as the IEEE division,
// as (float)(a * y) in double with y within a few double ulps of 1 / b: a
// float quotient lies at least 2^-49 (relative) from every midpoint of the
// float grid, and a * y is within 2^-50 of it, so rounding to float gives
// the correctly rounded quotient (held against division on 10^7 pairs, zero
// and denormal dividends included, with y off by up to 4 ulps:
// tests/test_torch_siso_step_emulation.py). Why: on
// the card a float division is a guarded fast path plus a branch to a
// software path for tiny or zero dividends, and the demapper's far-level
// posteriors are tiny or zero in every warp; this has no branch, so the
// level loops schedule as straight-line code.
VAE_DEV float fdiv(float a, double y) { return (float)((double)a * y); }

// 1 / b in double to within ~2 ulps, without a branch: the approximate
// reciprocal and two Newton steps on the card; the division on the host
// (fdiv gives the same float from either). Kept beside the fdiv that this
// kernel's own division check holds.
VAE_DEV double recip(double b) {
#ifdef VAE_HOST_EMULATION
  return 1.0 / b;
#else
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(b));
  y = VAE_DFMA(y, VAE_DFMA(-b, y, 1.0), y);
  return VAE_DFMA(y, VAE_DFMA(-b, y, 1.0), y);
#endif
}

// ---- Split sums and block totals, in the card's order.
#ifdef VAE_HOST_EMULATION
// The card's xor butterfly over g lanes: at each level lane l adds lane
// l ^ off's value to its own.
inline void butterfly(float* v, int g) {
  for (int off = g / 2; off > 0; off >>= 1) {
    float t[kWarp];
    for (int l = 0; l < g; ++l) t[l] = v[l] + v[l ^ off];
    for (int l = 0; l < g; ++l) v[l] = t[l];
  }
}
#endif

// part(l, a): lane l's N partial sums of one item split over G lanes; out:
// the item's N totals (on the card every lane of the group gets the same
// bits; in emulation the one thread computes every lane's partials).
template <int G, int N, typename F>
VAE_DEV void group_sum(int lane, F&& part, float* out) {
#ifdef VAE_HOST_EMULATION
  (void)lane;
  float v[N][G];
  for (int l = 0; l < G; ++l) {
    float a[N];
    part(l, a);
    for (int n = 0; n < N; ++n) v[n][l] = a[n];
  }
  for (int n = 0; n < N; ++n) {
    butterfly(v[n], G);
    out[n] = v[n][0];
  }
#else
  float a[N];
  part(lane, a);
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1) a[n] += __shfl_xor_sync(0xffffffffu, a[n], off);
    out[n] = a[n];
  }
#endif
}

// K block totals of one pass: the contributions of unit uu go to card thread
// uu % kThreads, which adds them in order; to_warps closes each warp by the
// xor butterfly and stores lane 0's value as the warp's partial in slots
// first, first + 1, ... of red. In emulation the contributions are kept in
// the order they come (units in order, each unit's in the card thread's
// order) and the card's thread and warp partials are formed from them.
#ifdef VAE_HOST_EMULATION
template <int K>
struct Tot {
  struct Part {
    int k, uu;
    float v;
  };
  std::vector<Part> parts;
  void add(int k, int uu, float v) { parts.push_back({k, uu, v}); }
  void to_warps(float* red, int first, int) const {
    for (int k = 0; k < K; ++k)
      for (int wp = 0; wp < kWarps; ++wp) {
        float lane[kWarp];
        for (int l = 0; l < kWarp; ++l) {
          float p = 0.f;
          for (const Part& c : parts)
            if (c.k == k && c.uu % kThreads == wp * kWarp + l) p += c.v;
          lane[l] = p;
        }
        butterfly(lane, kWarp);
        red[(first + k) * kWarps + wp] = lane[0];
      }
  }
};
#else
template <int K>
struct Tot {
  float p[K] = {};
  // k selects a register by predicate, not by index (an indexed register
  // array would live in local memory)
  __device__ __forceinline__ void add(int k, int, float v) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i == k) p[i] += v;
  }
  __device__ __forceinline__ void to_warps(float* red, int first, int tid) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = p[k];
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if ((tid & (kWarp - 1)) == 0) red[(first + k) * kWarps + tid / kWarp] = v;
    }
  }
};
#endif

// A block total after the barrier that follows to_warps: the warps' partials
// in order (every thread the same bits).
VAE_DEV float total(const float* red, int slot) {
  const float* r = red + slot * kWarps;
  float t = r[0];
  for (int wp = 1; wp < kWarps; ++wp) t += r[wp];
  return t;
}

// The emulation's one thread computes a split sum's every lane at the
// group's lane 0 and takes every lane's store; on the card lane `which`
// stores.
VAE_DEV bool owns(int lane, int which) { return kEmu || lane == which; }

// Level constants: amps, a^2, the prior P and 1 / P; 1 / var. Once per block.
VAE_DEV void load_consts(const Dims& D, const Smem& s, const float* amps, const float* P, float var,
                         int tid, int nt) {
  for (int l = tid; l < D.n_lev; l += nt) {
    const float a = amps[l];
    s.amps[l] = a;
    s.a2[l] = a * a;
    s.P[l] = P[l];
    s.rd[l] = 1.0 / (double)P[l];
  }
  if (tid == 0) s.rd[RD_VAR] = 1.0 / (double)var;
}

// One input buffer (4 planes) whole: the 2 rows of n_samp samples from src
// (row stride `stride`) at their padded places, zeros elsewhere.
VAE_DEV void load_x(const Dims& D, float* xb, const float* src, long long stride, int tid,
                    int nt) {
  for (int i = tid; i < 4 * D.xs; i += nt) {
    const int pl = i / D.xs, idx = i - pl * D.xs, smp = 2 * idx + (pl & 1) - D.mh;
    xb[i] = (idx < D.xn && smp >= 0 && smp < D.n_samp) ? src[(pl >> 1) * stride + smp] : 0.f;
  }
}

// The samples of the next minibatch into a buffer whose padding is already
// zero, by cp.async (waited for at the end of the step).
VAE_DEV void prefetch_x(const Dims& D, float* xb, const float* src, long long stride, int tid,
                        int nt) {
  for (int i = tid; i < 2 * D.n_samp; i += nt) {
    const int row = i >= D.n_samp, smp = i - row * D.n_samp, ps = smp + D.mh;
    copy_async(xb + (row * 2 + (ps & 1)) * D.xs + (ps >> 1), src + row * stride + smp);
  }
}

// One AMSGrad update (optax.amsgrad: b1 .9, b2 .999, eps 1e-8 outside the
// sqrt, nu_max over the bias-corrected nu, t = step + 1) of n parameters, op
// for op as the plain version's f32 tensor expression (ops/siso_frame_kernel.py:
// amsgrad).
VAE_DEV void amsgrad(float* p, float* mo, float* ve, float* vmax, const float* g, int n, float lr,
                     float bc1, float bc2, int tid, int nt) {
  const float omb1 = (float)(1.0 - 0.9), omb2 = (float)(1.0 - 0.999);
  for (int i = tid; i < n; i += nt) {
    const float gi = g[i];
    const float mi = AMS_B1 * mo[i] + omb1 * gi;
    const float vi = AMS_B2 * ve[i] + (omb2 * gi) * gi;
    const float xi = fmaxf(vmax[i], vi / bc2);
    mo[i] = mi;
    ve[i] = vi;
    vmax[i] = xi;
    p[i] = p[i] - lr * ((mi / bc1) / (sqrtf(xi) + AMS_EPS));
  }
}

// The same update of parameter i with gradient g, the bias-correction
// divisions by fdiv with the step's reciprocals (the same floats).
VAE_DEV void amsgrad_one(float* p, float* mo, float* ve, float* vmax, int i, float g, float lr,
                         const Smem& s) {
  const float omb1 = (float)(1.0 - 0.9), omb2 = (float)(1.0 - 0.999);
  const float mi = AMS_B1 * mo[i] + omb1 * g;
  const float vi = AMS_B2 * ve[i] + (omb2 * g) * g;
  const float xi = fmaxf(vmax[i], fdiv(vi, s.rd[RD_BC2]));
  mo[i] = mi;
  ve[i] = vi;
  vmax[i] = xi;
  p[i] = p[i] - lr * (fdiv(mi, s.rd[RD_BC1]) / (sqrtf(xi) + AMS_EPS));
}

// Where a step's results go: kernel F (ADAM false) writes loss, out, q, gh and
// gw of its run to device memory; kernel G (ADAM true) writes the loss and
// updates w and h in place with AMSGrad at learning rate lr.
struct Io {
  float *loss, *out, *q, *gh, *gw;
  float lr;
};

// The step on input buffer xb. Reads s.w, s.h and the level constants (and
// for ADAM the step's bias corrections); ends with a barrier.
template <int NL, bool ADAM, bool CLK>
VAE_DEV void siso_step(const Dims& D, const Smem& s, const float* xb, float amp_mean, float var,
                       const Io& io, int tid, int nt, Clock<CLK>& ck) {
  constexpr int NA = NL ? NL : MAX_LEV;
  const int n_sym = D.n_sym, m = D.m, n_lev = NL ? NL : D.n_lev, n_samp = D.n_samp;
  const int mh = D.mh, mh2 = D.mh2, n_eff = D.n_eff, xs = D.xs, us = D.us;
  const double rvar = s.rd[RD_VAR];
  // the metric's division by var: Markstein's correction of x * RN(1 / var),
  // the same float as x / var wherever no step underflows (x = 0 or x >=
  // 2^-100, held on 10^7 pairs in tests/test_torch_siso_step_emulation.py; a
  // nonzero (norm - a)^2 is far above that)
  const float yv = 1.f / var;

  // ---- 1. forward FIR, item t: out_I = sum_k w0 x_I + w1 x_Q, out_Q = sum_k
  // w0 x_Q - w1 x_I (the plain version's arrangements, models/vae_le.py),
  // each row a fused chain over k; per-warp partials of sum |out|
  {
    Tot<2> ab;
    for (int t = tid; t < n_sym; t += nt) {
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
      for (int k = 0; k < m; ++k) {
        const float* p0 = xb + (k & 1) * xs + t + (k >> 1);  // padded sample 2t + k
        const float xv0 = p0[0], xv1 = p0[2 * xs], w0 = s.w[k], w1 = s.w[m + k];
        a0 = VAE_FMA(w0, xv0, a0);
        a1 = VAE_FMA(w1, xv1, a1);
        b0 = VAE_FMA(w0, xv1, b0);
        b1 = VAE_FMA(-w1, xv0, b1);
      }
      const float oi = a0 + a1, oq = b0 + b1;
      s.out[t] = oi;
      s.out[n_sym + t] = oq;
      if (!ADAM) {
        io.out[t] = oi;
        io.out[n_sym + t] = oq;
      }
      ab.add(0, t, fabsf(oi));
      ab.add(1, t, fabsf(oq));
    }
    ab.to_warps(s.red, T_ABS0, tid);
  }
  VAE_SYNC();
  ck.mark(PH_FIR);

  // k_c = amp_mean / mean|out_c|, every thread
  const float k0 = amp_mean / (total(s.red, T_ABS0) / (float)n_sym);
  const float k1 = amp_mean / (total(s.red, T_ABS1) / (float)n_sym);

  // ---- 2. demapper per symbol t, both components (straight-line, so their
  // chains overlap): metric (norm - a)^2 / var -> q, the moments, the KL term
  // and its gradient term (formed at every t, kept at inner t); per-warp KL
  // partials
  {
    Tot<1> kl;
    for (int t = tid; t < n_sym; t += nt) {
      const bool inner = t >= mh && t < n_sym - mh;
      float klv[2];
#pragma unroll
      for (int comp = 0; comp < 2; ++comp) {
        const int it = comp * n_sym + t, row = comp * n_lev * n_sym + t;
        const float nrm = s.out[it] * (comp ? k1 : k0);
        float e[NA];
        float mmv = 0.f;
#pragma unroll
        for (int l = 0; l < NA; ++l)
          if (l < n_lev) {
            const float dd = nrm - s.amps[l], x = dd * dd, q0 = x * yv;
            e[l] = VAE_FMA(VAE_FMA(-q0, var, x), yv, q0);
            mmv = l == 0 ? e[l] : fminf(mmv, e[l]);
          }
        float s1v = 0.f;
#pragma unroll
        for (int l = 0; l < NA; ++l)
          if (l < n_lev) {
            e[l] = expf(mmv - e[l]);
            s1v += e[l];
          }
        const double r_s1 = recip((double)s1v);
        float eqv = 0.f, eq2v = 0.f, klc = 0.f;
#pragma unroll
        for (int l = 0; l < NA; ++l)
          if (l < n_lev) {
            const float ql = fdiv(e[l], r_s1);
            s.q[row + l * n_sym] = ql;
            if (!ADAM) io.q[row + l * n_sym] = ql;
            eqv += ql * s.amps[l];
            eq2v += ql * s.a2[l];
            const float r = fdiv(ql, s.rd[l]), rpe = r + EPS_KL, lg = logf(rpe);
            klc += -ql * lg;
            s.kq[row + l * n_sym] = lg + fdiv(r, recip((double)rpe));
          }
        s.eq[it] = eqv;
        s.v[it] = eq2v - eqv * eqv;
        klv[comp] = klc;
      }
      kl.add(0, t, inner ? klv[0] : 0.f);
      kl.add(0, t, inner ? klv[1] : 0.f);
    }
    kl.to_warps(s.red, T_KL, tid);
  }
  VAE_SYNC();
  ck.mark(PH_DEMAP);

  // ---- 3. one pass, two kinds of work (warp-aligned): the E-term window
  // totals S[j] = sum_t (v_I + v_Q)[t] over t in [(mh2 - j + 1) / 2,
  // (n_samp - j + 1) / 2), split over GS lanes, with |h[j]|^2; D[n] (re/im)
  // = sum over taps j of n's parity of (h (*) E_q[x])[(n + mh2 - j) / 2], four
  // fused chains per n, two n per item, with u = 2 D - 2 rx_w and the C
  // partials
  {
    Tot<1> cc;
    const int u_s = warp_round(m * GS), n_units = u_s + n_eff / 2;
    for (int uu = tid; uu < n_units; uu += nt) {
      if (uu < u_s) {
        const int j = uu / GS, lane = uu % GS;
        if (kEmu && lane != 0) continue;
        float sj;
        group_sum<GS, 1>(lane, [&](int l, float* a) {
          float acc = 0.f;
          if (j < m)
            for (int t = ((mh2 - j + 1) >> 1) + l; t < (n_samp - j + 1) >> 1; t += GS)
              acc += s.v[t] + s.v[n_sym + t];
          a[0] = acc;
        }, &sj);
        if (j < m && owns(lane, 0)) {
          s.S[j] = sj;
          s.hab[j] = s.h[j] * s.h[j] + s.h[m + j] * s.h[m + j];
        }
      } else {
        // D at n = 2i (even taps) and 2i + 1 (odd taps): both read E_q[x] at
        // t = i + mh - a for taps 2a and 2a + 1
        const int i = uu - u_s;
        float d[2][4] = {};  // per n: hr.eI, hi.eQ, hi.eI, hr.eQ
        for (int a = 0; a <= mh; ++a) {
          const int tt = i + mh - a;
          const float ei = s.eq[tt], eq = s.eq[n_sym + tt];
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int j = 2 * a + p;
            if (p == 0 || a < mh) {
              const float hr = s.h[j], hi = s.h[m + j];
              d[p][0] = VAE_FMA(hr, ei, d[p][0]);
              d[p][1] = VAE_FMA(hi, eq, d[p][1]);
              d[p][2] = VAE_FMA(hi, ei, d[p][2]);
              d[p][3] = VAE_FMA(hr, eq, d[p][3]);
            }
          }
        }
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float dr = d[p][0] - d[p][1], di = d[p][2] + d[p][3];
          const int xi = i + mh;  // rx_w[n] = padded sample n + mh2
          const float rr = xb[p * xs + xi], ri = xb[(2 + p) * xs + xi];
          const float er = rr - dr, ei2 = ri - di;
          cc.add(0, uu, er * er + ei2 * ei2);
          s.u[p * us + i] = 2.f * dr - 2.f * rr;
          s.u[(2 + p) * us + i] = 2.f * di - 2.f * ri;
        }
      }
    }
    cc.to_warps(s.red, T_C, tid);
  }
  VAE_SYNC();
  ck.mark(PH_DSC);

  // ---- the scalars, every thread: C = sum (rx_w - D)^2 + E, g_C = n_eff / C,
  // loss = n_eff log C - KL
  float e_term = 0.f;
  for (int j = 0; j < m; ++j) e_term += s.hab[j] * s.S[j];
  const float ne = (float)n_eff, big_c = total(s.red, T_C) + e_term, g_c = ne / big_c;
  if (tid == 0) *io.loss = ne * logf(big_c) - total(s.red, T_KL);

  // ================= backward (dL/dloss = 1; dL/dD = g_C u) =================
  // ---- 4. one pass, two kinds of work (warp-aligned): gh (re/im) at tap j =
  // correlation of dL/dD with EqUp, four fused chains split over GH lanes,
  // + the E term; per symbol t, both components, dL/dq (gEqUp and gVar at
  // sample 2t through the moments, + the KL term at inner t) -> softmin VJP
  // -> dL/dnorm, and per-warp partials of <dL/dnorm_c, norm_c>
  {
    Tot<2> dot;
    const int u_h = warp_round(m * GH), n_units = u_h + warp_round(n_sym);
    for (int uu = tid; uu < n_units; uu += nt) {
      if (uu < u_h) {
        const int j = uu / GH, lane = uu % GH;
        if (kEmu && lane != 0) continue;
        float r[4];
        group_sum<GH, 4>(lane, [&](int l, float* a) {
          float ar = 0.f, br = 0.f, ai = 0.f, bi = 0.f;
          if (j < m) {
            // n = (j & 1) + 2 i, EqUp's sample n + mh2 - j = 2 (i + t0)
            const int par = j & 1, n_par = (n_eff - par + 1) >> 1, t0 = mh - (j >> 1);
            const float* ur = s.u + par * us;
            const float* ui = s.u + (2 + par) * us;
            for (int i = l; i < n_par; i += GH) {
              const float g_re = g_c * ur[i], g_im = g_c * ui[i];
              const float ei = s.eq[t0 + i], eq = s.eq[n_sym + t0 + i];
              ar = VAE_FMA(g_re, ei, ar);
              br = VAE_FMA(g_im, eq, br);
              ai = VAE_FMA(g_im, ei, ai);
              bi = VAE_FMA(g_re, eq, bi);
            }
          }
          a[0] = ar;
          a[1] = br;
          a[2] = ai;
          a[3] = bi;
        }, r);
        if (j < m) {
          const float sj = s.S[j];
          if (owns(lane, 0)) {
            const float v = (r[0] + r[1]) + 2.f * g_c * s.h[j] * sj;
            s.gh[j] = v;
            if (!ADAM) io.gh[j] = v;
          }
          if (owns(lane, 1)) {
            const float v = (r[2] - r[3]) + 2.f * g_c * s.h[m + j] * sj;
            s.gh[m + j] = v;
            if (!ADAM) io.gh[m + j] = v;
          }
        }
      } else {
        const int t = uu - u_h;
        if (t < n_sym) {
          const int ps = 2 * t;
          // taps j with D's sample n = ps + j - mh2 in [0, n_eff) (n has j's parity)
          const int jlo = ps < mh2 ? mh2 - ps : 0, jhi = n_samp - ps < m ? n_samp - ps : m;
          // gEqUp_I = g_re.hr + g_im.hi, gEqUp_Q = g_im.hr - g_re.hi (two chains each)
          float c1[2] = {0.f, 0.f}, c2[2] = {0.f, 0.f}, hs = 0.f;
          for (int j = jlo; j < jhi; ++j) {
            const int ui = (j & 1) * us + ((ps + j - mh2) >> 1);
            const float g_re = g_c * s.u[ui], g_im = g_c * s.u[2 * us + ui];
            const float hr = s.h[j], hi = s.h[m + j];
            c1[0] = VAE_FMA(g_re, hr, c1[0]);
            c2[0] = VAE_FMA(g_im, hi, c2[0]);
            c1[1] = VAE_FMA(g_im, hr, c1[1]);
            c2[1] = VAE_FMA(g_re, hi, c2[1]);
            hs += s.hab[j];
          }
          const float gv = g_c * hs;
          const bool inner = t >= mh && t < n_sym - mh;
          float dotv[2];
#pragma unroll
          for (int comp = 0; comp < 2; ++comp) {
            const int it = comp * n_sym + t, row = comp * n_lev * n_sym + t;
            const float ge = comp ? c1[1] - c2[1] : c1[0] + c2[0];
            const float geq = ge - 2.f * s.eq[it] * gv;
            float g[NA];
            float inner_sum = 0.f;
#pragma unroll
            for (int l = 0; l < NA; ++l)
              if (l < n_lev) {
                const float gl = s.amps[l] * geq + s.a2[l] * gv;
                g[l] = inner ? gl + s.kq[row + l * n_sym] : gl;
                inner_sum += s.q[row + l * n_sym] * g[l];
              }
            const float nrm = s.out[it] * (comp ? k1 : k0);
            float acc = 0.f;
#pragma unroll
            for (int l = 0; l < NA; ++l)
              if (l < n_lev) {
                const float ql = s.q[row + l * n_sym];
                acc += (-ql * (g[l] - inner_sum)) * 2.f * (nrm - s.amps[l]);
              }
            const float gnv = fdiv(acc, rvar);
            s.gn[it] = gnv;
            dotv[comp] = gnv * nrm;
          }
          dot.add(0, uu, dotv[0]);
          dot.add(1, uu, dotv[1]);
        }
      }
    }
    dot.to_warps(s.red, T_DOT0, tid);
  }
  VAE_SYNC();
  ck.mark(PH_BACK);

  // ---- 5. the normalization VJP gout_c = k_c (gnorm_c - sign(out_c)
  // <gnorm_c, norm_c> / (N amp_mean)) per symbol
  {
    const float den = (float)n_sym * amp_mean;
    const float d0 = total(s.red, T_DOT0) / den, d1 = total(s.red, T_DOT1) / den;
    for (int t = tid; t < n_sym; t += nt) {
      const float oi = s.out[t], oq = s.out[n_sym + t];
      const float sgi = oi > 0.f ? 1.f : (oi < 0.f ? -1.f : 0.f);
      const float sgq = oq > 0.f ? 1.f : (oq < 0.f ? -1.f : 0.f);
      s.go[2 * t] = k0 * (s.gn[t] - sgi * d0);
      s.go[2 * t + 1] = k1 * (s.gn[n_sym + t] - sgq * d1);
    }
  }
  VAE_SYNC();
  ck.mark(PH_GOUT);

  // ---- 6. gw (c, k) = sum_t gout_I[t] xarr(I, c, 2t+k-mh) + gout_Q[t] xarr(Q, c, .):
  // item k, both c, four fused chains split over GW lanes; kernel G then
  // updates w (the item's lanes 0 and 1) and h (one thread per parameter)
  // with AMSGrad
  {
    const int u_w = warp_round(m * GW), n_units = u_w + (ADAM ? 2 * m : 0);
    for (int uu = tid; uu < n_units; uu += nt) {
      if (uu < u_w) {
        const int k = uu / GW, lane = uu % GW;
        if (kEmu && lane != 0) continue;
        float r[4];
        group_sum<GW, 4>(lane, [&](int l, float* a) {
          float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f;  // gI.x_I, gQ.x_Q, gI.x_Q, gQ.x_I
          if (k < m) {
            const float* px0 = xb + (k & 1) * xs + (k >> 1);  // padded sample 2t + k
            const float* px1 = px0 + 2 * xs;
            for (int t = l; t < n_sym; t += GW) {
              const float gi = s.go[2 * t], gq = s.go[2 * t + 1];
              const float xv0 = px0[t], xv1 = px1[t];
              a0 = VAE_FMA(gi, xv0, a0);
              b0 = VAE_FMA(gq, xv1, b0);
              a1 = VAE_FMA(gi, xv1, a1);
              b1 = VAE_FMA(gq, xv0, b1);
            }
          }
          a[0] = a0;
          a[1] = b0;
          a[2] = a1;
          a[3] = b1;
        }, r);
        if (k < m) {
          if (owns(lane, 0)) {
            if (ADAM)
              amsgrad_one(s.w, s.mw, s.vw, s.xw, k, r[0] + r[1], io.lr, s);
            else
              io.gw[k] = r[0] + r[1];
          }
          if (owns(lane, 1)) {
            if (ADAM)
              amsgrad_one(s.w, s.mw, s.vw, s.xw, m + k, r[2] - r[3], io.lr, s);
            else
              io.gw[m + k] = r[2] - r[3];
          }
        }
      } else {
        const int i = uu - u_w;
        amsgrad_one(s.h, s.mh, s.vh, s.xh, i, s.gh[i], io.lr, s);
      }
    }
  }
  if (ADAM) copy_async_wait();
  VAE_SYNC();
  ck.mark(PH_GW);
}

// ---- kernel F's block: run r's minibatch. x (R, 2, n_samp); w (R, 1, 2, m);
// h (R, 2, m); outputs loss (R), gw (R, 1, 2, m), gh (R, 2, m),
// q (R, 2 n_lev, n_sym), out (R, 2, n_sym).
template <int NL, bool CLK>
VAE_DEV void step_block(float* smem, int tid, int nt, int r, int n_sym, int m, int n_lev,
                        const float* x, const float* w, const float* h, const float* amps,
                        const float* P, float amp_mean, float var, float* loss, float* gw,
                        float* gh, float* q, float* out, long long* clocks) {
  const Dims D = make_dims(n_sym, m, n_lev);
  const Smem s = carve(smem, make_layout(D));
  const int np = 2 * m;
  const long long pofs = (long long)r * np, oofs = (long long)r * 2 * n_sym;
  Clock<CLK> ck;
  ck.start(clocks != nullptr && r == 0 && tid == 0);
  load_consts(D, s, amps, P, var, tid, nt);
  load_x(D, s.x, x + (long long)r * 2 * D.n_samp, D.n_samp, tid, nt);
  for (int i = tid; i < np; i += nt) {
    s.w[i] = w[pofs + i];
    s.h[i] = h[pofs + i];
  }
  VAE_SYNC();
  ck.mark(PH_LOAD);
  const Io io = {loss + r, out + oofs, q + oofs * n_lev, gh + pofs, gw + pofs, 0.f};
  siso_step<NL, false, CLK>(D, s, s.x, amp_mean, var, io, tid, nt, ck);
  ck.store(clocks);
}

// ---- kernel G's block: run r trains its whole experiment. rx (R, E, 2,
// n_total); params/moments (R, 2m); losses (E n_batches, R); eval slots
// w_ev / h_ev (n_evals + 1, R, 2m): slot i < n_evals after epoch i*epe, the
// last slot after the last epoch. Minibatch k + 1 is copied into the other
// input buffer while step k runs.
template <int NL, bool CLK>
VAE_DEV void experiment_block(float* smem, int tid, int nt, int r, int R, int n_epochs,
                              int n_batches, int n_sym, int m, int n_lev, long long n_total,
                              int epe, int n_evals, const float* rx, const float* w_in,
                              const float* h_in, const float* mw_in, const float* vw_in,
                              const float* xw_in, const float* mh_in, const float* vh_in,
                              const float* xh_in, float* w_out, float* h_out, float* mw_out,
                              float* vw_out, float* xw_out, float* mh_out, float* vh_out,
                              float* xh_out, float* losses, float* w_ev, float* h_ev,
                              const float* amps, const float* P, float amp_mean, float var,
                              float lr, long long step0, long long* clocks) {
  const Dims D = make_dims(n_sym, m, n_lev);
  const Smem s = carve(smem, make_layout(D));
  const int np = 2 * m, xb4 = 4 * D.xs;
  const long long pofs = (long long)r * np;
  load_consts(D, s, amps, P, var, tid, nt);
  for (int i = tid; i < np; i += nt) {
    s.w[i] = w_in[pofs + i];
    s.h[i] = h_in[pofs + i];
    s.mw[i] = mw_in[pofs + i];
    s.vw[i] = vw_in[pofs + i];
    s.xw[i] = xw_in[pofs + i];
    s.mh[i] = mh_in[pofs + i];
    s.vh[i] = vh_in[pofs + i];
    s.xh[i] = xh_in[pofs + i];
  }
  const float* rx_r = rx + (long long)r * n_epochs * 2 * n_total;
  load_x(D, s.x, rx_r, n_total, tid, nt);
  for (int i = tid; i < xb4; i += nt) s.x[xb4 + i] = 0.f;
  const int steps = n_epochs * n_batches;
  // AMSGrad's bias corrections, once per step (the last thread: it has the
  // least FIR work), read in the step's last pass
  const int t_sc = nt - 1;
  Clock<CLK> ck;
  ck.start(clocks != nullptr && r == 0 && tid == 0);
  VAE_SYNC();
  for (int k = 0; k < steps; ++k) {
    const int e = k / n_batches, b = k - e * n_batches;
    if (k + 1 < steps) {
      const int e1 = (k + 1) / n_batches, b1 = k + 1 - e1 * n_batches;
      prefetch_x(D, s.x + ((k + 1) & 1) * xb4,
                 rx_r + (long long)e1 * 2 * n_total + (long long)b1 * D.n_samp, n_total, tid, nt);
    }
    if (tid == t_sc) {
      const double tt = (double)(step0 + k + 1);
      s.rd[RD_BC1] = 1.0 / (double)(float)(1.0 - pow(0.9, tt));
      s.rd[RD_BC2] = 1.0 / (double)(float)(1.0 - pow(0.999, tt));
    }
    ck.mark(PH_LOAD);
    const Io io = {losses + (long long)k * R + r, nullptr, nullptr, nullptr, nullptr, lr};
    siso_step<NL, true, CLK>(D, s, s.x + (k & 1) * xb4, amp_mean, var, io, tid, nt, ck);
    if (b == n_batches - 1 && e % epe == 0 && e / epe < n_evals) {
      const long long sofs = ((long long)(e / epe) * R + r) * np;
      for (int i = tid; i < np; i += nt) {
        w_ev[sofs + i] = s.w[i];
        h_ev[sofs + i] = s.h[i];
      }
    }
  }
  const long long sofs = ((long long)n_evals * R + r) * np;
  for (int i = tid; i < np; i += nt) {
    w_ev[sofs + i] = s.w[i];
    h_ev[sofs + i] = s.h[i];
    w_out[pofs + i] = s.w[i];
    h_out[pofs + i] = s.h[i];
    mw_out[pofs + i] = s.mw[i];
    vw_out[pofs + i] = s.vw[i];
    xw_out[pofs + i] = s.xw[i];
    mh_out[pofs + i] = s.mh[i];
    vh_out[pofs + i] = s.vh[i];
    xh_out[pofs + i] = s.xh[i];
  }
  ck.store(clocks);
}

}  // namespace siso
