// One DP VAE minibatch step (butterfly -> PCS softmin demapper -> DP ELBO ->
// closed-form backward), shared by kernel A (one step) and kernel B (a whole
// frame of steps with Adam), for NVIDIA Hopper (sm_90a).
//
// Replaces the per-step body of the TPU kernels
// vae_equalizer_tpu/ops/elbo_kernel.py:_kernel and ops/frame_kernel.py:_kernel;
// the math is the closed form of vae_equalizer_tpu/ops/elbo_vjp.py, and the
// plain PyTorch version is vae_equalizer_tpu_torch/ops/elbo_kernel.py:
// dp_step_plain. Index conventions below follow that file.
//
// What bounds a step: not bytes or FLOPs (a step is ~0.2 MFLOP on a ~50 KB
// working set) but the chain of dependent phases, each as long as its
// slowest warp, on one SM per run. Measured per phase with clock64()
// (frame_block's `clocks`, PERF.md), the first design (256 threads, a
// serial sum per thread, branchy input reads, an 8-barrier tree, the level
// arrays in local memory) spent its time in the demapper and dL/dout level
// loops, and so, later, did the second (level loops through shared memory,
// a double-precision correction per division). This design, one block of
// 512 threads (dp_kernels.cu) per run:
//   * Every intermediate lives in shared memory. The input window is held
//     zero-padded (mh zeros each side of each of the 4 rows), so the
//     butterfly's inner loops read x at 2t + k with no bounds test; the sign
//     of the arrangement (models/vae_le.py: _arrangements) multiplies the
//     tap (exact).
//   * Every dot product is one fused multiply-add chain in the plain
//     version's contraction order (the butterfly's (i, k), the conv bank's
//     (nu, I/Q, flipped tap), t for gw, n for gh, (chi, tap) for dL/dE[x]),
//     so the rounding stays that of the plain version's matrix products:
//     sums split over lanes, tried first, were more exact but left the
//     float32 plain version by up to 3x chip_smoke's moment tolerance.
//     Items share their loads: the butterfly runs both outputs per (comp,
//     t), gw both outputs and components per (i, k) on one 16-byte load of
//     dL/dout per t, gh re and im per (chi, nu, j) on 8-byte loads of dL/dD
//     and E_q[x] (whence the (.., 2) layouts of u, eq and gout).
//   * The level count is a template parameter: in the instance for 8 levels
//     (64-QAM) an item's per-level values stay in registers and its level
//     loops unroll into straight-line code; the demapper writes each q row
//     to shared memory once, for dL/dout (and kernel A's output). The
//     generic instance (any n_lev up to MAX_LEV) loops over n_lev through
//     the item's q and kq rows (LevRow), with the same arithmetic.
//   * No division in the level loops: each is a multiply by the divisor's
//     reciprocal in double (fdiv: the same float as the IEEE division, with
//     no branch), the reciprocal taken once per block, item or level, and
//     the metric's division by 2 var is Markstein's float correction (the
//     same float too). Adam divides by its per-step bias corrections with
//     div_exact (a reciprocal and one exact correction in double).
//   * dL/dout takes one (pol, t) per thread, both components: each load of
//     dL/dD and of h feeds four fused chains and the gVar window is summed
//     once.
//   * Phases that do not depend on each other share a barrier: D, the
//     E-term window totals S and the C partials; gw and gh. dL/dD is kept
//     unscaled (u = 2 D - 2 rx) and its per-chi scale n_eff / C multiplies
//     each term where it is read, as in the plain version's g_c (2 D - 2 rx).
//   * C and the KL close with per-warp shuffle partials and one warp, which
//     also forms gVar's per-tap terms.
//   * Kernel B issues the next window's loads from device memory at the
//     start of a step and stores them after gw (latency hidden), and one
//     thread computes Adam's bias corrections and the lr halving per step.
// Seven barriers per step. Sums are in a fixed order (in-thread chains, a
// fixed lane split for S, fixed shuffle trees) and there are no atomics, so
// a run repeats bit for bit, and a block's result does not depend on the
// other blocks. The demapper, KL, C, the scalars and Adam keep the plain
// version's elementwise operations (the library is built with --fmad=false,
// ops/_build.py; the dot products' fused multiply-adds are explicit).
//
// The body also compiles as plain C++ (VAE_HOST_EMULATION), where one "thread"
// (tid 0, nt 1) runs every item of every phase in order, a warp is one lane
// and a barrier is a no-op; that is how its arithmetic is checked against
// the plain version without a GPU (csrc/dp_host_emulation.cpp).
#pragma once

#include "portable.cuh"

namespace dp {

using namespace vae;  // bf16 and put(): kernel B's out / dec / eq streams

// Vector loads from shared memory (the arrays read so lie at multiples of 4
// words, make_layout)
VAE_DEV float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
VAE_DEV float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

constexpr int MAX_LEV = 16;       // up to 256-QAM (16 levels per dimension)
constexpr float EPS_KL = 1e-12f;  // KL log guard (elbo_dp's eps)
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_EPS = 1e-8f;

// A warp, and the lanes that share one item's sum: G on the card, 1 in
// emulation (the one "thread" runs every term). Kept here, not in
// portable.cuh: cma, dfe and siso emulate the card's lanes instead.
#ifdef VAE_HOST_EMULATION
constexpr int kWarp = 1;
template <int G>
inline float group_sum(float v) {
  return v;
}
#else
constexpr int kWarp = 32;
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
#endif
template <int G>
VAE_HD constexpr int lanes() {
  return G < kWarp ? G : kWarp;
}
VAE_HD int warp_round(int n) { return (n + kWarp - 1) / kWarp * kWarp; }

// Phase clocks of kernel B: block 0's thread 0 adds the clock64() cycles of
// each phase of each step (from the previous mark to the barrier that ends the
// phase) into c[phase]; the launcher's `clocks` receives them summed over the
// frame (ops/frame_kernel.py: CLOCK_PHASES names them). With on false every
// mark is one untaken branch (kept per kernel: cma, dfe and siso compile
// their clocks in per CLK instead).
enum Phase { PH_FORWARD, PH_DEMAP, PH_DSC, PH_SCALARS, PH_BACK, PH_GW, PH_ADAM, N_PHASES };
struct Clock {
  bool on;
  long long t, c[N_PHASES];
};
VAE_DEV void clk_start(Clock& k) {
  if (k.on) k.t = VAE_CLOCK();
}
VAE_DEV void clk_mark(Clock& k, int ph) {
  if (k.on) {
    const long long now = VAE_CLOCK();
    k.c[ph] += now - k.t;
    k.t = now;
  }
}

// Shapes of one minibatch: n_sym symbols, n_samp = 2 n_sym samples (sps 2),
// m taps (odd), mh = m / 2, mh2 = 2 mh = m - 1, n_eff = n_samp - mh2; the
// padded input rows are xs >= n_samp + mh2 floats apart (xs = 16 mod 32, so
// the rows that one warp reads at one sample start in other banks).
struct Dims {
  int n_sym, m, n_lev, n_samp, mh, mh2, n_eff, xs;
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
  d.xs = (d.n_samp + d.mh2 + 15) / 32 * 32 + 16;
  return d;
}

// Shared-memory layout in 4-byte words.
//   x    (4, xs)            rows pol*2 + I/Q of the minibatch input, sample s
//                           at x[row * xs + mh + s], zero outside [0, n_samp)
//   w gw mw vw (2, 4, m)    butterfly taps, gradient, Adam moments
//   h gh mh vh (2, 2, 2, m) channel estimate (chi, nu, re/im, j), ...
//   out v mm s1 dec (2, 2, n_sym)   (pol, I/Q, t)
//   eq   (2, n_sym, 2)      E_q[x] (pol, t, I/Q)
//   gout (n_sym, 2, 2)      dL/dout (t, pol, I/Q)
//   q kq (2, 2, n_lev, n_sym)  posteriors; at inner t the KL's gradient term
//                           log(r + eps) + r / (r + eps), r = q / P (for gout;
//                           the generic instance's dL/dq, then)
//   u    (2, n_eff, 2)      2 D - 2 rx_w (chi, n, re/im); dL/dD = (n_eff / C_chi) u
//   S gvt (2, m)            E-term window totals S[nu, j]; sum_chi gC_chi |h[chi, nu, j]|^2
//   rd   (MAX_LEV + 8 doubles)  reciprocals: 1 / P per level, then
//                           1 / (2 var_x), 1 / (2 var_y), 1 / var_x,
//                           1 / var_y, 1 / bc1, 1 / bc2 (Adam, per step)
//   amps a2 nua2 P (n_lev)  level constants
//   vc (4)                  2 var_x, 2 var_y and their float reciprocals
//   red  (nwarps, 3)        per-warp C_x, C_y, KL partials
//   sc (8)                  step scalars: loss, C_x, C_y, n_eff / C_x, n_eff / C_y,
//                           Adam's bias corrections bc1, bc2 and w's lr
struct Layout {
  int x, w, gw, mw, vw, h, gh, mh, vh, out, eq, v, mm, s1, dec, gout, q, kq, u, S, gvt;
  int rd, amps, a2, nua2, P, vc, red, sc, total;
};

VAE_HD Layout make_layout(const Dims& D, int nt) {
  Layout L;
  int o = 0;
  const int n4 = 4 * D.n_sym, wm = 8 * D.m;
  L.rd = o; o += 2 * (MAX_LEV + 8);  // first: 8-byte aligned
  L.x = o; o += 4 * D.xs;
  L.w = o; o += wm;
  L.gw = o; o += wm;
  L.mw = o; o += wm;
  L.vw = o; o += wm;
  L.h = o; o += wm;
  L.gh = o; o += wm;
  L.mh = o; o += wm;
  L.vh = o; o += wm;
  L.out = o; o += n4;
  L.eq = o; o += n4;
  L.v = o; o += n4;
  L.mm = o; o += n4;
  L.s1 = o; o += n4;
  L.dec = o; o += n4;
  L.gout = o; o += n4;
  L.q = o; o += n4 * D.n_lev;
  L.kq = o; o += n4 * D.n_lev;
  L.u = o; o += 4 * D.n_eff;
  L.S = o; o += 2 * D.m;
  L.gvt = o; o += 2 * D.m;
  L.amps = o; o += D.n_lev;
  L.a2 = o; o += D.n_lev;
  L.nua2 = o; o += D.n_lev;
  L.P = o; o += D.n_lev;
  L.vc = o; o += 4;
  L.red = o; o += 3 * ((nt + kWarp - 1) / kWarp);
  L.sc = o; o += 8;
  L.total = o;
  return L;
}

struct Smem {
  float *x, *w, *gw, *mw, *vw, *h, *gh, *mh, *vh, *out, *eq, *v, *mm, *s1, *gout, *q, *kq, *u, *S, *gvt,
      *amps, *a2, *nua2, *P, *vc, *red, *sc;
  int* dec;
  double* rd;
};

VAE_DEV Smem carve(float* base, const Layout& L) {
  Smem s;
  s.x = base + L.x;
  s.w = base + L.w;
  s.gw = base + L.gw;
  s.mw = base + L.mw;
  s.vw = base + L.vw;
  s.h = base + L.h;
  s.gh = base + L.gh;
  s.mh = base + L.mh;
  s.vh = base + L.vh;
  s.out = base + L.out;
  s.eq = base + L.eq;
  s.v = base + L.v;
  s.mm = base + L.mm;
  s.s1 = base + L.s1;
  s.dec = reinterpret_cast<int*>(base + L.dec);
  s.gout = base + L.gout;
  s.q = base + L.q;
  s.kq = base + L.kq;
  s.u = base + L.u;
  s.S = base + L.S;
  s.gvt = base + L.gvt;
  s.amps = base + L.amps;
  s.a2 = base + L.a2;
  s.nua2 = base + L.nua2;
  s.P = base + L.P;
  s.rd = reinterpret_cast<double*>(base + L.rd);
  s.vc = base + L.vc;
  s.red = base + L.red;
  s.sc = base + L.sc;
  return s;
}

// Level constants: amps, a^2, nu_sc a^2, the prior P and 1 / P; 2 var and
// 1 / (2 var) per pol, in double and rounded to float; computed once.
VAE_DEV void load_consts(const Dims& D, const Smem& s, const float* amps, const float* P,
                         float nu_sc, float var0, float var1, int tid, int nt) {
  for (int l = tid; l < D.n_lev; l += nt) {
    const float a = amps[l];
    s.amps[l] = a;
    s.a2[l] = a * a;
    s.nua2[l] = nu_sc * (a * a);
    s.P[l] = P[l];
    s.rd[l] = 1.0 / (double)P[l];
  }
  if (tid == 0) {
    s.vc[0] = 2.f * var0;
    s.vc[1] = 2.f * var1;
    s.vc[2] = 1.f / s.vc[0];
    s.vc[3] = 1.f / s.vc[1];
    s.rd[MAX_LEV + 0] = 1.0 / (double)s.vc[0];
    s.rd[MAX_LEV + 1] = 1.0 / (double)s.vc[1];
    s.rd[MAX_LEV + 2] = 1.0 / (double)var0;
    s.rd[MAX_LEV + 3] = 1.0 / (double)var1;
  }
}

// The padded input rows: zeros everywhere (once per block; the window loads
// only ever write [mh, mh + n_samp) of each row), then 4 rows of n_samp
// samples from x, row stride `stride`.
VAE_DEV void zero_x(const Dims& D, const Smem& s, int tid, int nt) {
  for (int i = tid; i < 4 * D.xs; i += nt) s.x[i] = 0.f;
}
VAE_DEV void load_x(const Dims& D, const Smem& s, const float* x, long long stride, int tid,
                    int nt) {
  for (int i = tid; i < 4 * D.n_samp; i += nt) {
    const int r = i / D.n_samp, k = i - r * D.n_samp;
    s.x[r * D.xs + D.mh + k] = x[r * stride + k];
  }
}

// The signed butterfly input arrangement (models/vae_le.py: _arrangements):
// comp 0 (I) rows (x_I, y_I, -x_Q, -y_Q), comp 1 (Q) rows (x_Q, y_Q, x_I, y_I).
// Input i of component comp reads padded row xrow(comp, i) with sign
// xsign(comp, i); sample smp of it sits at that row's index smp + mh.
VAE_HD int xrow(int comp, int i) { return (i & 1) * 2 + ((i >> 1) ^ comp); }
VAE_HD float xsign(int comp, int i) { return (comp == 0 && i >= 2) ? -1.f : 1.f; }

// a / b for any float a and a float b > 0, to the same float as the IEEE
// division, from y = 1 / b taken in double once per block or step: the
// residual correction in double gives the double quotient exactly
// (Markstein; no double underflows for float operands), and rounding it to
// float gives the float quotient (53 >= 2 * 24 + 2); held against division
// on 1e9 pairs, denormal dividends included, none differing. Why: on the
// card a float division is a guarded fast path plus a software path for
// tiny or zero dividends; this has no branch. b is passed in double (a
// float's exact value) so callers convert a divisor shared by many
// divisions once. Adam's divisions by its bias corrections.
VAE_DEV float div_exact(float a, double b, double y) {
  const double ad = a, q = ad * y;
  return (float)VAE_DFMA(VAE_DFMA(-q, b, ad), y, q);
}

// a / b for float a and float b > 0, to the same float as the IEEE division,
// as (float)(a * y) in double with y within a few double ulps of 1 / b: a
// float quotient lies at least 2^-49 (relative) from every midpoint of the
// float grid, and a * y is within 2^-50 of it, so rounding to float gives
// the correctly rounded quotient (held against division on 10^7 pairs, zero
// and denormal dividends included, with y off by up to 4 ulps, and on 10^7
// pairs of the demapper's operands: tests/test_torch_dp_step_emulation.py).
// One multiply and two conversions, where div_exact adds two dependent
// double fused multiply-adds: the level loops' divisions.
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

// x / v for x = 0 or x >= 2^-100 and a normal v, to the same float as the
// IEEE division: Markstein's float correction of x * yv, yv = RN(1 / v)
// (held on 10^7 pairs in tests/test_torch_dp_step_emulation.py; the
// metric's nonzero (out - a)^2 is far above 2^-100). Three float operations.
VAE_DEV float mdiv(float x, float v, float yv) {
  const float q0 = x * yv;
  return VAE_FMA(VAE_FMA(-q0, v, x), yv, q0);
}

// An item's per-level values between its level loops: registers in the
// NL-level instance, whose loops (bound NL) unroll, and the item's own row in
// shared memory (level l at row[l * stride]) in the generic one (NL 0),
// whose loops (bound n_lev) do not.
template <int NL>
struct LevRow {
  float v[NL];
  VAE_DEV LevRow(float*, int) {}
  VAE_DEV float& operator[](int l) { return v[l]; }
};
template <>
struct LevRow<0> {
  float* row;
  int stride;
  VAE_DEV LevRow(float* r, int st) : row(r), stride(st) {}
  VAE_DEV float& operator[](int l) { return row[l * stride]; }
};

// The step, for NL levels (8), or any n_lev up to MAX_LEV (NL 0). Reads s.x,
// s.w, s.h and the level constants; leaves out, q, eq, v, mm, s1, dec, u, S,
// gout, gw, gh in shared memory and the scalars sc = [loss, C_x, C_y, gC_x,
// gC_y] (C is var_est * n_eff). Ends with a barrier.
template <int NL>
VAE_DEV void dp_step(const Dims& D, const Smem& s, int tid, int nt, Clock& ck) {
  const int n_sym = D.n_sym, m = D.m, n_lev = NL ? NL : D.n_lev, n_samp = D.n_samp;
  const int mh = D.mh, mh2 = D.mh2, n_eff = D.n_eff, xs = D.xs;

  // ---- forward butterfly: out[o, comp, t] = sum_{i,k} w[o,i,k] xarr(comp, i, 2t + k - mh),
  // each output one fused chain in the plain version's contraction order
  // (i, then k); item (comp, t) runs both o on the same loads of x
  for (int it = tid; it < 2 * n_sym; it += nt) {
    const int comp = it / n_sym, t = it - comp * n_sym;
    float p0 = 0.f, p1 = 0.f;
    for (int i = 0; i < 4; ++i) {
      const float* xr = s.x + xrow(comp, i) * xs + 2 * t;
      const float* w0 = s.w + i * m;
      const float* w1 = s.w + (4 + i) * m;
      const float sg = xsign(comp, i);
      for (int k = 0; k < m; ++k) {
        const float xv = xr[k];
        p0 = VAE_FMA(sg * w0[k], xv, p0);
        p1 = VAE_FMA(sg * w1[k], xv, p1);
      }
    }
    s.out[comp * n_sym + t] = p0;
    s.out[(2 + comp) * n_sym + t] = p1;
  }
  VAE_SYNC();
  clk_mark(ck, PH_FORWARD);

  // ---- demapper per (pol, comp, t): met -> mm, s1, q, argmax, moments, KL.
  // The per-level values pass from loop to loop in e (met, then exp), the
  // q row is written once, and at inner t the KL's gradient term.
  float kl_part = 0.f;
  for (int it = tid; it < 4 * n_sym; it += nt) {
    const int t = it % n_sym, p = (it / n_sym) >> 1;
    const float o = s.out[it];
    const float two_var = s.vc[p], y_two_var = s.vc[2 + p];
    float* qrow = s.q + (it / n_sym) * n_lev * n_sym + t;
    float* kqrow = s.kq + (it / n_sym) * n_lev * n_sym + t;
    LevRow<NL> e(qrow, n_sym);
    float mmv = 0.f;
#pragma unroll(NL ? NL : 1)
    for (int l = 0; l < n_lev; ++l) {
      const float dd = o - s.amps[l];
      e[l] = mdiv(dd * dd, two_var, y_two_var) + s.nua2[l];
      mmv = l == 0 ? e[l] : fminf(mmv, e[l]);
    }
    float s1v = 0.f;
#pragma unroll(NL ? NL : 1)
    for (int l = 0; l < n_lev; ++l) {
      e[l] = expf(mmv - e[l]);
      s1v += e[l];
    }
    const bool inner = t >= mh && t < n_sym - mh;
    const double r_s1 = recip((double)s1v);
    float eqv = 0.f, eq2v = 0.f, qbest = -1.f;
    int best = 0;
#pragma unroll(NL ? NL : 1)
    for (int l = 0; l < n_lev; ++l) {
      const float ql = fdiv(e[l], r_s1);
      qrow[l * n_sym] = ql;
      if (ql > qbest) {  // first maximum, as torch.argmax / jnp.argmax
        qbest = ql;
        best = l;
      }
      eqv += ql * s.amps[l];
      eq2v += ql * s.a2[l];
      if (inner) {
        const float r = fdiv(ql, s.rd[l]), rpe = r + EPS_KL, lg = logf(rpe);
        kl_part += -ql * lg;
        kqrow[l * n_sym] = lg + fdiv(r, recip((double)rpe));
      }
    }
    s.mm[it] = mmv;
    s.s1[it] = s1v;
    s.dec[it] = best;
    s.eq[((it / n_sym >> 1) * n_sym + t) * 2 + (it / n_sym & 1)] = eqv;
    s.v[it] = eq2v - eqv * eqv;
  }
  VAE_SYNC();
  clk_mark(ck, PH_DEMAP);

  // ---- one pass, two kinds of work (warp-aligned, so the shuffles of the
  // second see whole warps): D (chi, n) both re/im with u = 2 D - 2 rx_w and
  // this thread's C partials; the E-term window totals S[nu, j], split over
  // lanes; then per-warp partials of C_x, C_y and the KL
  float c0 = 0.f, c1 = 0.f;
  {
    constexpr int G = lanes<2>();
    const int n_d = 2 * n_eff, u_d = warp_round(n_d), n_units = u_d + 2 * m * G;
    for (int u0 = 0; u0 < n_units; u0 += nt) {
      const int uu = u0 + tid;
      if (uu < u_d) {
        if (uu < n_d) {
          const int chi = uu / n_eff, n = uu - chi * n_eff;
          // the plain version's 'valid' conv bank (models/losses.py: conv_bank):
          // inputs (nu, I/Q) in turn, flipped taps jf = mh2 - j ascending;
          // EqUp is zero at odd samples n + jf
          float dr = 0.f, di = 0.f;
          for (int nc = 0; nc < 4; ++nc) {
            const int nu = nc >> 1, c = nc & 1;
            const float* hr = s.h + ((chi * 2 + nu) * 2 + 0) * m;
            const float* hi = hr + m;
            const float* e = s.eq + nu * n_sym * 2 + c;
            const float* cr = c == 0 ? hr : hi;  // re row: (hr, -hi); im row: (hi, hr)
            const float* ci = c == 0 ? hi : hr;
            const float sr = c == 0 ? 1.f : -1.f;
            for (int jf = n & 1; jf <= mh2; jf += 2) {
              const float ev = e[(n + jf) & ~1];  // t = (n + jf) / 2
              dr = VAE_FMA(sr * cr[mh2 - jf], ev, dr);
              di = VAE_FMA(ci[mh2 - jf], ev, di);
            }
          }
          const float rr = s.x[(chi * 2 + 0) * xs + mh2 + n], ri = s.x[(chi * 2 + 1) * xs + mh2 + n];
          const float er = rr - dr, ei2 = ri - di;
          const float c = er * er + ei2 * ei2;
          if (chi == 0)
            c0 += c;
          else
            c1 += c;
          s.u[(chi * n_eff + n) * 2 + 0] = 2.f * dr - 2.f * rr;
          s.u[(chi * n_eff + n) * 2 + 1] = 2.f * di - 2.f * ri;
        }
      } else {
        const int it = (uu - u_d) / G, lane = (uu - u_d) % G;
        float acc = 0.f;
        if (it < 2 * m) {
          const int nu = it / m, j = it - nu * m;
          const float* v0 = s.v + (nu * 2 + 0) * n_sym;
          const float* v1 = v0 + n_sym;
          // samples smp in [mh2 - j, n_samp - j), even: symbols t = smp / 2
          const int t0 = (mh2 - j + 1) >> 1, t1 = (n_samp - j + 1) >> 1;
          for (int t = t0 + lane; t < t1; t += G) acc += v0[t] + v1[t];
        }
        acc = group_sum<G>(acc);
        if (it < 2 * m && lane == 0) s.S[it] = acc;
      }
    }
  }
  c0 = group_sum<kWarp>(c0);
  c1 = group_sum<kWarp>(c1);
  kl_part = group_sum<kWarp>(kl_part);
  if (tid % kWarp == 0) {
    float* r = s.red + 3 * (tid / kWarp);
    r[0] = c0;
    r[1] = c1;
    r[2] = kl_part;
  }
  VAE_SYNC();
  clk_mark(ck, PH_DSC);

  // ---- one warp: the block totals in a fixed order, the E term, the scalars
  if (tid < kWarp) {
    const int n_warps = (nt + kWarp - 1) / kWarp;
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, e0 = 0.f, e1 = 0.f;
    for (int wp = tid; wp < n_warps; wp += kWarp) {
      t0 += s.red[3 * wp];
      t1 += s.red[3 * wp + 1];
      t2 += s.red[3 * wp + 2];
    }
    for (int q = tid; q < 2 * m; q += kWarp) {
      const int nu = q / m, j = q - nu * m;
      const float sj = s.S[q];
      const float* h0 = s.h + ((0 * 2 + nu) * 2) * m;
      const float* h1 = s.h + ((1 * 2 + nu) * 2) * m;
      e0 += (h0[j] * h0[j] + h0[m + j] * h0[m + j]) * sj;
      e1 += (h1[j] * h1[j] + h1[m + j] * h1[m + j]) * sj;
    }
    t0 = group_sum<kWarp>(t0);
    t1 = group_sum<kWarp>(t1);
    t2 = group_sum<kWarp>(t2);
    e0 = group_sum<kWarp>(e0);
    e1 = group_sum<kWarp>(e1);
    const float ne = (float)n_eff;
    const float C0 = t0 + e0, C1 = t1 + e1, g0 = ne / C0, g1 = ne / C1;
    if (tid == 0) {
      s.sc[0] = ne * (logf(C0) + logf(C1)) - t2;
      s.sc[1] = C0;
      s.sc[2] = C1;
      s.sc[3] = g0;
      s.sc[4] = g1;
    }
    // gVar's per-tap terms (gout sums them over its tap window)
    for (int q = tid; q < 2 * m; q += kWarp) {
      const int nu = q / m, j = q - nu * m;
      const float* h0 = s.h + ((0 * 2 + nu) * 2) * m;
      const float* h1 = s.h + ((1 * 2 + nu) * 2) * m;
      const float a0 = h0[j] * h0[j] + h0[m + j] * h0[m + j];
      const float a1 = h1[j] * h1[j] + h1[m + j] * h1[m + j];
      s.gvt[q] = VAE_FMA(g1, a1, g0 * a0);
    }
  }
  VAE_SYNC();
  clk_mark(ck, PH_SCALARS);

  // ================= backward (dL/dloss = 1; dL/dD = sc[3 + chi] u) =================
  // ---- dL/dout per (pol, t), both components: gEqUp and gVar at sample 2t
  // -> gq -> softmin VJP
  for (int it = tid; it < 2 * n_sym; it += nt) {
    const int t = it % n_sym, nu = it / n_sym, ps = 2 * t;
    // taps j with D's sample n = ps + j - mh2 in [0, n_eff)
    const int jlo = ps < mh2 ? mh2 - ps : 0, jhi = n_samp - ps < m ? n_samp - ps : m;
    // gEqUp: the plain version's contraction over (chi, j) of dL/dD's tap
    // windows with hr and with hi, two fused chains per component, four on
    // each load; c = 0: u_re hr + u_im hi, c = 1: u_im hr - u_re hi
    float ch1[2] = {0.f, 0.f}, ch2[2] = {0.f, 0.f};
    for (int chi = 0; chi < 2; ++chi) {
      const float gc = s.sc[3 + chi];
      const float* uc = s.u + chi * n_eff * 2;
      const float* hr = s.h + ((chi * 2 + nu) * 2 + 0) * m;
      const float* hi = hr + m;
      for (int j = jlo; j < jhi; ++j) {
        const float2 uv = ld2(uc + 2 * (ps + j - mh2));
        const float g_re = gc * uv.x, g_im = gc * uv.y, hrj = hr[j], hij = hi[j];
        ch1[0] = VAE_FMA(g_re, hrj, ch1[0]);
        ch2[0] = VAE_FMA(g_im, hij, ch2[0]);
        ch1[1] = VAE_FMA(g_im, hrj, ch1[1]);
        ch2[1] = VAE_FMA(g_re, hij, ch2[1]);
      }
    }
    // gVar: sum over the tap window of sum_chi gC_chi |h[chi, nu, j]|^2
    float gv = 0.f;
    for (int j = jlo; j < jhi; ++j) gv += s.gvt[nu * m + j];
    const float2 eqt = ld2(s.eq + (nu * n_sym + t) * 2);
    const bool inner = t >= mh && t < n_sym - mh;
    const double r_var = s.rd[MAX_LEV + 2 + nu];
    // per component c (pc = 2 nu + c), both in each level's step: q and
    // dL/dq in registers, or (generic) the q row and the kq row, where dL/dq
    // overwrites the KL term that it adds at inner t
    float* qrow[2] = {s.q + 2 * nu * n_lev * n_sym + t, s.q + (2 * nu + 1) * n_lev * n_sym + t};
    float* kqrow[2] = {s.kq + 2 * nu * n_lev * n_sym + t, s.kq + (2 * nu + 1) * n_lev * n_sym + t};
    LevRow<NL> ql[2] = {LevRow<NL>(qrow[0], n_sym), LevRow<NL>(qrow[1], n_sym)};
    LevRow<NL> g[2] = {LevRow<NL>(kqrow[0], n_sym), LevRow<NL>(kqrow[1], n_sym)};
    const float geq[2] = {(ch1[0] + ch2[0]) - 2.f * eqt.x * gv, (ch1[1] + -ch2[1]) - 2.f * eqt.y * gv};
    float inner_sum[2] = {0.f, 0.f};
#pragma unroll(NL ? NL : 1)
    for (int l = 0; l < n_lev; ++l) {
      const float al = s.amps[l], a2l = s.a2[l];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if constexpr (NL > 0) ql[c][l] = qrow[c][l * n_sym];
        const float gl = al * geq[c] + a2l * gv;
        g[c][l] = inner ? gl + kqrow[c][l * n_sym] : gl;
        inner_sum[c] += ql[c][l] * g[c][l];
      }
    }
    const float o[2] = {s.out[2 * nu * n_sym + t], s.out[(2 * nu + 1) * n_sym + t]};
    float acc[2] = {0.f, 0.f};
#pragma unroll(NL ? NL : 1)
    for (int l = 0; l < n_lev; ++l) {
      const float al = s.amps[l];
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[c] += (-ql[c][l] * (g[c][l] - inner_sum[c])) * (o[c] - al);
    }
    const float go[2] = {fdiv(acc[0], r_var), fdiv(acc[1], r_var)};
    *reinterpret_cast<float2*>(s.gout + t * 4 + 2 * nu) = float2{go[0], go[1]};
  }
  VAE_SYNC();
  clk_mark(ck, PH_BACK);

  // ---- gw and gh in one pass, each item four fused chains in the plain
  // version's contraction order, sharing their loads:
  // gw (o, i, k) = sum_t gout_I[o,t] xarr(I,i,2t+k-mh) + sum_t gout_Q[o,t] xarr(Q,i,.),
  //   item (i, k), both o;
  // gh (chi, nu, re/im, j): correlation of dL/dD with EqUp + the E term,
  //   item (chi, nu, j): re = g_re . eq_I + g_im . eq_Q, im = g_im . eq_I - g_re . eq_Q
  for (int it = tid; it < 8 * m; it += nt) {
    if (it < 4 * m) {
      const int k = it % m, i = it / m;
      const float* x0 = s.x + xrow(0, i) * xs + k;
      const float* x1 = s.x + xrow(1, i) * xs + k;
      float a0 = 0.f, b0 = 0.f, a1 = 0.f, b1 = 0.f;  // (o, comp I / Q)
      for (int t = 0; t < n_sym; ++t) {
        const float4 g = ld4(s.gout + 4 * t);  // (o 0 I, o 0 Q, o 1 I, o 1 Q)
        const float xv0 = x0[2 * t], xv1 = x1[2 * t];
        a0 = VAE_FMA(g.x, xv0, a0);
        b0 = VAE_FMA(g.y, xv1, b0);
        a1 = VAE_FMA(g.z, xv0, a1);
        b1 = VAE_FMA(g.w, xv1, b1);
      }
      const float sg0 = xsign(0, i), sg1 = xsign(1, i);
      s.gw[i * m + k] = sg0 * a0 + sg1 * b0;
      s.gw[(4 + i) * m + k] = sg0 * a1 + sg1 * b1;
    } else {
      const int g = it - 4 * m, j = g % m, cn = g / m, nu = cn & 1, chi = cn >> 1;
      const float gc = s.sc[3 + chi];
      const float* uc = s.u + chi * n_eff * 2;
      const float* e = s.eq + nu * n_sym * 2;
      float ar = 0.f, br = 0.f, ai = 0.f, bi = 0.f;
      for (int n = j & 1; n < n_eff; n += 2) {  // n + mh2 - j even: t = (n + mh2 - j) / 2
        const float2 uv = ld2(uc + 2 * n), ev = ld2(e + n + mh2 - j);
        const float g_re = gc * uv.x, g_im = gc * uv.y;
        ar = VAE_FMA(g_re, ev.x, ar);
        br = VAE_FMA(g_im, ev.y, br);
        ai = VAE_FMA(g_im, ev.x, ai);
        bi = VAE_FMA(g_re, ev.y, bi);
      }
      const int o = ((chi * 2 + nu) * 2) * m + j;
      const float sj = s.S[nu * m + j];
      s.gh[o] = (ar + br) + 2.f * gc * s.h[o] * sj;
      s.gh[o + m] = (ai + -bi) + 2.f * gc * s.h[o + m] * sj;
    }
  }
  VAE_SYNC();
  clk_mark(ck, PH_GW);
}

// One Adam update (optax.adam: b1 .9, b2 .999, eps 1e-8 outside the sqrt,
// bias correction with t = step + 1) of w (lr_w) and h (lr_h), one parameter
// per thread, op for op as the plain version's f32 tensor expression.
VAE_DEV void adam(const Smem& s, int np, float lr_w, float lr_h, float bc1, float bc2, int tid,
                  int nt) {
  const double bc1d = bc1, bc2d = bc2, rbc1 = s.rd[MAX_LEV + 4], rbc2 = s.rd[MAX_LEV + 5];
  const float omb1 = (float)(1.0 - 0.9), omb2 = (float)(1.0 - 0.999);
  for (int k = tid; k < 2 * np; k += nt) {
    const bool is_w = k < np;
    const int i = is_w ? k : k - np;
    float* p = is_w ? s.w : s.h;
    float* mo = is_w ? s.mw : s.mh;
    float* ve = is_w ? s.vw : s.vh;
    const float gi = (is_w ? s.gw : s.gh)[i], lr = is_w ? lr_w : lr_h;
    const float mi = ADAM_B1 * mo[i] + omb1 * gi;
    const float vi = ADAM_B2 * ve[i] + (omb2 * gi) * gi;
    mo[i] = mi;
    ve[i] = vi;
    p[i] = p[i] - lr * (div_exact(mi, bc1d, rbc1) / (sqrtf(div_exact(vi, bc2d, rbc2)) + ADAM_EPS));
  }
}

// ---- kernel A's block: one run's minibatch, outputs in the JAX contract
// layout. x's 4 rows (pol*2 + I/Q) lie x_row floats apart, so the block reads
// a window of a longer frame row in place. NL: dp_step's.
template <int NL>
VAE_DEV void step_block(float* smem, int tid, int nt, const float* x, long long x_row,
                        const float* w, const float* h, const float* amps, const float* P,
                        const float* var, float nu_sc, int n_sym, int m, int n_lev, float* stats,
                        float* gw, float* gh, float* q, float* out) {
  const Dims D = make_dims(n_sym, m, n_lev);
  const float var0 = var[0], var1 = var[1];
  const Layout L = make_layout(D, nt);
  const Smem s = carve(smem, L);
  load_consts(D, s, amps, P, nu_sc, var0, var1, tid, nt);
  zero_x(D, s, tid, nt);
  for (int i = tid; i < 8 * m; i += nt) {
    s.w[i] = w[i];
    s.h[i] = h[i];
  }
  VAE_SYNC();
  load_x(D, s, x, x_row, tid, nt);
  VAE_SYNC();
  Clock ck;
  ck.on = false;
  dp_step<NL>(D, s, tid, nt, ck);
  if (tid == 0) {
    stats[0] = s.sc[0];
    stats[1] = s.sc[1] / (float)D.n_eff;
    stats[2] = s.sc[2] / (float)D.n_eff;
  }
  for (int i = tid; i < 8 * m; i += nt) {
    gw[i] = s.gw[i];
    gh[i] = s.gh[i];
  }
  for (int i = tid; i < 4 * n_sym; i += nt) out[i] = s.out[i];
  for (int i = tid; i < 4 * n_lev * n_sym; i += nt) q[i] = s.q[i];
}

// ---- kernel B's block: run r trains all m_max minibatches of its frame.
// Minibatch mb is the window of n_sym symbols starting at symbol
// mb * stride_sym (stride_sym = n_sym: back to back; smaller: VAEflex's
// overlapping windows). rx (R, 2, 2, n_total); params/moments (R, 8m);
// per-run constants P (R, n_lev), var (R, 2), nu_sc (R,), lr (R,): run r
// reads its own row (the wrapper broadcasts scalar inputs into these);
// streams per (mb, r): losses (m_max, R), var_est (m_max, R, 2),
// out/dec/mm/s1 (m_max, R, 2, 2, n_sym), eq (m_max, R, 2, n_sym) = E_q[x^I],
// out/dec/eq stored as SF/SD (float/int, or bf16 for all three). NL: dp_step's.
// Window mb + 1 is loaded into registers (N_PREFETCH per thread, the rest
// after gw) while step mb runs and stored into s.x after gw.
constexpr int N_PREFETCH = 4;

template <int NL, typename SF, typename SD>
VAE_DEV void frame_block(float* smem, int tid, int nt, int r, int R, int m_max, int n_sym,
                         int stride_sym, int m, int n_lev, long long n_total, const float* rx,
                         const float* w_in,
                         const float* h_in, const float* mw_in, const float* vw_in,
                         const float* mh_in, const float* vh_in, float* w_out, float* h_out,
                         float* mw_out, float* vw_out, float* mh_out, float* vh_out,
                         float* losses, float* var_est, SF* out, SD* dec, SF* eq,
                         float* mm, float* s1, const float* amps, const float* P,
                         const float* var, const float* nu_sc, const float* lr, long long step0,
                         double lr_half_step, long long* clocks) {
  const Dims D = make_dims(n_sym, m, n_lev);
  const float var0 = var[2 * r], var1 = var[2 * r + 1], lr_r = lr[r];
  const Layout L = make_layout(D, nt);
  const Smem s = carve(smem, L);
  const int np = 8 * m, n_x = 4 * D.n_samp, xs = D.xs, mh = D.mh, n_samp = D.n_samp;
  const long long pofs = (long long)r * np;
  load_consts(D, s, amps, P + (long long)r * n_lev, nu_sc[r], var0, var1, tid, nt);
  zero_x(D, s, tid, nt);
  for (int i = tid; i < np; i += nt) {
    s.w[i] = w_in[pofs + i];
    s.h[i] = h_in[pofs + i];
    s.mw[i] = mw_in[pofs + i];
    s.vw[i] = vw_in[pofs + i];
    s.mh[i] = mh_in[pofs + i];
    s.vh[i] = vh_in[pofs + i];
  }
  const float* rx_r = rx + (long long)r * 4 * n_total;
  VAE_SYNC();
  load_x(D, s, rx_r, n_total, tid, nt);
  const float ne = (float)D.n_eff;
  // Adam's step scalars, once per step (the last thread: it has the least
  // forward work), read after gw: sc[5] bc1, sc[6] bc2, sc[7] w's lr and
  // their reciprocals in rd
  const int t_sc = nt - 1;
  Clock ck;
  ck.on = clocks != nullptr && r == 0 && tid == 0;
  for (int p = 0; p < N_PHASES; ++p) ck.c[p] = 0;
  VAE_SYNC();
  for (int mb = 0; mb < m_max; ++mb) {
    clk_start(ck);
    const long long step = step0 + mb;
    if (tid == t_sc) {
      const double tt = (double)(step + 1);
      s.sc[5] = (float)(1.0 - pow(0.9, tt));
      s.sc[6] = (float)(1.0 - pow(0.999, tt));
      s.sc[7] = (double)step >= lr_half_step ? lr_r * 0.5f : lr_r;
      s.rd[MAX_LEV + 4] = 1.0 / (double)s.sc[5];
      s.rd[MAX_LEV + 5] = 1.0 / (double)s.sc[6];
    }
    const bool more = mb + 1 < m_max;
    const float* nx_src = rx_r + (long long)(mb + 1) * 2 * stride_sym;
    float nx[N_PREFETCH];
#pragma unroll
    for (int k = 0; k < N_PREFETCH; ++k) {
      const int i = tid + k * nt;
      if (more && i < n_x) {
        const int row = i / n_samp;
        nx[k] = nx_src[row * n_total + (i - row * n_samp)];
      }
    }

    dp_step<NL>(D, s, tid, nt, ck);

    const long long row = (long long)mb * R + r;
    if (tid == 0) {
      losses[row] = s.sc[0];
      var_est[row * 2 + 0] = s.sc[1] / ne;
      var_est[row * 2 + 1] = s.sc[2] / ne;
    }
    for (int i = tid; i < 4 * n_sym; i += nt) {
      put(out + row * 4 * n_sym + i, s.out[i]);
      put(dec + row * 4 * n_sym + i, s.dec[i]);
      mm[row * 4 * n_sym + i] = s.mm[i];
      s1[row * 4 * n_sym + i] = s.s1[i];
      const int pc = i / n_sym;
      if ((pc & 1) == 0)
        put(eq + row * 2 * n_sym + (pc >> 1) * n_sym + i % n_sym, s.eq[((pc >> 1) * n_sym + i % n_sym) * 2]);
    }
    adam(s, np, s.sc[7], lr_r, s.sc[5], s.sc[6], tid, nt);
    if (more) {
#pragma unroll
      for (int k = 0; k < N_PREFETCH; ++k) {
        const int i = tid + k * nt;
        if (i < n_x) {
          const int row = i / n_samp;
          s.x[row * xs + mh + (i - row * n_samp)] = nx[k];
        }
      }
      for (int i = tid + N_PREFETCH * nt; i < n_x; i += nt) {
        const int row = i / n_samp, k = i - row * n_samp;
        s.x[row * xs + mh + k] = nx_src[row * n_total + k];
      }
    }
    VAE_SYNC();
    clk_mark(ck, PH_ADAM);
  }
  for (int i = tid; i < np; i += nt) {
    w_out[pofs + i] = s.w[i];
    h_out[pofs + i] = s.h[i];
    mw_out[pofs + i] = s.mw[i];
    vw_out[pofs + i] = s.vw[i];
    mh_out[pofs + i] = s.mh[i];
    vh_out[pofs + i] = s.vh[i];
  }
  if (ck.on)
    for (int p = 0; p < N_PHASES; ++p) clocks[p] = ck.c[p];
}

}  // namespace dp
