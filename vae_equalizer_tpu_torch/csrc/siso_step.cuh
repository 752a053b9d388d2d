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
// Design: one thread block owns one run. Every intermediate of the step lives
// in the block's shared memory; each phase is a loop of independent items
// over the block's threads ("for it = tid; it < count; it += nt"), separated
// by barriers. Sums over time/taps/levels run in a fixed order inside one
// thread; block totals (sum |out|, C, the KL, the normalization dots) use a
// fixed-order shared-memory tree — no atomics, so a run repeats bit for bit.
// A step is ~1 MFLOP over ~55 KB: the chain of ~10 dependent phases bounds it.
// The ELBO back end (moments, elbo_forward, elbo_gd, elbo_gh, elbo_gq) is
// shared with kernel H (nn_step.cuh), which puts its softmax posteriors in q.
//
// The body also compiles as plain C++ (SISO_HOST_EMULATION), where one
// "thread" (tid 0, nt 1) runs every item of every phase in order; that is how
// its arithmetic is checked against the plain version without a GPU.
#pragma once

#ifdef SISO_HOST_EMULATION
#include <math.h>
#define SISO_HD inline
#define SISO_DEV inline
#define SISO_SYNC() ((void)0)
#else
#define SISO_HD __host__ __device__ __forceinline__
#define SISO_DEV __device__ __forceinline__
#define SISO_SYNC() __syncthreads()
#endif

namespace siso {

constexpr int MAX_LEV = 16;       // up to 256-QAM (16 levels per dimension)
constexpr float EPS_KL = 1e-12f;  // KL log guard (elbo_siso's eps)
constexpr float AMS_B1 = 0.9f;
constexpr float AMS_B2 = 0.999f;
constexpr float AMS_EPS = 1e-8f;

// Shapes of one minibatch: n_sym symbols, n_samp = 2 n_sym samples (sps 2),
// m taps (odd), mh = m / 2, mh2 = 2 mh = m - 1, n_eff = n_samp - mh2.
struct Dims {
  int n_sym, m, n_lev, n_samp, mh, mh2, n_eff;
};

SISO_HD Dims make_dims(int n_sym, int m, int n_lev) {
  Dims d;
  d.n_sym = n_sym;
  d.m = m;
  d.n_lev = n_lev;
  d.n_samp = 2 * n_sym;
  d.mh = m / 2;
  d.mh2 = 2 * (m / 2);
  d.n_eff = 2 * n_sym - 2 * (m / 2);
  return d;
}

// Shared-memory layout in 4-byte words.
//   x    (2, n_samp)           minibatch rows (I, Q)
//   w gw mw vw xw (2, m)       filter taps (input row c, tap k), gradient,
//                              AMSGrad mu, nu, nu_max
//   h gh mh vh xh (2, m)       channel estimate (re/im, tap j), ...
//   out gn eq v (2, n_sym)     filter output, dL/dnorm (then dL/dout),
//                              E_q[x], Var_q[x] per component (I, Q)
//   q    (2, n_lev, n_sym)     posteriors
//   d gd (2, n_eff)            D = h (*) E_q[x] and dL/dD, (re/im, n)
//   S    (m)                   E-term window totals S[j]
//   amps a2 P (n_lev)          level constants
//   red  (2, nt)               block-reduction scratch; sc (8) step scalars
struct Layout {
  int x, w, gw, mw, vw, xw, h, gh, mh, vh, xh, out, gn, eq, v, q, d, gd, S, amps, a2, P, red, sc;
  int total;
};

SISO_HD Layout make_layout(const Dims& D, int nt) {
  Layout L;
  int o = 0;
  const int n2 = 2 * D.n_sym, pm = 2 * D.m;
  L.x = o; o += 2 * D.n_samp;
  L.w = o; o += pm;
  L.gw = o; o += pm;
  L.mw = o; o += pm;
  L.vw = o; o += pm;
  L.xw = o; o += pm;
  L.h = o; o += pm;
  L.gh = o; o += pm;
  L.mh = o; o += pm;
  L.vh = o; o += pm;
  L.xh = o; o += pm;
  L.out = o; o += n2;
  L.gn = o; o += n2;
  L.eq = o; o += n2;
  L.v = o; o += n2;
  L.q = o; o += n2 * D.n_lev;
  L.d = o; o += 2 * D.n_eff;
  L.gd = o; o += 2 * D.n_eff;
  L.S = o; o += D.m;
  L.amps = o; o += D.n_lev;
  L.a2 = o; o += D.n_lev;
  L.P = o; o += D.n_lev;
  L.red = o; o += 2 * nt;
  L.sc = o; o += 8;
  L.total = o;
  return L;
}

struct Smem {
  float *x, *w, *gw, *mw, *vw, *xw, *h, *gh, *mh, *vh, *xh, *out, *gn, *eq, *v, *q, *d, *gd, *S;
  float *amps, *a2, *P, *red, *sc;
};

SISO_DEV Smem carve(float* base, const Layout& L) {
  Smem s;
  s.x = base + L.x;
  s.w = base + L.w;
  s.gw = base + L.gw;
  s.mw = base + L.mw;
  s.vw = base + L.vw;
  s.xw = base + L.xw;
  s.h = base + L.h;
  s.gh = base + L.gh;
  s.mh = base + L.mh;
  s.vh = base + L.vh;
  s.xh = base + L.xh;
  s.out = base + L.out;
  s.gn = base + L.gn;
  s.eq = base + L.eq;
  s.v = base + L.v;
  s.q = base + L.q;
  s.d = base + L.d;
  s.gd = base + L.gd;
  s.S = base + L.S;
  s.amps = base + L.amps;
  s.a2 = base + L.a2;
  s.P = base + L.P;
  s.red = base + L.red;
  s.sc = base + L.sc;
  return s;
}

// Level constants: amps, a^2 and the prior P, loaded once.
SISO_DEV void load_consts(const Dims& D, const Smem& s, const float* amps, const float* P, int tid,
                          int nt) {
  for (int l = tid; l < D.n_lev; l += nt) {
    const float a = amps[l];
    s.amps[l] = a;
    s.a2[l] = a * a;
    s.P[l] = P[l];
  }
}

// Minibatch input: 2 rows (I, Q) of n_samp samples, row stride `stride`.
SISO_DEV void load_x(const Dims& D, const Smem& s, const float* x, long long stride, int tid,
                     int nt) {
  for (int i = tid; i < 2 * D.n_samp; i += nt) {
    const int r = i / D.n_samp, k = i - r * D.n_samp;
    s.x[i] = x[r * stride + k];
  }
}

// Signed twoFIR input arrangement (models/vae_le.py: siso_arrangements): the
// I output reads rows (x_I, x_Q), the Q output (x_Q, -x_I); unpadded sample
// index smp, zero outside [0, n_samp).
SISO_DEV float xarr(const Dims& D, const float* x, int comp, int c, int smp) {
  if (smp < 0 || smp >= D.n_samp) return 0.f;
  if (comp == 0) return x[c * D.n_samp + smp];
  return c == 0 ? x[D.n_samp + smp] : -x[smp];
}

// Fixed-order tree over the nt (a power of 2) partials of `rows` rows of red
// (row stride nt); row r's total lands in red[r * nt]. Call after a barrier.
SISO_DEV void block_sum(float* red, int nt, int rows, int tid) {
  for (int st = nt / 2; st > 0; st >>= 1) {
    if (tid < st)
      for (int r = 0; r < rows; ++r) red[r * nt + tid] += red[r * nt + tid + st];
    SISO_SYNC();
  }
}

// ---- The ELBO back end, shared with kernel H (nn_step.cuh): every function
// below reads the posteriors q (2, n_lev, n_sym), the minibatch x and the
// channel estimate h from shared memory. With P = 1 the KL term is the plain
// posterior entropy (the uniform-prior ELBO of the VAE-NN).

// Posterior moments of column it = (comp, t) of q into s.eq / s.v, and its
// KL term -sum_l q log(q / P + eps) (inside the window t in [mh, n_sym - mh))
// added to the thread's partial kl_part.
SISO_DEV void moments(const Dims& D, const Smem& s, int it, float& kl_part) {
  const int comp = it / D.n_sym, t = it - comp * D.n_sym;
  const bool inner = t >= D.mh && t < D.n_sym - D.mh;
  const float* qrow = s.q + comp * D.n_lev * D.n_sym + t;
  float eqv = 0.f, eq2v = 0.f;
  for (int l = 0; l < D.n_lev; ++l) {
    const float ql = qrow[l * D.n_sym];
    eqv += ql * s.amps[l];
    eq2v += ql * s.a2[l];
    if (inner) kl_part += -ql * logf(ql / s.P[l] + EPS_KL);
  }
  s.eq[it] = eqv;
  s.v[it] = eq2v - eqv * eqv;
}

// D conv, the E-term window totals S, then C = sum (rx_w - D)^2 + E and the
// KL over the block (fixed-order trees): sc = [loss, C, g_C = n_eff / C].
// Call after a barrier that follows the moments; ends with one.
SISO_DEV void elbo_forward(const Dims& D, const Smem& s, float kl_part, int tid, int nt) {
  const int n_sym = D.n_sym, m = D.m, n_samp = D.n_samp;
  const int mh = D.mh, mh2 = D.mh2, n_eff = D.n_eff;
  const float* hr = s.h;
  const float* hi = s.h + m;
  const float* ei = s.eq;
  const float* eqq = s.eq + n_sym;
  // ---- D conv (re/im, n) and the E-term window totals S[j]
  for (int it = tid; it < 2 * n_eff; it += nt) {
    const int ri = it / n_eff, n = it - ri * n_eff;
    float acc = 0.f;
    for (int j = (n + mh2) & 1; j < m; j += 2) {  // EqUp is zero at odd samples
      const int tt = (n + mh2 - j) >> 1;
      acc += ri == 0 ? (hr[j] * ei[tt] - hi[j] * eqq[tt]) : (hi[j] * ei[tt] + hr[j] * eqq[tt]);
    }
    s.d[it] = acc;
  }
  for (int j = tid; j < m; j += nt) {
    float acc = 0.f;
    for (int smp = mh2 - j + ((mh2 - j) & 1); smp < n_samp - j; smp += 2)
      acc += s.v[smp >> 1] + s.v[n_sym + (smp >> 1)];
    s.S[j] = acc;
  }
  SISO_SYNC();

  // ---- C = sum (rx_w - D)^2 + E and the KL: fixed-order block tree
  {
    float c_part = 0.f;
    for (int it = tid; it < 2 * n_eff; it += nt) {
      const int ri = it / n_eff, n = it - ri * n_eff;
      const float diff = s.x[ri * n_samp + mh + n] - s.d[it];
      c_part += diff * diff;
    }
    s.red[tid] = c_part;
    s.red[nt + tid] = kl_part;
  }
  SISO_SYNC();
  block_sum(s.red, nt, 2, tid);
  if (tid == 0) {
    float e = 0.f;
    for (int j = 0; j < m; ++j) e += (hr[j] * hr[j] + hi[j] * hi[j]) * s.S[j];
    const float ne = (float)n_eff;
    const float C = s.red[0] + e;
    s.sc[0] = ne * logf(C) - s.red[nt];
    s.sc[1] = C;
    s.sc[2] = ne / C;
  }
  SISO_SYNC();
}

// dL/dD (re/im, n) into s.gd (dL/dloss = 1); ends with a barrier.
SISO_DEV void elbo_gd(const Dims& D, const Smem& s, int tid, int nt) {
  const float g_c = s.sc[2];
  for (int it = tid; it < 2 * D.n_eff; it += nt) {
    const int ri = it / D.n_eff, n = it - ri * D.n_eff;
    s.gd[it] = g_c * (2.f * s.d[it] - 2.f * s.x[ri * D.n_samp + D.mh + n]);
  }
  SISO_SYNC();
}

// gh (re/im, j): correlation of dL/dD with EqUp + the E term, into s.gh.
SISO_DEV void elbo_gh(const Dims& D, const Smem& s, int tid, int nt) {
  const int m = D.m, mh2 = D.mh2, n_eff = D.n_eff;
  const float g_c = s.sc[2];
  const float* g_re = s.gd;
  const float* g_im = s.gd + n_eff;
  const float* ei = s.eq;
  const float* eqq = s.eq + D.n_sym;
  for (int it = tid; it < 2 * m; it += nt) {
    const int ri = it / m, j = it - ri * m;
    float acc = 0.f;
    for (int n = j & 1; n < n_eff; n += 2) {  // n + Mh - j even
      const int tt = (n + mh2 - j) >> 1;
      acc += ri == 0 ? (g_re[n] * ei[tt] + g_im[n] * eqq[tt]) : (g_im[n] * ei[tt] - g_re[n] * eqq[tt]);
    }
    s.gh[it] = acc + 2.f * g_c * s.h[it] * s.S[j];
  }
}

// dL/dq of column it = (comp, t), per level, into gq[0, n_lev): gEqUp and
// gVar at sample 2t through the moments, plus the KL term.
SISO_DEV void elbo_gq(const Dims& D, const Smem& s, int it, float* gq) {
  const int n_sym = D.n_sym, m = D.m, n_lev = D.n_lev, n_samp = D.n_samp;
  const int mh = D.mh, mh2 = D.mh2, n_eff = D.n_eff;
  const float* hr = s.h;
  const float* hi = s.h + m;
  const float* g_re = s.gd;
  const float* g_im = s.gd + n_eff;
  const float g_c = s.sc[2];
  const int comp = it / n_sym, t = it - comp * n_sym, ps = 2 * t;
  float ge = 0.f, hsum = 0.f;
  for (int j = 0; j < m; ++j) {
    const int n = ps + j - mh2;
    if (n >= 0 && n < n_eff)
      ge += comp == 0 ? (g_re[n] * hr[j] + g_im[n] * hi[j]) : (g_im[n] * hr[j] - g_re[n] * hi[j]);
    if (ps >= mh2 - j && ps < n_samp - j) hsum += hr[j] * hr[j] + hi[j] * hi[j];
  }
  const float gv = g_c * hsum;
  const float geq = ge - 2.f * s.eq[it] * gv;
  const bool inner = t >= mh && t < n_sym - mh;
  const float* qrow = s.q + comp * n_lev * n_sym + t;
  for (int l = 0; l < n_lev; ++l) {
    float g = s.amps[l] * geq + s.a2[l] * gv;
    if (inner) {
      const float r = qrow[l * n_sym] / s.P[l];
      g += logf(r + EPS_KL) + r / (r + EPS_KL);
    }
    gq[l] = g;
  }
}

// The VAE-LE step. Reads s.x, s.w, s.h and the level constants; leaves out,
// q, eq, v, d, gd, S, gn (= dL/dout), gw and gh in shared memory and the
// scalars sc = [loss, C, g_C, k_I, k_Q, dot_I, dot_Q].
SISO_DEV void siso_step(const Dims& D, const Smem& s, float amp_mean, float var, int tid, int nt) {
  const int n_sym = D.n_sym, m = D.m, n_lev = D.n_lev;
  const int mh = D.mh;

  // ---- forward FIR: out[comp, t] = sum_{c,k} w[c,k] xarr(comp, c, 2t + k - mh), and sum |out|
  {
    float abs0 = 0.f, abs1 = 0.f;
    for (int it = tid; it < 2 * n_sym; it += nt) {
      const int comp = it / n_sym, t = it - comp * n_sym;
      float acc = 0.f;
      for (int c = 0; c < 2; ++c) {
        const float* wr = s.w + c * m;
        for (int k = 0; k < m; ++k) acc += wr[k] * xarr(D, s.x, comp, c, 2 * t + k - mh);
      }
      s.out[it] = acc;
      if (comp == 0)
        abs0 += fabsf(acc);
      else
        abs1 += fabsf(acc);
    }
    s.red[tid] = abs0;
    s.red[nt + tid] = abs1;
  }
  SISO_SYNC();
  block_sum(s.red, nt, 2, tid);
  if (tid == 0) {  // k_c = amp_mean / mean|out_c|
    s.sc[3] = amp_mean / (s.red[0] / (float)n_sym);
    s.sc[4] = amp_mean / (s.red[nt] / (float)n_sym);
  }
  SISO_SYNC();

  // ---- demapper per (comp, t): metric (norm - a)^2 / var -> q, moments, KL part
  float kl_part = 0.f;
  for (int it = tid; it < 2 * n_sym; it += nt) {
    const int comp = it / n_sym, t = it - comp * n_sym;
    const float nrm = s.out[it] * s.sc[3 + comp];
    float met[MAX_LEV];
    float mmv = 0.f;
    for (int l = 0; l < n_lev; ++l) {
      const float dd = nrm - s.amps[l];
      met[l] = dd * dd / var;
      mmv = l == 0 ? met[0] : fminf(mmv, met[l]);
    }
    float s1v = 0.f;
    for (int l = 0; l < n_lev; ++l) {
      met[l] = expf(mmv - met[l]);  // met now holds e_l
      s1v += met[l];
    }
    float* qrow = s.q + comp * n_lev * n_sym + t;
    for (int l = 0; l < n_lev; ++l) qrow[l * n_sym] = met[l] / s1v;
    moments(D, s, it, kl_part);
  }
  SISO_SYNC();
  elbo_forward(D, s, kl_part, tid, nt);

  // ================= backward (dL/dloss = 1) =================
  elbo_gd(D, s, tid, nt);
  elbo_gh(D, s, tid, nt);
  // ---- dL/dnorm per (comp, t): dL/dq -> softmin VJP
  {
    float dot0 = 0.f, dot1 = 0.f;
    for (int it = tid; it < 2 * n_sym; it += nt) {
      const int comp = it / n_sym, t = it - comp * n_sym;
      const float* qrow = s.q + comp * n_lev * n_sym + t;
      float gq[MAX_LEV];
      elbo_gq(D, s, it, gq);
      float inner_sum = 0.f;
      for (int l = 0; l < n_lev; ++l) inner_sum += qrow[l * n_sym] * gq[l];
      const float nrm = s.out[it] * s.sc[3 + comp];
      float acc = 0.f;
      for (int l = 0; l < n_lev; ++l) {
        const float ql = qrow[l * n_sym];
        acc += (-ql * (gq[l] - inner_sum)) * 2.f * (nrm - s.amps[l]);
      }
      const float gnv = acc / var;
      s.gn[it] = gnv;
      if (comp == 0)
        dot0 += gnv * nrm;
      else
        dot1 += gnv * nrm;
    }
    s.red[tid] = dot0;
    s.red[nt + tid] = dot1;
  }
  SISO_SYNC();
  block_sum(s.red, nt, 2, tid);
  if (tid == 0) {
    s.sc[5] = s.red[0];
    s.sc[6] = s.red[nt];
  }
  SISO_SYNC();

  // ---- normalization VJP: gout = k (gnorm - sign(out) <gnorm, norm> / (N amp_mean))
  {
    const float den = (float)n_sym * amp_mean;
    for (int it = tid; it < 2 * n_sym; it += nt) {
      const int comp = it / n_sym;
      const float o = s.out[it];
      const float sg = o > 0.f ? 1.f : (o < 0.f ? -1.f : 0.f);
      s.gn[it] = s.sc[3 + comp] * (s.gn[it] - sg * (s.sc[5 + comp] / den));
    }
  }
  SISO_SYNC();

  // ---- gw (c, k) = sum_t gout_I[t] xarr(I, c, 2t+k-mh) + gout_Q[t] xarr(Q, c, .)
  for (int it = tid; it < 2 * m; it += nt) {
    const int c = it / m, k = it - c * m;
    float acc = 0.f;
    for (int t = 0; t < n_sym; ++t) {
      const int smp = 2 * t + k - mh;
      acc += s.gn[t] * xarr(D, s.x, 0, c, smp) + s.gn[n_sym + t] * xarr(D, s.x, 1, c, smp);
    }
    s.gw[it] = acc;
  }
  SISO_SYNC();
}

// One AMSGrad update (optax.amsgrad: b1 .9, b2 .999, eps 1e-8 outside the
// sqrt, nu_max over the bias-corrected nu, t = step + 1) of n parameters, op
// for op as the plain version's f32 tensor expression (ops/siso_frame_kernel.py:
// amsgrad).
SISO_DEV void amsgrad(float* p, float* mo, float* ve, float* vmax, const float* g, int n, float lr,
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

// ---- kernel F's block: run r's minibatch. x (R, 2, n_samp); w (R, 1, 2, m);
// h (R, 2, m); outputs loss (R), gw (R, 1, 2, m), gh (R, 2, m),
// q (R, 2 n_lev, n_sym), out (R, 2, n_sym).
SISO_DEV void step_block(float* smem, int tid, int nt, int r, int n_sym, int m, int n_lev,
                         const float* x, const float* w, const float* h, const float* amps,
                         const float* P, float amp_mean, float var, float* loss, float* gw,
                         float* gh, float* q, float* out) {
  const Dims D = make_dims(n_sym, m, n_lev);
  const Layout L = make_layout(D, nt);
  const Smem s = carve(smem, L);
  const int np = 2 * m;
  const long long pofs = (long long)r * np;
  load_consts(D, s, amps, P, tid, nt);
  load_x(D, s, x + (long long)r * 2 * D.n_samp, D.n_samp, tid, nt);
  for (int i = tid; i < np; i += nt) {
    s.w[i] = w[pofs + i];
    s.h[i] = h[pofs + i];
  }
  SISO_SYNC();
  siso_step(D, s, amp_mean, var, tid, nt);
  if (tid == 0) loss[r] = s.sc[0];
  for (int i = tid; i < np; i += nt) {
    gw[pofs + i] = s.gw[i];
    gh[pofs + i] = s.gh[i];
  }
  const long long oofs = (long long)r * 2 * n_sym;
  for (int i = tid; i < 2 * n_sym; i += nt) out[oofs + i] = s.out[i];
  for (int i = tid; i < 2 * n_lev * n_sym; i += nt) q[oofs * n_lev + i] = s.q[i];
}

// ---- kernel G's block: run r trains its whole experiment. rx (R, E, 2,
// n_total); params/moments (R, 2m); losses (E n_batches, R); eval slots
// w_ev / h_ev (n_evals + 1, R, 2m): slot i < n_evals after epoch i*epe, the
// last slot after the last epoch.
SISO_DEV void experiment_block(float* smem, int tid, int nt, int r, int R, int n_epochs,
                               int n_batches, int n_sym, int m, int n_lev, long long n_total,
                               int epe, int n_evals, const float* rx, const float* w_in,
                               const float* h_in, const float* mw_in, const float* vw_in,
                               const float* xw_in, const float* mh_in, const float* vh_in,
                               const float* xh_in, float* w_out, float* h_out, float* mw_out,
                               float* vw_out, float* xw_out, float* mh_out, float* vh_out,
                               float* xh_out, float* losses, float* w_ev, float* h_ev,
                               const float* amps, const float* P, float amp_mean, float var,
                               float lr, long long step0) {
  const Dims D = make_dims(n_sym, m, n_lev);
  const Layout L = make_layout(D, nt);
  const Smem s = carve(smem, L);
  const int np = 2 * m;
  const long long pofs = (long long)r * np;
  load_consts(D, s, amps, P, tid, nt);
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
  for (int e = 0; e < n_epochs; ++e) {
    for (int b = 0; b < n_batches; ++b) {
      load_x(D, s, rx_r + (long long)e * 2 * n_total + (long long)b * D.n_samp, n_total, tid, nt);
      SISO_SYNC();
      siso_step(D, s, amp_mean, var, tid, nt);

      const long long k = (long long)e * n_batches + b;
      if (tid == 0) losses[k * R + r] = s.sc[0];
      const double tt = (double)(step0 + k + 1);
      const float bc1 = (float)(1.0 - pow(0.9, tt));
      const float bc2 = (float)(1.0 - pow(0.999, tt));
      amsgrad(s.w, s.mw, s.vw, s.xw, s.gw, np, lr, bc1, bc2, tid, nt);
      amsgrad(s.h, s.mh, s.vh, s.xh, s.gh, np, lr, bc1, bc2, tid, nt);
      SISO_SYNC();
    }
    if (e % epe == 0 && e / epe < n_evals) {
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
}

}  // namespace siso
