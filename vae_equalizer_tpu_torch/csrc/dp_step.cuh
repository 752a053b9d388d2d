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
// Design: one thread block owns one run. Every intermediate of the step
// lives in the block's shared memory; each phase is a loop of independent
// items over the block's threads ("for it = tid; it < count; it += nt"),
// separated by barriers. Sums over time/taps run in a fixed order inside one
// thread; block totals (C and the KL) use a fixed-order shared-memory tree —
// no atomics, so a run repeats bit for bit. What bounds a step on the card
// is the chain of ~10 dependent phases (latency), not bytes or FLOPs: the
// working set is ~40 KB and a step is ~0.2 MFLOP.
//
// The body also compiles as plain C++ (DP_HOST_EMULATION), where one "thread"
// (tid 0, nt 1) runs every item of every phase in order; that is how its
// arithmetic is checked against the plain version without a GPU.
#pragma once

#ifdef DP_HOST_EMULATION
#include <math.h>
#include <string.h>
#define DP_HD inline
#define DP_DEV inline
#define DP_SYNC() ((void)0)
#else
#include <cuda_bf16.h>
#define DP_HD __host__ __device__ __forceinline__
#define DP_DEV __device__ __forceinline__
#define DP_SYNC() __syncthreads()
#endif

namespace dp {

// Element types of kernel B's out / dec / eq streams: float32 (dec int32),
// or bfloat16 for all three with stream_bf16 (dec's level indices are exact
// in bfloat16). put() rounds to nearest even, as torch's .to(bfloat16).
#ifdef DP_HOST_EMULATION
struct bf16 {
  unsigned short bits;
};
inline void put(bf16* p, float v) {
  unsigned int u;
  memcpy(&u, &v, 4);
  p->bits = (v != v) ? (unsigned short)0x7fc0 : (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
#else
typedef __nv_bfloat16 bf16;
DP_DEV void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
#endif
DP_DEV void put(float* p, float v) { *p = v; }
DP_DEV void put(int* p, int v) { *p = v; }
DP_DEV void put(bf16* p, int v) { put(p, (float)v); }

constexpr int MAX_LEV = 16;       // up to 256-QAM (16 levels per dimension)
constexpr float EPS_KL = 1e-12f;  // KL log guard (elbo_dp's eps)
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_EPS = 1e-8f;

// Shapes of one minibatch: n_sym symbols, n_samp = 2 n_sym samples (sps 2),
// m taps (odd), mh = m / 2, mh2 = 2 mh = m - 1, n_eff = n_samp - mh2.
struct Dims {
  int n_sym, m, n_lev, n_samp, mh, mh2, n_eff;
};

DP_HD Dims make_dims(int n_sym, int m, int n_lev) {
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
//   x    (4, n_samp)        rows pol*2 + I/Q of the minibatch input
//   w gw mw vw (2, 4, m)    butterfly taps, gradient, Adam moments
//   h gh mh vh (2, 2, 2, m) channel estimate (chi, nu, re/im, j), ...
//   out eq v mm s1 dec gout (2, 2, n_sym)   (pol, I/Q, t)
//   q    (2, 2, n_lev, n_sym)
//   d gd (2, 2, n_eff)      D = h (*) E_q[x] and dL/dD, (chi, re/im, n)
//   S    (2, m)             E-term window totals S[nu, j]
//   amps a2 nua2 P (n_lev)  level constants
//   red  (3, nt)            block-reduction scratch; sc (8) step scalars
struct Layout {
  int x, w, gw, mw, vw, h, gh, mh, vh, out, eq, v, mm, s1, dec, gout, q, d, gd, S;
  int amps, a2, nua2, P, red, sc, total;
};

DP_HD Layout make_layout(const Dims& D, int nt) {
  Layout L;
  int o = 0;
  const int n4 = 4 * D.n_sym, wm = 8 * D.m;
  L.x = o; o += 4 * D.n_samp;
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
  L.d = o; o += 4 * D.n_eff;
  L.gd = o; o += 4 * D.n_eff;
  L.S = o; o += 2 * D.m;
  L.amps = o; o += D.n_lev;
  L.a2 = o; o += D.n_lev;
  L.nua2 = o; o += D.n_lev;
  L.P = o; o += D.n_lev;
  L.red = o; o += 3 * nt;
  L.sc = o; o += 8;
  L.total = o;
  return L;
}

struct Smem {
  float *x, *w, *gw, *mw, *vw, *h, *gh, *mh, *vh, *out, *eq, *v, *mm, *s1, *gout, *q, *d, *gd,
      *S, *amps, *a2, *nua2, *P, *red, *sc;
  int* dec;
};

DP_DEV Smem carve(float* base, const Layout& L) {
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
  s.d = base + L.d;
  s.gd = base + L.gd;
  s.S = base + L.S;
  s.amps = base + L.amps;
  s.a2 = base + L.a2;
  s.nua2 = base + L.nua2;
  s.P = base + L.P;
  s.red = base + L.red;
  s.sc = base + L.sc;
  return s;
}

// Level constants: amps, a^2, nu_sc a^2 and the prior P, computed once.
DP_DEV void load_consts(const Dims& D, const Smem& s, const float* amps, const float* P,
                        float nu_sc, int tid, int nt) {
  for (int l = tid; l < D.n_lev; l += nt) {
    const float a = amps[l];
    s.amps[l] = a;
    s.a2[l] = a * a;
    s.nua2[l] = nu_sc * (a * a);
    s.P[l] = P[l];
  }
}

// Minibatch input: 4 rows (pol*2 + I/Q) of n_samp samples, row stride `stride`.
DP_DEV void load_x(const Dims& D, const Smem& s, const float* x, long long stride, int tid,
                   int nt) {
  for (int i = tid; i < 4 * D.n_samp; i += nt) {
    const int r = i / D.n_samp, k = i - r * D.n_samp;
    s.x[i] = x[r * stride + k];
  }
}

// Signed butterfly input arrangement (models/vae_le.py: _arrangements):
// comp 0 (I) rows (x_I, y_I, -x_Q, -y_Q), comp 1 (Q) rows (x_Q, y_Q, x_I, y_I),
// at unpadded sample index smp (zero outside [0, n_samp)).
DP_DEV float xarr(const Dims& D, const float* x, int comp, int i, int smp) {
  if (smp < 0 || smp >= D.n_samp) return 0.f;
  const int pol = i & 1, c = (i >> 1) ^ comp;
  const float val = x[(pol * 2 + c) * D.n_samp + smp];
  return (comp == 0 && i >= 2) ? -val : val;
}

// The step. Reads s.x, s.w, s.h and the level constants; leaves out, q, eq,
// v, mm, s1, dec, d, gd, S, gout, gw, gh in shared memory and the scalars
// sc = [loss, C_x, C_y, gC_x, gC_y] (C is var_est * n_eff).
DP_DEV void dp_step(const Dims& D, const Smem& s, float var0, float var1, int tid, int nt) {
  const int n_sym = D.n_sym, m = D.m, n_lev = D.n_lev, n_samp = D.n_samp;
  const int mh = D.mh, mh2 = D.mh2, n_eff = D.n_eff;

  // ---- forward butterfly: out[o, comp, t] = sum_{i,k} w[o,i,k] xarr(comp, i, 2t + k - mh)
  for (int it = tid; it < 4 * n_sym; it += nt) {
    const int t = it % n_sym, oc = it / n_sym, o = oc >> 1, comp = oc & 1;
    float acc = 0.f;
    for (int i = 0; i < 4; ++i) {
      const float* wr = s.w + (o * 4 + i) * m;
      for (int k = 0; k < m; ++k) acc += wr[k] * xarr(D, s.x, comp, i, 2 * t + k - mh);
    }
    s.out[it] = acc;
  }
  DP_SYNC();

  // ---- demapper per (pol, comp, t): met -> mm, s1, q, argmax, moments, KL
  float kl_part = 0.f;
  for (int it = tid; it < 4 * n_sym; it += nt) {
    const int t = it % n_sym, p = (it / n_sym) >> 1;
    const float o = s.out[it];
    const float two_var = 2.f * (p ? var1 : var0);
    float met[MAX_LEV];
    float mmv = 0.f;
    for (int l = 0; l < n_lev; ++l) {
      const float dd = o - s.amps[l];
      met[l] = dd * dd / two_var + s.nua2[l];
      mmv = l == 0 ? met[0] : fminf(mmv, met[l]);
    }
    float s1v = 0.f;
    for (int l = 0; l < n_lev; ++l) {
      met[l] = expf(mmv - met[l]);  // met now holds e_l
      s1v += met[l];
    }
    const bool inner = t >= mh && t < n_sym - mh;
    float* qrow = s.q + (it / n_sym) * n_lev * n_sym + t;
    float eqv = 0.f, eq2v = 0.f, qbest = -1.f;
    int best = 0;
    for (int l = 0; l < n_lev; ++l) {
      const float ql = met[l] / s1v;
      qrow[l * n_sym] = ql;
      if (ql > qbest) {  // first maximum, as torch.argmax / jnp.argmax
        qbest = ql;
        best = l;
      }
      eqv += ql * s.amps[l];
      eq2v += ql * s.a2[l];
      if (inner) kl_part += -ql * logf(ql / s.P[l] + EPS_KL);
    }
    s.mm[it] = mmv;
    s.s1[it] = s1v;
    s.dec[it] = best;
    s.eq[it] = eqv;
    s.v[it] = eq2v - eqv * eqv;
  }
  DP_SYNC();

  // ---- D conv (chi, re/im, n) and the E-term window totals S[nu, j]
  for (int it = tid; it < 4 * n_eff; it += nt) {
    const int n = it % n_eff, xr = it / n_eff, chi = xr >> 1, ri = xr & 1;
    float acc = 0.f;
    for (int nu = 0; nu < 2; ++nu) {
      const float* hr = s.h + ((chi * 2 + nu) * 2 + 0) * m;
      const float* hi = s.h + ((chi * 2 + nu) * 2 + 1) * m;
      const float* ei = s.eq + (nu * 2 + 0) * n_sym;
      const float* eqq = s.eq + (nu * 2 + 1) * n_sym;
      for (int j = (n + mh2) & 1; j < m; j += 2) {  // EqUp is zero at odd samples
        const int tt = (n + mh2 - j) >> 1;
        acc += ri == 0 ? (hr[j] * ei[tt] - hi[j] * eqq[tt]) : (hi[j] * ei[tt] + hr[j] * eqq[tt]);
      }
    }
    s.d[it] = acc;
  }
  for (int it = tid; it < 2 * m; it += nt) {
    const int nu = it / m, j = it % m;
    const float* v0 = s.v + (nu * 2 + 0) * n_sym;
    const float* v1 = s.v + (nu * 2 + 1) * n_sym;
    float acc = 0.f;
    for (int smp = mh2 - j + ((mh2 - j) & 1); smp < n_samp - j; smp += 2)
      acc += v0[smp >> 1] + v1[smp >> 1];
    s.S[it] = acc;
  }
  DP_SYNC();

  // ---- C = sum (rx_w - D)^2 + E per chi, and the KL: fixed-order block tree
  {
    float c0 = 0.f, c1 = 0.f;
    for (int it = tid; it < 4 * n_eff; it += nt) {
      const int chi = it / (2 * n_eff), rem = it % (2 * n_eff), c = rem / n_eff, n = rem % n_eff;
      const float diff = s.x[(chi * 2 + c) * n_samp + mh + n] - s.d[it];
      if (chi == 0)
        c0 += diff * diff;
      else
        c1 += diff * diff;
    }
    s.red[tid] = c0;
    s.red[nt + tid] = c1;
    s.red[2 * nt + tid] = kl_part;
  }
  DP_SYNC();
  for (int st = nt / 2; st > 0; st >>= 1) {
    if (tid < st) {
      s.red[tid] += s.red[tid + st];
      s.red[nt + tid] += s.red[nt + tid + st];
      s.red[2 * nt + tid] += s.red[2 * nt + tid + st];
    }
    DP_SYNC();
  }
  if (tid == 0) {
    float e0 = 0.f, e1 = 0.f;
    for (int nu = 0; nu < 2; ++nu)
      for (int j = 0; j < m; ++j) {
        const float sj = s.S[nu * m + j];
        const float* h0 = s.h + ((0 * 2 + nu) * 2) * m;
        const float* h1 = s.h + ((1 * 2 + nu) * 2) * m;
        e0 += (h0[j] * h0[j] + h0[m + j] * h0[m + j]) * sj;
        e1 += (h1[j] * h1[j] + h1[m + j] * h1[m + j]) * sj;
      }
    const float ne = (float)n_eff;
    const float C0 = s.red[0] + e0, C1 = s.red[nt] + e1;
    s.sc[0] = ne * (logf(C0) + logf(C1)) - s.red[2 * nt];
    s.sc[1] = C0;
    s.sc[2] = C1;
    s.sc[3] = ne / C0;
    s.sc[4] = ne / C1;
  }
  DP_SYNC();

  // ================= backward (dL/dloss = 1) =================
  for (int it = tid; it < 4 * n_eff; it += nt) {
    const int chi = it / (2 * n_eff), rem = it % (2 * n_eff), c = rem / n_eff, n = rem % n_eff;
    const float rxw = s.x[(chi * 2 + c) * n_samp + mh + n];
    s.gd[it] = s.sc[3 + chi] * (2.f * s.d[it] - 2.f * rxw);
  }
  DP_SYNC();

  // ---- gh (chi, nu, re/im, j): correlation of dL/dD with EqUp + the E term
  for (int it = tid; it < 8 * m; it += nt) {
    const int j = it % m, cnr = it / m, ri = cnr & 1, nu = (cnr >> 1) & 1, chi = cnr >> 2;
    const float* g_re = s.gd + (chi * 2 + 0) * n_eff;
    const float* g_im = s.gd + (chi * 2 + 1) * n_eff;
    const float* ei = s.eq + (nu * 2 + 0) * n_sym;
    const float* eqq = s.eq + (nu * 2 + 1) * n_sym;
    float acc = 0.f;
    for (int n = j & 1; n < n_eff; n += 2) {  // n + mh2 - j even
      const int tt = (n + mh2 - j) >> 1;
      acc += ri == 0 ? (g_re[n] * ei[tt] + g_im[n] * eqq[tt]) : (g_im[n] * ei[tt] - g_re[n] * eqq[tt]);
    }
    s.gh[it] = acc + 2.f * s.sc[3 + chi] * s.h[it] * s.S[nu * m + j];
  }
  // ---- dL/dout per (pol, comp, t): gEqUp and gVar at sample 2t -> gq -> softmin VJP
  for (int it = tid; it < 4 * n_sym; it += nt) {
    const int t = it % n_sym, pc = it / n_sym, nu = pc >> 1, c = pc & 1, ps = 2 * t;
    float ge = 0.f, gv = 0.f;
    for (int chi = 0; chi < 2; ++chi) {
      const float* g_re = s.gd + (chi * 2 + 0) * n_eff;
      const float* g_im = s.gd + (chi * 2 + 1) * n_eff;
      const float* hr = s.h + ((chi * 2 + nu) * 2 + 0) * m;
      const float* hi = s.h + ((chi * 2 + nu) * 2 + 1) * m;
      float hsum = 0.f;
      for (int j = 0; j < m; ++j) {
        const int n = ps + j - mh2;
        if (n >= 0 && n < n_eff)
          ge += c == 0 ? (g_re[n] * hr[j] + g_im[n] * hi[j]) : (g_im[n] * hr[j] - g_re[n] * hi[j]);
        if (ps >= mh2 - j && ps < n_samp - j) hsum += hr[j] * hr[j] + hi[j] * hi[j];
      }
      gv += s.sc[3 + chi] * hsum;
    }
    const float geq = ge - 2.f * s.eq[it] * gv;
    const bool inner = t >= mh && t < n_sym - mh;
    const float* qrow = s.q + pc * n_lev * n_sym + t;
    float gq[MAX_LEV];
    float inner_sum = 0.f;
    for (int l = 0; l < n_lev; ++l) {
      const float ql = qrow[l * n_sym];
      float g = s.amps[l] * geq + s.a2[l] * gv;
      if (inner) {
        const float r = ql / s.P[l];
        g += logf(r + EPS_KL) + r / (r + EPS_KL);
      }
      gq[l] = g;
      inner_sum += ql * g;
    }
    const float o = s.out[it];
    float acc = 0.f;
    for (int l = 0; l < n_lev; ++l) {
      const float ql = qrow[l * n_sym];
      acc += (-ql * (gq[l] - inner_sum)) * (o - s.amps[l]);
    }
    s.gout[it] = acc / (nu ? var1 : var0);
  }
  DP_SYNC();

  // ---- gw (o, i, k) = sum_t gout_I[o,t] xarr(I,i,2t+k-mh) + gout_Q[o,t] xarr(Q,i,.)
  for (int it = tid; it < 8 * m; it += nt) {
    const int k = it % m, oi = it / m, i = oi & 3, o = oi >> 2;
    const float* gi = s.gout + (o * 2 + 0) * n_sym;
    const float* gq = s.gout + (o * 2 + 1) * n_sym;
    float acc = 0.f;
    for (int t = 0; t < n_sym; ++t) {
      const int smp = 2 * t + k - mh;
      acc += gi[t] * xarr(D, s.x, 0, i, smp) + gq[t] * xarr(D, s.x, 1, i, smp);
    }
    s.gw[it] = acc;
  }
  DP_SYNC();
}

// One Adam update (optax.adam: b1 .9, b2 .999, eps 1e-8 outside the sqrt,
// bias correction with t = step + 1) of n parameters, op for op as the
// plain version's f32 tensor expression.
DP_DEV void adam(float* p, float* mo, float* ve, const float* g, int n, float lr, float bc1,
                 float bc2, int tid, int nt) {
  const float omb1 = (float)(1.0 - 0.9), omb2 = (float)(1.0 - 0.999);
  for (int i = tid; i < n; i += nt) {
    const float gi = g[i];
    const float mi = ADAM_B1 * mo[i] + omb1 * gi;
    const float vi = ADAM_B2 * ve[i] + (omb2 * gi) * gi;
    mo[i] = mi;
    ve[i] = vi;
    p[i] = p[i] - lr * ((mi / bc1) / (sqrtf(vi / bc2) + ADAM_EPS));
  }
}

// ---- kernel A's block: one run's minibatch, outputs in the JAX contract
// layout. x's 4 rows (pol*2 + I/Q) lie x_row floats apart, so the block reads
// a window of a longer frame row in place.
DP_DEV void step_block(float* smem, int tid, int nt, const float* x, long long x_row,
                       const float* w, const float* h, const float* amps, const float* P,
                       const float* var, float nu_sc, int n_sym, int m, int n_lev, float* stats,
                       float* gw, float* gh, float* q, float* out) {
  const Dims D = make_dims(n_sym, m, n_lev);
  const float var0 = var[0], var1 = var[1];
  const Layout L = make_layout(D, nt);
  const Smem s = carve(smem, L);
  load_consts(D, s, amps, P, nu_sc, tid, nt);
  load_x(D, s, x, x_row, tid, nt);
  for (int i = tid; i < 8 * m; i += nt) {
    s.w[i] = w[i];
    s.h[i] = h[i];
  }
  DP_SYNC();
  dp_step(D, s, var0, var1, tid, nt);
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
// out/dec/eq stored as SF/SD (float/int, or bf16 for all three).
template <typename SF, typename SD>
DP_DEV void frame_block(float* smem, int tid, int nt, int r, int R, int m_max, int n_sym,
                        int stride_sym, int m, int n_lev, long long n_total, const float* rx,
                        const float* w_in,
                        const float* h_in, const float* mw_in, const float* vw_in,
                        const float* mh_in, const float* vh_in, float* w_out, float* h_out,
                        float* mw_out, float* vw_out, float* mh_out, float* vh_out,
                        float* losses, float* var_est, SF* out, SD* dec, SF* eq,
                        float* mm, float* s1, const float* amps, const float* P,
                        const float* var, const float* nu_sc, const float* lr, long long step0,
                        double lr_half_step) {
  const Dims D = make_dims(n_sym, m, n_lev);
  const float var0 = var[2 * r], var1 = var[2 * r + 1], lr_r = lr[r];
  const Layout L = make_layout(D, nt);
  const Smem s = carve(smem, L);
  const int np = 8 * m;
  const long long pofs = (long long)r * np;
  load_consts(D, s, amps, P + (long long)r * n_lev, nu_sc[r], tid, nt);
  for (int i = tid; i < np; i += nt) {
    s.w[i] = w_in[pofs + i];
    s.h[i] = h_in[pofs + i];
    s.mw[i] = mw_in[pofs + i];
    s.vw[i] = vw_in[pofs + i];
    s.mh[i] = mh_in[pofs + i];
    s.vh[i] = vh_in[pofs + i];
  }
  const float* rx_r = rx + (long long)r * 4 * n_total;
  const float ne = (float)D.n_eff;
  for (int mb = 0; mb < m_max; ++mb) {
    load_x(D, s, rx_r + (long long)mb * 2 * stride_sym, n_total, tid, nt);
    DP_SYNC();
    dp_step(D, s, var0, var1, tid, nt);

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
      if ((pc & 1) == 0) put(eq + row * 2 * n_sym + (pc >> 1) * n_sym + i % n_sym, s.eq[i]);
    }

    const long long step = step0 + mb;
    const double tt = (double)(step + 1);
    const float bc1 = (float)(1.0 - pow(0.9, tt));
    const float bc2 = (float)(1.0 - pow(0.999, tt));
    const float lr_w = (double)step >= lr_half_step ? lr_r * 0.5f : lr_r;
    adam(s.w, s.mw, s.vw, s.gw, np, lr_w, bc1, bc2, tid, nt);
    adam(s.h, s.mh, s.vh, s.gh, np, lr_r, bc1, bc2, tid, nt);
    DP_SYNC();
  }
  for (int i = tid; i < np; i += nt) {
    w_out[pofs + i] = s.w[i];
    h_out[pofs + i] = s.h[i];
    mw_out[pofs + i] = s.mw[i];
    vw_out[pofs + i] = s.vw[i];
    mh_out[pofs + i] = s.mh[i];
    vh_out[pofs + i] = s.vh[i];
  }
}

}  // namespace dp
