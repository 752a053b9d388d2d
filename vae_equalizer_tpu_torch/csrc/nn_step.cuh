// Kernel H's block: one run of the whole AWGN VAE-NN experiment (E x
// n_batches dependent minibatch steps + AMSGrad), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vae_equalizer_tpu/ops/nn_frame_kernel.py:_kernel
// (pallas_call at :500). The plain PyTorch version is
// vae_equalizer_tpu_torch/ops/nn_frame_kernel.py: vae_nn_experiment_train_plain.
//
// One step, each phase a loop of independent items over the block's threads
// between barriers:
//   conv1 (2 -> C, k1, pad k1/2) + bias, ELU        h1 (pre-ELU), a (post)
//   [BatchNorm: batch mean / biased var per channel, running update]
//   conv2 (C -> C, 3, stride 2, pad 1) + bias + (x[2n] + x[2n+1]) / 2
//   softmax over each half                           q (2, n_lev, N)
//   uniform-prior SISO ELBO and its gradient down to dL/dq: kernel G's
//   device functions (siso_step.cuh) with P = 1, so the KL is the entropy
//   softmax VJP                                      gz, in place of q
//   gW2, gb2; ge = conv2^T gz (into a); BatchNorm VJP; ELU VJP; gW1, gb1
//   AMSGrad (optax semantics) on W1', W2', h [, gamma | beta]
// The TPU layout (im2col with a ones row for the bias, selection matmuls for
// the stride-2 phase split, parity-major h) answered Mosaic's constraints and
// is not carried over: samples are indexed directly.
//
// Bound: a step is ~3.4 MFLOP on ~150 KB (Net_BN ~190 KB) of shared memory;
// 6,500 dependent steps of ~14 phases make the latency chain the bound, not
// FLOPs or bytes.
// Every long sum (gW1: C x (2 k1 + 1) sums of 2 bl terms, gW2: C x (3C + 1)
// of bl, the BatchNorm statistics: C of 2 bl) is one warp's, closed by a
// fixed-order shuffle tree: no atomics, so a run repeats bit for bit.
//
// Compiles as plain C++ with -DNN_HOST_EMULATION (one "thread", a warp of
// one lane), as siso_step.cuh does, to check its arithmetic without a GPU.
#pragma once

#if defined(NN_HOST_EMULATION) && !defined(SISO_HOST_EMULATION)
#define SISO_HOST_EMULATION
#endif
#include "siso_step.cuh"

namespace nn {

constexpr float BN_EPS = 1e-5f;
constexpr int N_STATE = 17;  // w1 w2 h bnp rs, then (m, v, x) of w1, w2, h, bnp
constexpr int N_EVAL = 5;    // w1 w2 h bnp rs

#ifdef NN_HOST_EMULATION
constexpr int kWarp = 1;
inline float warp_sum(float v) { return v; }
#else
constexpr int kWarp = 32;
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
#endif

// Launch arguments. State and eval arrays in the order of N_STATE / N_EVAL;
// every per-run array is (R, size) with the sizes of state_sizes().
struct Args {
  int R, n_epochs, n_batches, n_sym, m, n_lev, k1, epe, n_evals, batchnorm;
  long long n_total, step0;
  float lr, momentum;
  const float* rx;  // (R, E, 2, n_total)
  const float* in[N_STATE];
  float* out[N_STATE];
  float* losses;  // (E n_batches, R)
  float* ev[N_EVAL];  // (n_evals + 1, R, size)
  const float* amps;
};

struct Dims {
  siso::Dims s;
  int ch, k1, p1, k1w, w2w, L, N;
  bool bn;
};

SISO_HD Dims make_dims(int n_sym, int m, int n_lev, int k1, bool bn) {
  Dims d;
  d.s = siso::make_dims(n_sym, m, n_lev);
  d.ch = 2 * n_lev;
  d.k1 = k1;
  d.p1 = k1 / 2;
  d.k1w = 2 * k1 + 1;
  d.w2w = 3 * d.ch + 1;
  d.L = 2 * n_sym;
  d.N = n_sym;
  d.bn = bn;
  return d;
}

// Sizes (floats per run) of the N_STATE arrays.
SISO_HD void state_sizes(const Dims& D, int* sz) {
  const int base[4] = {D.ch * D.k1w, D.ch * D.w2w, 2 * D.s.m, 2 * D.ch};
  sz[0] = base[0];
  sz[1] = base[1];
  sz[2] = base[2];
  sz[3] = base[3];
  sz[4] = base[3];
  for (int g = 0; g < 4; ++g)
    for (int k = 0; k < 3; ++k) sz[5 + 3 * g + k] = base[g];
}

// Shared-memory layout in 4-byte words: the state arrays, the gradients gw1
// gw2 gh gbn, the minibatch x (2, L), h1 / a / xhat (C, L) (xhat only with
// BatchNorm), q (C, N), eq v (2, N), d gd (2, n_eff), S (m), amps a2 P
// (n_lev), bnst (C, 4) = [mean, 1/std, s1, s2], red (2, nt), sc (8).
struct Layout {
  int state[N_STATE];
  int gw1, gw2, gh, gbn, x, h1, a, xhat, q, eq, v, d, gd, S, amps, a2, P, bnst, red, sc, total;
};

SISO_HD Layout make_layout(const Dims& D, int nt) {
  Layout L;
  int sz[N_STATE];
  state_sizes(D, sz);
  int o = 0;
  for (int i = 0; i < N_STATE; ++i) {
    L.state[i] = o;
    o += sz[i];
  }
  L.gw1 = o; o += sz[0];
  L.gw2 = o; o += sz[1];
  L.gh = o; o += sz[2];
  L.gbn = o; o += sz[3];
  L.x = o; o += 2 * D.L;
  L.h1 = o; o += D.ch * D.L;
  L.a = o; o += D.ch * D.L;
  L.xhat = o; o += D.bn ? D.ch * D.L : 0;
  L.q = o; o += D.ch * D.N;
  L.eq = o; o += 2 * D.N;
  L.v = o; o += 2 * D.N;
  L.d = o; o += 2 * D.s.n_eff;
  L.gd = o; o += 2 * D.s.n_eff;
  L.S = o; o += D.s.m;
  L.amps = o; o += D.s.n_lev;
  L.a2 = o; o += D.s.n_lev;
  L.P = o; o += D.s.n_lev;
  L.bnst = o; o += 4 * D.ch;
  L.red = o; o += 2 * nt;
  L.sc = o; o += 8;
  L.total = o;
  return L;
}

struct Smem {
  siso::Smem s;  // x, h, gh, q, eq, v, d, gd, S, amps, a2, P, red, sc: the ELBO back end's view
  float* state[N_STATE];
  float *w1, *w2, *bnp, *rs, *gw1, *gw2, *gbn, *h1, *a, *xhat, *bnst;
};

SISO_DEV Smem carve(float* base, const Layout& L) {
  Smem m;
  for (int i = 0; i < N_STATE; ++i) m.state[i] = base + L.state[i];
  m.w1 = m.state[0];
  m.w2 = m.state[1];
  m.bnp = m.state[3];
  m.rs = m.state[4];
  m.gw1 = base + L.gw1;
  m.gw2 = base + L.gw2;
  m.gbn = base + L.gbn;
  m.h1 = base + L.h1;
  m.a = base + L.a;
  m.xhat = base + L.xhat;
  m.bnst = base + L.bnst;
  siso::Smem& s = m.s;
  s.x = base + L.x;
  s.w = s.gw = s.mw = s.vw = s.xw = nullptr;
  s.h = m.state[2];
  s.gh = base + L.gh;
  s.mh = s.vh = s.xh = nullptr;
  s.out = s.gn = nullptr;
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
  return m;
}

// One minibatch step on s.x; leaves the loss in s.sc[0], the gradients in
// gw1 / gw2 / gh / gbn and the updated running statistics in rs.
SISO_DEV void nn_step(const Dims& D, const Smem& m, float momentum, int tid, int nt) {
  const siso::Smem& s = m.s;
  const int ch = D.ch, n_lev = D.s.n_lev, L = D.L, N = D.N, k1 = D.k1, p1 = D.p1;
  const int k1w = D.k1w, w2w = D.w2w;
  const int lane = tid % kWarp, warp = tid / kWarp, nw = nt / kWarp;
  const float* x = s.x;

  // ---- conv1 + bias, ELU: h1 (pre-ELU) and a (post-ELU), (C, L)
  for (int it = tid; it < ch * L; it += nt) {
    const int c = it / L, t = it - c * L;
    const float* wr = m.w1 + c * k1w;
    float acc = 0.f;
    for (int k = 0; k < k1; ++k) {
      const int smp = t + k - p1;
      if (smp < 0 || smp >= L) continue;
      acc += wr[2 * k] * x[smp] + wr[2 * k + 1] * x[L + smp];
    }
    acc += wr[2 * k1];
    m.h1[it] = acc;
    m.a[it] = acc > 0.f ? acc : expm1f(acc);
  }
  SISO_SYNC();

  // ---- BatchNorm (train mode): per-channel statistics, one warp per channel
  if (D.bn) {
    const float inv_l = 1.f / (float)L;
    const float unb = (float)((double)L / (double)(L - 1));
    for (int c = warp; c < ch; c += nw) {
      const float* row = m.a + c * L;
      float sum = 0.f;
      for (int t = lane; t < L; t += kWarp) sum += row[t];
      const float mu = warp_sum(sum) * inv_l;
      float ss = 0.f;
      for (int t = lane; t < L; t += kWarp) {
        const float dv = row[t] - mu;
        ss += dv * dv;
      }
      const float var = warp_sum(ss) * inv_l;
      if (lane == 0) {
        m.bnst[4 * c] = mu;
        m.bnst[4 * c + 1] = 1.f / sqrtf(var + BN_EPS);
        m.rs[2 * c] = (1.f - momentum) * m.rs[2 * c] + momentum * mu;
        m.rs[2 * c + 1] = (1.f - momentum) * m.rs[2 * c + 1] + momentum * var * unb;
      }
    }
    SISO_SYNC();
    for (int it = tid; it < ch * L; it += nt) {
      const int c = it / L;
      const float xh = (m.a[it] - m.bnst[4 * c]) * m.bnst[4 * c + 1];
      m.xhat[it] = xh;
      m.a[it] = xh * m.bnp[2 * c] + m.bnp[2 * c + 1];
    }
    SISO_SYNC();
  }

  // ---- conv2 (stride 2, taps at samples 2n - 1, 2n, 2n + 1) + bias + residual -> z in q
  for (int it = tid; it < ch * N; it += nt) {
    const int c = it / N, n = it - c * N;
    const float* wr = m.w2 + c * w2w;
    float acc = 0.f;
    for (int d = 0; d < 3; ++d) {
      const int smp = 2 * n + d - 1;
      if (smp < 0) continue;
      const float* wd = wr + d * ch;
      for (int j = 0; j < ch; ++j) acc += wd[j] * m.a[j * L + smp];
    }
    acc += wr[3 * ch];
    const int half = c / n_lev;
    s.q[it] = acc + (x[half * L + 2 * n] + x[half * L + 2 * n + 1]) / 2.f;
  }
  SISO_SYNC();

  // ---- softmax over each half's levels, posterior moments, entropy partial
  float kl_part = 0.f;
  for (int it = tid; it < 2 * N; it += nt) {
    const int comp = it / N, t = it - comp * N;
    float* col = s.q + comp * n_lev * N + t;
    float mx = col[0];
    for (int l = 1; l < n_lev; ++l) mx = fmaxf(mx, col[l * N]);
    float sum = 0.f;
    for (int l = 0; l < n_lev; ++l) {
      const float e = expf(col[l * N] - mx);
      col[l * N] = e;
      sum += e;
    }
    for (int l = 0; l < n_lev; ++l) col[l * N] = col[l * N] / sum;
    siso::moments(D.s, s, it, kl_part);
  }
  SISO_SYNC();
  siso::elbo_forward(D.s, s, kl_part, tid, nt);

  // ================= backward (dL/dloss = 1) =================
  siso::elbo_gd(D.s, s, tid, nt);
  siso::elbo_gh(D.s, s, tid, nt);
  // ---- dL/dq -> softmax VJP: gz = q (gq - <q, gq>) per half, in place of q
  for (int it = tid; it < 2 * N; it += nt) {
    const int comp = it / N, t = it - comp * N;
    float gq[siso::MAX_LEV];
    siso::elbo_gq(D.s, s, it, gq);
    float* col = s.q + comp * n_lev * N + t;
    float inner = 0.f;
    for (int l = 0; l < n_lev; ++l) inner += col[l * N] * gq[l];
    for (int l = 0; l < n_lev; ++l) col[l * N] = col[l * N] * (gq[l] - inner);
  }
  SISO_SYNC();
  const float* gz = s.q;

  // ---- gW2' (c, d C + j) = sum_n gz[c, n] a[j, 2n + d - 1]; bias column 3C: sum_n gz[c, n]
  for (int item = warp; item < ch * w2w; item += nw) {
    const int c = item / w2w, col = item - c * w2w;
    const float* gzr = gz + c * N;
    float acc = 0.f;
    if (col == 3 * ch) {
      for (int n = lane; n < N; n += kWarp) acc += gzr[n];
    } else {
      const int d = col / ch, j = col - d * ch;
      const float* ar = m.a + j * L + d - 1;
      for (int n = lane; n < N; n += kWarp)
        if (2 * n + d >= 1) acc += gzr[n] * ar[2 * n];
    }
    acc = warp_sum(acc);
    if (lane == 0) m.gw2[item] = acc;
  }
  SISO_SYNC();

  // ---- ge = conv2^T gz, (C, L), into a: even s = 2n takes tap 1 at n; odd
  // s takes tap 2 at n = (s - 1) / 2 and tap 0 at n = (s + 1) / 2 < N
  for (int it = tid; it < ch * L; it += nt) {
    const int j = it / L, smp = it - j * L;
    float acc = 0.f;
    if ((smp & 1) == 0) {
      const int n = smp >> 1;
      for (int c = 0; c < ch; ++c) acc += m.w2[c * w2w + ch + j] * gz[c * N + n];
    } else {
      const int n2 = (smp - 1) >> 1, n0 = (smp + 1) >> 1;
      for (int c = 0; c < ch; ++c) {
        acc += m.w2[c * w2w + 2 * ch + j] * gz[c * N + n2];
        if (n0 < N) acc += m.w2[c * w2w + j] * gz[c * N + n0];
      }
    }
    m.a[it] = acc;
  }
  SISO_SYNC();

  // ---- BatchNorm VJP sums, one warp per channel: g_gamma, g_beta, and
  // s1 = mean(ge gamma), s2 = mean(ge gamma xhat)
  if (D.bn) {
    const float inv_l = 1.f / (float)L;
    for (int c = warp; c < ch; c += nw) {
      const float* ge = m.a + c * L;
      const float* xh = m.xhat + c * L;
      const float gamma = m.bnp[2 * c];
      float sg = 0.f, sb = 0.f, s1 = 0.f, s2 = 0.f;
      for (int t = lane; t < L; t += kWarp) {
        const float g = ge[t], gx = g * gamma;
        sg += g * xh[t];
        sb += g;
        s1 += gx;
        s2 += gx * xh[t];
      }
      sg = warp_sum(sg);
      sb = warp_sum(sb);
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        m.gbn[2 * c] = sg;
        m.gbn[2 * c + 1] = sb;
        m.bnst[4 * c + 2] = s1 * inv_l;
        m.bnst[4 * c + 3] = s2 * inv_l;
      }
    }
    SISO_SYNC();
  }

  // ---- [BatchNorm input gradient] and the ELU VJP: gh1 = ge elu'(h1), into a
  for (int it = tid; it < ch * L; it += nt) {
    float g = m.a[it];
    if (D.bn) {
      const int c = it / L;
      const float* st = m.bnst + 4 * c;
      g = st[1] * (g * m.bnp[2 * c] - st[2] - m.xhat[it] * st[3]);
    }
    const float hv = m.h1[it];
    m.a[it] = hv > 0.f ? g : g * expf(hv);
  }
  SISO_SYNC();

  // ---- gW1' (c, 2k + i) = sum_t gh1[c, t] x[i, t + k - p1]; bias column 2 k1
  for (int item = warp; item < ch * k1w; item += nw) {
    const int c = item / k1w, col = item - c * k1w;
    const float* gr = m.a + c * L;
    float acc = 0.f;
    if (col == 2 * k1) {
      for (int t = lane; t < L; t += kWarp) acc += gr[t];
    } else {
      const int k = col >> 1, i = col & 1;
      const int lo = p1 - k > 0 ? p1 - k : 0, hi = L + p1 - k < L ? L + p1 - k : L;
      const float* xr = x + i * L + k - p1;
      for (int t = lo + lane; t < hi; t += kWarp) acc += gr[t] * xr[t];
    }
    acc = warp_sum(acc);
    if (lane == 0) m.gw1[item] = acc;
  }
  SISO_SYNC();
}

// Kernel H's block: run r trains its whole experiment.
SISO_DEV void experiment_block(float* smem, int tid, int nt, int r, const Args& A) {
  const Dims D = make_dims(A.n_sym, A.m, A.n_lev, A.k1, A.batchnorm != 0);
  const Layout L = make_layout(D, nt);
  const Smem m = carve(smem, L);
  const siso::Smem& s = m.s;
  int sz[N_STATE];
  state_sizes(D, sz);
  for (int l = tid; l < A.n_lev; l += nt) {
    const float a = A.amps[l];
    s.amps[l] = a;
    s.a2[l] = a * a;
    s.P[l] = 1.f;  // uniform prior: the KL term is the entropy
  }
  for (int i = 0; i < N_STATE; ++i)
    for (int k = tid; k < sz[i]; k += nt) m.state[i][k] = A.in[i][(long long)r * sz[i] + k];
  float* grads[4] = {m.gw1, m.gw2, s.gh, m.gbn};
  const int n_groups = D.bn ? 4 : 3;  // w1, w2, h [, gamma | beta]
  const float* rx_r = A.rx + (long long)r * A.n_epochs * 2 * A.n_total;

  auto write_slot = [&](int slot) {  // the eval arrays are the first N_EVAL state arrays
    for (int i = 0; i < N_EVAL; ++i) {
      const long long ofs = ((long long)slot * A.R + r) * sz[i];
      for (int k = tid; k < sz[i]; k += nt) A.ev[i][ofs + k] = m.state[i][k];
    }
  };

  for (int e = 0; e < A.n_epochs; ++e) {
    for (int b = 0; b < A.n_batches; ++b) {
      siso::load_x(D.s, s, rx_r + (long long)e * 2 * A.n_total + (long long)b * D.L, A.n_total, tid,
                   nt);
      SISO_SYNC();
      nn_step(D, m, A.momentum, tid, nt);

      const long long k = (long long)e * A.n_batches + b;
      if (tid == 0) A.losses[k * A.R + r] = s.sc[0];
      const double tt = (double)(A.step0 + k + 1);
      const float bc1 = (float)(1.0 - pow(0.9, tt));
      const float bc2 = (float)(1.0 - pow(0.999, tt));
      for (int g = 0; g < n_groups; ++g)  // state g is the parameter, 5 + 3g.. its moments
        siso::amsgrad(m.state[g], m.state[5 + 3 * g], m.state[6 + 3 * g], m.state[7 + 3 * g],
                      grads[g], sz[g], A.lr, bc1, bc2, tid, nt);
      SISO_SYNC();
    }
    if (e % A.epe == 0 && e / A.epe < A.n_evals) write_slot(e / A.epe);
  }
  write_slot(A.n_evals);
  for (int i = 0; i < N_STATE; ++i)
    for (int k = tid; k < sz[i]; k += nt) A.out[i][(long long)r * sz[i] + k] = m.state[i][k];
}

}  // namespace nn
