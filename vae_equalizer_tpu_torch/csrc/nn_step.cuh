// Kernel H's block: one run of the whole AWGN VAE-NN experiment (E x
// n_batches dependent minibatch steps + AMSGrad), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel vae_equalizer_tpu/ops/nn_frame_kernel.py:_kernel
// (pallas_call at :500). The plain PyTorch version is
// vae_equalizer_tpu_torch/ops/nn_frame_kernel.py: vae_nn_experiment_train_plain.
//
// One step, each phase a loop of independent items over the block's threads
// between barriers:
//   conv1 (2 -> C, k1, pad k1/2) + bias, ELU        a (post-ELU), dact = ELU'
//   [BatchNorm: batch mean / biased var per channel, running update]
//   conv2 (C -> C, 3, stride 2, pad 1) + bias + (x[2n] + x[2n+1]) / 2
//   softmax over each half, posterior moments        q (2, n_lev, N)
//   the uniform-prior SISO ELBO (the KL is the entropy) and its gradient
//   down to dL/dq, softmax VJP                       gz, in place of q
//   gW2, gb2; ge = conv2^T gz (into a); BatchNorm VJP; ELU VJP; gW1, gb1
//   AMSGrad (optax semantics) on W1', W2', h [, gamma | beta]
// The TPU layout (im2col with a ones row for the bias, selection matmuls for
// the stride-2 phase split, parity-major h) answered Mosaic's constraints and
// is not carried over.
//
// What bounds a step: not FLOPs or bytes (a step is ~3.4 MFLOP on ~195 KB of
// shared memory; 6,500 dependent steps) but, per phase, the SM's issue rate,
// its shared-memory bandwidth (one 32-lane wavefront per cycle) and the
// phase's longest serial chain. The five convolution phases are GEMMs with
// M = C = 16 channels (conv1 16 x 600 x 51, conv2 16 x 300 x 49, conv2^T
// 16 x 600 x <= 32, gW2 16 x 49 x 300, gW1 16 x 51 x 600). Measured per
// phase with clock64() (`clocks`, PERF.md), they ran at the shared-memory
// rate when each multiply-add read both operands from shared memory (and a
// warp-wide broadcast of a 16-byte weight costs four wavefronts), and the
// ELBO's serial sums and block trees were the next cost. This design, one
// block of kBlock = 512 threads per run, counts wavefronts per multiply-add:
//   * Outer-product register tiles. A convolution item is one warp's: G = 4
//     channels (2 where C is not a multiple of 4; always 2 in conv2, which
//     then has as many items as warps) x TS = 5 samples per lane, the samples
//     32 apart, so each step loads the G weights once for the warp (a
//     broadcast) and TS samples at unit stride, (G + TS) wavefronts for
//     32 G TS multiply-adds. W1' and W2' (and their AMSGrad moments) are
//     held transposed, (column, channel), so a tap's G channels are
//     contiguous; conv2^T reads a second, natural copy of W2's taps,
//     refreshed by AMSGrad. Rows are zero-padded (x by p1 and past the
//     last block; the sample planes and q past N), so no item tests bounds.
//   * Sample planes. The activations a, dact, xhat and the gradients that
//     share their layout are stored as even and odd sample planes per
//     channel (the odd plane 16 banks after the even one, with a zero at
//     odd index -1), so conv2 and gW2 read a[2n + d - 1] at unit stride and
//     writes of consecutive samples do not collide; conv2^T runs its even
//     and odd outputs as separate, uniform items.
//   * Weight gradients split over the lanes. A gW2 / gW1 item is a warp's G
//     channels x 32 / G columns, each lane summing its n (t) in registers
//     (G + 32 / G loads at unit stride for 32 multiply-adds), closed by a
//     fixed-order reduce-scatter of 31 shuffles (tile_out); the biases are
//     one warp sum per channel.
//   * The ELBO back end is H's own, for the uniform prior: a column's levels
//     in registers (unrolled for 8 levels, 64-QAM), D and the C partials in
//     one pass (u = 2 D - 2 x in parity planes), the E-term window totals and
//     gh one warp per tap, the block totals closed by per-warp shuffles and
//     one warp; 4 barriers where kernel G's functions take 14.
//   * The shapes and the layout live in a header in shared memory, read
//     again after each barrier, so no phase holds another phase's pointers
//     in registers.
//   * Every product is an explicit fused multiply-add in a fixed order; the
//     elementwise math (ELU, BatchNorm, softmax, the ELBO's logs and
//     divisions, AMSGrad) keeps the plain version's operations (the library
//     is built with --fmad=false).
//   * The next minibatch is copied into a second x buffer with cp.async
//     while the step runs; AMSGrad's bias corrections are computed once per
//     step by one thread.
// Sums are in a fixed order (in-thread chains, fixed shuffle trees) and there
// are no atomics, so a run repeats bit for bit.
//
// Compiles as plain C++ with -DVAE_HOST_EMULATION (one "thread", a warp of
// one lane, barriers are no-ops; csrc/nn_host_emulation.cpp), to check its
// arithmetic without a GPU. It includes siso_step.cuh for AMSGrad.
#pragma once

#include "portable.cuh"
#include "siso_step.cuh"

namespace nn {

using namespace vae;  // copy_async, copy_async_wait

constexpr float BN_EPS = 1e-5f;
constexpr int N_STATE = 17;  // w1 w2 h bnp rs, then (m, v, x) of w1, w2, h, bnp
constexpr int N_EVAL = 5;    // w1 w2 h bnp rs
constexpr int kBlock = 512;  // threads per block (nn_kernels.cu)
constexpr int MAX_WARPS = 32;

// A warp of one lane in emulation (kept here, not in portable.cuh: cma, dfe
// and siso emulate the card's lanes instead).
#ifdef VAE_HOST_EMULATION
constexpr int kWarp = 1;
inline float warp_sum(float v) { return v; }
#else
constexpr int kWarp = 32;
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
#endif

// G consecutive floats from / to shared memory in one vector access (the
// arrays so accessed lie at multiples of 4 words, make_layout).
template <int G>
VAE_DEV void ldv(const float* p, float* o) {
  if constexpr (G == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x;
    o[1] = v.y;
  }
}
template <int G>
VAE_DEV void stv(float* p, const float* v) {
  if constexpr (G == 4) {
    float4 w;
    w.x = v[0];
    w.y = v[1];
    w.z = v[2];
    w.w = v[3];
    *reinterpret_cast<float4*>(p) = w;
  } else {
    float2 w;
    w.x = v[0];
    w.y = v[1];
    *reinterpret_cast<float2*>(p) = w;
  }
}

// Phase clocks: block 0's thread 0 adds the clock64() cycles of each phase
// of each step (from the previous mark to the barrier that ends the phase)
// into c[phase], in shared memory; the launcher's `clocks` receives them
// summed over the call (ops/nn_frame_kernel.py: NN_CLOCK_PHASES names them).
// With on false every mark is one untaken branch (kept per kernel: cma, dfe
// and siso compile their clocks in per CLK instead).
enum Phase {
  PH_LOAD, PH_CONV1, PH_BN, PH_CONV2, PH_SOFTMAX, PH_ELBO, PH_GQ, PH_GW2, PH_CONV2T, PH_BNELU,
  PH_GW1, PH_AMS, N_PHASES
};
struct Clock {
  bool on;
  long long t;
  long long* c;
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
  long long* clocks;  // N_PHASES cycles of block 0, or null
};

// The launchers' Args from their C arguments (csrc/nn_kernels.cu,
// nn_host_emulation.cpp); ptrs: rx, the N_STATE inputs, the N_STATE outputs,
// losses, the N_EVAL eval slot arrays, amps. Returns false for arguments the
// kernel refuses.
inline bool make_args(Args* a, int R, int n_epochs, int n_batches, int n_sym, int m, int n_lev,
                      int k1, long long n_total, int epe, int n_evals, int batchnorm,
                      void* const* ptrs, float lr, float momentum, long long step0,
                      long long* clocks) {
  if (R < 1 || n_epochs < 1 || n_batches < 1 || epe < 1 || n_lev < 1 ||
      n_lev > siso::MAX_LEV || m % 2 != 1 || 2 * n_sym <= m || k1 < 1 ||
      n_total < (long long)n_batches * 2 * n_sym)
    return false;
  a->R = R;
  a->n_epochs = n_epochs;
  a->n_batches = n_batches;
  a->n_sym = n_sym;
  a->m = m;
  a->n_lev = n_lev;
  a->k1 = k1;
  a->epe = epe;
  a->n_evals = n_evals;
  a->batchnorm = batchnorm;
  a->n_total = n_total;
  a->step0 = step0;
  a->lr = lr;
  a->momentum = momentum;
  int p = 0;
  a->rx = (const float*)ptrs[p++];
  for (int i = 0; i < N_STATE; ++i) a->in[i] = (const float*)ptrs[p++];
  for (int i = 0; i < N_STATE; ++i) a->out[i] = (float*)ptrs[p++];
  a->losses = (float*)ptrs[p++];
  for (int i = 0; i < N_EVAL; ++i) a->ev[i] = (float*)ptrs[p++];
  a->amps = (const float*)ptrs[p++];
  a->clocks = clocks;
  return true;
}

// Shapes: N symbols, L = 2N samples (sps 2), m taps of h (odd), mh = m / 2,
// mh2 = 2 mh, n_eff = L - mh2; C = 2 n_lev channels. The convolutions run
// in blocks of kWarp TS samples (lane + kWarp s, s < TS), so the padded
// counts are lp = L and np = N rounded up to kWarp TS. An activation (C, L) is
// stored as sample planes: sample t of channel c at c rs + (t & 1) oo +
// (t >> 1); oo >= np + 1 is 16 mod 32 (the odd plane's index -1, at oo - 1,
// and every index past the data stay zero) and rs is odd. A row of q (C,
// N) is qs = np + 1 long (zero past N). An x row holds xl = p1 zeros, the L
// samples and zeros up to xs; u (2, n_eff) is stored as parity planes of us
// (16 mod 32) per component.
constexpr int TS = 5;  // samples per lane of a convolution item

struct Dims {
  int n_lev, ch, m, mh, mh2, n_eff, k1, p1, k1w, w2w, L, N, lp, np, rs, oo, qs, xl, xs, us, w2s;
  bool bn;
};

VAE_HD int round_up(int a, int b) { return (a + b - 1) / b * b; }
VAE_HD int bank16(int a) { return (a + 15) / 32 * 32 + 16; }  // least >= a that is 16 mod 32

VAE_HD Dims make_dims(int n_sym, int m, int n_lev, int k1, bool bn) {
  Dims d;
  d.n_lev = n_lev;
  d.ch = 2 * n_lev;
  d.m = m;
  d.mh = m / 2;
  d.mh2 = 2 * (m / 2);
  d.n_eff = 2 * n_sym - d.mh2;
  d.k1 = k1;
  d.p1 = k1 / 2;
  d.k1w = 2 * k1 + 1;
  d.w2w = 3 * d.ch + 1;
  d.L = 2 * n_sym;
  d.N = n_sym;
  d.lp = round_up(d.L, kWarp * TS);
  d.np = round_up(n_sym, kWarp * TS);
  d.oo = bank16(d.np + 1);
  d.rs = (d.oo + d.np) | 1;
  d.qs = d.np + 1;
  d.xl = d.p1;
  d.xs = round_up(d.xl + d.lp + k1 + 16, 4);  // gW1's masked tap columns read past k1
  d.us = bank16((d.n_eff + 1) / 2);
  d.w2s = 3 * d.ch;
  d.bn = bn;
  return d;
}

VAE_HD int toff(const Dims& D, int t) { return (t & 1) * D.oo + (t >> 1); }

// Sizes (floats per run) of the N_STATE arrays.
VAE_HD void state_sizes(const Dims& D, int* sz) {
  const int base[4] = {D.ch * D.k1w, D.ch * D.w2w, 2 * D.m, 2 * D.ch};
  sz[0] = base[0];
  sz[1] = base[1];
  sz[2] = base[2];
  sz[3] = base[3];
  sz[4] = base[3];
  for (int g = 0; g < 4; ++g)
    for (int k = 0; k < 3; ++k) sz[5 + 3 * g + k] = base[g];
}

// Shared index of element k (the JAX layout) of state array i: W1' and W2'
// and their moments are held transposed, (column, channel).
VAE_HD int sidx(const Dims& D, int i, int k) {
  const int g = i < 5 ? i : (i - 5) / 3;
  if (g > 1) return k;
  const int w = g == 0 ? D.k1w : D.w2w;
  const int c = k / w;
  return (k - c * w) * D.ch + c;
}

// Shared-memory layout in 4-byte words after the header, every array at a
// multiple of 4: the state arrays, the gradients gw1 gw2 gh gbn, two
// minibatch buffers x (2, xs), the residual res (2, N), dact / a / xhat (C planes
// of rs; xhat only with BatchNorm), q (C, qs), eq v ge (2, N), u (2, 2, us), S
// and h2 = |h|^2 (m), amps a2 (n_lev), bnst (C, 4) = [mean, 1/std, s1, s2],
// red (2, MAX_WARPS), sc (8) = [loss, C, n_eff / C, -, bc1, bc2], W2's taps in
// natural layout w2n (C, 3C), the phase clocks.
struct Layout {
  int state[N_STATE];
  int gw1, gw2, gh, gbn, x, res, dact, a, xhat, q, eq, v, ge, u, S, h2, amps, a2, bnst, red, sc, w2n, clk;
  int total;
};

// The header at the start of shared memory.
struct Hdr {
  Dims D;
  Layout L;
};

VAE_HD int take(int& o, int n) {
  const int r = o;
  o += (n + 3) / 4 * 4;
  return r;
}

VAE_HD Layout make_layout(const Dims& D) {
  Layout L;
  int sz[N_STATE];
  state_sizes(D, sz);
  int o = 0;
  take(o, (int)((sizeof(Hdr) + 3) / 4));
  for (int i = 0; i < N_STATE; ++i) L.state[i] = take(o, sz[i]);
  L.gw1 = take(o, sz[0]);
  L.gw2 = take(o, sz[1]);
  L.gh = take(o, sz[2]);
  L.gbn = take(o, sz[3]);
  L.x = take(o, 4 * D.xs);
  L.res = take(o, 2 * D.N);
  L.dact = take(o, D.ch * D.rs);
  L.a = take(o, D.ch * D.rs);
  L.xhat = take(o, D.bn ? D.ch * D.rs : 0);
  L.q = take(o, D.ch * D.qs);
  L.eq = take(o, 2 * D.N);
  L.v = take(o, 2 * D.N);
  L.ge = take(o, 2 * D.N);
  L.u = take(o, 4 * D.us);
  L.S = take(o, D.m);
  L.h2 = take(o, D.m);
  L.amps = take(o, D.n_lev);
  L.a2 = take(o, D.n_lev);
  L.bnst = take(o, 4 * D.ch);
  L.red = take(o, 2 * MAX_WARPS);
  L.sc = take(o, 8);
  L.w2n = take(o, D.ch * D.w2s);
  L.clk = take(o, 2 * N_PHASES);
  L.total = o;
  return L;
}

// A warp's 32 sums of a weight-gradient tile, each split over the lanes:
// reduce-scatter in a fixed order (lane l ends with output l), then
// write(i, total of output i). In emulation the one lane holds the totals.
template <class W>
VAE_DEV void tile_out(float (&v)[32], int lane, W write) {
#ifdef VAE_HOST_EMULATION
  (void)lane;
  for (int i = 0; i < 32; ++i) write(i, v[i]);
#else
#pragma unroll
  for (int k = 0; k < 5; ++k) {  // static bounds, so v stays in registers
    const int h = 16 >> k;
    const bool up = (lane & h) != 0;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < h) {
        const float send = up ? v[i] : v[i + h];
        const float keep = up ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, h);
      }
  }
  write(lane, v[0]);
#endif
}

// ---- The uniform-prior SISO ELBO (models/losses.py: elbo_siso with P =
// None, so the KL is the posterior entropy): D[., n] = sum_j h[j] EqUp[n +
// mh2 - j] for n in [0, n_eff) (EqUp is E_q[x] at even samples), C = sum
// (x[mh + n] - D)^2 + sum_j |h_j|^2 S[j], loss = n_eff log C - entropy.

// Softmax of column it = (comp, t) of z (in q), its moments into eq / v, and
// its entropy term -sum q log(q + eps) inside the window t in [mh, N - mh).
// NL levels unrolled (0: any n_lev up to MAX_LEV, the rest predicated off).
template <int NL>
VAE_DEV float softmax_column(const Dims& D, float* q, const float* amps, const float* a2, float* eq,
                             float* v, int it) {
  constexpr int NA = NL ? NL : siso::MAX_LEV;
  const int nl = NL ? NL : D.n_lev, N = D.N, qs = D.qs;
  const int comp = it / N, t = it - comp * N;
  float* col = q + comp * nl * qs + t;
  float z[NA];
#pragma unroll
  for (int l = 0; l < NA; ++l)
    if (l < nl) z[l] = col[l * qs];
  float mx = z[0];
#pragma unroll
  for (int l = 1; l < NA; ++l)
    if (l < nl) mx = fmaxf(mx, z[l]);
  float sum = 0.f;
#pragma unroll
  for (int l = 0; l < NA; ++l)
    if (l < nl) {
      z[l] = expf(z[l] - mx);
      sum += z[l];
    }
  const bool inner = t >= D.mh && t < N - D.mh;
  float eqv = 0.f, eq2v = 0.f, ent = 0.f;
#pragma unroll
  for (int l = 0; l < NA; ++l)
    if (l < nl) {
      const float ql = z[l] / sum;
      col[l * qs] = ql;
      eqv += ql * amps[l];
      eq2v += ql * a2[l];
      if (inner) ent += -ql * logf(ql + siso::EPS_KL);
    }
  eq[it] = eqv;
  v[it] = eq2v - eqv * eqv;
  return ent;
}

// For column it = (comp, t): ge = sum_j (h (*) u)[2t + j - mh2] over the taps
// that reach [0, n_eff) (comp 0: u_re hr + u_im hi; comp 1: u_im hr - u_re
// hi) and hsum = the sum of |h_j|^2 over the same taps.
VAE_DEV void ge_column(const Dims& D, const float* u, const float* h, const float* h2, float* ge,
                       float* hs, int it) {
  const int N = D.N, m = D.m, mh2 = D.mh2, us = D.us;
  const int comp = it / N, t = it - comp * N, ps = 2 * t;
  const int jlo = mh2 - ps > 0 ? mh2 - ps : 0, jhi = D.L - ps < m ? D.L - ps : m;
  // u[ri, n] for n = 2t + j - mh2 lies in parity plane j & 1 at t + ((j - mh2) >> 1)
  const float* ua = u + (comp == 0 ? 0 : 2 * us) + t;
  const float* ub = u + (comp == 0 ? 2 * us : 0) + t;
  const float sg = comp == 0 ? 1.f : -1.f;
  float acc = 0.f, hsum = 0.f;
  for (int j = jlo; j < jhi; ++j) {
    const int o = (j & 1) * us + ((j - mh2) >> 1);
    acc = VAE_FMA(ua[o], h[j], acc);
    acc = VAE_FMA(sg * ub[o], h[m + j], acc);
    hsum += h2[j];
  }
  ge[it] = acc;
  hs[it] = hsum;
}

// dL/dq of column it = (comp, t) through the moments and the entropy, then
// the softmax VJP in place: gz = q (gq - <q, gq>). dL/dE_q[x] = g_C ge -
// 2 E_q[x] gv and dL/dVar_q[x] = gv = g_C hsum at sample 2t (ge_column).
template <int NL>
VAE_DEV void softmax_vjp_column(const Dims& D, float* q, const float* amps, const float* a2,
                                const float* eq, const float* ge, const float* hs, float g_c,
                                int it) {
  constexpr int NA = NL ? NL : siso::MAX_LEV;
  const int nl = NL ? NL : D.n_lev, N = D.N, qs = D.qs;
  const int comp = it / N, t = it - comp * N;
  const float gv = g_c * hs[it];
  const float geq = g_c * ge[it] - 2.f * eq[it] * gv;
  const bool inner = t >= D.mh && t < N - D.mh;
  float* col = q + comp * nl * qs + t;
  float qv[NA], g[NA];
  float dot = 0.f;
#pragma unroll
  for (int l = 0; l < NA; ++l)
    if (l < nl) {
      qv[l] = col[l * qs];
      float gl = amps[l] * geq + a2[l] * gv;
      if (inner) gl += logf(qv[l] + siso::EPS_KL) + qv[l] / (qv[l] + siso::EPS_KL);
      g[l] = gl;
      dot += qv[l] * gl;
    }
#pragma unroll
  for (int l = 0; l < NA; ++l)
    if (l < nl) col[l * qs] = qv[l] * (g[l] - dot);
}

// One minibatch step on the x buffer x (row i at x + i xs + xl); leaves the
// loss in sc[0], the gradients in gw1 / gw2 / gh / gbn and the updated
// running statistics in rs.
template <int G, int NL>
VAE_DEV void nn_step(const Hdr& H, float* base, const float* x, float momentum, int tid, int nt,
                     Clock& ck) {
  const int lane = tid % kWarp, warp = tid / kWarp, nw = nt / kWarp;

  // ---- conv1 + bias, ELU: warp items (channel group, block of kWarp TS
  // samples); a (xhat with BatchNorm) = ELU(h1), dact = ELU'(h1); and
  // conv2's residual res[i, n] = (x[i, 2n] + x[i, 2n + 1]) / 2
  {
    const Dims& D = H.D;
    const int ch = D.ch, L = D.L, k1 = D.k1, rs = D.rs, xs = D.xs, ng = ch / G, nb = D.lp / (kWarp * TS);
    float* res = base + H.L.res;
    for (int i = tid; i < D.L; i += nt) {  // i = row N + n
      const float* xr = x + (i >= D.N ? xs : 0) + D.xl + 2 * (i >= D.N ? i - D.N : i);
      res[i] = (xr[0] + xr[1]) / 2.f;
    }
    const float* w1 = base + H.L.state[0];
    float* act = base + (D.bn ? H.L.xhat : H.L.a);
    float* dact = base + H.L.dact;
    for (int it = warp; it < ng * nb; it += nw) {
      const int g = it / nb, t0 = (it - g * nb) * kWarp * TS + lane;
      const float* wg = w1 + G * g;
      const float* x0 = x + t0;  // x0[k + kWarp s] = x[0, t0 + kWarp s + k - p1]
      float acc[G][TS] = {};
      for (int k = 0; k < k1; ++k) {
        float wa[G], wb[G];
        ldv<G>(wg + 2 * k * ch, wa);
        ldv<G>(wg + (2 * k + 1) * ch, wb);
#pragma unroll
        for (int s = 0; s < TS; ++s) {
          const float xa = x0[k + kWarp * s], xb = x0[xs + k + kWarp * s];
#pragma unroll
          for (int q = 0; q < G; ++q) acc[q][s] = VAE_FMA(wb[q], xb, VAE_FMA(wa[q], xa, acc[q][s]));
        }
      }
      float b[G];
      ldv<G>(wg + 2 * k1 * ch, b);
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const int t = t0 + kWarp * s;
        if (t < L) {
          const int o = G * g * rs + toff(D, t);
#pragma unroll
          for (int q = 0; q < G; ++q) {
            const float h = acc[q][s] + b[q];
            act[o + q * rs] = h > 0.f ? h : expm1f(h);
            dact[o + q * rs] = h > 0.f ? 1.f : expf(h);
          }
        }
      }
    }
    VAE_SYNC();
  }
  clk_mark(ck, PH_CONV1);

  // ---- BatchNorm (train mode): per-channel statistics, one warp per channel
  if (H.D.bn) {
    const Dims& D = H.D;
    const int ch = D.ch, L = D.L, N = D.N, rs = D.rs, oo = D.oo;
    float* xhat = base + H.L.xhat;
    float* bnst = base + H.L.bnst;
    float* rsv = base + H.L.state[4];
    const float inv_l = 1.f / (float)L;
    const float unb = (float)((double)L / (double)(L - 1));
    for (int c = warp; c < ch; c += nw) {
      const float* row = xhat + c * rs;
      float sum = 0.f;
      for (int t = lane; t < L; t += kWarp) sum += row[toff(D, t)];
      const float mu = warp_sum(sum) * inv_l;
      float ss = 0.f;
      for (int t = lane; t < L; t += kWarp) {
        const float dv = row[toff(D, t)] - mu;
        ss += dv * dv;
      }
      const float var = warp_sum(ss) * inv_l;
      if (lane == 0) {
        bnst[4 * c] = mu;
        bnst[4 * c + 1] = 1.f / sqrtf(var + BN_EPS);
        rsv[2 * c] = (1.f - momentum) * rsv[2 * c] + momentum * mu;
        rsv[2 * c + 1] = (1.f - momentum) * rsv[2 * c + 1] + momentum * var * unb;
      }
    }
    VAE_SYNC();
    const float* bnp = base + H.L.state[3];
    float* a = base + H.L.a;
    for (int r = warp; r < 2 * ch; r += nw) {  // rows (channel, plane)
      const int c = r >> 1, o0 = c * rs + (r & 1) * oo;
      const float mu = bnst[4 * c], istd = bnst[4 * c + 1], gamma = bnp[2 * c], beta = bnp[2 * c + 1];
      for (int n = lane; n < N; n += kWarp) {
        const float xh = (xhat[o0 + n] - mu) * istd;
        xhat[o0 + n] = xh;
        a[o0 + n] = xh * gamma + beta;
      }
    }
    VAE_SYNC();
  }
  clk_mark(ck, PH_BN);

  // ---- conv2 (stride 2, taps at samples 2n - 1, 2n, 2n + 1: odd plane n - 1,
  // even n, odd n) + bias + residual -> z in q; warp items (channel group,
  // block of kWarp TS symbols)
  {
    const Dims& D = H.D;
    const int ch = D.ch, n_lev = D.n_lev, N = D.N, qs = D.qs, rs = D.rs, oo = D.oo;
    constexpr int G2 = 2;  // 2-channel groups: 16 items at the default shapes
    const int ng = ch / G2, nb = D.np / (kWarp * TS);
    const float* w2 = base + H.L.state[1];
    const float* a = base + H.L.a;
    const float* res = base + H.L.res;
    float* q = base + H.L.q;
    for (int it = warp; it < ng * nb; it += nw) {
      const int g = it / nb, n0 = (it - g * nb) * kWarp * TS + lane;
      const float* wg = w2 + G2 * g;
      float acc[G2][TS] = {};
      for (int d = 0; d < 3; ++d) {
        const float* ad = a + n0 + (d == 1 ? 0 : (d == 0 ? oo - 1 : oo));
        const float* wd = wg + d * ch * ch;
#pragma unroll 4
        for (int j = 0; j < ch; ++j) {
          float w[G2];
          ldv<G2>(wd + j * ch, w);
#pragma unroll
          for (int s = 0; s < TS; ++s) {
            const float av = ad[j * rs + kWarp * s];
#pragma unroll
            for (int qq = 0; qq < G2; ++qq) acc[qq][s] = VAE_FMA(w[qq], av, acc[qq][s]);
          }
        }
      }
      float b[G2];
      ldv<G2>(wg + 3 * ch * ch, b);
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const int n = n0 + kWarp * s;
        if (n < N) {
#pragma unroll
          for (int qq = 0; qq < G2; ++qq) {
            const int c = G2 * g + qq;
            q[c * qs + n] = (acc[qq][s] + b[qq]) + res[(c >= n_lev ? N : 0) + n];
          }
        }
      }
    }
    VAE_SYNC();
  }
  clk_mark(ck, PH_CONV2);

  // ---- softmax, moments and entropy per column
  float ent_part = 0.f;
  {
    const Dims& D = H.D;
    float* q = base + H.L.q;
    const float* amps = base + H.L.amps;
    const float* a2 = base + H.L.a2;
    float* eq = base + H.L.eq;
    float* v = base + H.L.v;
    for (int it = tid; it < 2 * D.N; it += nt) ent_part += softmax_column<NL>(D, q, amps, a2, eq, v, it);
    VAE_SYNC();
  }
  clk_mark(ck, PH_SOFTMAX);

  // ---- ELBO forward: D and u = 2 D - 2 x per n with the C partials; the
  // E-term window totals S[j] = sum of v_I + v_Q over the symbols sample
  // window j reaches, one warp per tap; warp partials of C and the entropy,
  // then one warp: E, C, the loss and g_C = n_eff / C
  {
    const Dims& D = H.D;
    const int N = D.N, m = D.m, mh = D.mh, mh2 = D.mh2, n_eff = D.n_eff, L = D.L, xs = D.xs, us = D.us;
    const float* h = base + H.L.state[2];
    const float* eq = base + H.L.eq;
    const float* v = base + H.L.v;
    float* u = base + H.L.u;
    float* S = base + H.L.S;
    float* red = base + H.L.red;
    float c_part = 0.f;
    for (int n = tid; n < n_eff; n += nt) {
      float dre = 0.f, dim = 0.f;
      for (int j = (n + mh2) & 1; j < m; j += 2) {  // EqUp is zero at odd samples
        const int tt = (n + mh2 - j) >> 1;
        const float ei = eq[tt], eqq = eq[N + tt];
        dre = VAE_FMA(-h[m + j], eqq, VAE_FMA(h[j], ei, dre));
        dim = VAE_FMA(h[j], eqq, VAE_FMA(h[m + j], ei, dim));
      }
      const float xr = x[D.xl + mh + n], xi = x[xs + D.xl + mh + n];
      const float er = xr - dre, ei = xi - dim;
      c_part += er * er;
      c_part += ei * ei;
      const int o = (n & 1) * us + (n >> 1);
      u[o] = 2.f * dre - 2.f * xr;
      u[2 * us + o] = 2.f * dim - 2.f * xi;
    }
    float* h2 = base + H.L.h2;
    for (int j = tid; j < m; j += nt) h2[j] = h[j] * h[j] + h[m + j] * h[m + j];
    for (int j = warp; j < m; j += nw) {
      const int t0 = (mh2 - j + 1) >> 1, t1 = (L - j + 1) >> 1;
      float acc = 0.f;
      for (int t = t0 + lane; t < t1; t += kWarp) acc += v[t] + v[N + t];
      acc = warp_sum(acc);
      if (lane == 0) S[j] = acc;
    }
    c_part = warp_sum(c_part);
    ent_part = warp_sum(ent_part);
    if (lane == 0) {
      red[warp] = c_part;
      red[MAX_WARPS + warp] = ent_part;
    }
    VAE_SYNC();
    if (warp == 0) {
      float* sc = base + H.L.sc;
      float c = 0.f, ent = 0.f, e = 0.f;
      for (int w = lane; w < nw; w += kWarp) {
        c += red[w];
        ent += red[MAX_WARPS + w];
      }
      for (int j = lane; j < m; j += kWarp) e += h2[j] * S[j];
      c = warp_sum(c);
      ent = warp_sum(ent);
      e = warp_sum(e);
      if (lane == 0) {
        const float ne = (float)n_eff, cc = c + e;
        sc[0] = ne * logf(cc) - ent;
        sc[1] = cc;
        sc[2] = ne / cc;
      }
    }
    // meanwhile the other warps (all of it in emulation): per column, the
    // correlation of u with h that dL/dE_q[x] needs and the |h|^2 sum of
    // dL/dVar_q[x], into ge and (v is read no more) v
    {
      const int w0 = nw > 1 ? 1 : 0;
      float* ge = base + H.L.ge;
      float* hs = base + H.L.v;
      if (warp >= w0)
        for (int it = tid - w0 * kWarp; it < 2 * N; it += nt - w0 * kWarp)
          ge_column(D, u, h, h2, ge, hs, it);
    }
    VAE_SYNC();
  }
  clk_mark(ck, PH_ELBO);

  // ================= backward (dL/dloss = 1) =================
  // ---- per column: dL/dq and the softmax VJP (gz in place of q); per tap j,
  // one warp: gh[ri, j] = g_C sum_n (u (*) E_q[x]) + 2 g_C h S[j]
  {
    const Dims& D = H.D;
    const int N = D.N, m = D.m, mh2 = D.mh2, n_eff = D.n_eff, us = D.us;
    float* q = base + H.L.q;
    const float* amps = base + H.L.amps;
    const float* a2 = base + H.L.a2;
    const float* eq = base + H.L.eq;
    const float* u = base + H.L.u;
    const float* h = base + H.L.state[2];
    const float* ge = base + H.L.ge;
    const float* hs = base + H.L.v;
    const float* S = base + H.L.S;
    float* gh = base + H.L.gh;
    const float g_c = base[H.L.sc + 2];
    for (int it = tid; it < 2 * N; it += nt) softmax_vjp_column<NL>(D, q, amps, a2, eq, ge, hs, g_c, it);
    for (int j = nw - 1 - warp; j < m; j += nw) {  // the last warps have the fewest columns
      const float* ur = u + (j & 1) * us;  // n = (j & 1) + 2 i: plane j & 1, index i
      float ar = 0.f, ai = 0.f;
      for (int i = lane; 2 * i + (j & 1) < n_eff; i += kWarp) {
        const int tt = i + ((j & 1) + mh2 - j) / 2;  // (n + mh2 - j) / 2
        const float ei = eq[tt], eqq = eq[N + tt], uR = ur[i], uI = ur[2 * us + i];
        ar = VAE_FMA(uI, eqq, VAE_FMA(uR, ei, ar));
        ai = VAE_FMA(-uR, eqq, VAE_FMA(uI, ei, ai));
      }
      ar = warp_sum(ar);
      ai = warp_sum(ai);
      if (lane == 0) {
        gh[j] = g_c * ar + 2.f * g_c * h[j] * S[j];
        gh[m + j] = g_c * ai + 2.f * g_c * h[m + j] * S[j];
      }
    }
    VAE_SYNC();
  }
  clk_mark(ck, PH_GQ);

  // ---- gW2' (d C + j, c) = sum_n gz[c, n] a[j, 2n + d - 1], bias column 3C:
  // sum_n gz[c, n]. Warp items: (channel group, 32 / G consecutive columns)
  // with the n split over the lanes and closed by tile_out, or a channel
  // group's biases.
  {
    const Dims& D = H.D;
    const int ch = D.ch, N = D.N, qs = D.qs, rs = D.rs, oo = D.oo, ng = ch / G;
    constexpr int CW = 32 / G;
    const int n_cg = (3 * ch + CW - 1) / CW;
    const float* gz = base + H.L.q;
    const float* a = base + H.L.a;
    float* gw2 = base + H.L.gw2;
    for (int it = warp; it < ng * (n_cg + 1); it += nw) {
      const int g = it / (n_cg + 1), cg = it - g * (n_cg + 1);
      const float* gzg = gz + G * g * qs;
      if (cg < n_cg) {
        const float* ar[CW];
#pragma unroll
        for (int s = 0; s < CW; ++s) {
          const int col = cg * CW + s < 3 * ch ? cg * CW + s : 0, d = col / ch, j = col - d * ch;
          ar[s] = a + j * rs + (d == 1 ? 0 : (d == 0 ? oo - 1 : oo));
        }
        float acc[32] = {};  // [col slot s][channel q] at s G + q
        for (int n = lane; n < N; n += kWarp) {
          float gv[G];
#pragma unroll
          for (int qq = 0; qq < G; ++qq) gv[qq] = gzg[qq * qs + n];
#pragma unroll
          for (int s = 0; s < CW; ++s) {
            const float av = ar[s][n];
#pragma unroll
            for (int qq = 0; qq < G; ++qq) acc[s * G + qq] = VAE_FMA(gv[qq], av, acc[s * G + qq]);
          }
        }
        tile_out(acc, lane, [&](int i, float val) {
          const int col = cg * CW + i / G;
          if (col < 3 * ch) gw2[col * ch + G * g + i % G] = val;
        });
      } else {
        float acc[G] = {};
        for (int n = lane; n < N; n += kWarp)
#pragma unroll
          for (int qq = 0; qq < G; ++qq) acc[qq] += gzg[qq * qs + n];
#pragma unroll
        for (int qq = 0; qq < G; ++qq) {
          const float tot = warp_sum(acc[qq]);
          if (lane == 0) gw2[3 * ch * ch + G * g + qq] = tot;
        }
      }
    }
    VAE_SYNC();
  }
  clk_mark(ck, PH_GW2);

  // ---- ge = conv2^T gz, (C, L) planes, into a: even sample 2n takes tap 1 at
  // n; odd 2n + 1 takes tap 2 at n and tap 0 at n + 1 (gz is zero at N). Warp
  // items (channel group, parity, block of kWarp TS symbols).
  {
    const Dims& D = H.D;
    const int ch = D.ch, N = D.N, qs = D.qs, rs = D.rs, oo = D.oo, w2s = D.w2s, ng = ch / G;
    const int nb = D.np / (kWarp * TS);
    const float* gz = base + H.L.q;
    const float* w2n = base + H.L.w2n;
    float* a = base + H.L.a;
    for (int it = warp; it < ng * 2 * nb; it += nw) {
      const int g = it / (2 * nb), rem = it - g * 2 * nb, p = rem / nb;
      const int n0 = (rem - p * nb) * kWarp * TS + lane;
      const float* wg = w2n + G * g;
      float acc[G][TS] = {};
      if (p == 0) {
        for (int c = 0; c < ch; ++c) {
          float w[G];
          ldv<G>(wg + c * w2s + ch, w);
#pragma unroll
          for (int s = 0; s < TS; ++s) {
            const float gv = gz[c * qs + n0 + kWarp * s];
#pragma unroll
            for (int qq = 0; qq < G; ++qq) acc[qq][s] = VAE_FMA(w[qq], gv, acc[qq][s]);
          }
        }
      } else {
        for (int c = 0; c < ch; ++c) {
          float w2[G], w0[G];
          ldv<G>(wg + c * w2s + 2 * ch, w2);
          ldv<G>(wg + c * w2s, w0);
#pragma unroll
          for (int s = 0; s < TS; ++s) {
            const float* gr = gz + c * qs + n0 + kWarp * s;
            const float g2 = gr[0], g0 = gr[1];
#pragma unroll
            for (int qq = 0; qq < G; ++qq) acc[qq][s] = VAE_FMA(w0[qq], g0, VAE_FMA(w2[qq], g2, acc[qq][s]));
          }
        }
      }
#pragma unroll
      for (int s = 0; s < TS; ++s) {
        const int n = n0 + kWarp * s;
        if (n < N)
#pragma unroll
          for (int qq = 0; qq < G; ++qq) a[(G * g + qq) * rs + p * oo + n] = acc[qq][s];
      }
    }
    VAE_SYNC();
  }
  clk_mark(ck, PH_CONV2T);

  // ---- BatchNorm VJP sums, one warp per channel: g_gamma, g_beta, and
  // s1 = mean(ge gamma), s2 = mean(ge gamma xhat)
  if (H.D.bn) {
    const Dims& D = H.D;
    const int ch = D.ch, L = D.L, rs = D.rs;
    const float* a = base + H.L.a;
    const float* xhat = base + H.L.xhat;
    const float* bnp = base + H.L.state[3];
    float* gbn = base + H.L.gbn;
    float* bnst = base + H.L.bnst;
    const float inv_l = 1.f / (float)L;
    for (int c = warp; c < ch; c += nw) {
      const float* ge = a + c * rs;
      const float* xh = xhat + c * rs;
      const float gamma = bnp[2 * c];
      float sg = 0.f, sb = 0.f, s1 = 0.f, s2 = 0.f;
      for (int t = lane; t < L; t += kWarp) {
        const int o = toff(D, t);
        const float g = ge[o], gx = g * gamma;
        sg += g * xh[o];
        sb += g;
        s1 += gx;
        s2 += gx * xh[o];
      }
      sg = warp_sum(sg);
      sb = warp_sum(sb);
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        gbn[2 * c] = sg;
        gbn[2 * c + 1] = sb;
        bnst[4 * c + 2] = s1 * inv_l;
        bnst[4 * c + 3] = s2 * inv_l;
      }
    }
    VAE_SYNC();
  }

  // ---- [BatchNorm input gradient] and the ELU VJP: gh1 = ge elu'(h1), into a;
  // rows (channel, plane)
  {
    const Dims& D = H.D;
    const int ch = D.ch, N = D.N, rs = D.rs, oo = D.oo;
    const bool bn = D.bn;
    float* a = base + H.L.a;
    const float* dact = base + H.L.dact;
    const float* xhat = base + H.L.xhat;
    const float* bnp = base + H.L.state[3];
    const float* bnst = base + H.L.bnst;
    for (int r = warp; r < 2 * ch; r += nw) {
      const int c = r >> 1, o0 = c * rs + (r & 1) * oo;
      const float istd = bnst[4 * c + 1], s1 = bnst[4 * c + 2], s2 = bnst[4 * c + 3], gamma = bnp[2 * c];
      for (int n = lane; n < N; n += kWarp) {
        float g = a[o0 + n];
        if (bn) g = istd * (g * gamma - s1 - xhat[o0 + n] * s2);
        a[o0 + n] = g * dact[o0 + n];
      }
    }
    VAE_SYNC();
  }
  clk_mark(ck, PH_BNELU);

  // ---- gW1' (2k + i, c) = sum_t gh1[c, t] x[i, t + k - p1], bias column 2 k1:
  // sum_t gh1[c, t]. Warp items: (channel group, 32 / G consecutive tap
  // columns; columns past 2 k1 read x and are not stored) with the t split
  // over the lanes and closed by tile_out, or a channel group's biases.
  {
    const Dims& D = H.D;
    const int ch = D.ch, L = D.L, k1 = D.k1, p1 = D.p1, rs = D.rs, xs = D.xs, ng = ch / G;
    constexpr int CW = 32 / G;
    const int n_cg = (2 * k1 + CW - 1) / CW;
    const float* gh1 = base + H.L.a;
    float* gw1 = base + H.L.gw1;
    for (int it = warp; it < ng * (n_cg + 1); it += nw) {
      const int g = it / (n_cg + 1), cg = it - g * (n_cg + 1);
      const float* gr = gh1 + G * g * rs;
      if (cg < n_cg) {
        // column cg CW + s = 2k + i reads x[i, t + k - p1] = x + i xs + xl + t + k - p1
        const float* xc = x + cg * (CW / 2) + (D.xl - p1);
        float acc[32] = {};  // [col slot s][channel q] at s G + q
        // the samples t = t_first + t_step j (t_step even: one sample plane)
        auto run = [&](int t_first, int t_step) {
          const float* gp = gr + toff(D, t_first);
          const float* xp = xc + t_first;
          for (int t = t_first; t < L; t += t_step, gp += t_step / 2, xp += t_step) {
            float gv[G];
#pragma unroll
            for (int qq = 0; qq < G; ++qq) gv[qq] = gp[qq * rs];
#pragma unroll
            for (int s = 0; s < CW; ++s) {
              const float xv = xp[(s & 1) * xs + (s >> 1)];
#pragma unroll
              for (int qq = 0; qq < G; ++qq) acc[s * G + qq] = VAE_FMA(gv[qq], xv, acc[s * G + qq]);
            }
          }
        };
#ifdef VAE_HOST_EMULATION
        run(0, 2);
        run(1, 2);
#else
        run(lane, kWarp);
#endif
        tile_out(acc, lane, [&](int i, float val) {
          const int col = cg * CW + i / G;
          if (col < 2 * k1) gw1[col * ch + G * g + i % G] = val;
        });
      } else {
        float acc[G] = {};
        for (int t = lane; t < L; t += kWarp) {
          const int o = toff(D, t);
#pragma unroll
          for (int qq = 0; qq < G; ++qq) acc[qq] += gr[qq * rs + o];
        }
#pragma unroll
        for (int qq = 0; qq < G; ++qq) {
          const float tot = warp_sum(acc[qq]);
          if (lane == 0) gw1[2 * k1 * ch + G * g + qq] = tot;
        }
      }
    }
    VAE_SYNC();
  }
  clk_mark(ck, PH_GW1);
}

// Kernel H's block for channel tiles of G and NL levels (0: any): run r trains
// its whole experiment.
template <int G, int NL>
VAE_DEV void experiment_run(float* smem, int tid, int nt, int r, const Args& A) {
  Hdr* hp = reinterpret_cast<Hdr*>(smem);
  if (tid == 0) {
    hp->D = make_dims(A.n_sym, A.m, A.n_lev, A.k1, A.batchnorm != 0);
    hp->L = make_layout(hp->D);
  }
  VAE_SYNC();
  const Hdr& H = *hp;
  float* const base = smem;
  int sz[N_STATE];
  state_sizes(H.D, sz);
  for (int l = tid; l < A.n_lev; l += nt) {
    const float a = A.amps[l];
    base[H.L.amps + l] = a;
    base[H.L.a2 + l] = a * a;
  }
  for (int i = H.L.x + tid; i < H.L.eq; i += nt) base[i] = 0.f;  // x, dact, a, xhat, q and their pads
  for (int i = 0; i < N_STATE; ++i)
    for (int k = tid; k < sz[i]; k += nt)
      base[H.L.state[i] + sidx(H.D, i, k)] = A.in[i][(long long)r * sz[i] + k];
  for (int k = tid; k < H.D.ch * H.D.w2s; k += nt) {
    const int c = k / H.D.w2s, col = k - c * H.D.w2s;
    base[H.L.w2n + k] = A.in[1][(long long)r * sz[1] + c * H.D.w2w + col];
  }
  Clock ck;
  ck.on = A.clocks != nullptr && r == 0 && tid == 0;
  ck.c = reinterpret_cast<long long*>(base + H.L.clk);
  if (ck.on)
    for (int p = 0; p < N_PHASES; ++p) ck.c[p] = 0;
  const int n_groups = H.D.bn ? 4 : 3;  // w1, w2, h [, gamma | beta]
  const float* rx_r = A.rx + (long long)r * A.n_epochs * 2 * A.n_total;
  const long long n_steps = (long long)A.n_epochs * A.n_batches;
  VAE_SYNC();
  for (int i = tid; i < 2 * H.D.L; i += nt) {  // minibatch 0 into buffer 0
    const int row = i / H.D.L;
    base[H.L.x + row * H.D.xs + H.D.xl + i - row * H.D.L] = rx_r[row * A.n_total + (i - row * H.D.L)];
  }

  auto write_slot = [&](int slot) {  // the eval arrays are the first N_EVAL state arrays
    for (int i = 0; i < N_EVAL; ++i) {
      const long long ofs = ((long long)slot * A.R + r) * sz[i];
      for (int k = tid; k < sz[i]; k += nt) A.ev[i][ofs + k] = base[H.L.state[i] + sidx(H.D, i, k)];
    }
  };
  VAE_SYNC();

  for (int e = 0; e < A.n_epochs; ++e) {
    for (int b = 0; b < A.n_batches; ++b) {
      clk_start(ck);
      const long long k = (long long)e * A.n_batches + b;
      if (tid == nt - 1) {  // AMSGrad's bias corrections, read after gW1
        const double tt = (double)(A.step0 + k + 1);
        base[H.L.sc + 4] = (float)(1.0 - pow(0.9, tt));
        base[H.L.sc + 5] = (float)(1.0 - pow(0.999, tt));
      }
      // the next minibatch, copied into the other x buffer during the step
      if (k + 1 < n_steps) {
        const int e1 = b + 1 < A.n_batches ? e : e + 1, b1 = b + 1 < A.n_batches ? b + 1 : 0;
        const float* src = rx_r + (long long)e1 * 2 * A.n_total + (long long)b1 * H.D.L;
        float* dst = base + H.L.x + ((k + 1) & 1) * 2 * H.D.xs + H.D.xl;
        for (int i = tid; i < H.D.L; i += nt) {
          copy_async(dst + i, src + i);
          copy_async(dst + H.D.xs + i, src + A.n_total + i);
        }
      }
      clk_mark(ck, PH_LOAD);
      nn_step<G, NL>(H, base, base + H.L.x + (k & 1) * 2 * H.D.xs, A.momentum, tid, nt, ck);

      if (tid == 0) A.losses[k * A.R + r] = base[H.L.sc];
      const float bc1 = base[H.L.sc + 4], bc2 = base[H.L.sc + 5];
      const int grads[4] = {H.L.gw1, H.L.gw2, H.L.gh, H.L.gbn};
      for (int g = 0; g < n_groups; ++g)  // state g is the parameter, 5 + 3g.. its moments
        siso::amsgrad(base + H.L.state[g], base + H.L.state[5 + 3 * g], base + H.L.state[6 + 3 * g],
                      base + H.L.state[7 + 3 * g], base + grads[g], sz[g], A.lr, bc1, bc2, tid, nt);
      {  // W2's natural copy, from the elements this thread just updated
        const int ch = H.D.ch, w2s = H.D.w2s;
        const float* w2 = base + H.L.state[1];
        float* w2n = base + H.L.w2n;
        for (int i = tid; i < 3 * ch * ch; i += nt) {
          const int col = i / ch, c = i - col * ch;
          w2n[c * w2s + col] = w2[i];
        }
      }
      copy_async_wait();
      VAE_SYNC();
      clk_mark(ck, PH_AMS);
    }
    if (e % A.epe == 0 && e / A.epe < A.n_evals) write_slot(e / A.epe);
  }
  write_slot(A.n_evals);
  for (int i = 0; i < N_STATE; ++i)
    for (int k = tid; k < sz[i]; k += nt)
      A.out[i][(long long)r * sz[i] + k] = base[H.L.state[i] + sidx(H.D, i, k)];
  if (ck.on)
    for (int p = 0; p < N_PHASES; ++p) A.clocks[p] = ck.c[p];
}

// Kernel H's block: run r trains its whole experiment (the launchers'
// entry): 4-channel tiles where C allows, else 2; 64-QAM's 8 levels unrolled.
VAE_DEV void experiment_block(float* smem, int tid, int nt, int r, const Args& A) {
  if (A.n_lev == 8)
    experiment_run<4, 8>(smem, tid, nt, r, A);
  else if (2 * A.n_lev % 4 == 0)
    experiment_run<4, 0>(smem, tid, nt, r, A);
  else
    experiment_run<2, 0>(smem, tid, nt, r, A);
}

// Shared memory (floats) of one block.
inline int smem_floats(int n_sym, int m, int n_lev, int k1, bool bn) {
  return make_layout(make_dims(n_sym, m, n_lev, k1, bn)).total;
}

}  // namespace nn
