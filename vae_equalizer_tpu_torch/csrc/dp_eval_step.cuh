// Kernel K's body: the DP VAE frame's eval (sync, aligned SER and MI) of one
// run, split over the kCluster blocks of a thread block cluster.
//
// Replaces no TPU kernel. The JAX package evaluates a frame with plain jnp
// (vae_equalizer_tpu/train/dp.py:187-214, _dp_frame_eval_mb's stats branch);
// on this card the port's plain version of it (vae_equalizer_tpu_torch/train/
// dp.py: _dp_frame_eval_mb) is ~590 small PyTorch kernels a frame of 8 runs,
// 1.2 ms of device time and, in the loop mode, most of the host's launches.
// Kernel K computes the same numbers in one launch, with the plain version's
// decisions in its order:
//   1. both sync searches (E_q[x^I], then the constellation output's I): 21
//      cyclic shifts over the first corr_len symbols, |corr| per (component,
//      equalizer pol b, tx pol i), the first maximum over the shifts, then
//      over the components, and the XY / YX choice by >=;
//   2. the level decode of tx and the aligned indices (align_idx_dp), read
//      at the shifted positions and never stored;
//   3. the eval mask at those positions (batch_cut_weight or
//      margin_weight_maxshift, by the weight object's kind);
//   4. the masked soft SER (8 IQ-flip x rotation variants of kernel B's
//      decisions), the MI (8 traces rebuilt from out, mm and s1, and the
//      prior), and the PCS constellation SER (the masked magnitude rescale,
//      then 8 variants; non-finite outputs count as errors);
//   5. the pol roll by r (soft SER, MI) and by r_c (constellation SER).
//
// What bounds it: neither bytes nor operations. A flagship frame of 8 runs
// reads ~7 MB (2 us at 3.35 TB/s) and does ~4e7 operations (chip_smoke.py:
// _eval_flops), most of them the MI's 8 expf, divisions and log2f a symbol
// and pol. Measured on an H100 with clock64() (ops/eval_kernel.py:
// eval_clocks), a flagship launch takes ~70,000 cycles: the soft SER and MI
// pass 43 %, the constellation pass 23 %, the staging and correlations 18 %;
// each phase is latency-bound (R = 1 takes as long as R = 8, and 256 or 384
// threads a block run slower than 512). So each run gets a cluster of
// kCluster blocks on as many SMs: block k takes the k-th slice of the
// correlation window and of the frame's symbols; partial sums meet through
// distributed shared memory (each block reads its peers' partials after a
// cluster barrier, a thread a value), every block takes the same decisions
// from the same totals, and block 0 writes the run's results. The MI's
// hypotheses far from the output (most of the 8) skip exp, the division
// and log2 where the result is log2(eps) anyway (trace). Every sum is
// fixed-order (per thread, then a fixed shuffle tree, then warps and blocks
// in rank order) and accumulated in float64 like core/reduce.py: run_sum,
// and a run's cluster reads only that run's data, so a run's results do not
// depend on how many runs share the launch (run sharding). Counts are
// integers; the SER, MI and magnitude divisions and the MI's per-symbol
// terms round in float32 as the plain version's elementwise operations do
// (the library is built with --fmad=false, ops/_build.py).
//
// The one place K may decide otherwise: the sync correlations. The plain
// _dp_shift_core sums them in float32 (an einsum), K in float64, so where two
// shifts' |corr| (or the XY and YX sums) lie within float32 rounding of each
// other, the two may pick different shifts. A synced frame's peak stands
// ~45:1 above the next shift (ops/eval_kernel.py: SYNC_CORR_LEN), far from
// such a tie; the tests and chip_smoke.py hold shift and r equal on the
// flagship's and VAEflex's frames, not on crafted ties.
//
// The body also compiles as plain C++ (VAE_HOST_EMULATION): one "thread"
// (tid 0, nt 1) runs every item, a barrier is a no-op, and the cluster's
// blocks run phase by phase, one after another (csrc/dp_eval_host_emulation.cpp).
#pragma once

#include "portable.cuh"

namespace ev {

using namespace vae;  // bf16 and ld(): kernel B's streams, read in place

constexpr int kShifts = 21;  // the sync search's cyclic shifts, -10 .. 10
constexpr int kHalf = kShifts / 2;
constexpr int kCluster = 8;  // blocks (SMs) per run
constexpr int kThreads = 512;
constexpr int kMaxLev = 16;      // up to 256-QAM
constexpr int kMaxCorr = 2000;   // the longest sync window
constexpr int kChunk = (kMaxCorr + kCluster - 1) / kCluster;  // a block's share of it
constexpr int kTile = 3;         // shifts per correlation item: (search, b, 3 shifts) x 4 sums
constexpr int kItems = 2 * 2 * kShifts / kTile;
constexpr int kCorr = 2 * 2 * 2 * 2 * kShifts;  // (search, comp, b, i, shift)
constexpr float kEps = 1e-12f;   // the MI's log guard
enum MaskKind { kBatchCut = 0, kMargin = 1 };

// The warp's sums: a one-lane warp in emulation. Kept here, not in
// portable.cuh: cma, dfe and siso emulate the card's lanes instead.
#ifdef VAE_HOST_EMULATION
constexpr int kWarp = 1;
template <typename T>
inline T warp_sum(T v) {
  return v;
}
template <int G, typename T>
inline T group_sum(T v) {
  return v;
}
#else
constexpr int kWarp = 32;
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
// the sum over each aligned group of G lanes, a fixed xor tree
template <int G, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
#endif
VAE_DEV int ld_idx(const int* p) { return *p; }
VAE_DEV int ld_idx(const bf16* p) { return (int)ld(p); }
constexpr int kMaxWarps = (kThreads + kWarp - 1) / kWarp;
// lanes that share a correlation item, every 16th symbol of the chunk each
// (one in emulation); kItems x kLanes threads, whole warps
constexpr int kLanes = kWarp < 16 ? kWarp : 16;

// The launch's arguments. Streams of kernel B, (m_max, R, 2 pol, 2 comp, L)
// for out / dec / mm / s1 (one set of strides, in elements; time stride 1)
// and (m_max, R, 2 pol, L) for eq, read in place; symbol n of the frame is
// (n / L, n % L). tx (R, 2 pol, 2 comp, N = m_max L) levels (time stride 1).
// P (n_lev) per run at p_run (0: shared), var (2) at v_run, nu_sc per run
// from nu_runs or the shared nu. mask: kind, then (m_max, batch_len, n_cut)
// of the batch cut or (n_eval) of the margin trim, and the margin. res_f
// (R, 6): ser_const, ser_soft, mi per tx pol; res_i (R, 3): shift, r.
struct Args {
  int R, m_max, L, n_lev, corr_len;
  const void *out, *dec, *eq;
  const float *mm, *s1;
  long long s_mb, s_run, s_pol, s_comp, e_mb, e_run, e_pol;
  const float* tx;
  long long t_run, t_pol, t_comp;
  const float *amps, *P, *var, *nu_runs;
  long long p_run, v_run;
  float nu, inv_step, half;
  int mask_kind, mask_a, mask_b, mask_c, margin;
  float* res_f;
  int* res_i;
};

// A block's partial sums of passes A and B, read by its peers.
constexpr int kAI = 2 * 8 + 2 + 2;  // per pol: soft SER errors (8), soft and constellation weights
constexpr int kAD = 2 * 9 + 2;      // per pol: MI traces (8) and prior; |tx| and |out| sums
constexpr int kBI = 2 * 8;          // per pol: constellation SER errors (8)

struct Shared {
  double tx_w[2][2][kChunk];                 // tx[i][c] over this block's chunk
  double e_w[2][2][kChunk + 2 * kHalf];      // [search][b]: e from kHalf before the chunk
  double corr[kCorr];                        // this block's chunk, read by its peers
  double total[kCorr];                       // summed over the cluster
  double peak[16];                           // (search, comp, b, i): the largest |corr|
  int at[16];                                // ... and its first shift
  int shift[2][2], r[2];                     // [search]: 0 E_q[x^I], 1 the constellation
  float amps[kMaxLev], lp[kMaxLev], d[kMaxLev], inv2v[2], nu, scale, eps, log_eps;
  int wi[kMaxWarps][kAI];                    // per-warp partials
  double wd[kMaxWarps][kAD];
  int a_i[kAI], b_i[kBI];                    // the block's partials, read by its peers
  double a_d[kAD];
  int sum_i[kAI + kBI];                      // block 0: the cluster's totals
  double sum_d[kAD];
};

// (search, comp, b, i, shift) -> the correlation's slot
VAE_DEV int slot(int g, int c, int b, int i, int s) { return (((g * 2 + c) * 2 + b) * 2 + i) * kShifts + s; }

VAE_DEV int mod(int x, int n) {
  const int m = x % n;
  return m < 0 ? m + n : m;
}

// n - s wrapped into [0, N) for |s| <= N (the launcher refuses N < kShifts)
VAE_DEV int wrap(int x, int n) { return x < 0 ? x + n : (x >= n ? x - n : x); }

// "v is above best" as torch.argmax / max see it: NaN above everything
VAE_DEV bool above(double v, double best) { return v > best || (v != v && best == best); }
VAE_DEV float max_nan(float a, float b) { return (b != b || b > a) ? b : a; }
VAE_DEV float min_nan(float a, float b) { return (b != b || b < a) ? b : a; }

// The eval mask at aligned position t (s0: the search's shift of pol 0, ms:
// its largest |shift|): batch_cut_weight / margin_weight_maxshift
// (train/eval_utils.py) in integers.
VAE_DEV int mask(const Args& a, int t, int s0, int ms) {
  if (a.mask_kind == kMargin) return t >= a.margin && t < a.mask_a - a.margin - ms;
  const int j = t % a.mask_b, mb = t / a.mask_b, keep = a.mask_b - s0 - a.mask_c;
  const int pos = mb * keep + j;
  return j < keep && pos >= a.margin && pos < a.mask_a * keep - a.margin - ms;
}

// Level index of a tx level (metrics/ser.py: _decode_levels)
VAE_DEV int decode(const Args& a, float x) { return (int)rintf(a.inv_step * x + a.half); }

// Symbol n's offset in the (mb, run, pol, comp, t) streams and in eq
VAE_DEV long long at_s(const Args& a, int run, int n) {
  return (n / a.L) * a.s_mb + run * a.s_run + n % a.L;
}
VAE_DEV long long at_e(const Args& a, int run, int n) {
  return (n / a.L) * a.e_mb + run * a.e_run + n % a.L;
}

// Sum the threads' partials: a fixed shuffle tree in each warp, then the
// warps in order; threads q < NI + ND write the block's totals.
template <int NI, int ND>
VAE_DEV void block_sum(Shared& sh, const int (&ci)[NI], const double (&cd)[ND], int* out_i,
                       double* out_d, int tid, int nt) {
  const int lane = tid % kWarp, warp = tid / kWarp, nw = (nt + kWarp - 1) / kWarp;
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    const int v = warp_sum(ci[k]);
    if (lane == 0) sh.wi[warp][k] = v;
  }
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const double v = warp_sum(cd[k]);
    if (lane == 0) sh.wd[warp][k] = v;
  }
  VAE_SYNC();
  for (int q = tid; q < NI + ND; q += nt) {
    if (q < NI) {
      int s = 0;
      for (int w = 0; w < nw; ++w) s += sh.wi[w][q];
      out_i[q] = s;
    } else {
      double s = 0.0;
      for (int w = 0; w < nw; ++w) s += sh.wd[w][q - NI];
      out_d[q - NI] = s;
    }
  }
  VAE_SYNC();
}

// Phase 1: the run constants, then this block's chunk of both correlation
// windows staged, and its partial correlations (corr).
template <typename SF>
VAE_DEV void sync_partial(const Args& a, int run, int rank, Shared& sh, int tid, int nt) {
  const int N = a.m_max * a.L, lc = a.corr_len < N ? a.corr_len : N;
  const int chunk = (lc + kCluster - 1) / kCluster, l0 = rank * chunk;
  const int len = lc - l0 < 0 ? 0 : (lc - l0 < chunk ? lc - l0 : chunk);
  const SF* out = static_cast<const SF*>(a.out);
  const SF* eq = static_cast<const SF*>(a.eq);
  for (int l = tid; l < a.n_lev; l += nt) {
    sh.amps[l] = a.amps[l];
    sh.lp[l] = log2f(a.P[run * a.p_run + l]);
  }
  for (int j = tid; j < 2; j += nt) sh.inv2v[j] = 0.5f / a.var[run * a.v_run + j];
  if (tid == 0) {
    sh.nu = a.nu_runs ? a.nu_runs[run] : a.nu;
    sh.eps = kEps;
  }
  for (int q = tid; q < 4 * len; q += nt) {
    const int ic = q / len, l = q % len;
    sh.tx_w[ic / 2][ic % 2][l] = a.tx[run * a.t_run + (ic / 2) * a.t_pol + (ic % 2) * a.t_comp + l0 + l];
  }
  const int ext = len + 2 * kHalf;
  for (int q = tid; q < 4 * ext; q += nt) {
    const int gb = q / ext, k = q % ext, b = gb % 2;
    const int n = mod(l0 - kHalf + k, lc);
    sh.e_w[gb / 2][b][k] = gb / 2 == 0 ? ld(eq + at_e(a, run, n) + b * a.e_pol)
                                       : ld(out + at_s(a, run, n) + b * a.s_pol);
  }
  VAE_SYNC();
  // log2(eps) at run time, as the plain version's log2 computes it (not folded)
  if (tid == 0) sh.log_eps = log2f(sh.eps);
  // item (g, b, tile): the 4 (comp, tx pol) sums of kTile shifts s over every
  // kLanes-th symbol of the chunk, then the item's lanes summed; e at
  // l - (s - kHalf) is e_w[l + 2 kHalf - s]
  for (int q = tid; q < kItems * kLanes; q += nt) {
    const int lane = q % kLanes, item = q / kLanes;
    const int s0 = (item % (kShifts / kTile)) * kTile, b = (item / (kShifts / kTile)) % 2;
    const int g = item / (2 * kShifts / kTile);
    double acc[kTile][2][2] = {};
    for (int l = lane; l < len; l += kLanes) {
      double t[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) t[i][c] = sh.tx_w[i][c][l];
#pragma unroll
      for (int u = 0; u < kTile; ++u) {
        const double e = sh.e_w[g][b][l + 2 * kHalf - s0 - u];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int i = 0; i < 2; ++i) acc[u][c][i] += t[i][c] * e;
      }
    }
#pragma unroll
    for (int u = 0; u < kTile; ++u)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const double v = group_sum<kLanes>(acc[u][c][i]);
          if (lane == 0) sh.corr[slot(g, c, b, i, s0 + u)] = v;
        }
  }
}

// Phase 2 (after a cluster barrier): the correlations summed over the
// cluster's blocks in rank order, then each search's decision
// (metrics/sync.py: _dp_shift_core), the same in every block.
template <typename Peer>
VAE_DEV void sync_decide(const Peer& peer, Shared& sh, int tid, int nt) {
  for (int q = tid; q < kCorr; q += nt) {
    double v = 0.0;
    for (int k = 0; k < kCluster; ++k) v += peer(k)->corr[q];
    sh.total[q] = v;
  }
  VAE_SYNC();
  for (int q = tid; q < 16; q += nt) {  // (g, c, b, i): the first largest |corr| over the shifts
    const int base = q * kShifts;  // = slot(g, c, b, i, 0)
    double best = fabs(sh.total[base]);
    int ind = 0;
    for (int s = 1; s < kShifts; ++s) {
      const double v = fabs(sh.total[base + s]);
      if (above(v, best)) best = v, ind = s;
    }
    sh.peak[q] = best;
    sh.at[q] = ind;
  }
  VAE_SYNC();
  for (int g = tid; g < 2; g += nt) {
    double cmax[2][2];  // [b][i]: the best component's peak
    int pick[2][2];
    for (int b = 0; b < 2; ++b)
      for (int i = 0; i < 2; ++i) {
        const int q0 = ((g * 2 + 0) * 2 + b) * 2 + i, q1 = ((g * 2 + 1) * 2 + b) * 2 + i;
        const bool one = above(sh.peak[q1], sh.peak[q0]);  // the first maximum over the components
        cmax[b][i] = one ? sh.peak[q1] : sh.peak[q0];
        pick[b][i] = one ? sh.at[q1] : sh.at[q0];
      }
    const bool xy = cmax[0][0] + cmax[1][1] >= cmax[0][1] + cmax[1][0];
    sh.shift[g][0] = kHalf - (xy ? pick[0][0] : pick[0][1]);
    sh.shift[g][1] = kHalf - (xy ? pick[1][1] : pick[1][0]);
    sh.r[g] = xy ? 0 : 1;
  }
  VAE_SYNC();
}

// One MI trace: log2(q + eps) of the posterior at level a, rebuilt from the
// demapper's statistics (metrics/mi.py: mutual_information_ambiguity_mb_stats).
// Where mm - met < -46, exp is below 2^-65 and so is q (s1 >= 1: its largest
// term is exp(0)), so q + eps rounds to eps and the trace is log2(eps), with
// no exp or division (whose slow path a zero or subnormal quotient takes).
VAE_DEV float trace(float o, float mm, float s1, float a, float inv2v, float nu, float log_eps) {
  const float d = o - a;
  const float met = d * d * inv2v + nu * a * a;
  const float z = mm - met;
  if (z < -46.0f && s1 >= 1.0f) return log_eps;
  return log2f(expf(z) / s1 + kEps);
}

// Phase 3: over this block's slice of the symbols, both pols: the soft SER
// errors and the MI traces at the E_q[x^I] sync's alignment, and the
// constellation sync's weights and magnitude sums.
template <typename SF, typename SD>
VAE_DEV void pass_a(const Args& a, int run, int rank, Shared& sh, int tid, int nt) {
  const int N = a.m_max * a.L, chunk = (N + kCluster - 1) / kCluster;
  const int n0 = rank * chunk, n1 = n0 + chunk < N ? n0 + chunk : N;
  const SF* out = static_cast<const SF*>(a.out);
  const SD* dec = static_cast<const SD*>(a.dec);
  const int top = a.n_lev - 1;
  const int r0 = sh.r[0], r1 = sh.r[1];
  const int s00 = sh.shift[0][0], s10 = sh.shift[1][0];
  const int ms0 = abs(s00) > abs(sh.shift[0][1]) ? abs(s00) : abs(sh.shift[0][1]);
  const int ms1 = abs(s10) > abs(sh.shift[1][1]) ? abs(s10) : abs(sh.shift[1][1]);
  const float nu = sh.nu;
  int ci[kAI] = {};
  double cd[kAD] = {};
  for (int n = n0 + tid; n < n1; n += nt) {
    const long long os = at_s(a, run, n);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long oj = os + j * a.s_pol;
      const float o0 = ld(out + oj), o1 = ld(out + oj + a.s_comp);
      // E_q[x^I] alignment: tx pol j ^ r at its shift, read at t
      {
        const int p = j ^ r0;
        const int t = wrap(n - sh.shift[0][p], N);
        const int w = mask(a, t, s00, ms0);
        const float wf = (float)w;
        const float* txp = a.tx + run * a.t_run + p * a.t_pol + t;
        const int di = decode(a, txp[0]), dq = decode(a, txp[a.t_comp]);
        const int ei = ld_idx(dec + oj), eqd = ld_idx(dec + oj + a.s_comp);
        const int vi[4] = {ei, top - ei, top - eqd, eqd};
        const int vq[4] = {eqd, top - eqd, ei, top - ei};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          ci[j * 8 + 2 * v] += ((vi[v] != di) | (vq[v] != dq)) * w;
          ci[j * 8 + 2 * v + 1] += ((vi[v] != di) | (vq[v] != top - dq)) * w;
        }
        ci[16 + j] += w;
        const float m0 = a.mm[oj], m1 = a.mm[oj + a.s_comp];
        const float z0 = a.s1[oj], z1 = a.s1[oj + a.s_comp];
        const float iv = sh.inv2v[j], le = sh.log_eps;
        const float ai = sh.amps[di], air = sh.amps[top - di];
        const float aq = sh.amps[dq], aqr = sh.amps[top - dq];
        // a1 a2 a3 a4 b1 b2 b3 b4 (mi.py: _best_of_ambiguities' arguments)
        const float tr[8] = {trace(o0, m0, z0, ai, iv, nu, le), trace(o0, m0, z0, air, iv, nu, le),
                             trace(o1, m1, z1, ai, iv, nu, le), trace(o1, m1, z1, air, iv, nu, le),
                             trace(o1, m1, z1, aq, iv, nu, le), trace(o1, m1, z1, aqr, iv, nu, le),
                             trace(o0, m0, z0, aq, iv, nu, le), trace(o0, m0, z0, aqr, iv, nu, le)};
#pragma unroll
        for (int k = 0; k < 8; ++k) cd[j * 9 + k] += (double)(tr[k] * wf);
        cd[j * 9 + 8] += (double)((sh.lp[di] + sh.lp[dq]) * wf);
      }
      // constellation alignment: the weights and the magnitude sums
      {
        const int p = j ^ r1;
        const int t = wrap(n - sh.shift[1][p], N);
        const int w = mask(a, t, s10, ms1);
        const float wf = (float)w;
        const float* txp = a.tx + run * a.t_run + p * a.t_pol + t;
        const float ti = sh.amps[decode(a, txp[0])], tq = sh.amps[decode(a, txp[a.t_comp])];
        cd[18] += (double)(sqrtf(ti * ti + tq * tq) * wf);
        cd[19] += (double)(sqrtf(o0 * o0 + o1 * o1) * wf);
        ci[18 + j] += w;
      }
    }
  }
  block_sum(sh, ci, cd, sh.a_i, sh.a_d, tid, nt);
}

// Phase 4 (after a cluster barrier): the magnitude rescale from the
// cluster's sums, then the constellation SER errors over this block's slice
// (metrics/ser.py: ser_constell_shaping).
template <typename SF, typename Peer>
VAE_DEV void pass_b(const Args& a, const Peer& peer, int run, int rank, Shared& sh, int tid, int nt) {
  for (int q = tid; q < 4; q += nt) {  // the cluster's |tx| and |out| sums and weights, in rank order
    if (q < 2) {
      double v = 0.0;
      for (int k = 0; k < kCluster; ++k) v += peer(k)->a_d[18 + q];
      sh.sum_d[18 + q] = v;
    } else {
      int v = 0;
      for (int k = 0; k < kCluster; ++k) v += peer(k)->a_i[16 + q];
      sh.sum_i[16 + q] = v;
    }
  }
  VAE_SYNC();
  if (tid == 0) {
    const float wf = (float)(sh.sum_i[18] + sh.sum_i[19]);
    sh.scale = ((float)sh.sum_d[18] / wf) / ((float)sh.sum_d[19] / wf);
    const float var0 = a.var[run * a.v_run];
    for (int l = 0; l + 1 < a.n_lev; ++l)
      sh.d[l] = (1.0f + 2.0f * sh.nu * var0) * (sh.amps[l] + sh.amps[l + 1]) / 2.0f;
  }
  VAE_SYNC();
  const int N = a.m_max * a.L, chunk = (N + kCluster - 1) / kCluster;
  const int n0 = rank * chunk, n1 = n0 + chunk < N ? n0 + chunk : N;
  const SF* out = static_cast<const SF*>(a.out);
  const int top = a.n_lev - 1, r1 = sh.r[1], s10 = sh.shift[1][0];
  const int ms1 = abs(s10) > abs(sh.shift[1][1]) ? abs(s10) : abs(sh.shift[1][1]);
  const float scale = sh.scale;
  int ci[kBI] = {};
  const double none[1] = {0.0};
  for (int n = n0 + tid; n < n1; n += nt) {
    const long long os = at_s(a, run, n);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const long long oj = os + j * a.s_pol;
      const float x0 = ld(out + oj) * scale, x1 = ld(out + oj + a.s_comp) * scale;
      const int p = j ^ r1;
      const int t = wrap(n - sh.shift[1][p], N);
      const int w = mask(a, t, s10, ms1);
      const float* txp = a.tx + run * a.t_run + p * a.t_pol + t;
      const int di = decode(a, txp[0]), dq = decode(a, txp[a.t_comp]);
      int p0 = 0, p1 = 0, m0 = 0, m1 = 0;
      for (int l = 0; l < top; ++l) {
        const float d = sh.d[l];
        p0 += x0 >= d;
        p1 += x1 >= d;
        m0 += x0 <= -d;
        m1 += x1 <= -d;
      }
      const int bad = !isfinite(x0) || !isfinite(x1);
      const int is[4] = {p0, m0, m1, p1};
      const int qs[4] = {p1, m1, p0, m0};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        ci[j * 8 + v] += ((is[v] != di) | (qs[v] != dq) | bad) * w;
        ci[j * 8 + 4 + v] += ((is[v] != di) | (qs[v] != top - dq) | bad) * w;
      }
    }
  }
  double unused[1];
  block_sum<kBI, 1>(sh, ci, none, sh.b_i, unused, tid, nt);
}

// Phase 5, block 0 (after a cluster barrier): the cluster's counts and sums
// in rank order (a thread each), then each estimator's variants reduced and
// the pols rolled.
template <typename Peer>
VAE_DEV void finish(const Args& a, const Peer& peer, int run, Shared& sh, int tid, int nt) {
  for (int q = tid; q < kAI + kBI + kAD; q += nt) {
    if (q < kAI + kBI) {
      int v = 0;
      for (int k = 0; k < kCluster; ++k) v += q < kAI ? peer(k)->a_i[q] : peer(k)->b_i[q - kAI];
      sh.sum_i[q] = v;
    } else {
      double v = 0.0;
      for (int k = 0; k < kCluster; ++k) v += peer(k)->a_d[q - kAI - kBI];
      sh.sum_d[q - kAI - kBI] = v;
    }
  }
  VAE_SYNC();
  if (tid != 0) return;
  const int* ai = sh.sum_i;
  const int* bi = sh.sum_i + kAI;
  const double* ad = sh.sum_d;
  float soft[2], mi[2], cons[2];
  for (int j = 0; j < 2; ++j) {
    const float ws = (float)ai[16 + j], wc = (float)ai[18 + j];
    soft[j] = (float)ai[j * 8] / ws;
    cons[j] = (float)bi[j * 8] / wc;
    for (int v = 1; v < 8; ++v) {
      soft[j] = min_nan(soft[j], (float)ai[j * 8 + v] / ws);
      cons[j] = min_nan(cons[j], (float)bi[j * 8 + v] / wc);
    }
    float t[8];
    for (int k = 0; k < 8; ++k) t[k] = (float)ad[j * 9 + k];
    // a1 + b1, a2 + b2, a4 + b3, a3 + b4, a1 + b2, a2 + b1, a3 + b3, a4 + b4
    const float hyp[8] = {t[0] + t[4], t[1] + t[5], t[3] + t[6], t[2] + t[7],
                          t[0] + t[5], t[1] + t[4], t[2] + t[6], t[3] + t[7]};
    float best = hyp[0];
    for (int k = 1; k < 8; ++k) best = max_nan(best, hyp[k]);
    mi[j] = (best - (float)ad[j * 9 + 8]) / ws;
  }
  float* rf = a.res_f + run * 6;
  int* ri = a.res_i + run * 3;
  for (int i = 0; i < 2; ++i) {
    rf[i] = cons[i ^ sh.r[1]];
    rf[2 + i] = soft[i ^ sh.r[0]];
    rf[4 + i] = mi[i ^ sh.r[0]];
    ri[i] = sh.shift[0][i];
  }
  ri[2] = sh.r[0];
}

}  // namespace ev
