// The block bodies of kernels C, D and I (csrc/cma_kernels.cu), in a header so
// that the host emulation (csrc/cma_host_emulation.cpp) compiles the same
// source. C and D's layouts (float32, contiguous; I's are with its body): y (4, lp) rows nu*2 + c of the
// normalized, zero-padded signal of one run; taps (8, m) rows
// chi*4 + nu*2 + c (= h (2, 2, 2, m)); out (4, n_sym) rows chi*2 + comp and
// e (n_sym, 2), both at the reference's rolled storage index
// (s - offset) mod n_sym.
//
// Lane-split sums: an item's dot product is split over a group of G lanes
// (G a power of two, groups aligned in the warp), each lane summing its own
// terms in order, and closed by an xor-butterfly of __shfl_xor_sync (every
// lane ends with the same bits). Sums run in this fixed order without
// atomics, so a launch repeats bit for bit.
//
// Under VAE_HOST_EMULATION this is plain C++ for checking the arithmetic
// without a GPU: one thread runs every item of every phase, computes each
// of an item's G lane partials in turn and closes them with the same
// butterfly (group_sum), so it reproduces the card's lane partition and
// summation order; barriers are no-ops and cp.async is a copy.

#ifndef CMA_STEP_CUH
#define CMA_STEP_CUH

#include "portable.cuh"

namespace cma {

constexpr int MAX_M = 64;  // taps per row
// The card's warp in emulation too (kept here, not in portable.cuh: dp,
// dp_eval and nn emulate a one-lane warp instead).
constexpr int kWarp = 32;

using namespace vae;  // the cp.async family

template <int N>
struct Vec {
  float v[N];
  VAE_DEV void add(const Vec& o) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] + o.v[i];
  }
#ifndef VAE_HOST_EMULATION
  __device__ __forceinline__ void add_lane(int off) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] + __shfl_xor_sync(0xffffffffu, v[i], off);
  }
#endif
};

// Each lane's partial sums of one item, for a group of up to a warp of lanes:
// on the card a thread holds its own lane's (p[0]); in emulation the one
// thread holds all of them.
template <int N>
struct Parts {
#ifdef VAE_HOST_EMULATION
  Vec<N> p[kWarp];
  Vec<N>& of(int l) { return p[l]; }
#else
  Vec<N> p[1];
  __device__ __forceinline__ Vec<N>& of(int) { return p[0]; }
#endif
};

// The butterfly over the g lanes of a group: level `off` adds lane l ^ off's
// value to lane l's (on the card the whole warp takes part).
template <int N>
VAE_DEV Vec<N> group_tree(Parts<N>& ps, int g) {
#ifdef VAE_HOST_EMULATION
  for (int off = g / 2; off > 0; off >>= 1)
    for (int i = 0; i < off; ++i) ps.p[i].add(ps.p[i + off]);
#else
#pragma unroll
  for (int off = g / 2; off > 0; off >>= 1) ps.p[0].add_lane(off);
#endif
  return ps.p[0];
}

// part(l): lane l's partial sums; the group's total (every lane the same bits).
template <int N, typename F>
VAE_DEV Vec<N> group_sum(int g, int lane, F&& part) {
  Parts<N> ps;
#ifdef VAE_HOST_EMULATION
  (void)lane;
  for (int i = 0; i < g; ++i) ps.p[i] = part(i);
#else
  ps.p[0] = part(lane);
#endif
  return group_tree<N>(ps, g);
}

// Phase clocks (measurement only): one thread adds the clock64() cycles of
// each phase into c[phase]; the launcher's `clocks` receives them summed over
// the frame (ops/cma_kernel.py: C_CLOCK_PHASES, ops/cma_frame_kernel.py:
// D_CLOCK_PHASES name them). Compiled in only for CLK = true, so a launch
// without clocks runs the body without them (kept per kernel: dp and nn
// switch theirs at run time instead).
template <bool CLK, int N>
struct Clock {
  bool on;
  long long t, c[N];
  VAE_DEV void start(bool enable) {
    on = CLK && enable;
    for (int p = 0; p < N; ++p) c[p] = 0;
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
      for (int p = 0; p < N; ++p) out[p] = c[p];
  }
};

// ---------------------------------------------------------------------------
// Kernel C: the per-symbol recurrence, one warp per run. Lane l owns the
// taps k = l + 32 j (j < TPL: 1 for M <= 32, so no lane carries a dead slot)
// of all 8 rows, in registers. Per symbol, on the dependent chain: each
// lane's o_re / o_im of both out-pols over its taps (w_I.h_re - w_Q.h_im,
// w_I.h_im + w_Q.h_re, closed before the butterfly: 4 trees of 5 levels, not
// 8), the errors and lane 0's stores, the tap updates (each lane its own
// taps, no barrier); the next symbol's window is read from device memory
// through L1, loaded before the butterfly. Measured per phase (PERF.md), the
// butterfly's shuffle latency then sets the chain; windows staged in shared
// memory by cp.async and out / e staged and stored 32 symbols at a time were
// both slower and are not used.

enum CPhase { C_DOT, C_REDUCE, C_ERR_STORE, C_UPDATE, C_NEXT, C_N_PHASES };

struct CArgs {
  const float* y;
  long long lp;
  int n_sym, m, sps, offset;
  const float* h_in;
  float* h_out;
  float* out;
  float* e;
  float big_r, lr2;
  int update;
  long long* clocks;
};

template <int TPL>
struct CLane {
  float h[8][TPL];   // taps, rows chi*4 + nu*2 + c
  float w[4][TPL];   // this symbol's window, rows nu*2 + c
  float wn[4][TPL];  // the next symbol's
};

template <bool CLK, int TPL, bool UPD>
VAE_DEV void cma_symbols_run(int lane, const CArgs& a) {
  const int m = a.m, sps = a.sps, n_sym = a.n_sym;
  Clock<CLK, C_N_PHASES> ck;
  ck.start(a.clocks != nullptr && lane == 0);
#ifdef VAE_HOST_EMULATION
  CLane<TPL> st[kWarp];
  auto each = [&](auto&& f) {
    for (int l = 0; l < kWarp; ++l) f(l, st[l]);
  };
#else
  CLane<TPL> st[1];
  auto each = [&](auto&& f) { f(lane, st[0]); };
#endif
  auto window = [&](int l, int u, float (&win)[4][TPL]) {  // symbol u's, rows nu*2 + c
    const float* src = a.y + (long long)u * sps;
#pragma unroll
    for (int j = 0; j < TPL; ++j) {
      const int k = l + kWarp * j;
#pragma unroll
      for (int row = 0; row < 4; ++row) win[row][j] = k < m ? src[row * a.lp + k] : 0.f;
    }
  };
  each([&](int l, CLane<TPL>& ls) {
#pragma unroll
    for (int j = 0; j < TPL; ++j) {
      const int k = l + kWarp * j;
#pragma unroll
      for (int row = 0; row < 8; ++row) ls.h[row][j] = k < m ? a.h_in[row * m + k] : 0.f;
    }
    window(l, 0, ls.w);
  });
  int sr = ((-a.offset) % n_sym + n_sym) % n_sym;  // storage index of symbol s
  ck.mark(C_NEXT);
  for (int s = 0; s < n_sym; ++s) {
    Parts<4> ps;  // o_re, o_im of chi 0, then of chi 1
    each([&](int l, CLane<TPL>& ls) {
      float part[8];  // per chi: w_I.h_re, w_Q.h_im, w_I.h_im, w_Q.h_re
#pragma unroll
      for (int i = 0; i < 8; ++i) part[i] = 0.f;
#pragma unroll
      for (int j = 0; j < TPL; ++j) {
#pragma unroll
        for (int nu = 0; nu < 2; ++nu) {
          const float wi = ls.w[nu * 2][j], wq = ls.w[nu * 2 + 1][j];
#pragma unroll
          for (int chi = 0; chi < 2; ++chi) {
            const float hre = ls.h[chi * 4 + nu * 2][j], him = ls.h[chi * 4 + nu * 2 + 1][j];
            part[chi * 4 + 0] += wi * hre;
            part[chi * 4 + 1] += wq * him;
            part[chi * 4 + 2] += wi * him;
            part[chi * 4 + 3] += wq * hre;
          }
        }
      }
#pragma unroll
      for (int chi = 0; chi < 2; ++chi) {
        ps.of(l).v[chi * 2 + 0] = part[chi * 4 + 0] - part[chi * 4 + 1];
        ps.of(l).v[chi * 2 + 1] = part[chi * 4 + 2] + part[chi * 4 + 3];
      }
    });
    if (s + 1 < n_sym) each([&](int l, CLane<TPL>& ls) { window(l, s + 1, ls.wn); });
    ck.mark(C_DOT);
    const Vec<4> o = group_tree<4>(ps, kWarp);
    ck.mark(C_REDUCE);
    float err[2];
#pragma unroll
    for (int chi = 0; chi < 2; ++chi)
      err[chi] = a.big_r - o.v[chi * 2] * o.v[chi * 2] - o.v[chi * 2 + 1] * o.v[chi * 2 + 1];
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) a.out[q * n_sym + sr] = o.v[q];
      a.e[2 * sr] = err[0];
      a.e[2 * sr + 1] = err[1];
    }
    sr = sr + 1 == n_sym ? 0 : sr + 1;
    ck.mark(C_ERR_STORE);
    if (UPD) {
      each([&](int, CLane<TPL>& ls) {
#pragma unroll
        for (int chi = 0; chi < 2; ++chi) {
          const float sc = a.lr2 * err[chi], o_re = o.v[chi * 2], o_im = o.v[chi * 2 + 1];
#pragma unroll
          for (int j = 0; j < TPL; ++j) {
#pragma unroll
            for (int nu = 0; nu < 2; ++nu) {
              const float wi = ls.w[nu * 2][j], wq = ls.w[nu * 2 + 1][j];
              float& hre = ls.h[chi * 4 + nu * 2][j];
              float& him = ls.h[chi * 4 + nu * 2 + 1][j];
              hre = hre + sc * (o_re * wi + o_im * wq);
              him = him + sc * (o_im * wi - o_re * wq);
            }
          }
        }
      });
    }
    ck.mark(C_UPDATE);
    if (s + 1 < n_sym)
      each([&](int, CLane<TPL>& ls) {
#pragma unroll
        for (int j = 0; j < TPL; ++j)
#pragma unroll
          for (int row = 0; row < 4; ++row) ls.w[row][j] = ls.wn[row][j];
      });
    ck.mark(C_NEXT);
  }
  each([&](int l, CLane<TPL>& ls) {
#pragma unroll
    for (int j = 0; j < TPL; ++j) {
      const int k = l + kWarp * j;
      if (k < m) {
#pragma unroll
        for (int row = 0; row < 8; ++row) a.h_out[row * m + k] = ls.h[row][j];
      }
    }
  });
  ck.store(a.clocks);
}

// ---------------------------------------------------------------------------
// Kernel D: the CMAbatch / CMAflex chunk engine, the whole frame in one block
// per run (models/cma.py: _cma_chunked, chunk_schedule), in stages:
//   prefix  symbols 0 .. j0 (the last is the first update point) with the
//           initial taps, S symbols a stage: the first `offset` outputs
//           only, then one stage per ring slot, which also seeds the slot
//           with its partial sums sum_t e_t inc_t (slot j: symbols
//           offset + j S .. + S - 1); then taps += 2 lr * (ring sum, oldest
//           slot first);
//   chunk c (c < n_full, update point k_c = j0 + c S), three barrier
//   intervals:
//     A  the outputs of symbols k_c + 1 .. k_c + S with the taps of update c
//        (the last is the next update point, which sees the taps before its
//        update);
//     B  the partial sums of symbols k_c .. k_c + S - 1, split over t;
//     U  per tap entry, by the thread that owns it for the whole frame: the
//        splits summed in order into the oldest slot, the ring sum (newest
//        slot last) and taps += 2 lr * (ring sum);
//   tail    symbols k_T + 1 .. k_T + tail - 1 (k_T = j0 + n_full S) with the
//           final taps.
// A splits each (chi, t) dot product over a group of GA = 8 lanes (a warp:
// two symbols, both out-pols; KA taps per lane), each lane closing its o_re /
// o_im before the 3-level butterfly; a warp without a symbol skips the round.
// In B a lane owns a tap-entry group (nu, k), whose four sums (chi, comp)
// share their loads, and the warps split the chunk's symbols into gb
// consecutive runs: the lanes of a warp read the same symbol's o / e (one
// broadcast) and consecutive samples. Outputs and errors go to a ring of
// S + 1 symbols in shared memory (B reads them) and to out / e in the rolled
// storage order. Each stage's window span (S + 1 windows) is copied into
// shared memory by cp.async one stage ahead (the windows do not depend on
// the taps). Shared memory grows with the ring, 8m floats a slot, as the
// parent design's did. Runtime-bound loops stay rolled: unrolled, the chunk
// loop ran ~10 % slower (PERF.md).

enum DPhase {
  D_PREFIX,
  D_COPY,          // the next stage's tile copies started
  D_OUTPUTS,       // A, this thread's items
  D_OUTPUTS_SYNC,  // A's barrier
  D_PARTIALS,      // B, this thread's split
  D_PARTIALS_SYNC,
  D_UPDATE,        // U, this thread's tap entry
  D_TILE_WAIT,     // the next stage's tile copies done
  D_UPDATE_SYNC,
  D_TAIL,
  D_N_PHASES
};

constexpr int kChunkThreads = 512;  // D's block on the card
constexpr int GA = 8;               // lanes per output item
// Taps per lane in A, a template argument of the block: 1, 2, 4 or 8.
VAE_HD int d_taps_per_lane(int m) {
  int ka = 1;
  while (ka * GA < m) ka *= 2;
  return ka;
}

struct DArgs {
  const float* y;
  long long lp;
  int n_sym, m, sps, offset, j0, S, n_full, n_slots, tail, gb;
  const float* h_in;
  float* h_out;
  float* out;
  float* e;
  float big_r, lr2;
  long long* clocks;
};

// Warps that hold the 2m tap-entry groups of B, one lane each.
VAE_HD int d_group_warps(int m) { return (2 * m + kWarp - 1) / kWarp; }
// B's splits of a chunk's symbols: a power of two, as many as the block's
// warps hold, with at least 4 symbols each.
VAE_HD int d_split(int m, int S) {
  int g = 1;
  while (2 * g * d_group_warps(m) * kWarp <= kChunkThreads && 4 * (2 * g) <= S) g *= 2;
  return g;
}
// Samples per row of a stage's tile (the windows of S + 1 symbols), padded.
VAE_HD int d_tile_cols(int m, int sps, int S) { return (S * sps + m + 3) / 4 * 4; }
// Shared memory of D's block (floats): the o / e ring (S + 1, 8), two tiles
// (4, cols), B's split sums (gb, 2m, 4), the taps (8m) and the partial-sum
// ring (n_slots, 8m).
VAE_HD long long d_smem_floats(int m, int sps, int S, int n_slots) {
  return 8LL * (S + 1) + 8LL * d_tile_cols(m, sps, S) + 8LL * m * d_split(m, S) +
         8LL * m * (1 + n_slots);
}

template <bool CLK, int KA>
VAE_DEV void chunked_block(float* smem, int tid, int nt, const DArgs& a) {
  const int m = a.m, sps = a.sps, S = a.S, n_slots = a.n_slots, n_sym = a.n_sym, j0 = a.j0;
  const int hm = 8 * m, lb = S + 1, cols = d_tile_cols(m, sps, S), gb = a.gb;
  // stages g: the prefix's first p0 hold its first `offset` symbols (S a
  // stage, outputs only), the next n_slots one ring slot each (the last also
  // k_0 = j0), then chunk c is stage p0 + n_slots + c (from k_c), the tail
  // the last; stage g's tile holds the windows of its S + 1 symbols from
  // stage_base(g), in buffer g & 1
  const int offset = a.offset, p0 = (offset + S - 1) / S;
  float* oe = smem;                // (lb, 8): o chi*2 + comp, e 4 + chi; symbol s at s % lb
  float* tiles = oe + 8 * lb;      // (2, 4, cols)
  float* psum = tiles + 8 * cols;  // (gb, 2m, 4): B's split sums
  float* h = psum + gb * hm;       // (8, m)
  float* ring = h + hm;            // (n_slots, 8, m)
  Clock<CLK, D_N_PHASES> ck;
  ck.start(a.clocks != nullptr && tid == 0);
  auto tile_of = [&](int g) { return tiles + (g & 1) * 4 * cols; };
  auto stage_base = [&](int g) { return g < p0 ? g * S : offset + (g - p0) * S; };
  // stage g's windows, a quarter of the threads per row (no division)
  const int per_row = nt >= 4 ? nt / 4 : 1, row0 = tid / per_row, k0 = tid - row0 * per_row;
  auto load_tile = [&](int g) {
    const long long base = (long long)stage_base(g) * sps;
    const int width = S * sps + m;
    const int end = a.lp - base < width ? (int)(a.lp - base) : width;
    float* dst = tile_of(g);
    #pragma unroll 1
    for (int row = row0; row < 4; row += nt >= 4 ? 4 : 1) {
      const float* src = a.y + row * a.lp + base;
      #pragma unroll 1
      for (int k = k0; k < end; k += per_row) copy_async(dst + row * cols + k, src + k);
    }
  };

  // A: the outputs of symbols s0 .. s0 + count - 1 with the taps h, windows
  // from stage g's tile at symbol offset t_off, o / e ring index of s0 i0
  auto outputs = [&](int g, int s0, int count, int t_off, int i0) {
    const float* tile = tile_of(g);
    int sr0 = s0 - a.offset;  // storage index of s0
    if (sr0 < 0) sr0 += n_sym;
    // lane l's taps of out-pol chi, 0 past m (loads from a valid index and a
    // select, not a branch around each load)
    auto taps = [&](int chi, int l, float (&hr)[4][KA]) {
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        const int k = l + GA * j, kk = k < m ? k : 0;
#pragma unroll
        for (int row = 0; row < 4; ++row) {
          const float v = h[(chi * 4 + row) * m + kk];
          hr[row][j] = k < m ? v : 0.f;
        }
      }
    };
    // lane l's o_re = w_I.h_re - w_Q.h_im, o_im = w_I.h_im + w_Q.h_re over its
    // taps and both in-pols (past m its taps are 0 and the terms exact zeros)
    auto part = [&](int t, int l, const float (&hr)[4][KA]) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      const float* w = tile + (t_off + t) * sps;
#pragma unroll
      for (int j = 0; j < KA; ++j) {
        const int k = l + GA * j, kk = k < m ? k : 0;
#pragma unroll
        for (int nu = 0; nu < 2; ++nu) {
          const float wi = w[(nu * 2) * cols + kk], wq = w[(nu * 2 + 1) * cols + kk];
          const float hre = hr[nu * 2][j], him = hr[nu * 2 + 1][j];
          p[0] += wi * hre;
          p[1] += wq * him;
          p[2] += wi * him;
          p[3] += wq * hre;
        }
      }
      return Vec<2>{{p[0] - p[1], p[2] + p[3]}};
    };
    auto emit = [&](int chi, int t, const Vec<2>& p) {
      const float o_re = p.v[0], o_im = p.v[1];
      const float err = a.big_r - o_re * o_re - o_im * o_im;
      int sr = sr0 + t;
      if (sr >= n_sym) sr -= n_sym;
      a.out[(chi * 2) * n_sym + sr] = o_re;
      a.out[(chi * 2 + 1) * n_sym + sr] = o_im;
      a.e[2 * sr + chi] = err;
      int ix = i0 + t;
      if (ix >= lb) ix -= lb;
      oe[ix * 8 + chi * 2] = o_re;
      oe[ix * 8 + chi * 2 + 1] = o_im;
      oe[ix * 8 + 4 + chi] = err;
    };

#ifdef VAE_HOST_EMULATION
    for (int t = 0; t < count; ++t)
      for (int chi = 0; chi < 2; ++chi) {
        const Vec<2> p = group_sum<2>(GA, 0, [&](int l) {
          float hr[4][KA];
          taps(chi, l, hr);
          return part(t, l, hr);
        });
        emit(chi, t, p);
      }
#else
    // warp w, group q = lane / 8: symbols t = 2 w + q / 2 (+ 2 warps per
    // round), out-pol q & 1; the taps of that out-pol in registers
    const int warp = tid / kWarp, grp = (tid % kWarp) / GA, l = tid % GA, chi = grp & 1;
    const int n_warps = nt / kWarp;
    if (2 * warp < count) {
      float hr[4][KA];
      taps(chi, l, hr);
      #pragma unroll 1
      for (int t0 = 2 * warp; t0 < count; t0 += 2 * n_warps) {
        const int t = t0 + (grp >> 1);
        const bool act = t < count;
        const Vec<2> p = group_sum<2>(GA, l, [&](int ll) { return act ? part(t, ll, hr) : Vec<2>{}; });
        if (act && l == 0) emit(chi, t, p);
      }
    }
#endif
  };

  // B: split sp of tap-entry group item = (nu, k) over `count` symbols whose
  // windows start at tile symbol offset t_off and whose o / e sit from ring
  // index i0, into psum[sp][item]: sums (chi, comp)
  // e_t (o_re w_I + o_im w_Q), e_t (o_im w_I - o_re w_Q), t in order.
  const int q_len = (S + gb - 1) / gb;
  auto partials = [&](const float* tile, int t_off, int i0, int count, int item, int sp) {
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    const int nu = item / m, k = item - nu * m;
    const int t_end = sp * q_len + q_len < count ? sp * q_len + q_len : count;
    const float* wi = tile + (nu * 2) * cols + k;
    const float* wq = tile + (nu * 2 + 1) * cols + k;
    int ix = i0 + sp * q_len;
    if (ix >= lb) ix -= lb;
    #pragma unroll 1
    for (int t = sp * q_len; t < t_end; ++t) {
      const float4 o = *reinterpret_cast<const float4*>(oe + ix * 8);
      const float2 ee = *reinterpret_cast<const float2*>(oe + ix * 8 + 4);
      const float wI = wi[(t_off + t) * sps], wQ = wq[(t_off + t) * sps];
      p[0] += ee.x * (o.x * wI + o.y * wQ);
      p[1] += ee.x * (o.y * wI - o.x * wQ);
      p[2] += ee.y * (o.z * wI + o.w * wQ);
      p[3] += ee.y * (o.w * wI - o.z * wQ);
      ix = ix + 1 == lb ? 0 : ix + 1;
    }
    float4 v;
    v.x = p[0];
    v.y = p[1];
    v.z = p[2];
    v.w = p[3];
    *reinterpret_cast<float4*>(psum + (sp * 2 * m + item) * 4) = v;
  };
  auto split_sums = [&](const float* tile, int t_off, int i0, int count) {
#ifdef VAE_HOST_EMULATION
    for (int sp = 0; sp < gb; ++sp)
      for (int item = 0; item < 2 * m; ++item) partials(tile, t_off, i0, count, item, sp);
#else
    const int per_split = d_group_warps(m) * kWarp, sp = tid / per_split, item = tid - sp * per_split;
    if (sp < gb && item < 2 * m) partials(tile, t_off, i0, count, item, sp);
#endif
  };
  // U: tap entry i = row * m + k (row chi*4 + nu*2 + comp) is sum (chi, comp)
  // of group (nu, k), at psum offset (nu*m + k) * 4 + chi*2 + comp; its
  // splits in order
  auto psum_at = [&](int i) {
    const int row = i / m, k = i - row * m;
    return (((row >> 1) & 1) * m + k) * 4 + (row >> 2) * 2 + (row & 1);
  };
  auto combined = [&](int at) {
    float v = psum[at];
    #pragma unroll 1
    for (int sp = 1; sp < gb; ++sp) v += psum[sp * 8 * m + at];
    return v;
  };

  // ---- set-up and prefix
  for (int i = tid; i < hm; i += nt) h[i] = a.h_in[i];
  load_tile(0);
  copy_async_wait();
  VAE_SYNC();
  int g = 0;
  for (; g < p0; ++g) {  // symbols g S .. of the first `offset`
    load_tile(g + 1);
    const int s0 = g * S;
    outputs(g, s0, offset - s0 < S ? offset - s0 : S, 0, s0 % lb);
    copy_async_wait();
    VAE_SYNC();
  }
  for (int j = 0; j < n_slots; ++j, ++g) {  // slot j: symbols offset + j S .. + S - 1
    load_tile(g + 1);
    const int s0 = offset + j * S, i0 = s0 % lb;
    outputs(g, s0, j + 1 < n_slots ? S : S + 1, 0, i0);
    VAE_SYNC();
    split_sums(tile_of(g), 0, i0, S);
    VAE_SYNC();
    for (int i = tid; i < hm; i += nt) ring[j * hm + i] = combined(psum_at(i));
    copy_async_wait();
    VAE_SYNC();
  }
  for (int i = tid; i < hm; i += nt) {
    float up = ring[i];
    for (int j = 1; j < n_slots; ++j) up += ring[j * hm + i];
    h[i] = h[i] + a.lr2 * up;
  }
  VAE_SYNC();
  ck.mark(D_PREFIX);

  // ---- full chunks
  int head = 0, ib = j0 % lb;  // the oldest slot; o / e ring index of k_c
  // U's tap entries: the block's threads cover 8m (m <= 64), so a thread owns
  // at most one, for the whole frame
  const int at_own = tid < hm ? psum_at(tid) : 0;
  for (int c = 0; c < a.n_full; ++c, ++g) {
    const int kc = j0 + c * S;
    load_tile(g + 1);
    ck.mark(D_COPY);
    outputs(g, kc + 1, S, 1, ib + 1 == lb ? 0 : ib + 1);
    ck.mark(D_OUTPUTS);
    VAE_SYNC();
    ck.mark(D_OUTPUTS_SYNC);
    split_sums(tile_of(g), 0, ib, S);
    ck.mark(D_PARTIALS);
    VAE_SYNC();
    ck.mark(D_PARTIALS_SYNC);
    #pragma unroll 1
    for (int i = tid; i < hm; i += nt) {
      // the new slot value into the oldest slot; the ring sum from the next
      // oldest (head + 1) round to it, as two runs of slots; the taps
      const float v = combined(i == tid ? at_own : psum_at(i));
      ring[head * hm + i] = v;
      const float* r = ring + i;
      float up = head + 1 < n_slots ? r[(head + 1) * hm] : r[0];
#pragma unroll 4
      for (int sl = head + 2; sl < n_slots; ++sl) up += r[sl * hm];
#pragma unroll 4
      for (int sl = head + 1 < n_slots ? 0 : 1; sl <= head; ++sl) up += r[sl * hm];
      h[i] = h[i] + a.lr2 * up;
    }
    ck.mark(D_UPDATE);
    copy_async_wait();
    ck.mark(D_TILE_WAIT);
    VAE_SYNC();
    ck.mark(D_UPDATE_SYNC);
    head = head + 1 == n_slots ? 0 : head + 1;
    ib += S;
    if (ib >= lb) ib -= lb;
  }

  // ---- tail
  outputs(g, j0 + a.n_full * S + 1, a.tail - 1, 1, ib + 1 == lb ? 0 : ib + 1);
  for (int i = tid; i < hm; i += nt) a.h_out[i] = h[i];
  ck.mark(D_TAIL);
  ck.store(a.clocks);
}

// ---------------------------------------------------------------------------
// Kernel I: the whole AWGN CMA experiment (SISO) — the SISO form of kernel
// C's body (models/cma.py: cma_siso, once per epoch). A run is a group of
// kIGroup lanes (aligned in the warp; the warp holds up to 32 / kIGroup
// runs); lane g of the group owns the taps k = g + kIGroup j (j < TPL) of
// both planes in registers, for the whole experiment. Per epoch the window
// index restarts on that epoch's frame (the reference's y = pad(rx, M//2) per
// call: samples outside the frame read as 0). The group stages its frame,
// zero-padded, in shared memory: a ring of 4 chunks of kIChunk samples per
// plane (and a mirror of the ring's first kIGroup TPL samples past its end,
// so no window wraps), each chunk copied with cp.async two chunks ahead of
// the windows that read it. Per symbol, on the dependent chain: each lane's
// o_re / o_im over its taps (pairwise sums over j, closed before the
// butterfly), a butterfly of log2(kIGroup) levels over the group, the error,
// the tap updates (each lane its own taps, no barrier); the next symbol's
// window is read from the ring before the butterfly. Every lane sums |e|
// over the epoch in double (the epoch's mean |e|, the experiment's loss),
// branch-free and off the chain; after epoch i*epe (i < n_evals) every lane
// writes its taps to eval slot i.

constexpr int kIGroup = 16;     // lanes per run: 2, 4, 8, 16 or 32
constexpr int kIChunk = 512;    // samples per plane in a staged chunk
constexpr int kIRing = 4 * kIChunk;

// Runs per warp: one run a warp while the runs fit on the card's SMs (each
// chain then has an SM's issue slots to itself), else up to 32 / kIGroup.
VAE_HD int i_runs_per_warp(int R, int sms) {
  const int per = (R + sms - 1) / sms;
  return per < 1 ? 1 : per > kWarp / kIGroup ? kWarp / kIGroup : per;
}

// Shared-memory floats of one run's ring (two planes, each with its mirror).
VAE_HD int i_ring_floats(int tpl) { return 2 * (kIRing + kIGroup * tpl); }

enum IPhase { I_DOT, I_BUTTERFLY, I_ERR, I_UPDATE, I_NEXT, I_N_PHASES };

struct IArgs {
  const float* rx;  // (E, 2, n_total): this run's frames
  long long n_total;
  int n_epochs, n_sym, m, sps, mh, epe, n_evals;
  long long ev_stride;  // floats between eval slots (R * 2 * m)
  const float* h_in;    // (2, m)
  float* h_out;         // (2, m)
  float* h_ev;          // slot i at h_ev + i * ev_stride, (2, m)
  float* loss;          // (E,)
  float big_r, lr2;
  long long* clocks;
};

template <int TPL>
struct ILane {
  float h[2][TPL];   // taps, rows re / im
  float w[2][TPL];   // this symbol's window, rows I / Q
  float wn[2][TPL];  // the next symbol's
  bool ok[TPL];      // tap l + kIGroup j < m
};

// v[0] + ... + v[N - 1] as pairwise sums of adjacent ranges (N a power of two).
template <int N>
VAE_DEV float pair_sum(float (&v)[N]) {
#pragma unroll
  for (int s = 1; s < N; s *= 2)
#pragma unroll
    for (int i = 0; i < N; i += 2 * s) v[i] = v[i] + v[i + s];
  return v[0];
}

// One run. g: this lane's place in its group (unused in emulation, where one
// thread runs the group's lanes in turn); writer: this group writes the
// run's outputs (a group past the last run repeats it and writes nothing);
// ring: the group's i_ring_floats(TPL) floats of shared memory.
template <bool CLK, int TPL>
VAE_DEV void cma_siso_run(int g, bool writer, float* ring, const IArgs& a) {
  constexpr int kSpan = kIGroup * TPL, kPlane = kIRing + kSpan;
  const int n_sym = a.n_sym;
  Clock<CLK, I_N_PHASES> ck;
  ck.start(a.clocks != nullptr && g == 0);
#ifdef VAE_HOST_EMULATION
  ILane<TPL> st[kIGroup];
  auto each = [&](auto&& f) {
    for (int l = 0; l < kIGroup; ++l) f(l, st[l]);
  };
#else
  ILane<TPL> st[1];
  auto each = [&](auto&& f) { f(g, st[0]); };
#endif
  each([&](int l, ILane<TPL>& ls) {
#pragma unroll
    for (int j = 0; j < TPL; ++j) {
      const int k = l + kIGroup * j;
      ls.ok[j] = k < a.m;
#pragma unroll
      for (int row = 0; row < 2; ++row) ls.h[row][j] = k < a.m ? a.h_in[row * a.m + k] : 0.f;
    }
  });
  // chunk c of the zero-padded frame y[i] = x[i - mh] into the ring (slot
  // c % 4; the ring's first kSpan samples also into the mirror)
  auto stage = [&](const float* x, long long c) {
    each([&](int l, ILane<TPL>&) {
      for (int q = l; q < kIChunk; q += kIGroup) {
        const long long i = c * kIChunk + q, xi = i - a.mh;
        const int r = (int)(i & (kIRing - 1));
        const bool in = xi >= 0 && xi < a.n_total;
#pragma unroll
        for (int row = 0; row < 2; ++row) {
          float* d = ring + row * kPlane;
          if (in) {
            copy_async(d + r, x + row * a.n_total + xi);
            if (r < kSpan) copy_async(d + kIRing + r, x + row * a.n_total + xi);
          } else {
            d[r] = 0.f;
            if (r < kSpan) d[kIRing + r] = 0.f;
          }
        }
      }
    });
    copy_async_commit();
  };
  // lane l's share of symbol u's window, from the ring
  auto window = [&](int l, ILane<TPL>& ls, long long u, float (&win)[2][TPL]) {
    const int pos = (int)((u * a.sps) & (kIRing - 1)) + l;
#pragma unroll
    for (int j = 0; j < TPL; ++j) {
      const float vi = ring[pos + kIGroup * j], vq = ring[kPlane + pos + kIGroup * j];
      win[0][j] = ls.ok[j] ? vi : 0.f;
      win[1][j] = ls.ok[j] ? vq : 0.f;
    }
  };
  for (int ep = 0; ep < a.n_epochs; ++ep) {
    const float* x = a.rx + (long long)ep * 2 * a.n_total;
    stage(x, 0);
    stage(x, 1);
    stage(x, 2);
    copy_async_wait_prior();  // chunks 0 and 1
    sync_warp();
    long long next = 1;  // the chunk whose start the windows reach next
    each([&](int l, ILane<TPL>& ls) { window(l, ls, 0, ls.w); });
    double esum = 0.0;
    ck.mark(I_NEXT);
    for (int s = 0; s < n_sym; ++s) {
      Parts<2> ps;  // o_re, o_im
      each([&](int l, ILane<TPL>& ls) {
        float p0[TPL], p1[TPL], p2[TPL], p3[TPL];  // w_I.h_re, w_Q.h_im, w_I.h_im, w_Q.h_re
#pragma unroll
        for (int j = 0; j < TPL; ++j) {
          const float wi = ls.w[0][j], wq = ls.w[1][j], hre = ls.h[0][j], him = ls.h[1][j];
          p0[j] = wi * hre;
          p1[j] = wq * him;
          p2[j] = wi * him;
          p3[j] = wq * hre;
        }
        ps.of(l).v[0] = pair_sum<TPL>(p0) - pair_sum<TPL>(p1);
        ps.of(l).v[1] = pair_sum<TPL>(p2) + pair_sum<TPL>(p3);
      });
      // the next window starts in chunk `next`: stage the one after it into
      // the slot of the chunk the windows have left, and wait for `next`
      // (staged a chunk earlier)
      const long long u = s + 1;
      if (u * a.sps >= next * kIChunk) {
        stage(x, next + 2);
        copy_async_wait_prior();
        sync_warp();
        ++next;
      }
      each([&](int l, ILane<TPL>& ls) { window(l, ls, u, ls.wn); });
      ck.mark(I_DOT);
      const Vec<2> o = group_tree<2>(ps, kIGroup);
      ck.mark(I_BUTTERFLY);
      const float o_re = o.v[0], o_im = o.v[1];
      const float err = a.big_r - o_re * o_re - o_im * o_im;
      const float sc = a.lr2 * err;
      ck.mark(I_ERR);
      each([&](int, ILane<TPL>& ls) {
#pragma unroll
        for (int j = 0; j < TPL; ++j) {
          const float wi = ls.w[0][j], wq = ls.w[1][j];
          ls.h[0][j] = ls.h[0][j] + sc * (o_re * wi + o_im * wq);
          ls.h[1][j] = ls.h[1][j] + sc * (o_im * wi - o_re * wq);
        }
      });
      esum += fabs((double)err);
      ck.mark(I_UPDATE);
      each([&](int, ILane<TPL>& ls) {
#pragma unroll
        for (int j = 0; j < TPL; ++j) {
          ls.w[0][j] = ls.wn[0][j];
          ls.w[1][j] = ls.wn[1][j];
        }
      });
      ck.mark(I_NEXT);
    }
    copy_async_wait();  // the copies past the frame's end, before the ring is restaged
    sync_warp();
    if (writer && g == 0) a.loss[ep] = (float)(esum / n_sym);
    if (writer && ep % a.epe == 0 && ep / a.epe < a.n_evals) {
      float* slot = a.h_ev + (long long)(ep / a.epe) * a.ev_stride;
      each([&](int l, ILane<TPL>& ls) {
#pragma unroll
        for (int j = 0; j < TPL; ++j) {
          const int k = l + kIGroup * j;
          if (k < a.m) {
            slot[k] = ls.h[0][j];
            slot[a.m + k] = ls.h[1][j];
          }
        }
      });
    }
  }
  if (writer)
    each([&](int l, ILane<TPL>& ls) {
#pragma unroll
      for (int j = 0; j < TPL; ++j) {
        const int k = l + kIGroup * j;
        if (k < a.m) {
          a.h_out[k] = ls.h[0][j];
          a.h_out[a.m + k] = ls.h[1][j];
        }
      }
    });
  ck.store(a.clocks);
}

}  // namespace cma

#endif  // CMA_STEP_CUH
