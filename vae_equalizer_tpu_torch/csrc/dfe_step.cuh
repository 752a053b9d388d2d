// Kernel J's bodies (csrc/dfe_kernel.cu), in a header so that the host
// emulation (csrc/dfe_host_emulation.cpp) compiles the same source: the
// decision-feedback loop of one chain (ops/dfe_kernel.py:
// dfe_decide_plain). Two routes, picked by the wrapper from the points table:
//
// The grid route (dfe_grid_chain), for a table that is the Cartesian product
// of one level set per axis, real-major (p = ix L + iy, every system path's
// QAM): one thread per chain, no shuffle. The plain version's distance is
// d(ix, iy) = fl(dx[ix] + dy[iy]) with dx[ix] = fl(fl(re - lx[ix])^2) and dy
// likewise, and fl(a + b) is monotone in a and in b. So the smallest d is
// fl(min dx + min dy); row ix holds a point at that distance iff fl(dx[ix] +
// min dy) equals it; and the first index of the smallest d (torch.argmin's
// tie rule) is ix* = the first argmin of fl(dx[ix] + min dy), then iy* = the
// first argmin of fl(dx[ix*] + dy[iy]). Exact for any inputs, rounding ties
// included: 2 L distances and two first-argmin trees over L instead of L^2
// distances and a 5-level shuffle butterfly. The correction sums the older
// K2 - 1 products while the previous symbol is decided; only the newest
// decision's product and add (the plain version's last) wait for it. The
// decided point's levels come out of the trees, so the state needs no load.
//
// The general route (dfe_chain), for any other table: one warp per chain.
// Per symbol t >= K2, on the dependent chain: the correction from the last
// K2 decisions (every lane the same, in the plain version's order:
// a0..a3 = sum_j of f_re s_re, f_im s_im, f_re s_im, f_im s_re over the
// flipped taps j = 0, 1, ..., c = (a0 - a1, a2 + a3)), ik = ff[t] + c, each
// lane's squared distances to its PPL points (p = lane + 32 i) and its
// first minimum, then an xor butterfly of (distance, index) pairs that keeps
// the smaller distance and, on equal distances, the smaller index: a
// lexicographic minimum, so every lane ends with the first index of the
// smallest distance, whatever the tree's order (torch.argmin's tie rule).
// The decided point enters the state; lane 0 stores the index. With
// --fmad=false every product and sum rounds as the plain version's, so the
// decisions equal its bit for bit.
//
// Under VAE_HOST_EMULATION this is plain C++ for checking the arithmetic
// without a GPU: one thread runs every lane of the warp in turn and closes
// the lanes' minima with the same butterfly; the points are read from the
// argument instead of shared memory.

#ifndef DFE_STEP_CUH
#define DFE_STEP_CUH

#include "portable.cuh"

namespace dfe {

// The card's warp in emulation too (kept here, not in portable.cuh: dp,
// dp_eval and nn emulate a one-lane warp instead).
constexpr int kWarp = 32;
constexpr int MAX_K2 = 4;        // feedback taps: h1, the longest channel preset, has 5 taps
constexpr int MAX_POINTS = 256;  // constellation points (8 per lane)

struct JArgs {
  const float* ff;      // (2, n): this chain's feedforward output, rows re / im
  const float* fb;      // (2, k2): its feedback taps
  const int* init;      // (n,): initial decisions; the first k2 seed the state
  int* idx;             // (n,): the decisions
  int n, n_points;
  long long* clocks;    // (J_N_PHASES,) or null: chain 0's cycles per phase
};

// Per-symbol phases of the clocks (ops/dfe_kernel.py: J_CLOCK_PHASES).
enum JPhase { J_CORRECTION, J_DISTANCES, J_ARGMIN, J_STATE, J_NEXT_FF, J_N_PHASES };

// Phase clocks (measurement only): one thread adds the clock64() cycles of
// each phase into c[phase], summed over the symbols. Compiled in only for
// CLK = true, so a launch without clocks runs the body without them (kept
// per kernel: dp and nn switch theirs at run time instead).
template <bool CLK>
struct Clock {
  bool on;
  long long t, c[J_N_PHASES];
  VAE_DEV void start(bool enable) {
    on = CLK && enable;
    for (int p = 0; p < J_N_PHASES; ++p) c[p] = 0;
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
      for (int p = 0; p < J_N_PHASES; ++p) out[p] = c[p];
  }
};

struct Best {
  float d;
  int i;
};

VAE_DEV Best first_min(Best a, Best b) {
  return (b.d < a.d || (b.d == a.d && b.i < a.i)) ? b : a;
}

// One chain. pre / pim: the points' planes (shared memory on the card).
template <bool CLK, int K2, int PPL>
VAE_DEV void dfe_chain(int lane, const float* pre, const float* pim, const JArgs& a) {
  const int n = a.n;
  Clock<CLK> ck;
  ck.start(a.clocks != nullptr && lane == 0);
  float fr[K2 > 0 ? K2 : 1], fi[K2 > 0 ? K2 : 1];  // flipped taps: f[j] = fb[K2 - 1 - j]
  float sr[K2 > 0 ? K2 : 1], si[K2 > 0 ? K2 : 1];  // the state, oldest first
#pragma unroll
  for (int j = 0; j < K2; ++j) {
    fr[j] = a.fb[K2 - 1 - j];
    fi[j] = a.fb[K2 + K2 - 1 - j];
    const int i0 = a.init[j];
    sr[j] = pre[i0];
    si[j] = pim[i0];
    if (lane == 0) a.idx[j] = i0;
  }
#ifdef VAE_HOST_EMULATION
  constexpr int kLanes = kWarp;
#else
  constexpr int kLanes = 1;
#endif
  float qr[kLanes][PPL], qi[kLanes][PPL];  // each lane's points
  for (int l = 0; l < kLanes; ++l) {
    const int ln = kLanes == 1 ? lane : l;
#pragma unroll
    for (int i = 0; i < PPL; ++i) {
      const int p = ln + kWarp * i;
      qr[l][i] = p < a.n_points ? pre[p] : 0.f;
      qi[l][i] = p < a.n_points ? pim[p] : 0.f;
    }
  }
  float vr = K2 < n ? a.ff[K2] : 0.f, vi = K2 < n ? a.ff[n + K2] : 0.f;
  ck.mark(J_NEXT_FF);
  for (int t = K2; t < n; ++t) {
    const float nr = t + 1 < n ? a.ff[t + 1] : 0.f, ni = t + 1 < n ? a.ff[n + t + 1] : 0.f;
    float ikr = vr, iki = vi;
    if (K2 > 0) {
      float a0 = fr[0] * sr[0], a1 = fi[0] * si[0], a2 = fr[0] * si[0], a3 = fi[0] * sr[0];
#pragma unroll
      for (int j = 1; j < K2; ++j) {
        a0 = a0 + fr[j] * sr[j];
        a1 = a1 + fi[j] * si[j];
        a2 = a2 + fr[j] * si[j];
        a3 = a3 + fi[j] * sr[j];
      }
      ikr = vr + (a0 - a1);
      iki = vi + (a2 + a3);
    }
    ck.mark(J_CORRECTION);
    Best lb[kLanes];
    for (int l = 0; l < kLanes; ++l) {
      const int ln = kLanes == 1 ? lane : l;
      Best b = {INFINITY, 0x7fffffff};
#pragma unroll
      for (int i = 0; i < PPL; ++i) {
        const int p = ln + kWarp * i;
        if (p < a.n_points) {
          const float dr = ikr - qr[l][i], di = iki - qi[l][i];
          b = first_min(b, Best{dr * dr + di * di, p});
        }
      }
      lb[l] = b;
    }
    ck.mark(J_DISTANCES);
#ifdef VAE_HOST_EMULATION
    for (int off = kWarp / 2; off > 0; off >>= 1)
      for (int l = 0; l < off; ++l) lb[l] = first_min(lb[l], lb[l + off]);
#else
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const Best o = {__shfl_xor_sync(0xffffffffu, lb[0].d, off),
                      __shfl_xor_sync(0xffffffffu, lb[0].i, off)};
      lb[0] = first_min(lb[0], o);
    }
#endif
    const int k = lb[0].i;
    ck.mark(J_ARGMIN);
    if (lane == 0) a.idx[t] = k;
    if (K2 > 0) {
#pragma unroll
      for (int j = 0; j + 1 < K2; ++j) {
        sr[j] = sr[j + 1];
        si[j] = si[j + 1];
      }
      sr[K2 > 0 ? K2 - 1 : 0] = pre[k];
      si[K2 > 0 ? K2 - 1 : 0] = pim[k];
    }
    ck.mark(J_STATE);
    vr = nr;
    vi = ni;
    ck.mark(J_NEXT_FF);
  }
  ck.store(a.clocks);
}

// The first minimum of the pairs (e[i], i) over i < N, N a power of two, as a
// tree of adjacent ranges (the right range's indices are the larger, so it
// wins only with a strictly smaller value); v[i] and w[i] ride along with
// the winner. Returns the index; e[0], v[0] and w[0] end as the winner's.
template <int N>
VAE_DEV int first_argmin(float (&e)[N], float (&v)[N], float (&w)[N]) {
  int ix[N];
#pragma unroll
  for (int i = 0; i < N; ++i) ix[i] = i;
#pragma unroll
  for (int s = 1; s < N; s *= 2) {
#pragma unroll
    for (int i = 0; i < N; i += 2 * s) {
      const bool right = e[i + s] < e[i];
      e[i] = right ? e[i + s] : e[i];
      v[i] = right ? v[i + s] : v[i];
      w[i] = right ? w[i + s] : w[i];
      ix[i] = right ? ix[i + s] : ix[i];
    }
  }
  return ix[0];
}

// One chain on the grid route. pts: the (2, L * L) points table, real-major,
// whose levels are lx[ix] = pts[ix L] and ly[iy] = pts[L L + iy]; `store`:
// this thread writes the decisions (on the card the other lanes of the warp
// run a copy of a chain in lockstep and write nothing). The feedforward
// output is loaded D symbols ahead in registers.
template <bool CLK, int K2, int L>
VAE_DEV void dfe_grid_chain(bool store, const float* pts, const JArgs& a) {
  constexpr int D = K2 == 3 ? 3 : 4;  // symbols a block: a multiple of K2, so the state's ring turns whole
  constexpr int NS = K2 > 0 ? K2 : 1;
  const int n = a.n;
  Clock<CLK> ck;
  ck.start(a.clocks != nullptr && store);
  float lx[L], ly[L];
#pragma unroll
  for (int i = 0; i < L; ++i) {
    lx[i] = pts[i * L];
    ly[i] = pts[L * L + i];
  }
  // flipped taps f[j] = fb[K2 - 1 - j]; the state as a ring: at a block's
  // symbol u the j-th oldest decision is in slot (u + j) % K2
  float fr[NS], fi[NS], sr[NS], si[NS];
#pragma unroll
  for (int j = 0; j < K2; ++j) {
    fr[j] = a.fb[K2 - 1 - j];
    fi[j] = a.fb[K2 + K2 - 1 - j];
    const int i0 = a.init[j];
    sr[j] = pts[i0];
    si[j] = pts[L * L + i0];
    if (store) a.idx[j] = i0;
  }
  // q0..q3: the sums over the state's older K2 - 1 entries of f_re s_re,
  // f_im s_im, f_re s_im, f_im s_re (oldest first, the plain version's
  // order), for the block's symbol u
  float q0 = 0.f, q1 = 0.f, q2 = 0.f, q3 = 0.f;
  auto older = [&](int u) {
    if (K2 > 1) {
      const int r0 = u % NS;
      q0 = fr[0] * sr[r0];
      q1 = fi[0] * si[r0];
      q2 = fr[0] * si[r0];
      q3 = fi[0] * sr[r0];
#pragma unroll
      for (int j = 1; j + 1 < K2; ++j) {
        const int r = (u + j) % NS;
        q0 = q0 + fr[j] * sr[r];
        q1 = q1 + fi[j] * si[r];
        q2 = q2 + fr[j] * si[r];
        q3 = q3 + fi[j] * sr[r];
      }
    }
  };
  older(0);
  float cr[D], ci[D];  // ff of symbols t .. t + D - 1
#pragma unroll
  for (int u = 0; u < D; ++u) {
    cr[u] = K2 + u < n ? a.ff[K2 + u] : 0.f;
    ci[u] = K2 + u < n ? a.ff[n + K2 + u] : 0.f;
  }
  ck.mark(J_NEXT_FF);
  for (int t0 = K2; t0 < n; t0 += D) {
    float nr[D], ni[D];
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int t = t0 + D + u;
      nr[u] = t < n ? a.ff[t] : 0.f;
      ni[u] = t < n ? a.ff[n + t] : 0.f;
    }
    ck.mark(J_NEXT_FF);
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int t = t0 + u;
      if (t >= n) break;
      float ikr = cr[u], iki = ci[u];
      if (K2 > 0) {
        constexpr int k = K2 > 0 ? K2 - 1 : 0;  // the newest decision, in slot (u + k) % K2
        const int r = (u + k) % NS;
        const float p0 = fr[k] * sr[r], p1 = fi[k] * si[r], p2 = fr[k] * si[r], p3 = fi[k] * sr[r];
        const float a0 = K2 > 1 ? q0 + p0 : p0, a1 = K2 > 1 ? q1 + p1 : p1;
        const float a2 = K2 > 1 ? q2 + p2 : p2, a3 = K2 > 1 ? q3 + p3 : p3;
        ikr = ikr + (a0 - a1);
        iki = iki + (a2 + a3);
      }
      ck.mark(J_CORRECTION);
      float dx[L], dy[L], ex[L], ey[L], vx[L], vy[L], my[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const float xr = ikr - lx[i], yi = iki - ly[i];
        dx[i] = xr * xr;
        dy[i] = yi * yi;
        my[i] = dy[i];
      }
#pragma unroll
      for (int s = 1; s < L; s *= 2)  // min dy, as a tree
#pragma unroll
        for (int i = 0; i < L; i += 2 * s) my[i] = fminf(my[i], my[i + s]);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        ex[i] = dx[i] + my[0];
        vx[i] = lx[i];
      }
      ck.mark(J_DISTANCES);
      const int ix = first_argmin<L>(ex, dx, vx);
#pragma unroll
      for (int i = 0; i < L; ++i) {
        ey[i] = dx[0] + dy[i];
        vy[i] = ly[i];
      }
      const int iy = first_argmin<L>(ey, vy, dy);  // dy rides unused
      ck.mark(J_ARGMIN);
      if (store) a.idx[t] = ix * L + iy;
      if (K2 > 0) {  // the newest decision takes the oldest's slot
        sr[u % NS] = vx[0];
        si[u % NS] = vy[0];
        older(u + 1);
      }
      ck.mark(J_STATE);
    }
#pragma unroll
    for (int u = 0; u < D; ++u) {
      cr[u] = nr[u];
      ci[u] = ni[u];
    }
  }
  ck.store(a.clocks);
}

}  // namespace dfe

#endif  // DFE_STEP_CUH
