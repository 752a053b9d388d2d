// Kernel J's block body (csrc/dfe_kernel.cu), in a header so that the host
// emulation (csrc/dfe_host_emulation.cpp) compiles the same source: the
// decision-feedback loop of one chain (ops/dfe_kernel.py:
// dfe_decide_plain), one warp per chain.
//
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
// Under DFE_HOST_EMULATION this is plain C++ for checking the arithmetic
// without a GPU: one thread runs every lane of the warp in turn and closes
// the lanes' minima with the same butterfly; the points are read from the
// argument instead of shared memory.

#ifndef DFE_STEP_CUH
#define DFE_STEP_CUH

#include <math.h>

#ifdef DFE_HOST_EMULATION
#define DFE_DEV inline
#else
#include <cuda_runtime.h>
#define DFE_DEV __device__ __forceinline__
#endif

namespace dfe {

constexpr int kWarp = 32;
constexpr int MAX_K2 = 4;        // feedback taps: h1, the longest channel preset, has 5 taps
constexpr int MAX_POINTS = 256;  // constellation points (8 per lane)

struct JArgs {
  const float* ff;      // (2, n): this chain's feedforward output, rows re / im
  const float* fb;      // (2, k2): its feedback taps
  const int* init;      // (n,): initial decisions; the first k2 seed the state
  int* idx;             // (n,): the decisions
  int n, n_points;
};

struct Best {
  float d;
  int i;
};

DFE_DEV Best first_min(Best a, Best b) {
  return (b.d < a.d || (b.d == a.d && b.i < a.i)) ? b : a;
}

// One chain. pre / pim: the points' planes (shared memory on the card).
template <int K2, int PPL>
DFE_DEV void dfe_chain(int lane, const float* pre, const float* pim, const JArgs& a) {
  const int n = a.n;
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
#ifdef DFE_HOST_EMULATION
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
#ifdef DFE_HOST_EMULATION
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
    vr = nr;
    vi = ni;
  }
}

}  // namespace dfe

#endif  // DFE_STEP_CUH
