// Kernels C and D for NVIDIA Hopper (sm_90a): the CMA family's 2x2 butterfly
// equalizers, behind a plain C interface loaded with ctypes
// (vae_equalizer_tpu_torch/ops/_build.py).
//
// C (cma_dp_kernel) replaces vae_equalizer_tpu/ops/cma_kernel.py:
//   cma_dp_pallas — the per-symbol CMA recurrence over a whole frame, for R
//   runs. One warp per run: lane l owns the taps k = l, l + 32, ... of all 8
//   tap rows, in registers. Per symbol: 8 partial dot products over the
//   lane's taps, warp-shuffle sums in a fixed xor-butterfly order (every lane
//   ends with the same total), the per-pol error e = R - |o|^2, the 8 tap
//   updates (each lane its own taps, so no barrier), and lane 0 writes out/e
//   at the reference's rolled storage index. The next symbol's window does
//   not depend on the taps, so its loads are issued before the reduction.
//   Bound by the latency of the dependent per-symbol chain (~10^4 symbols a
//   frame), not by bytes or FLOPs; R runs fill R warps.
//
// D (cma_chunked_kernel) replaces vae_equalizer_tpu/ops/cma_frame_kernel.py:
//   cma_chunked_frame_pallas(_rb) — every full chunk of the CMAbatch /
//   CMAflex chunk engine, for R runs. One block per run, the chunk loop
//   inside it, with the taps and the ring of B/S per-chunk partial sums
//   resident in shared memory (a circular ring, summed oldest first). Per
//   chunk (the JAX contract, cma_frame_kernel.py:12-20): the symbol at the
//   update point with the old taps; taps += 2 lr * (sum of the ring); the
//   other S-1 symbols with the new taps; e; the chunk's partial sums
//   sum_t e_t inc_t (one thread per tap entry, summed over t in order, no
//   atomics) into the oldest ring slot. Windows are read straight from the
//   normalized signal by index: no im2col is built. Bound by the chain of
//   ~4 barrier-separated phases per chunk.
//
// Layouts (float32, contiguous): y (R, 4, lp) rows nu*2 + c of the
// normalized, zero-padded signal; taps (R, 8, m) rows chi*4 + nu*2 + c
// (= h (R, 2, 2, 2, m)). Each launcher returns cudaGetLastError() so the
// wrapper can raise on a refused launch.
//
// Both block bodies also compile as plain C++ (CMA_HOST_EMULATION): one
// "lane"/"thread" runs every item of every phase, and the warp sum is the
// identity; that is how the arithmetic is checked without a GPU.

#ifdef CMA_HOST_EMULATION
#include <math.h>
#define CMA_DEV inline
#define CMA_SYNC() ((void)0)
#define CMA_LANES 1
#else
#include <cuda_runtime.h>
#define CMA_DEV __device__ __forceinline__
#define CMA_SYNC() __syncthreads()
#define CMA_LANES 32
#endif

namespace cma {

constexpr int MAX_M = 64;                                // taps per row
constexpr int KPL = (MAX_M + CMA_LANES - 1) / CMA_LANES;  // taps per lane

CMA_DEV float lane_sum(float v) {
#ifndef CMA_HOST_EMULATION
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
#endif
  return v;
}

// Kernel C body for one run. y (4, lp); h_in/h_out (8, m); out (4, n_sym)
// rows chi*2 + comp and e (n_sym, 2), both at storage index
// (s - offset) mod n_sym; lr2 = 2 lr.
CMA_DEV void cma_symbols_run(int lane, const float* __restrict__ y, long long lp, int n_sym,
                             int m, int sps, int offset, const float* __restrict__ h_in,
                             float* __restrict__ h_out, float* __restrict__ out,
                             float* __restrict__ e_out, float big_r, float lr2, bool update) {
  float h[8][KPL], w[4][KPL], wn[4][KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + j * CMA_LANES;
#pragma unroll
    for (int row = 0; row < 8; ++row) h[row][j] = k < m ? h_in[row * m + k] : 0.f;
#pragma unroll
    for (int row = 0; row < 4; ++row) w[row][j] = k < m ? y[row * lp + k] : 0.f;
  }
  for (int s = 0; s < n_sym; ++s) {
    // part[chi*4 + ...]: w_I.h_re, w_Q.h_im, w_I.h_im, w_Q.h_re over (nu, k)
    float part[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) part[i] = 0.f;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
#pragma unroll
      for (int nu = 0; nu < 2; ++nu) {
        const float wi = w[nu * 2][j], wq = w[nu * 2 + 1][j];
#pragma unroll
        for (int chi = 0; chi < 2; ++chi) {
          const float hre = h[chi * 4 + nu * 2][j], him = h[chi * 4 + nu * 2 + 1][j];
          part[chi * 4 + 0] += wi * hre;
          part[chi * 4 + 1] += wq * him;
          part[chi * 4 + 2] += wi * him;
          part[chi * 4 + 3] += wq * hre;
        }
      }
    }
    if (s + 1 < n_sym) {
      const long long base = (long long)(s + 1) * sps;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = lane + j * CMA_LANES;
#pragma unroll
        for (int row = 0; row < 4; ++row) wn[row][j] = k < m ? y[row * lp + base + k] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) part[i] = lane_sum(part[i]);
    float o_re[2], o_im[2], err[2];
#pragma unroll
    for (int chi = 0; chi < 2; ++chi) {
      o_re[chi] = part[chi * 4 + 0] - part[chi * 4 + 1];
      o_im[chi] = part[chi * 4 + 2] + part[chi * 4 + 3];
      err[chi] = big_r - o_re[chi] * o_re[chi] - o_im[chi] * o_im[chi];
    }
    if (lane == 0) {
      int sr = s - offset;
      if (sr < 0) sr += n_sym;
#pragma unroll
      for (int chi = 0; chi < 2; ++chi) {
        out[(chi * 2 + 0) * n_sym + sr] = o_re[chi];
        out[(chi * 2 + 1) * n_sym + sr] = o_im[chi];
        e_out[sr * 2 + chi] = err[chi];
      }
    }
    if (update) {
#pragma unroll
      for (int chi = 0; chi < 2; ++chi) {
        const float sc = lr2 * err[chi];
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
#pragma unroll
          for (int nu = 0; nu < 2; ++nu) {
            const float wi = w[nu * 2][j], wq = w[nu * 2 + 1][j];
            float& hre = h[chi * 4 + nu * 2][j];
            float& him = h[chi * 4 + nu * 2 + 1][j];
            hre = hre + sc * (o_re[chi] * wi + o_im[chi] * wq);
            him = him + sc * (o_im[chi] * wi - o_re[chi] * wq);
          }
        }
      }
    }
    if (s + 1 < n_sym) {
#pragma unroll
      for (int j = 0; j < KPL; ++j)
#pragma unroll
        for (int row = 0; row < 4; ++row) w[row][j] = wn[row][j];
    }
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + j * CMA_LANES;
    if (k < m) {
#pragma unroll
      for (int row = 0; row < 8; ++row) h_out[row * m + k] = h[row][j];
    }
  }
}

// Output o, error e of symbol k0 + t for out-pol chi with the taps h, into
// the chunk's shared rows and the run's global streams (column col).
CMA_DEV void chunk_symbol(int chi, int t, long long k0, const float* __restrict__ y, long long lp,
                          int m, int sps, const float* h, float* o, float* e, int S, float big_r,
                          float* __restrict__ out, float* __restrict__ e_out, long long T,
                          long long col) {
  float a = 0.f, b = 0.f, c = 0.f, d = 0.f;  // w_I.h_re, w_Q.h_im, w_I.h_im, w_Q.h_re
  const long long base = (k0 + t) * sps;
  for (int nu = 0; nu < 2; ++nu) {
    const float* wi = y + (nu * 2) * lp + base;
    const float* wq = y + (nu * 2 + 1) * lp + base;
    const float* hre = h + (chi * 4 + nu * 2) * m;
    const float* him = h + (chi * 4 + nu * 2 + 1) * m;
    for (int k = 0; k < m; ++k) {
      a += wi[k] * hre[k];
      b += wq[k] * him[k];
      c += wi[k] * him[k];
      d += wq[k] * hre[k];
    }
  }
  const float o_re = a - b, o_im = c + d;
  const float err = big_r - o_re * o_re - o_im * o_im;
  o[(chi * 2) * S + t] = o_re;
  o[(chi * 2 + 1) * S + t] = o_im;
  e[chi * S + t] = err;
  out[(chi * 2) * T + col] = o_re;
  out[(chi * 2 + 1) * T + col] = o_im;
  e_out[chi * T + col] = err;
}

// Kernel D body for one run: n_full chunks of S symbols from update point
// j0. ring_in/ring_out (n_slots, 8m) oldest slot first; out (4, n_full S)
// rows chi*2 + comp, e (2, n_full S), in symbol order; lr2 = 2 lr.
// Shared memory (floats): taps (8m), ring (n_slots, 8m), the chunk's
// outputs o (4, S) rows chi*2 + comp and errors e (2, S).
CMA_DEV void chunked_run(float* smem, int tid, int nt, const float* __restrict__ y, long long lp,
                         int m, int sps, int j0, int S, int n_full, int n_slots,
                         const float* __restrict__ h_in, const float* __restrict__ ring_in,
                         float* __restrict__ h_out, float* __restrict__ ring_out,
                         float* __restrict__ out, float* __restrict__ e_out, float big_r,
                         float lr2) {
  const int hm = 8 * m;
  float* h = smem;
  float* ring = h + hm;
  float* o = ring + n_slots * hm;
  float* e = o + 4 * S;
  const long long T = (long long)n_full * S;
  for (int i = tid; i < hm; i += nt) h[i] = h_in[i];
  for (int i = tid; i < n_slots * hm; i += nt) ring[i] = ring_in[i];
  CMA_SYNC();
  int head = 0;  // the oldest ring slot
  for (int c = 0; c < n_full; ++c) {
    const long long k0 = j0 + (long long)c * S;
    const long long col = (long long)c * S;
    // 1. the symbol at the update point, with the taps before the update
    for (int it = tid; it < 2; it += nt)
      chunk_symbol(it, 0, k0, y, lp, m, sps, h, o, e, S, big_r, out, e_out, T, col);
    CMA_SYNC();
    // 2. taps += 2 lr * (ring sum, oldest slot first)
    for (int i = tid; i < hm; i += nt) {
      float up = ring[head * hm + i];
      for (int j = 1; j < n_slots; ++j) {
        int slot = head + j;
        if (slot >= n_slots) slot -= n_slots;
        up += ring[slot * hm + i];
      }
      h[i] = h[i] + lr2 * up;
    }
    CMA_SYNC();
    // 3. symbols 1 .. S-1 of the chunk, with the new taps
    for (int it = tid; it < 2 * (S - 1); it += nt) {
      const int t = 1 + it / 2;
      chunk_symbol(it % 2, t, k0, y, lp, m, sps, h, o, e, S, big_r, out, e_out, T, col + t);
    }
    CMA_SYNC();
    // 4. partial sums sum_t e_t inc_t of the chunk into the oldest slot
    float* slot = ring + head * hm;
    for (int i = tid; i < hm; i += nt) {
      const int row = i / m, k = i - row * m;
      const int chi = row / 4, nu = (row / 2) % 2, comp = row % 2;
      const float* wi = y + (nu * 2) * lp + k0 * sps + k;
      const float* wq = y + (nu * 2 + 1) * lp + k0 * sps + k;
      const float* ore = o + (chi * 2) * S;
      const float* oim = o + (chi * 2 + 1) * S;
      const float* et = e + chi * S;
      float acc = 0.f;
      for (int t = 0; t < S; ++t) {
        const float a = wi[t * sps], b = wq[t * sps];
        const float inc = comp == 0 ? ore[t] * a + oim[t] * b : oim[t] * a - ore[t] * b;
        acc += et[t] * inc;
      }
      slot[i] = acc;
    }
    head = head + 1 == n_slots ? 0 : head + 1;
    CMA_SYNC();
  }
  for (int i = tid; i < hm; i += nt) h_out[i] = h[i];
  for (int i = tid; i < n_slots * hm; i += nt) {
    const int j = i / hm;
    int slot = head + j;
    if (slot >= n_slots) slot -= n_slots;
    ring_out[i] = ring[slot * hm + (i - j * hm)];
  }
}

}  // namespace cma

#ifndef CMA_HOST_EMULATION
namespace {

constexpr int kChunkThreads = 256;

__global__ void __launch_bounds__(32)
cma_dp_kernel(int n_sym, int m, int sps, long long lp, int offset, const float* y,
              const float* h_in, float* h_out, float* out, float* e, float big_r, float lr2,
              int update) {
  const long long r = blockIdx.x;
  cma::cma_symbols_run(threadIdx.x, y + r * 4 * lp, lp, n_sym, m, sps, offset, h_in + r * 8 * m,
                       h_out + r * 8 * m, out + r * 4 * n_sym, e + r * 2 * n_sym, big_r, lr2,
                       update != 0);
}

__global__ void __launch_bounds__(kChunkThreads)
cma_chunked_kernel(int m, int sps, long long lp, int j0, int S, int n_full, int n_slots,
                   const float* y, const float* h_in, const float* ring_in, float* h_out,
                   float* ring_out, float* out, float* e, float big_r, float lr2) {
  extern __shared__ float smem[];
  const long long r = blockIdx.x;
  const long long hm = 8LL * m, T = (long long)n_full * S;
  cma::chunked_run(smem, threadIdx.x, blockDim.x, y + r * 4 * lp, lp, m, sps, j0, S, n_full,
                   n_slots, h_in + r * hm, ring_in + r * n_slots * hm, h_out + r * hm,
                   ring_out + r * n_slots * hm, out + r * 4 * T, e + r * 2 * T, big_r, lr2);
}

}  // namespace

extern "C" {

int cma_dp_launch(int R, int n_sym, int m, int sps, long long lp, const float* y,
                  const float* h_in, float* h_out, float* out, float* e, float big_r, float lr2,
                  int update, void* stream) {
  if (R < 1 || n_sym < 1 || m < 1 || m > cma::MAX_M || sps < 1 ||
      lp < (long long)(n_sym - 1) * sps + m)
    return (int)cudaErrorInvalidValue;
  const int mh = m / 2;
  cma_dp_kernel<<<R, 32, 0, (cudaStream_t)stream>>>(n_sym, m, sps, lp, mh - mh / sps, y, h_in,
                                                    h_out, out, e, big_r, lr2, update);
  return (int)cudaGetLastError();
}

int cma_chunked_launch(int R, int m, int sps, long long lp, int j0, int S, int n_full,
                       int n_slots, const float* y, const float* h_in, const float* ring_in,
                       float* h_out, float* ring_out, float* out, float* e, float big_r,
                       float lr2, void* stream) {
  if (R < 1 || m < 1 || sps < 1 || S < 1 || n_full < 0 || n_slots < 1 || j0 < 0 ||
      lp < ((long long)j0 + (long long)n_full * S - 1) * sps + m)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (8ull * m * (1 + n_slots) + 6ull * S);  // chunked_run
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(cma_chunked_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  cma_chunked_kernel<<<R, kChunkThreads, bytes, (cudaStream_t)stream>>>(
      m, sps, lp, j0, S, n_full, n_slots, y, h_in, ring_in, h_out, ring_out, out, e, big_r, lr2);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // CMA_HOST_EMULATION
