// Kernel J for NVIDIA Hopper (sm_90a): the LMMSE / DFE baseline's decision-
// feedback loop, behind a plain C interface loaded with ctypes
// (vae_equalizer_tpu_torch/ops/_build.py). The bodies are in dfe_step.cuh.
//
// J has no TPU kernel to replace: it is the JAX package's lax.scan of
//   models/lmmse_dfe.py: dfe_equalize. B independent chains, two routes
//   (dfe_step.cuh), both bound by the latency of the dependent per-symbol
//   chain (n symbols a chain), not by bytes or FLOPs:
//   * dfe_grid_kernel, for a points table that is a square grid of L x L
//     levels (L = 2, 4, 8, 16; every QAM of the system): one thread per
//     chain, the levels, the state and the flipped taps in registers, the
//     feedforward output loaded 3-4 symbols ahead; cpw chains share a warp
//     (cpw = ceil(B / SMs), at most 32, so up to 132 chains take an SM each),
//     the warp's other lanes running a copy of a chain in lockstep;
//   * dfe_decide_kernel, for any other table: one warp per chain, the points
//     in shared memory and in registers (PPL per lane: 1 up to 32 points, 2
//     for 64-QAM, 8 up to 256), a 5-level butterfly of (distance, index)
//     pairs per symbol.
//
// Layouts (contiguous): ff (B, 2, n) float32; fb (B, 2, k2) float32; points
// (2, n_points) float32; init and idx (B, n) int32. `clocks` (int64 per
// phase, or null): chain 0's lane 0's clock64() cycles per phase, summed over
// the symbols (measurement only; a launch without it runs the body compiled
// without clocks). Returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "dfe_step.cuh"

namespace {

template <bool CLK, int K2, int PPL>
__global__ void __launch_bounds__(32) dfe_decide_kernel(dfe::JArgs a, const float* points) {
  __shared__ float pts[2][dfe::MAX_POINTS];
  for (int p = threadIdx.x; p < a.n_points; p += blockDim.x) {
    pts[0][p] = points[p];
    pts[1][p] = points[a.n_points + p];
  }
  __syncwarp();
  const long long b = blockIdx.x;
  a.ff += b * 2 * a.n;
  a.fb += b * 2 * K2;
  a.init += b * a.n;
  a.idx += b * a.n;
  if (b != 0) a.clocks = nullptr;
  dfe::dfe_chain<CLK, K2, PPL>(threadIdx.x, pts[0], pts[1], a);
}

template <bool CLK, int K2, int L>
__global__ void __launch_bounds__(32) dfe_grid_kernel(dfe::JArgs a, const float* points, int B,
                                                       int cpw) {
  const int lane = threadIdx.x;
  long long b = (long long)blockIdx.x * cpw + lane % cpw;
  const bool store = lane < cpw && b < B;
  if (b >= B) b = B - 1;
  a.ff += b * 2 * a.n;
  a.fb += b * 2 * K2;
  a.init += b * a.n;
  a.idx += b * a.n;
  if (b != 0 || lane != 0) a.clocks = nullptr;
  dfe::dfe_grid_chain<CLK, K2, L>(store, points, a);
}

using GridKernel = void (*)(dfe::JArgs, const float*, int, int);

template <bool CLK, int K2>
GridKernel pick_grid(int l) {
  return l == 2 ? dfe_grid_kernel<CLK, K2, 2> : l == 4 ? dfe_grid_kernel<CLK, K2, 4>
                : l == 8 ? dfe_grid_kernel<CLK, K2, 8> : dfe_grid_kernel<CLK, K2, 16>;
}

template <bool CLK, int K2>
void (*pick(int ppl))(dfe::JArgs, const float*) {
  return ppl == 1 ? dfe_decide_kernel<CLK, K2, 1> : ppl == 2 ? dfe_decide_kernel<CLK, K2, 2>
                                                           : dfe_decide_kernel<CLK, K2, 8>;
}

}  // namespace

extern "C" {

// grid_l: L for the grid route (the table is an L x L grid, real-major; L =
// 2, 4, 8 or 16), 0 for the general route.
int dfe_decide_launch(int B, int n, int k2, int n_points, int grid_l, const float* ff,
                      const float* fb, const float* points, const int* init, int* idx,
                      long long* clocks, void* stream) {
  if (B < 1 || n < 1 || k2 < 0 || k2 > dfe::MAX_K2 || n_points < 1 ||
      n_points > dfe::MAX_POINTS ||
      (grid_l != 0 && (grid_l * grid_l != n_points || (grid_l & (grid_l - 1)) || grid_l < 2)))
    return (int)cudaErrorInvalidValue;
  const dfe::JArgs a = {ff, fb, init, idx, n, n_points, clocks};
  if (grid_l != 0) {
    int dev = 0, sms = 1;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int cpw = B <= sms ? 1 : (B + sms - 1) / sms < dfe::kWarp ? (B + sms - 1) / sms : dfe::kWarp;
    // by_k2[clocks][k2]
    static GridKernel (*const by_k2[2][dfe::MAX_K2 + 1])(int) = {
        {pick_grid<false, 0>, pick_grid<false, 1>, pick_grid<false, 2>, pick_grid<false, 3>,
         pick_grid<false, 4>},
        {pick_grid<true, 0>, pick_grid<true, 1>, pick_grid<true, 2>, pick_grid<true, 3>,
         pick_grid<true, 4>}};
    by_k2[clocks != nullptr][k2](grid_l)<<<(B + cpw - 1) / cpw, dfe::kWarp, 0,
                                          (cudaStream_t)stream>>>(a, points, B, cpw);
    return (int)cudaGetLastError();
  }
  const int need = (n_points + dfe::kWarp - 1) / dfe::kWarp;  // points per lane: 1, 2 or 8
  const int ppl = need <= 2 ? need : 8;
  // by_k2[clocks][k2]
  static void (*(*const by_k2[2][dfe::MAX_K2 + 1])(int))(dfe::JArgs, const float*) = {
      {pick<false, 0>, pick<false, 1>, pick<false, 2>, pick<false, 3>, pick<false, 4>},
      {pick<true, 0>, pick<true, 1>, pick<true, 2>, pick<true, 3>, pick<true, 4>}};
  auto kernel = by_k2[clocks != nullptr][k2](ppl);
  kernel<<<B, dfe::kWarp, 0, (cudaStream_t)stream>>>(a, points);
  return (int)cudaGetLastError();
}

}  // extern "C"
