// Kernel J for NVIDIA Hopper (sm_90a): the LMMSE / DFE baseline's decision-
// feedback loop, behind a plain C interface loaded with ctypes
// (vae_equalizer_tpu_torch/ops/_build.py). The block body is in dfe_step.cuh.
//
// J (dfe_decide_kernel) has no TPU kernel to replace: it is the JAX package's
//   lax.scan of models/lmmse_dfe.py: dfe_equalize. B independent chains, one
//   warp per chain, the points in shared memory and in registers (PPL per
//   lane: 1 up to 32 points, 2 for 64-QAM, 8 up to 256), the K2-symbol state and the flipped feedback taps in
//   every lane's registers. Bound by the latency of the dependent per-symbol
//   chain (the correction, the distances, a 5-level butterfly of (distance,
//   index) pairs, the state shift; n symbols a chain), not by bytes or FLOPs;
//   B chains fill B SMs.
//
// Layouts (contiguous): ff (B, 2, n) float32; fb (B, 2, k2) float32; points
// (2, n_points) float32; init and idx (B, n) int32. Returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include "dfe_step.cuh"

namespace {

template <int K2, int PPL>
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
  dfe::dfe_chain<K2, PPL>(threadIdx.x, pts[0], pts[1], a);
}

template <int K2>
void (*pick(int ppl))(dfe::JArgs, const float*) {
  return ppl == 1 ? dfe_decide_kernel<K2, 1> : ppl == 2 ? dfe_decide_kernel<K2, 2>
                                                     : dfe_decide_kernel<K2, 8>;
}

}  // namespace

extern "C" {

int dfe_decide_launch(int B, int n, int k2, int n_points, const float* ff, const float* fb,
                      const float* points, const int* init, int* idx, void* stream) {
  if (B < 1 || n < 1 || k2 < 0 || k2 > dfe::MAX_K2 || n_points < 1 ||
      n_points > dfe::MAX_POINTS)
    return (int)cudaErrorInvalidValue;
  const int need = (n_points + dfe::kWarp - 1) / dfe::kWarp;  // points per lane: 1, 2 or 8
  const int ppl = need <= 2 ? need : 8;
  static void (*(*const by_k2[dfe::MAX_K2 + 1])(int))(dfe::JArgs, const float*) = {
      pick<0>, pick<1>, pick<2>, pick<3>, pick<4>};
  const dfe::JArgs a = {ff, fb, init, idx, n, n_points};
  auto kernel = by_k2[k2](ppl);
  kernel<<<B, dfe::kWarp, 0, (cudaStream_t)stream>>>(a, points);
  return (int)cudaGetLastError();
}

}  // extern "C"
