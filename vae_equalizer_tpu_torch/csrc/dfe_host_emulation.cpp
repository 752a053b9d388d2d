// Kernel J's bodies (dfe_step.cuh) on the host, for checking their arithmetic
// without a GPU: a drop-in for the dfe library with the launcher's C
// signature (csrc/dfe_kernel.cu, ops/_build.py: _SIGNATURES["dfe"]), the
// chains one after another. The grid route's thread is the card's (one per
// chain, no lane exchanges); on the general route one thread runs every lane
// of the warp in turn and closes the lanes' minima with the card's butterfly.
//
// ops/_build.py: host_library builds it under VAE_HOST_EMULATION;
// tests/test_torch_dfe_step_emulation.py patches ops/_build.py's load / stream
// to return it, and calls the wrapper's own launch code on CPU tensors against
// the plain version.

#include "dfe_step.cuh"

namespace {

template <int K2>
void run(int ppl, const float* points, const dfe::JArgs& a) {
  const float* pre = points;
  const float* pim = points + a.n_points;
  switch (ppl) {
    case 1: dfe::dfe_chain<true, K2, 1>(0, pre, pim, a); break;
    case 2: dfe::dfe_chain<true, K2, 2>(0, pre, pim, a); break;
    default: dfe::dfe_chain<true, K2, 8>(0, pre, pim, a); break;
  }
}

template <int K2>
void run_grid(int l, const float* points, const dfe::JArgs& a) {
  switch (l) {
    case 2: dfe::dfe_grid_chain<true, K2, 2>(true, points, a); break;
    case 4: dfe::dfe_grid_chain<true, K2, 4>(true, points, a); break;
    case 8: dfe::dfe_grid_chain<true, K2, 8>(true, points, a); break;
    default: dfe::dfe_grid_chain<true, K2, 16>(true, points, a); break;
  }
}

}  // namespace

extern "C" {

int dfe_decide_launch(int B, int n, int k2, int n_points, int grid_l, const float* ff,
                      const float* fb, const float* points, const int* init, int* idx,
                      long long* clocks, void*) {
  if (B < 1 || n < 1 || k2 < 0 || k2 > dfe::MAX_K2 || n_points < 1 ||
      n_points > dfe::MAX_POINTS ||
      (grid_l != 0 && (grid_l * grid_l != n_points || (grid_l & (grid_l - 1)) || grid_l < 2)))
    return 1;  // cudaErrorInvalidValue
  const int need = (n_points + dfe::kWarp - 1) / dfe::kWarp;  // points per lane: 1, 2 or 8
  const int ppl = need <= 2 ? need : 8;
  static void (*const by_k2[dfe::MAX_K2 + 1])(int, const float*, const dfe::JArgs&) = {
      run<0>, run<1>, run<2>, run<3>, run<4>};
  static void (*const grid_by_k2[dfe::MAX_K2 + 1])(int, const float*, const dfe::JArgs&) = {
      run_grid<0>, run_grid<1>, run_grid<2>, run_grid<3>, run_grid<4>};
  for (int b = 0; b < B; ++b) {
    const dfe::JArgs a = {ff + (long long)b * 2 * n, fb + (long long)b * 2 * k2,
                          init + (long long)b * n, idx + (long long)b * n, n, n_points,
                          b == 0 ? clocks : nullptr};
    if (grid_l != 0)
      grid_by_k2[k2](grid_l, points, a);
    else
      by_k2[k2](ppl, points, a);
  }
  return 0;
}

}  // extern "C"
