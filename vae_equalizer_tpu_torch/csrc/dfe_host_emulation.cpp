// Kernel J's block (dfe_step.cuh) on the host, for checking its arithmetic
// without a GPU: a drop-in for the dfe library with the launcher's C
// signature (csrc/dfe_kernel.cu, ops/_build.py: _SIGNATURES["dfe"]), in
// which one thread runs every lane of the warp in turn and closes the lanes'
// minima with the card's butterfly, and the chains run one after another.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -DDFE_HOST_EMULATION
//       -o libdfe_host.so dfe_host_emulation.cpp
//
// tests/test_torch_dfe.py builds it, patches ops/_build.py's load / stream
// to return it, and calls the wrapper's own launch code on CPU tensors
// against the plain version.
#ifndef DFE_HOST_EMULATION
#define DFE_HOST_EMULATION
#endif

#include "dfe_step.cuh"

namespace {

template <int K2>
void run(int ppl, const float* points, const dfe::JArgs& a) {
  const float* pre = points;
  const float* pim = points + a.n_points;
  switch (ppl) {
    case 1: dfe::dfe_chain<K2, 1>(0, pre, pim, a); break;
    case 2: dfe::dfe_chain<K2, 2>(0, pre, pim, a); break;
    default: dfe::dfe_chain<K2, 8>(0, pre, pim, a); break;
  }
}

}  // namespace

extern "C" {

int dfe_decide_launch(int B, int n, int k2, int n_points, const float* ff, const float* fb,
                      const float* points, const int* init, int* idx, void*) {
  if (B < 1 || n < 1 || k2 < 0 || k2 > dfe::MAX_K2 || n_points < 1 ||
      n_points > dfe::MAX_POINTS)
    return 1;  // cudaErrorInvalidValue
  const int need = (n_points + dfe::kWarp - 1) / dfe::kWarp;  // points per lane: 1, 2 or 8
  const int ppl = need <= 2 ? need : 8;
  static void (*const by_k2[dfe::MAX_K2 + 1])(int, const float*, const dfe::JArgs&) = {
      run<0>, run<1>, run<2>, run<3>, run<4>};
  for (int b = 0; b < B; ++b) {
    const dfe::JArgs a = {ff + (long long)b * 2 * n, fb + (long long)b * 2 * k2,
                          init + (long long)b * n, idx + (long long)b * n, n, n_points};
    by_k2[k2](ppl, points, a);
  }
  return 0;
}

}  // extern "C"
