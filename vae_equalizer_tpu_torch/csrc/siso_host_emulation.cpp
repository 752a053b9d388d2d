// Kernels F and G's blocks (siso_step.cuh) on the host, for checking their
// arithmetic without a GPU: a drop-in for the siso library with the
// launchers' C signatures (csrc/siso_kernels.cu, ops/_build.py:
// _SIGNATURES["siso"]; the same 8-level / generic instances), in which one
// "thread" runs every item of every phase, computes every lane's partial of
// a split sum and each block total's thread and warp partials in the card's
// order (siso::kThreads threads), barriers are no-ops and the blocks of the
// runs run one after another.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -DSISO_HOST_EMULATION
//       -o libsiso_host.so siso_host_emulation.cpp
//
// tests/test_torch_siso_step_emulation.py builds it, patches ops/_build.py's
// load / stream to return it, and calls the wrappers' own launch code on CPU
// tensors against the plain versions.
#ifndef SISO_HOST_EMULATION
#define SISO_HOST_EMULATION
#endif
#include <stdlib.h>

#include "siso_step.cuh"

namespace {

bool bad_shape(int n_sym, int m, int n_lev) {
  return n_lev < 1 || n_lev > siso::MAX_LEV || m % 2 != 1 || 2 * n_sym <= m;
}

float* block_smem(int n_sym, int m, int n_lev) {
  const siso::Layout L = siso::make_layout(siso::make_dims(n_sym, m, n_lev));
  return static_cast<float*>(calloc((size_t)L.total, sizeof(float)));
}

}  // namespace

extern "C" {

int vae_siso_step_launch(int R, int n_sym, int m, int n_lev, const float* x, const float* w,
                         const float* h, const float* amps, const float* P, float amp_mean,
                         float var, float* loss, float* gw, float* gh, float* q, float* out,
                         long long* clocks, void*) {
  if (R < 1 || bad_shape(n_sym, m, n_lev)) return 1;  // cudaErrorInvalidValue
  float* smem = block_smem(n_sym, m, n_lev);
  if (smem == nullptr) return 2;  // cudaErrorMemoryAllocation
  const auto block = n_lev == 8 ? siso::step_block<8, true> : siso::step_block<0, true>;
  for (int r = 0; r < R; ++r)
    block(smem, 0, 1, r, n_sym, m, n_lev, x, w, h, amps, P, amp_mean, var, loss, gw, gh, q, out,
          clocks);
  free(smem);
  return 0;
}

int vae_siso_experiment_launch(int R, int n_epochs, int n_batches, int n_sym, int m, int n_lev,
                               long long n_total, int epe, int n_evals, const float* rx,
                               const float* w_in, const float* h_in, const float* mw_in,
                               const float* vw_in, const float* xw_in, const float* mh_in,
                               const float* vh_in, const float* xh_in, float* w_out,
                               float* h_out, float* mw_out, float* vw_out, float* xw_out,
                               float* mh_out, float* vh_out, float* xh_out, float* losses,
                               float* w_ev, float* h_ev, const float* amps, const float* P,
                               float amp_mean, float var, float lr, long long step0,
                               long long* clocks, void*) {
  if (R < 1 || n_epochs < 1 || n_batches < 1 || epe < 1 ||
      n_total < (long long)n_batches * 2 * n_sym || bad_shape(n_sym, m, n_lev))
    return 1;  // cudaErrorInvalidValue
  float* smem = block_smem(n_sym, m, n_lev);
  if (smem == nullptr) return 2;  // cudaErrorMemoryAllocation
  const auto block =
      n_lev == 8 ? siso::experiment_block<8, true> : siso::experiment_block<0, true>;
  for (int r = 0; r < R; ++r)
    block(smem, 0, 1, r, R, n_epochs, n_batches, n_sym, m, n_lev, n_total, epe, n_evals, rx, w_in,
          h_in, mw_in, vw_in, xw_in, mh_in, vh_in, xh_in, w_out, h_out, mw_out, vw_out, xw_out,
          mh_out, vh_out, xh_out, losses, w_ev, h_ev, amps, P, amp_mean, var, lr, step0, clocks);
  free(smem);
  return 0;
}

}  // extern "C"
