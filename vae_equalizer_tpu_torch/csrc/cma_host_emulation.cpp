// Kernels C, D and I's blocks (cma_step.cuh) on the host, for checking their
// arithmetic without a GPU: a drop-in for the cma library with the
// launchers' C signatures (csrc/cma_kernels.cu, ops/_build.py:
// _SIGNATURES["cma"]), in which one thread runs every item of every phase,
// computing each item's lane partials one after another and closing them
// with the card's butterfly (the card's lane partition and summation order),
// barriers are no-ops and the blocks of the runs run one after another.
//
// ops/_build.py: host_library builds it under VAE_HOST_EMULATION;
// tests/test_torch_cma_step_emulation.py patches ops/_build.py's load / stream
// to return it, and calls the wrappers' own launch code on CPU tensors against
// the plain versions.
#include <stdlib.h>

#include "cma_step.cuh"

extern "C" {

int cma_dp_launch(int R, int n_sym, int m, int sps, long long lp, const float* y,
                  const float* h_in, float* h_out, float* out, float* e, float big_r,
                  const float* lr, int update, long long* clocks, void*) {
  if (R < 1 || n_sym < 1 || m < 1 || m > cma::MAX_M || sps < 1 ||
      lp < (long long)(n_sym - 1) * sps + m)
    return 1;  // cudaErrorInvalidValue
  const int mh = m / 2;
  for (int r = 0; r < R; ++r) {
    const cma::CArgs a = {y + (long long)r * 4 * lp, lp, n_sym, m, sps, mh - mh / sps,
                          h_in + r * 8 * m, h_out + r * 8 * m, out + (long long)r * 4 * n_sym,
                          e + (long long)r * 2 * n_sym, big_r, 2.0f * *lr, update,
                          r == 0 ? clocks : nullptr};
    if (m <= 32)
      update ? cma::cma_symbols_run<true, 1, true>(0, a) : cma::cma_symbols_run<true, 1, false>(0, a);
    else
      update ? cma::cma_symbols_run<true, 2, true>(0, a) : cma::cma_symbols_run<true, 2, false>(0, a);
  }
  return 0;
}

int cma_chunked_launch(int R, int n_sym, int m, int sps, long long lp, int j0, int S, int n_full,
                       int n_slots, int tail, const float* y, const float* h_in, float* h_out,
                       float* out, float* e, float big_r, const float* lr, long long* clocks,
                       void*) {
  if (R < 1 || m < 1 || m > cma::MAX_M || sps < 1 || S < 1 || n_slots < 1 || n_full < 0 ||
      tail < 1 || tail > S || j0 < n_slots * S || n_sym != j0 + n_full * S + tail ||
      lp < (long long)(n_sym - 1) * sps + m)
    return 1;  // cudaErrorInvalidValue
  float* smem = static_cast<float*>(
      calloc((size_t)cma::d_smem_floats(m, sps, S, n_slots), sizeof(float)));
  if (smem == nullptr) return 2;  // cudaErrorMemoryAllocation
  const int mh = m / 2;
  for (int r = 0; r < R; ++r) {
    const cma::DArgs a = {y + (long long)r * 4 * lp, lp, n_sym, m, sps, mh - mh / sps, j0, S,
                          n_full, n_slots, tail, cma::d_split(m, S), h_in + r * 8 * m,
                          h_out + r * 8 * m, out + (long long)r * 4 * n_sym,
                          e + (long long)r * 2 * n_sym, big_r, 2.0f * *lr,
                          r == 0 ? clocks : nullptr};
    switch (cma::d_taps_per_lane(m)) {
      case 1: cma::chunked_block<true, 1>(smem, 0, 1, a); break;
      case 2: cma::chunked_block<true, 2>(smem, 0, 1, a); break;
      case 4: cma::chunked_block<true, 4>(smem, 0, 1, a); break;
      default: cma::chunked_block<true, 8>(smem, 0, 1, a); break;
    }
  }
  free(smem);
  return 0;
}

int cma_siso_experiment_launch(int R, int n_epochs, int m, int sps, long long n_total, int epe,
                               int n_evals, const float* rx, const float* h_in, float* h_out,
                               float* h_ev, float* loss, float big_r, float lr2,
                               long long* clocks, void*) {
  const long long n_sym = n_total / sps;
  if (R < 1 || n_epochs < 1 || m < 1 || m > cma::MAX_M || sps < 1 || n_sym < 1 ||
      n_sym > 0x7fffffff || epe < 1 || n_evals < 0 || n_evals > n_epochs / epe)
    return 1;  // cudaErrorInvalidValue
  // the card's packing of runs into warps, as on a card of one SM (so up to
  // 32 / kIGroup runs share a warp, and groups past the last run repeat it)
  const int rpw = cma::i_runs_per_warp(R, 1);
  int lt = 0;
  while ((cma::kIGroup << lt) < m) ++lt;
  float* ring = static_cast<float*>(calloc((size_t)cma::i_ring_floats(1 << lt), sizeof(float)));
  if (ring == nullptr) return 2;  // cudaErrorMemoryAllocation
  for (int b = 0; b < (R + rpw - 1) / rpw; ++b)
    for (int q = 0; q < cma::kWarp / cma::kIGroup; ++q) {
      const int r0 = b * rpw + (q < rpw ? q : rpw - 1);
      const bool writer = q < rpw && r0 < R;
      const int r = r0 < R ? r0 : R - 1;
      const cma::IArgs a = {rx + (long long)r * n_epochs * 2 * n_total, n_total, n_epochs,
                            (int)n_sym, m, sps, m / 2, epe, n_evals, (long long)R * 2 * m,
                            h_in + r * 2 * m, h_out + r * 2 * m, h_ev + r * 2 * m,
                            loss + (long long)r * n_epochs, big_r, lr2,
                            b == 0 && q == 0 ? clocks : nullptr};
      switch (lt) {
        case 0: cma::cma_siso_run<true, 1>(0, writer, ring, a); break;
        case 1: cma::cma_siso_run<true, 2>(0, writer, ring, a); break;
        case 2: cma::cma_siso_run<true, 4>(0, writer, ring, a); break;
        case 3: cma::cma_siso_run<true, 8>(0, writer, ring, a); break;
        default: cma::cma_siso_run<true, 16>(0, writer, ring, a); break;
      }
    }
  free(ring);
  return 0;
}

}  // extern "C"
