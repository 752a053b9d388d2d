// Kernels F and G's blocks (siso_step.cuh) on the host, for checking their
// arithmetic without a GPU: a drop-in for the siso library with the
// launchers' C signatures (csrc/siso_kernels.cu, ops/_build.py:
// _SIGNATURES["siso"]; the same 8-level / generic instances), in which one
// "thread" runs every item of every phase, computes every lane's partial of
// a split sum and each block total's thread and warp partials in the card's
// order (siso::kThreads threads), barriers are no-ops and the blocks of the
// runs run one after another. vae_siso_division_check holds the body's two
// branch-free division forms to IEEE division.
//
// ops/_build.py: host_library builds it under VAE_HOST_EMULATION;
// tests/test_torch_siso_step_emulation.py patches ops/_build.py's load /
// stream to return it, and calls the wrappers' own launch code on CPU tensors
// against the plain versions.
#include <stdlib.h>
#include <string.h>

#include <cstdint>
#include <random>

#include "siso_step.cuh"

namespace {

bool bad_shape(int n_sym, int m, int n_lev) {
  return n_lev < 1 || n_lev > siso::MAX_LEV || m % 2 != 1 || 2 * n_sym <= m;
}

float* block_smem(int n_sym, int m, int n_lev) {
  const siso::Layout L = siso::make_layout(siso::make_dims(n_sym, m, n_lev));
  return static_cast<float*>(calloc((size_t)L.total, sizeof(float)));
}

float f_of(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
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

// The body's two division forms against IEEE float division (round to
// nearest) on n draws: fdiv's (float)(a * y) in double with y = RN(1 / b)
// moved by -4..4 double ulps (a any finite float, zero and denormals
// included; b > 0 normal in [2^-106, 2^94)), and the metric's Markstein
// correction of x * RN(1 / v) (x = 0 or in [2^-100, 2^60), v in [2^-40,
// 2^40)). bad[0], bad[1]: the quotients of each form that differ.
void vae_siso_division_check(long long n, long long* bad) {
  std::mt19937_64 g(12345);
  bad[0] = bad[1] = 0;
  for (long long i = 0; i < n; ++i) {
    const uint64_t r = g();
    uint32_t ua = (uint32_t)r & 0x7fffffffu;
    if ((ua >> 23) == 0xff) ua = 0;
    const uint32_t ub = ((uint32_t)(r >> 32) & 0x7fffffu) | ((uint32_t)(21 + (r >> 55) % 200) << 23);
    const float a = (i & 1) ? -f_of(ua) : f_of(ua), b = f_of(ub), want = a / b;
    if (isfinite(want))
      for (int k = -4; k <= 4; ++k) {
        double y = 1.0 / (double)b;
        for (int s = 0; s < (k < 0 ? -k : k); ++s) y = nextafter(y, k < 0 ? 0.0 : 1e300);
        const float got = siso::fdiv(a, y);
        bad[0] += memcmp(&got, &want, 4) != 0;
      }
    const uint32_t ma = (i % 97 == 0) ? 0u : (((uint32_t)r & 0x7fffffu) | ((uint32_t)(27 + (r >> 23) % 160) << 23));
    const uint32_t mb = ((uint32_t)(r >> 32) & 0x7fffffu) | ((uint32_t)(87 + (r >> 56) % 80) << 23);
    const float x = f_of(ma), v = f_of(mb), yv = 1.f / v, q0 = x * yv;
    const float q1 = fmaf(fmaf(-q0, v, x), yv, q0), wq = x / v;
    bad[1] += memcmp(&q1, &wq, 4) != 0;
  }
}

}  // extern "C"
