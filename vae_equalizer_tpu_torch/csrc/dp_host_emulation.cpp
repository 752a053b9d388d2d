// Kernels A and B's step body (dp_step.cuh) on the host, for checking its
// arithmetic without a GPU: a drop-in for the dp library with the launchers'
// C signatures (csrc/dp_kernels.cu, ops/_build.py: _SIGNATURES["dp"]), in
// which one "thread" (tid 0 of 1) runs every item of every phase and the
// blocks of the runs run one after another.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -DDP_HOST_EMULATION \
//       -o libdp_host.so dp_host_emulation.cpp
//
// tests/test_torch_dp_step_emulation.py builds it, patches ops/_build.py's
// load / stream to return it, and calls the wrappers' own launch code on CPU
// tensors against the plain versions.
#ifndef DP_HOST_EMULATION
#define DP_HOST_EMULATION
#endif
#include <stdlib.h>

#include "dp_step.cuh"

namespace {

constexpr int kInvalid = 1;  // cudaErrorInvalidValue

// The launchers' refusals (dp_kernels.cu: prepare); returns a block's scratch.
float* prepare(int n_sym, int m, int n_lev) {
  if (n_lev < 1 || n_lev > dp::MAX_LEV || m % 2 != 1 || 2 * n_sym <= m) return nullptr;
  const dp::Layout L = dp::make_layout(dp::make_dims(n_sym, m, n_lev), 1);
  return static_cast<float*>(calloc((size_t)L.total, sizeof(float)));
}

}  // namespace

extern "C" {

int vae_dp_step_launch(int R, const float* x, long long x_run, long long x_row, const float* w,
                       const float* h, const float* amps, const float* P, const float* var,
                       float nu_sc, int n_sym, int m, int n_lev, float* stats, float* gw,
                       float* gh, float* q, float* out, void*) {
  if (R < 1 || x_run < 0 || x_row < 2 * n_sym) return kInvalid;
  float* smem = prepare(n_sym, m, n_lev);
  if (smem == nullptr) return kInvalid;
  const long long np = 8 * m;
  for (long long r = 0; r < R; ++r)
    dp::step_block(smem, 0, 1, x + r * x_run, x_row, w + r * np, h + r * np, amps, P, var, nu_sc,
                   n_sym, m, n_lev, stats + r * 3, gw + r * np, gh + r * np,
                   q + r * 4 * n_lev * n_sym, out + r * 4 * n_sym);
  free(smem);
  return 0;
}

int vae_dp_frame_launch(int R, int m_max, int n_sym, int stride_sym, int m, int n_lev,
                        long long n_total, const float* rx, const float* w_in,
                        const float* h_in, const float* mw_in, const float* vw_in,
                        const float* mh_in, const float* vh_in, float* w_out, float* h_out,
                        float* mw_out, float* vw_out, float* mh_out, float* vh_out,
                        float* losses, float* var_est, void* out, void* dec, void* eq, float* mm,
                        float* s1, const float* amps, const float* P, const float* var,
                        const float* nu_sc, const float* lr, long long step0,
                        double lr_half_step, int stream_bf16, long long* clocks, void*) {
  if (R < 1 || m_max < 1 || stride_sym < 1 ||
      n_total < 2 * ((long long)stride_sym * (m_max - 1) + n_sym))
    return kInvalid;
  float* smem = prepare(n_sym, m, n_lev);
  if (smem == nullptr) return kInvalid;
  for (int r = 0; r < R; ++r) {
    if (stream_bf16)
      dp::frame_block<dp::bf16, dp::bf16>(
          smem, 0, 1, r, R, m_max, n_sym, stride_sym, m, n_lev, n_total, rx, w_in, h_in, mw_in,
          vw_in, mh_in, vh_in, w_out, h_out, mw_out, vw_out, mh_out, vh_out, losses, var_est,
          static_cast<dp::bf16*>(out), static_cast<dp::bf16*>(dec), static_cast<dp::bf16*>(eq), mm,
          s1, amps, P, var, nu_sc, lr, step0, lr_half_step, clocks);
    else
      dp::frame_block<float, int>(
          smem, 0, 1, r, R, m_max, n_sym, stride_sym, m, n_lev, n_total, rx, w_in, h_in, mw_in,
          vw_in, mh_in, vh_in, w_out, h_out, mw_out, vw_out, mh_out, vh_out, losses, var_est,
          static_cast<float*>(out), static_cast<int*>(dec), static_cast<float*>(eq), mm, s1, amps,
          P, var, nu_sc, lr, step0, lr_half_step, clocks);
  }
  free(smem);
  return 0;
}

}  // extern "C"
