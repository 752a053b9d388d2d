// Kernel K's body (dp_eval_step.cuh) on the host, for checking its arithmetic
// without a GPU: a drop-in for the eval library with the launcher's C
// signature (csrc/dp_eval_kernel.cu, ops/_build.py: _SIGNATURES["eval"]), in
// which one "thread" (tid 0 of 1) runs every item (the host has no clock:
// `clocks` is left as it is), a run's cluster of
// ev::kCluster blocks runs phase by phase (each phase of every block, then
// the next, as the cluster barriers order them on the card), and the runs
// run one after another.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -DDP_EVAL_HOST_EMULATION \
//       -o libdp_eval_host.so dp_eval_host_emulation.cpp
//
// tests/test_torch_eval_kernel_emulation.py builds it, patches ops/_build.py's
// load / stream to return it, and calls the wrapper's own launch code on CPU
// tensors against the plain version.
#ifndef DP_EVAL_HOST_EMULATION
#define DP_EVAL_HOST_EMULATION
#endif
#include <stdlib.h>

#include "dp_eval_step.cuh"

namespace {

constexpr int kInvalid = 1;  // cudaErrorInvalidValue

// A peer block's shared memory, by its rank in the cluster
struct HostPeers {
  ev::Shared* const* blocks;
  const ev::Shared* operator()(int k) const { return blocks[k]; }
};

template <typename SF, typename SD>
void run_cluster(const ev::Args& a, int run, ev::Shared* const* sh) {
  const HostPeers peer{sh};
  for (int k = 0; k < ev::kCluster; ++k) ev::sync_partial<SF>(a, run, k, *sh[k], 0, 1);
  for (int k = 0; k < ev::kCluster; ++k) {
    ev::sync_decide(peer, *sh[k], 0, 1);
    ev::pass_a<SF, SD>(a, run, k, *sh[k], 0, 1);
  }
  for (int k = 0; k < ev::kCluster; ++k) ev::pass_b<SF>(a, peer, run, k, *sh[k], 0, 1);
  ev::finish(a, peer, run, *sh[0], 0, 1);
}

}  // namespace

extern "C" {

int vae_dp_eval_launch(int R, int m_max, int L, int n_lev, int corr_len, int stream_bf16,
                       const void* out, const void* dec, const void* eq, const float* mm,
                       const float* s1, long long s_mb, long long s_run, long long s_pol,
                       long long s_comp, long long e_mb, long long e_run, long long e_pol,
                       const float* tx, long long t_run, long long t_pol, long long t_comp,
                       const float* amps, const float* P, long long p_run, const float* var,
                       long long v_run, float nu, const float* nu_runs, float inv_step, float half,
                       int mask_kind, int mask_a, int mask_b, int mask_c, int margin, float* res_f,
                       int* res_i, long long*, void*) {
  const long long N = (long long)m_max * L;
  if (R < 1 || m_max < 1 || L < 1 || N < ev::kShifts || N > 0x7fffffffLL || n_lev < 2 ||
      n_lev > ev::kMaxLev || corr_len < 1 || (corr_len < N ? corr_len : N) > ev::kMaxCorr ||
      (mask_kind == ev::kBatchCut && mask_b < 1))
    return kInvalid;
  const ev::Args a{R, m_max, L, n_lev, corr_len, out, dec, eq, mm, s1, s_mb, s_run, s_pol, s_comp,
                   e_mb, e_run, e_pol, tx, t_run, t_pol, t_comp, amps, P, var, nu_runs, p_run, v_run,
                   nu, inv_step, half, mask_kind, mask_a, mask_b, mask_c, margin, res_f, res_i};
  ev::Shared* sh[ev::kCluster];
  for (int k = 0; k < ev::kCluster; ++k)
    sh[k] = static_cast<ev::Shared*>(calloc(1, sizeof(ev::Shared)));
  for (int run = 0; run < R; ++run) {
    if (stream_bf16)
      run_cluster<ev::bf16, ev::bf16>(a, run, sh);
    else
      run_cluster<float, int>(a, run, sh);
  }
  for (int k = 0; k < ev::kCluster; ++k) free(sh[k]);
  return 0;
}

}  // extern "C"
