// Kernel K for NVIDIA Hopper (sm_90a), behind a plain C interface loaded with
// ctypes (vae_equalizer_tpu_torch/ops/_build.py, library "eval"): the DP VAE
// frame's eval (sync, aligned SER and MI) for all R runs of a frame in one
// launch, on kernel B's streams read in place (ops/eval_kernel.py).
//
// grid = R clusters of ev::kCluster blocks of ev::kThreads threads, one
// cluster per run (its blocks on as many SMs); the body and the note on why
// K exists, what bounds it and how the design answers it are in
// dp_eval_step.cuh. Between the phases the cluster's blocks meet at a cluster
// barrier and read each other's partials from distributed shared memory; the
// last barrier keeps every block's shared memory alive until block 0 has
// read it. `clocks` (8 int64, or null): block 0's thread 0 adds its
// clock64() cycles per phase (ops/eval_kernel.py: CLOCK_PHASES), for
// measurement (eval_clocks). The launcher returns cudaGetLastError() so the
// wrapper can raise on a refused launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dp_eval_step.cuh"

namespace cg = cooperative_groups;

namespace {

// A peer block's shared memory, by its rank in the cluster
struct ClusterPeers {
  ev::Shared* self;
  __device__ const ev::Shared* operator()(int k) const {
    cg::cluster_group cl = cg::this_cluster();
    return cl.map_shared_rank(self, k);
  }
};

// out / eq as float and dec as int32, or all three as bfloat16 (stream_bf16)
template <typename SF, typename SD>
__global__ void __cluster_dims__(ev::kCluster, 1, 1) __launch_bounds__(ev::kThreads)
vae_dp_eval_kernel(ev::Args a, long long* clocks) {
  __shared__ ev::Shared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank(), run = blockIdx.x / ev::kCluster;
  const int tid = threadIdx.x, nt = blockDim.x;
  const ClusterPeers peer{&sh};
  const bool clk = clocks != nullptr && blockIdx.x == 0 && tid == 0;
  long long t = clk ? clock64() : 0;
  auto mark = [&](int ph) {
    if (clk) {
      const long long now = clock64();
      clocks[ph] += now - t;
      t = now;
    }
  };
  ev::sync_partial<SF>(a, run, rank, sh, tid, nt);
  mark(0);
  cl.sync();
  mark(1);
  ev::sync_decide(peer, sh, tid, nt);
  mark(2);
  ev::pass_a<SF, SD>(a, run, rank, sh, tid, nt);
  mark(3);
  cl.sync();
  mark(4);
  ev::pass_b<SF>(a, peer, run, rank, sh, tid, nt);
  mark(5);
  cl.sync();
  mark(6);
  if (rank == 0) ev::finish(a, peer, run, sh, tid, nt);
  mark(7);
  cl.sync();
}

}  // namespace

extern "C" {

// R, m_max, L, n_lev, corr_len, stream_bf16, out, dec, eq, mm, s1, their
// strides (mb, run, pol, comp), eq's (mb, run, pol), tx and its strides (run,
// pol, comp), amps, P and its run stride, var and its run stride, nu_sc
// (shared) and nu_sc per run (or null), inv_step and half of the level
// decode, the mask (kind, a, b, c, margin), res_f (R, 6), res_i (R, 3),
// clocks (8 int64, or null), stream
int vae_dp_eval_launch(int R, int m_max, int L, int n_lev, int corr_len, int stream_bf16,
                       const void* out, const void* dec, const void* eq, const float* mm,
                       const float* s1, long long s_mb, long long s_run, long long s_pol,
                       long long s_comp, long long e_mb, long long e_run, long long e_pol,
                       const float* tx, long long t_run, long long t_pol, long long t_comp,
                       const float* amps, const float* P, long long p_run, const float* var,
                       long long v_run, float nu, const float* nu_runs, float inv_step, float half,
                       int mask_kind, int mask_a, int mask_b, int mask_c, int margin, float* res_f,
                       int* res_i, long long* clocks, void* stream) {
  const long long N = (long long)m_max * L;
  if (R < 1 || m_max < 1 || L < 1 || N < ev::kShifts || N > 0x7fffffffLL || n_lev < 2 ||
      n_lev > ev::kMaxLev || corr_len < 1 || (corr_len < N ? corr_len : N) > ev::kMaxCorr ||
      (mask_kind == ev::kBatchCut && mask_b < 1))
    return (int)cudaErrorInvalidValue;
  const ev::Args a{R, m_max, L, n_lev, corr_len, out, dec, eq, mm, s1, s_mb, s_run, s_pol, s_comp,
                   e_mb, e_run, e_pol, tx, t_run, t_pol, t_comp, amps, P, var, nu_runs, p_run, v_run,
                   nu, inv_step, half, mask_kind, mask_a, mask_b, mask_c, margin, res_f, res_i};
  const dim3 grid(R * ev::kCluster);
  if (stream_bf16)
    vae_dp_eval_kernel<ev::bf16, ev::bf16><<<grid, ev::kThreads, 0, (cudaStream_t)stream>>>(a, clocks);
  else
    vae_dp_eval_kernel<float, int><<<grid, ev::kThreads, 0, (cudaStream_t)stream>>>(a, clocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
