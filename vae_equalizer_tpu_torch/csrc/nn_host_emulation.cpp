// Kernel H's block (nn_step.cuh) on the host, for checking its arithmetic
// without a GPU: a drop-in for the nn library with the launcher's C signature
// (csrc/nn_kernels.cu, ops/_build.py: _SIGNATURES["nn"]), in which one
// "thread" (tid 0 of 1) runs every item of every phase, a warp is one lane,
// barriers are no-ops and the blocks of the runs run one after another.
//
// ops/_build.py: host_library builds it under VAE_HOST_EMULATION;
// tests/test_torch_nn_step_emulation.py patches ops/_build.py's load / stream
// to return it, and calls the wrapper's own launch code on CPU tensors against
// the plain version.
#include <stdlib.h>

#include "nn_step.cuh"

extern "C" {

int vae_nn_experiment_launch(int R, int n_epochs, int n_batches, int n_sym, int m, int n_lev, int k1,
                             long long n_total, int epe, int n_evals, int batchnorm,
                             void* const* ptrs, float lr, float momentum, long long step0,
                             long long* clocks, void*) {
  nn::Args a;
  if (!nn::make_args(&a, R, n_epochs, n_batches, n_sym, m, n_lev, k1, n_total, epe, n_evals,
                     batchnorm, ptrs, lr, momentum, step0, clocks))
    return 1;  // cudaErrorInvalidValue
  float* smem = static_cast<float*>(
      calloc((size_t)nn::smem_floats(n_sym, m, n_lev, k1, batchnorm != 0), sizeof(float)));
  if (smem == nullptr) return 2;  // cudaErrorMemoryAllocation
  for (int r = 0; r < R; ++r) nn::experiment_block(smem, 0, 1, r, a);
  free(smem);
  return 0;
}

}  // extern "C"
