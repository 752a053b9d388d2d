// Kernel L's bodies (dp_channel_step.cuh) on the host, for checking their
// arithmetic without a GPU: a drop-in for the channel library with the
// launchers' C signatures (csrc/dp_channel_kernel.cu, ops/_build.py:
// _SIGNATURES["channel"]), in which every index of every kernel runs in turn,
// each L4 power block sums its threads' partials and then its tree in the
// card's order, and L3 takes cos and sin of theta from the host's libm.
//
// ops/_build.py: host_library builds it under VAE_HOST_EMULATION;
// tests/test_torch_dp_channel_emulation.py patches ops/_build.py's load /
// stream to return it, and runs the wrappers' own launch code on CPU tensors,
// with torch.fft between them, against the plain channel.
#include "dp_channel_step.cuh"

namespace {

constexpr int kInvalid = 1;  // cudaErrorInvalidValue

template <bool F>
void mix(int R, int fft_len, float th, ch::cf e0, ch::cf e1, const float* d0, const float* d1,
         const float* cd, float* z) {
  for (int k = 0; k < fft_len; ++k) {
    const ch::H h = ch::response<F>(cosf(th), sinf(th), e0, e1, ch::ld(d0 + 2 * k), ch::ld(d1 + 2 * k));
    for (int r0 = 0; r0 < R; r0 += ch::kMixRuns)
      ch::mix<F>(k, r0, r0 + ch::kMixRuns < R ? r0 + ch::kMixRuns : R, fft_len, h, ch::ld(cd + 2 * k), z);
  }
}

}  // namespace

extern "C" {

int dp_levels_launch(int R, long long per_run, int n_lev, const float* u, float amp0,
                     const float* steps, const float* edges, long long e_run, float* out, void*) {
  if (R < 1 || per_run < 1 || n_lev < 2 || n_lev > ch::kMaxLev || e_run < 0) return kInvalid;
  for (long long i = 0; i < (long long)R * per_run; ++i)
    ch::level(i, per_run, n_lev, u, amp0, steps, edges, e_run, out);
  return 0;
}

int dp_fft_input_launch(int R, int n_conv, int sps, int up_len, int fft_len, const float* levels,
                        float* out, void*) {
  if (R < 1 || sps < 1 || up_len < 1 || up_len > sps * (n_conv - 1) + 1 || fft_len < up_len)
    return kInvalid;
  for (long long i = 0; i < (long long)R * 2 * fft_len; ++i)
    ch::fft_input(i, n_conv, sps, up_len, fft_len, levels, out);
  return 0;
}

int dp_mix_launch(int R, int fft_len, const float* theta, float e0r, float e0i, float e1r,
                  float e1i, const float* d0, const float* d1, const float* cd, float* z, int fused,
                  void*) {
  if (R < 1 || fft_len < 1) return kInvalid;
  const ch::cf e0{e0r, e0i}, e1{e1r, e1i};
  (fused ? mix<true> : mix<false>)(R, fft_len, *theta, e0, e1, d0, d1, cd, z);
  return 0;
}

int dp_noise_launch(int R, int fft_len, int start, int sig_len, int n_rx, float scale,
                    const float* z, double* partial, double inv_n, int sps, float snr,
                    const float* snr_runs, int recip, const float* noise, float* rx, float* sigma,
                    void*) {
  if (R < 1 || R > 65535 || sig_len < 1 || start < 0 || start + sig_len > fft_len || n_rx < 1 ||
      n_rx > sig_len)
    return kInvalid;
  const ch::Window w{z, fft_len, start, sig_len, scale};
  double s[ch::kThreads];
  for (int r = 0; r < R; ++r) {
    for (int g = 0; g < ch::kPowerBlocks; ++g) {
      for (int tid = 0; tid < ch::kThreads; ++tid) s[tid] = ch::power_partial(w, r, g, tid);
      for (int width = ch::kThreads / 2; width > 0; width /= 2)
        for (int tid = 0; tid < width; ++tid) ch::tree_step(s, width, tid);
      partial[r * ch::kPowerBlocks + g] = s[0];
    }
  }
  for (int r = 0; r < R; ++r) {
    const float sig = ch::sigma(partial, r, inv_n, sps, snr, snr_runs, recip);
    sigma[r] = sig;
    for (int p = 0; p < 2; ++p)
      for (int t = 0; t < n_rx; ++t) ch::add_noise(w, r, p, t, n_rx, sig, noise, rx);
  }
  return 0;
}

}  // extern "C"
