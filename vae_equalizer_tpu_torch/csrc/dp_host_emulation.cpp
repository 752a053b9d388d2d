// Kernels A and B's step body (dp_step.cuh) on the host, for checking its
// arithmetic without a GPU: a drop-in for the dp library with the launchers'
// C signatures (csrc/dp_kernels.cu, ops/_build.py: _SIGNATURES["dp"]; the
// same 8-level / generic instances by n_lev), in which one "thread" (tid 0
// of 1) runs every item of every phase and the blocks of the runs run one
// after another. vae_dp_step_launch_generic / vae_dp_frame_launch_generic
// take the same arguments and run the generic instance at any n_lev, so the
// two instances can be held to each other at 8 levels; vae_dp_division_check
// holds the step's branch-free divisions to IEEE division.
//
// ops/_build.py: host_library builds it under VAE_HOST_EMULATION;
// tests/test_torch_dp_step_emulation.py patches ops/_build.py's load / stream
// to return it, and calls the wrappers' own launch code on CPU tensors against
// the plain versions.
#include <math.h>
#include <stdlib.h>
#include <string.h>

#include <random>

#include "dp_step.cuh"

namespace {

constexpr int kInvalid = 1;  // cudaErrorInvalidValue

// The launchers' refusals (dp_kernels.cu: prepare); returns a block's scratch.
float* prepare(int n_sym, int m, int n_lev) {
  if (n_lev < 1 || n_lev > dp::MAX_LEV || m % 2 != 1 || 2 * n_sym <= m) return nullptr;
  const dp::Layout L = dp::make_layout(dp::make_dims(n_sym, m, n_lev), 1);
  return static_cast<float*>(calloc((size_t)L.total, sizeof(float)));
}

template <int NL>
int step_launch(int R, const float* x, long long x_run, long long x_row, const float* w,
                const float* h, const float* amps, const float* P, const float* var, float nu_sc,
                int n_sym, int m, int n_lev, float* stats, float* gw, float* gh, float* q,
                float* out) {
  if (R < 1 || x_run < 0 || x_row < 2 * n_sym) return kInvalid;
  float* smem = prepare(n_sym, m, n_lev);
  if (smem == nullptr) return kInvalid;
  const long long np = 8 * m;
  for (long long r = 0; r < R; ++r)
    dp::step_block<NL>(smem, 0, 1, x + r * x_run, x_row, w + r * np, h + r * np, amps, P, var,
                       nu_sc, n_sym, m, n_lev, stats + r * 3, gw + r * np, gh + r * np,
                       q + r * 4 * n_lev * n_sym, out + r * 4 * n_sym);
  free(smem);
  return 0;
}

template <int NL>
int frame_launch(int R, int m_max, int n_sym, int stride_sym, int m, int n_lev, long long n_total,
                 const float* rx, const float* w_in, const float* h_in, const float* mw_in,
                 const float* vw_in, const float* mh_in, const float* vh_in, float* w_out,
                 float* h_out, float* mw_out, float* vw_out, float* mh_out, float* vh_out,
                 float* losses, float* var_est, void* out, void* dec, void* eq, float* mm,
                 float* s1, const float* amps, const float* P, const float* var,
                 const float* nu_sc, const float* lr, const long long* step0, double lr_half_step,
                 int stream_bf16, long long* clocks) {
  if (R < 1 || m_max < 1 || stride_sym < 1 ||
      n_total < 2 * ((long long)stride_sym * (m_max - 1) + n_sym))
    return kInvalid;
  float* smem = prepare(n_sym, m, n_lev);
  if (smem == nullptr) return kInvalid;
  for (int r = 0; r < R; ++r) {
    if (stream_bf16)
      dp::frame_block<NL, dp::bf16, dp::bf16>(
          smem, 0, 1, r, R, m_max, n_sym, stride_sym, m, n_lev, n_total, rx, w_in, h_in, mw_in,
          vw_in, mh_in, vh_in, w_out, h_out, mw_out, vw_out, mh_out, vh_out, losses, var_est,
          static_cast<dp::bf16*>(out), static_cast<dp::bf16*>(dec), static_cast<dp::bf16*>(eq), mm,
          s1, amps, P, var, nu_sc, lr, *step0, lr_half_step, clocks);
    else
      dp::frame_block<NL, float, int>(
          smem, 0, 1, r, R, m_max, n_sym, stride_sym, m, n_lev, n_total, rx, w_in, h_in, mw_in,
          vw_in, mh_in, vh_in, w_out, h_out, mw_out, vw_out, mh_out, vh_out, losses, var_est,
          static_cast<float*>(out), static_cast<int*>(dec), static_cast<float*>(eq), mm, s1, amps,
          P, var, nu_sc, lr, *step0, lr_half_step, clocks);
  }
  free(smem);
  return 0;
}

// Uniform draws: a float with a random significand in [2^lo, 2^hi), or a
// dividend that is that, or zero, or a denormal (1 in 32 each).
struct Draw {
  std::mt19937_64 g;
  float in(int lo, int hi) {
    const unsigned long long r = g();
    const unsigned int bits = (unsigned int)(r & 0x7fffffu) | (unsigned int)(127 + lo + (int)((r >> 23) % (unsigned)(hi - lo))) << 23;
    float f;
    memcpy(&f, &bits, 4);
    return f;
  }
  float dividend(int lo, int hi) {
    const unsigned int k = (unsigned int)(g() % 32);
    if (k == 0) return 0.f;
    if (k == 1) {
      const unsigned int bits = 1u + (unsigned int)(g() % 0x7fffffu);
      float f;
      memcpy(&f, &bits, 4);
      return f;
    }
    return in(lo, hi);
  }
  float sign(float f) { return (g() & 1) ? -f : f; }
};

// fdiv(a, y) against a / b, y being recip(b) moved by -4..4 double ulps (the
// card's recip is within ~2 ulps of 1 / b); the mismatches.
long long fdiv_bad(float a, float b) {
  long long bad = 0;
  const float want = a / b;
  for (int k = -4; k <= 4; ++k) {
    double y = dp::recip((double)b);
    for (int s = 0; s < (k < 0 ? -k : k); ++s) y = nextafter(y, k < 0 ? 0.0 : 1e300);
    const float got = dp::fdiv(a, y);
    bad += memcmp(&got, &want, 4) != 0;
  }
  return bad;
}

}  // namespace

extern "C" {

// The step's branch-free divisions against IEEE float division on n draws of
// each of the demapper's and dL/dout's divisions over their operand ranges
// (seeded by seed): the metric (out - a)^2 / (2 var) by mdiv (out within
// 2^2, levels a in [2^-4, 2), 2 var in [2^-14, 2), out = a in 1 of 16
// draws), and by fdiv with a reciprocal 4 ulps off either way: e / s1 (e in
// [2^-126, 1], s1 in [1, 16)), q / P (P in [2^-20, 1)), r / (r + eps) (r in
// [2^-126, 2^20)) and dL/dout's acc / var (acc of either sign within 2^20,
// var in [2^-17, 2)), each dividend zero or denormal in 1 of 16 draws. Returns
// the number of quotients that differ.
long long vae_dp_division_check(long long n, unsigned long long seed) {
  Draw d{std::mt19937_64(seed)};
  long long bad = 0;
  for (long long i = 0; i < n; ++i) {
    const float a = d.sign(d.in(-4, 1)), v = d.in(-14, 1);
    const float o = (d.g() % 16 == 0) ? a : d.sign(d.in(-30, 2)), dd = o - a, x = dd * dd;
    const float got = dp::mdiv(x, v, 1.f / v), want = x / v;
    bad += memcmp(&got, &want, 4) != 0;
    bad += fdiv_bad(d.dividend(-126, 0), d.in(0, 4));
    bad += fdiv_bad(d.dividend(-126, 0), d.in(-20, 0));
    const float r = d.dividend(-126, 20);
    bad += fdiv_bad(r, r + dp::EPS_KL);
    bad += fdiv_bad(d.sign(d.dividend(-126, 20)), d.in(-17, 1));
  }
  return bad;
}

#define DP_STEP_ARGS                                                                           \
  int R, const float *x, long long x_run, long long x_row, const float *w, const float *h,     \
      const float *amps, const float *P, const float *var, float nu_sc, int n_sym, int m,      \
      int n_lev, float *stats, float *gw, float *gh, float *q, float *out, void *
#define DP_STEP_PASS R, x, x_run, x_row, w, h, amps, P, var, nu_sc, n_sym, m, n_lev, stats, gw, gh, q, out
#define DP_FRAME_ARGS                                                                          \
  int R, int m_max, int n_sym, int stride_sym, int m, int n_lev, long long n_total,            \
      const float *rx, const float *w_in, const float *h_in, const float *mw_in,               \
      const float *vw_in, const float *mh_in, const float *vh_in, float *w_out, float *h_out,  \
      float *mw_out, float *vw_out, float *mh_out, float *vh_out, float *losses,               \
      float *var_est, void *out, void *dec, void *eq, float *mm, float *s1, const float *amps, \
      const float *P, const float *var, const float *nu_sc, const float *lr,                   \
      const long long *step0, double lr_half_step, int stream_bf16, long long *clocks, void *
#define DP_FRAME_PASS                                                                          \
  R, m_max, n_sym, stride_sym, m, n_lev, n_total, rx, w_in, h_in, mw_in, vw_in, mh_in, vh_in,  \
      w_out, h_out, mw_out, vw_out, mh_out, vh_out, losses, var_est, out, dec, eq, mm, s1,     \
      amps, P, var, nu_sc, lr, step0, lr_half_step, stream_bf16, clocks

int vae_dp_step_launch(DP_STEP_ARGS) {
  return n_lev == 8 ? step_launch<8>(DP_STEP_PASS) : step_launch<0>(DP_STEP_PASS);
}
int vae_dp_step_launch_generic(DP_STEP_ARGS) { return step_launch<0>(DP_STEP_PASS); }

int vae_dp_frame_launch(DP_FRAME_ARGS) {
  return n_lev == 8 ? frame_launch<8>(DP_FRAME_PASS) : frame_launch<0>(DP_FRAME_PASS);
}
int vae_dp_frame_launch_generic(DP_FRAME_ARGS) { return frame_launch<0>(DP_FRAME_PASS); }

}  // extern "C"
