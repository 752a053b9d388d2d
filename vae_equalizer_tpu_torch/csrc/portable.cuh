// What the step headers (dp, dp_eval, cma, siso, nn, dfe) need to compile both
// for the card and, under VAE_HOST_EMULATION, as plain C++ for checking their
// arithmetic without a GPU (csrc/*_host_emulation.cpp, built by
// ops/_build.py: host_library). On the host one "thread" runs every item of a
// block, so a barrier is a no-op, the clock reads 0 and cp.async is a copy.
// VAE_FMA / VAE_DFMA are the step bodies' explicit fused multiply-adds: the
// libraries are built without contraction (--fmad=false, -ffp-contract=off),
// so every other product and sum rounds alone, as in the plain versions.
//
// How a warp's lanes are emulated differs by kernel and stays in each header.
#pragma once

#include <math.h>

#ifdef VAE_HOST_EMULATION
#include <stdlib.h>
#include <string.h>
#define VAE_HD inline
#define VAE_DEV inline
#define VAE_SYNC() ((void)0)
#define VAE_CLOCK() 0LL
#define VAE_FMA(a, b, c) fmaf(a, b, c)
#define VAE_DFMA(a, b, c) fma(a, b, c)
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
#else
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#define VAE_HD __host__ __device__ __forceinline__
#define VAE_DEV __device__ __forceinline__
#define VAE_SYNC() __syncthreads()
#define VAE_CLOCK() clock64()
#define VAE_FMA(a, b, c) __fmaf_rn(a, b, c)
#define VAE_DFMA(a, b, c) __fma_rn(a, b, c)
#endif

namespace vae {

// A stream element of kernels B and K: float32 (decisions int32), or bfloat16
// for all three streams (stream_bf16; the level indices are exact in
// bfloat16). put() rounds to nearest even, as torch's .to(bfloat16).
#ifdef VAE_HOST_EMULATION
struct bf16 {
  unsigned short bits;
};
inline void put(bf16* p, float v) {
  unsigned int u;
  memcpy(&u, &v, 4);
  p->bits = (v != v) ? (unsigned short)0x7fc0 : (unsigned short)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}
inline float ld(const bf16* p) {
  const unsigned int u = (unsigned int)p->bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
#else
typedef __nv_bfloat16 bf16;
VAE_DEV void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
VAE_DEV float ld(const bf16* p) { return __bfloat162float(*p); }
#endif
VAE_DEV void put(float* p, float v) { *p = v; }
VAE_DEV void put(int* p, int v) { *p = v; }
VAE_DEV void put(bf16* p, int v) { put(p, (float)v); }
VAE_DEV float ld(const float* p) { return *p; }

// One float from device to shared memory, in flight until copy_async_wait
// (or, committed as a group, until copy_async_wait_prior leaves at most the
// latest group in flight).
#ifdef VAE_HOST_EMULATION
inline void copy_async(float* dst, const float* src) { *dst = *src; }
inline void copy_async_wait() {}
inline void copy_async_commit() {}
inline void copy_async_wait_prior() {}
inline void sync_warp() {}
#else
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }
__device__ __forceinline__ void copy_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void copy_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void sync_warp() { __syncwarp(); }
#endif

}  // namespace vae
