// Shared helpers for the paddle_tpu_torch Hopper kernels: float32 and
// bfloat16 loads/stores with float32 math, and the dtype codes the Python
// wrappers pass (0 = float32, 1 = bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {

constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// dynamic shared memory a block gets without an opt-in attribute; K4, B1
// and B2 opt in through allow_smem
constexpr size_t kMaxDynamicSmem = 48 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast
}

// element i of an output of T, or of float32 where `f32` (K4's float32
// output, which blha_attention's epilogue reads before it rounds once)
template <typename T>
__device__ __forceinline__ void put_out(void* out, size_t i, float x,
                                        bool f32) {
  if (f32)
    reinterpret_cast<float*>(out)[i] = x;
  else
    reinterpret_cast<T*>(out)[i] = from_f<T>(x);
}

// 16 bytes of T as floats: 8 bfloat16 or 4 float32 values
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// dynamic shared memory past the 48 KB default: opt the kernel in (up to
// the device's per-block limit) or refuse the shape before launching
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kMaxDynamicSmem) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  if (bytes > (size_t)optin) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace ptt
