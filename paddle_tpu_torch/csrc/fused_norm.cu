// RMSNorm and residual-add + RMSNorm (kernel K1).
//
// Replaces paddle_tpu/ops/pallas/fused_norm.py:_pallas_rms and
// :_pallas_rms_residual.  out = x * rsqrt(mean(x^2) + eps) * w over the last
// dim with float32 statistics; the residual form first sums s = x + r in
// float32, writes residual_out = s (in the tensor's type) and normalizes the
// float32 s.
//
// Bound on the H100: bytes.  A row of H = 4096 does ~3 flops per element
// against 2 (or 3) bytes read and 2 (or 4) written, far below the ~295
// flop/byte ridge.  Design: one block per row, so each input element is read
// from device memory once; the float32 row stays in shared memory between
// the sum-of-squares pass and the scaling pass (H <= 12288 keeps it inside
// the 48 KB default; a wider row is refused), and the sum is reduced with
// warp shuffles.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ float block_sum(float v, float* red) {
  v = ptt::warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
    v = ptt::warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    rms_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const T* __restrict__ w, T* __restrict__ out,
               T* __restrict__ res_out, int h, float eps) {
  extern __shared__ float row[];  // h floats
  __shared__ float red[32];
  const size_t base = (size_t)blockIdx.x * h;
  float ss = 0.f;
  for (int i = threadIdx.x; i < h; i += kThreads) {
    float v = ptt::to_f(x[base + i]);
    if (kResidual) {
      v += ptt::to_f(r[base + i]);
      res_out[base + i] = ptt::from_f<T>(v);
    }
    row[i] = v;  // each thread reads back only the entries it wrote
    ss += v * v;
  }
  const float inv = rsqrtf(block_sum(ss, red) / (float)h + eps);
  for (int i = threadIdx.x; i < h; i += kThreads)
    out[base + i] = ptt::from_f<T>(row[i] * inv * ptt::to_f(w[i]));
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* w, void* out,
                   void* res_out, int n, int h, float eps, cudaStream_t s) {
  // the float32 row must fit the 48 KB default of one block: h <= 12288
  const size_t smem = (size_t)h * sizeof(float);
  if (smem > ptt::kMaxDynamicSmem) return cudaErrorInvalidConfiguration;
  if (r != nullptr)
    rms_kernel<T, true><<<n, kThreads, smem, s>>>(
        (const T*)x, (const T*)r, (const T*)w, (T*)out, (T*)res_out, h, eps);
  else
    rms_kernel<T, false><<<n, kThreads, smem, s>>>(
        (const T*)x, nullptr, (const T*)w, (T*)out, nullptr, h, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_rms_norm(const void* x, const void* r, const void* w,
                            void* out, void* res_out, int n, int h, float eps,
                            int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == ptt::kFloat32)
    return (int)launch<float>(x, r, w, out, res_out, n, h, eps, s);
  if (dtype == ptt::kBFloat16)
    return (int)launch<__nv_bfloat16>(x, r, w, out, res_out, n, h, eps, s);
  return (int)cudaErrorInvalidValue;
}

// the name of a cudaError_t an entry returned (one entry for the library)
extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
