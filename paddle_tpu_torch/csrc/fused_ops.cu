// Rotary embedding (kernel K2) and SwiGLU (kernel K3).
//
// K2 replaces paddle_tpu/ops/pallas/fused_ops.py:_rope_one_pallas (forward):
// the neox half-split rotation [x1*c - x2*s, x2*c + x1*s] in float32 of
// q [B, S, H, D] and k [B, S, KVH, D] by cos/sin [S, D/2].  The serving
// engine passes B = 1, S = T packed tokens and the cos/sin rows gathered at
// each token's absolute position.  One launch rotates q and k together.
// K3 replaces fused_ops.py:_swiglu_pallas: silu(a) * b with float32 math.
//
// Bound on the H100: bytes for both (a handful of flops per element).
// Design: K2 gives one block to one token and walks all q and k heads of it,
// so the token's cos/sin row is read once and each element once; q and k
// may be strided views over the tokens (the columns of a packed qkv buffer),
// and the outputs are contiguous.  K3 is one grid-stride pass, one read of
// each input and one write.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                T* __restrict__ oq, T* __restrict__ ok,
                const float* __restrict__ cos_t,
                const float* __restrict__ sin_t, int S, int H, int KVH, int D,
                long long qsb, long long qss, long long ksb, long long kss) {
  const int tok = blockIdx.x;  // b * S + s
  const int b = tok / S, s = tok % S;
  const int half = D / 2;
  const float* c = cos_t + (size_t)s * half;
  const float* sn = sin_t + (size_t)s * half;
  const int n = (H + KVH) * half;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int head = idx / half, j = idx - head * half;
    const T* src;
    T* dst;
    if (head < H) {
      src = q + b * qsb + s * qss + (size_t)head * D;
      dst = oq + ((size_t)tok * H + head) * D;
    } else {
      const int hk = head - H;
      src = k + b * ksb + s * kss + (size_t)hk * D;
      dst = ok + ((size_t)tok * KVH + hk) * D;
    }
    const float x1 = ptt::to_f(src[j]), x2 = ptt::to_f(src[j + half]);
    const float cc = c[j], ss = sn[j];
    dst[j] = ptt::from_f<T>(x1 * cc - x2 * ss);
    dst[j + half] = ptt::from_f<T>(x2 * cc + x1 * ss);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ o, long long n) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const float av = ptt::to_f(a[i]);
    const float sig = 1.f / (1.f + expf(-av));
    o[i] = ptt::from_f<T>(av * sig * ptt::to_f(b[i]));
  }
}

}  // namespace

extern "C" int ptt_rope(const void* q, const void* k, void* oq, void* ok,
                        const void* cos_t, const void* sin_t, int B, int S,
                        int H, int KVH, int D, long long qsb, long long qss,
                        long long ksb, long long kss, int dtype,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = B * S;
  if (dtype == ptt::kFloat32)
    rope_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)q, (const float*)k, (float*)oq, (float*)ok,
        (const float*)cos_t, (const float*)sin_t, S, H, KVH, D, qsb, qss, ksb,
        kss);
  else if (dtype == ptt::kBFloat16)
    rope_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (__nv_bfloat16*)oq,
        (__nv_bfloat16*)ok, (const float*)cos_t, (const float*)sin_t, S, H,
        KVH, D, qsb, qss, ksb, kss);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ptt_swiglu(const void* a, const void* b, void* o, long long n,
                          int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 132 * 16 ? blocks : 132 * 16);
  if (dtype == ptt::kFloat32)
    swiglu_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)a, (const float*)b, (float*)o, n);
  else if (dtype == ptt::kBFloat16)
    swiglu_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)o,
        n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
