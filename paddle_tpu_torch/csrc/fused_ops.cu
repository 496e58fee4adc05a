// Rotary embedding (kernel K2) and SwiGLU (kernel K3).
//
// K2 replaces paddle_tpu/ops/pallas/fused_ops.py:_rope_one_pallas (forward):
// the neox half-split rotation [x1*c - x2*s, x2*c + x1*s] in float32 of
// q [B, S, H, D] and k [B, S, KVH, D] by cos/sin [S, D/2].  The serving
// engine passes B = 1, S = T packed tokens and the cos/sin rows gathered at
// each token's absolute position.  One launch rotates q and k together.
// K3 replaces fused_ops.py:_swiglu_pallas: silu(a) * b with float32 math.
// B6b replaces fused_ops.py:_swiglu_bwd_pallas (kernel _swiglu_bwd_kernel):
// da = g * b * (sig + silu * (1 - sig)), db = g * silu, with sig = sigmoid(a)
// recomputed from a (no activation stash), float32 math.  The rope backward
// is K2 itself, launched with -sin (fused_ops.py:_rope_bwd).
//
// Bound on the H100: bytes for all three (a handful of flops per element).
// Design: K2 gives one block to one token and walks all q and k heads of it,
// so the token's cos/sin row is read once and each element once; q and k
// may be strided views over the tokens (the columns of a packed qkv buffer),
// and the outputs are contiguous.  K3 and B6b are one grid-stride pass each,
// one read of each input and one write of each output; K3 moves 16 bytes of
// each a thread per step where the three pointers allow it.
#include <stdint.h>

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
__device__ __forceinline__ T swiglu1(T a, T b) {
  const float av = ptt::to_f(a);
  const float sig = 1.f / (1.f + expf(-av));
  return ptt::from_f<T>(av * sig * ptt::to_f(b));
}

// vec: a, b and o are 16-byte aligned.  Then each thread reads 16 bytes of
// a and of b (8 bfloat16 or 4 float32) and writes 16 of o per step of a
// grid-stride loop, and the last numel % (16 / sizeof(T)) elements go
// element by element; otherwise the whole range does.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ o, long long n, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long step = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long nv = n / V;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (long long i = t0; i < nv; i += step) {
      const uint4 ra = a4[i], rb = b4[i];
      uint4 ro;
      const T* ea = reinterpret_cast<const T*>(&ra);
      const T* eb = reinterpret_cast<const T*>(&rb);
      T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int e = 0; e < V; ++e) eo[e] = swiglu1(ea[e], eb[e]);
      o4[i] = ro;
    }
    tail = nv * V;
  }
  for (long long i = tail + t0; i < n; i += step) o[i] = swiglu1(a[i], b[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ g, T* __restrict__ da,
                      T* __restrict__ db, long long n) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const float av = ptt::to_f(a[i]), bv = ptt::to_f(b[i]);
    const float gv = ptt::to_f(g[i]);
    const float sig = 1.f / (1.f + expf(-av));
    const float silu = av * sig;
    da[i] = ptt::from_f<T>(gv * bv * (sig + silu * (1.f - sig)));
    db[i] = ptt::from_f<T>(gv * silu);
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

// K3's grid: a block per 256 vectors, at most 8 blocks (2048 threads) an
// SM, 64 KB of a and b in flight on each
int swiglu_grid(long long n, int vec, int V) {
  const long long items = vec ? (n / V > 0 ? n / V : n) : n;
  const long long blocks = (items + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 8 ? blocks : 132 * 8);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

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
  if (n <= 0) return (int)cudaSuccess;
  const int vec = aligned16(a) && aligned16(b) && aligned16(o);
  if (dtype == ptt::kFloat32)
    swiglu_kernel<float><<<swiglu_grid(n, vec, 4), kThreads, 0, st>>>(
        (const float*)a, (const float*)b, (float*)o, n, vec);
  else if (dtype == ptt::kBFloat16)
    swiglu_kernel<__nv_bfloat16>
        <<<swiglu_grid(n, vec, 8), kThreads, 0, st>>>(
            (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
            (__nv_bfloat16*)o, n, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ptt_swiglu_bwd(const void* a, const void* b, const void* g,
                              void* da, void* db, long long n, int dtype,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = grid_for(n);
  if (dtype == ptt::kFloat32)
    swiglu_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)a, (const float*)b, (const float*)g, (float*)da,
        (float*)db, n);
  else if (dtype == ptt::kBFloat16)
    swiglu_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
        (const __nv_bfloat16*)g, (__nv_bfloat16*)da, (__nv_bfloat16*)db, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
