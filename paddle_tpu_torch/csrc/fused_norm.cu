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
// flop/byte ridge.  Design: one memory round trip.  A row is cut into packs
// (16 bytes: 8 bfloat16 or 4 float32, where H and every pointer allow it;
// one element otherwise) and `tpr` threads share it, pack p going to thread
// p % tpr; each thread loads its `P` packs of x (and r) at once, stores the
// residual sum right away, keeps the float32 row in registers, reduces the
// sum of squares by warp shuffles and one shared exchange, then scales from
// its registers.  Each element is read once and written once.  A row wider
// than tpr * P packs sums its remaining packs in the first pass and reads
// them again (from L2) in the second.  `rms_plan` in
// ops/hopper/fused_norm.py picks the pack width, P, tpr and the rows of a
// block from host sizes; the entry refuses anything else.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

// threads a block of an instance may have: 1024 where a thread holds at
// most 16 floats of its row (64 registers each: one block an SM is all
// the launch bounds ask of the register budget), else 256
__host__ __device__ constexpr int max_threads(int held) {
  return held <= 16 ? 1024 : 256;
}

// kVec: 16 bytes of T a pack, else one element
template <typename T, bool kVec>
struct Pack {
  static constexpr int N = kVec ? 16 / (int)sizeof(T) : 1;
  using Raw = typename std::conditional<kVec, uint4, T>::type;

  __device__ __forceinline__ static Raw load(const T* p) {
    return *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ static void store(T* p, Raw v) {
    *reinterpret_cast<Raw*>(p) = v;
  }
  __device__ __forceinline__ static void to_f(const Raw& raw, float* f) {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = ptt::to_f(e[i]);
  }
  __device__ __forceinline__ static Raw from_f(const float* f) {
    Raw raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = ptt::from_f<T>(f[i]);
    return raw;
  }
};

// the sum of v over the tpr threads of a row (each gets the same bits): a
// row of tpr < 32 is an aligned group of lanes; a wider one adds its warps'
// sums through shared memory, in warp order
__device__ __forceinline__ float row_sum(float v, int tpr, float* red) {
  if (tpr < 32) {
    for (int o = tpr / 2; o > 0; o >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  }
  v = ptt::warp_sum(v);
  if (tpr == 32) return v;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  const int wpr = tpr / 32, first = warp / wpr * wpr;
  float s = 0.f;
  for (int i = 0; i < wpr; ++i) s += red[first + i];
  return s;
}

template <typename T, bool kRes, bool kVec, int P>
__global__ void __launch_bounds__(P * Pack<T, kVec>::N <= 16 ? 1024 : 256, 1)
    rms_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const T* __restrict__ w, T* __restrict__ out,
               T* __restrict__ res_out, int n, int h, int tpr, int rows,
               float eps) {
  using PK = Pack<T, kVec>;
  constexpr int V = PK::N;
  __shared__ float red[32];
  const int nv = h / V;  // packs in a row
  const int rib = threadIdx.x / tpr, t = threadIdx.x - rib * tpr;
  const int row = blockIdx.x * rows + rib;
  // a thread past the last row loads nothing but joins the reduction
  const bool live = row < n;
  const size_t base = (size_t)(live ? row : 0) * h;
  const T* xr = x + base;
  const T* rr = kRes ? r + base : nullptr;
  typename PK::Raw rx[P], rv[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = t + j * tpr;
    if (live && p < nv) {
      rx[j] = PK::load(xr + (size_t)p * V);
      if (kRes) rv[j] = PK::load(rr + (size_t)p * V);
    }
  }
  float v[P][V];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = t + j * tpr;
#pragma unroll
    for (int e = 0; e < V; ++e) v[j][e] = 0.f;
    if (live && p < nv) {
      PK::to_f(rx[j], v[j]);
      if (kRes) {
        float f[V];
        PK::to_f(rv[j], f);
#pragma unroll
        for (int e = 0; e < V; ++e) v[j][e] += f[e];
        PK::store(res_out + base + (size_t)p * V, PK::from_f(v[j]));
      }
#pragma unroll
      for (int e = 0; e < V; ++e) ss += v[j][e] * v[j][e];
    }
  }
  // the packs past the registers: summed here, read again below
  const int held = P * tpr;
#pragma unroll 4
  for (int p = held + t; live && p < nv; p += tpr) {
    float s[V];
    PK::to_f(PK::load(xr + (size_t)p * V), s);
    if (kRes) {
      float f[V];
      PK::to_f(PK::load(rr + (size_t)p * V), f);
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += f[e];
      PK::store(res_out + base + (size_t)p * V, PK::from_f(s));
    }
#pragma unroll
    for (int e = 0; e < V; ++e) ss += s[e] * s[e];
  }
  const float inv = rsqrtf(row_sum(ss, tpr, red) / (float)h + eps);
  if (!live) return;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = t + j * tpr;
    if (p < nv) {
      float f[V];
      PK::to_f(PK::load(w + (size_t)p * V), f);
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = v[j][e] * inv * f[e];
      PK::store(out + base + (size_t)p * V, PK::from_f(f));
    }
  }
#pragma unroll 4
  for (int p = held + t; p < nv; p += tpr) {
    float s[V], f[V];
    PK::to_f(PK::load(xr + (size_t)p * V), s);
    if (kRes) {
      PK::to_f(PK::load(rr + (size_t)p * V), f);
#pragma unroll
      for (int e = 0; e < V; ++e) s[e] += f[e];
    }
    PK::to_f(PK::load(w + (size_t)p * V), f);
#pragma unroll
    for (int e = 0; e < V; ++e) f[e] = s[e] * inv * f[e];
    PK::store(out + base + (size_t)p * V, PK::from_f(f));
  }
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

struct Args {
  const void *x, *r, *w;
  void *out, *res_out;
  int n, h, tpr, rows;
  float eps;
  cudaStream_t s;
};

template <typename T, bool kRes, bool kVec, int P>
cudaError_t go(const Args& a) {
  if (a.tpr * a.rows > max_threads(P * Pack<T, kVec>::N))
    return cudaErrorInvalidValue;
  const int blocks = (a.n + a.rows - 1) / a.rows;
  rms_kernel<T, kRes, kVec, P><<<blocks, a.tpr * a.rows, 0, a.s>>>(
      (const T*)a.x, (const T*)a.r, (const T*)a.w, (T*)a.out,
      (T*)a.res_out, a.n, a.h, a.tpr, a.rows, a.eps);
  return cudaGetLastError();
}

// the instances: packs a thread holds, 1, 2, 4 or 8
template <typename T, bool kRes, bool kVec>
cudaError_t by_per(const Args& a, int per) {
  switch (per) {
    case 1: return go<T, kRes, kVec, 1>(a);
    case 2: return go<T, kRes, kVec, 2>(a);
    case 4: return go<T, kRes, kVec, 4>(a);
    case 8: return go<T, kRes, kVec, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(const Args& a, int vec, int per) {
  // a row's threads: an aligned lane group (1-16) or whole warps; a
  // block: whole warps
  const bool group = a.tpr >= 1 && a.tpr < 32 && (a.tpr & (a.tpr - 1)) == 0;
  const bool warps = a.tpr >= 32 && a.tpr % 32 == 0 && a.tpr <= 1024;
  if (!(group || warps) || a.rows < 1 || (a.tpr * a.rows) % 32 != 0 ||
      a.h < 1)
    return cudaErrorInvalidValue;
  if (vec) {
    const bool ok = a.h % (16 / (int)sizeof(T)) == 0 && aligned16(a.x) &&
                    aligned16(a.w) && aligned16(a.out) &&
                    (a.r == nullptr ||
                     (aligned16(a.r) && aligned16(a.res_out)));
    if (!ok) return cudaErrorInvalidValue;
    return a.r ? by_per<T, true, true>(a, per)
               : by_per<T, false, true>(a, per);
  }
  return a.r ? by_per<T, true, false>(a, per)
             : by_per<T, false, false>(a, per);
}

}  // namespace

extern "C" int ptt_rms_norm(const void* x, const void* r, const void* w,
                            void* out, void* res_out, int n, int h, float eps,
                            int vec, int per, int tpr, int rows, int dtype,
                            void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Args a{x, r, w, out, res_out, n, h, tpr, rows, eps,
               (cudaStream_t)stream};
  if (dtype == ptt::kFloat32) return (int)launch<float>(a, vec, per);
  if (dtype == ptt::kBFloat16)
    return (int)launch<__nv_bfloat16>(a, vec, per);
  return (int)cudaErrorInvalidValue;
}

// the name of a cudaError_t an entry returned (one entry for the library)
extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
