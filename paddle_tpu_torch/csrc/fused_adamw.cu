// Fused AdamW update (kernel B9).
//
// Replaces paddle_tpu/ops/pallas/fused_adamw.py:fused_adamw (its _kernel):
// one pass over a flattened parameter that reads the gradient g (float32 or
// bfloat16) and the float32 master weight w and moments m, v, and writes w,
// m, v in place and the parameter p in its own dtype:
//
//   w = w * (1 - lr * wd)
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   w = w - lr * (m / c1) / (sqrt(v / c2) + eps),  c1 = 1 - b1^t, c2 = 1 - b2^t
//   p = w (rounded to p's dtype)
//
// t, the parameter's step count (its beta_pow accumulator, already advanced
// for this step), is read from device memory, so a step needs no host sync;
// c1 and c2 are computed from it by every thread (two powf).  p may be null:
// a float32 parameter is its own master weight (w is p), as in the
// reference's optimizer, and nothing else is written.
//
// Two optional one-element float32 pointers carry a TrainStep's controls,
// both read from device memory (no host sync):
//   gmul: a gradient clip's scale; g is read as
//         float(round_to_G(float(g) * gmul)), the reference's
//         (g * scale).astype(g.dtype) then widened to float32
//         (paddle_tpu/nn/clip.py, jit/api.py:536-540);
//   skip: nonzero where the step's scaler found a non-finite gradient; the
//         kernel then writes nothing, so p, w, m and v keep their bits (the
//         reference's jnp.where(found_inf, old, new), jit/api.py:556-562).
//         Every thread reads it and returns before its loop.
//
// Bound on the H100: bytes, 28 per element with a bfloat16 gradient and
// parameter (g 2, w/m/v 4 + 4 each, p 2) against ~20 flops.  Design: one
// grid-stride pass, each thread on consecutive elements of all five arrays
// so every warp's loads and stores are coalesced.  The reference's tiling
// rule (n a multiple of 512 * 256, a TPU block shape) does not carry over:
// any n runs.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(P* __restrict__ p, float* __restrict__ w,
                 float* __restrict__ m, float* __restrict__ v,
                 const G* __restrict__ g, const float* __restrict__ t_ptr,
                 const float* __restrict__ gmul_ptr,
                 const float* __restrict__ skip_ptr, long long n, float lr,
                 float b1, float b2, float omb1, float omb2, float eps,
                 float wd) {
  if (skip_ptr != nullptr && *skip_ptr != 0.f) return;
  const bool scaled = gmul_ptr != nullptr;
  const float gmul = scaled ? *gmul_ptr : 1.f;
  const float t = *t_ptr;
  const float c1 = 1.f - powf(b1, t), c2 = 1.f - powf(b2, t);
  const float decay = 1.f - lr * wd;
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    float gf = ptt::to_f(g[i]);
    if (scaled) gf = ptt::to_f(ptt::from_f<G>(gf * gmul));
    float wv = w[i] * decay;
    const float mv = b1 * m[i] + omb1 * gf;
    const float vv = b2 * v[i] + omb2 * gf * gf;
    wv = wv - lr * ((mv / c1) / (sqrtf(vv / c2) + eps));
    w[i] = wv;
    m[i] = mv;
    v[i] = vv;
    if (p != nullptr) p[i] = ptt::from_f<P>(wv);
  }
}

template <typename P, typename G>
cudaError_t launch(void* p, void* w, void* m, void* v, const void* g,
                   const void* t, const void* gmul, const void* skip,
                   long long n, float lr, float b1, float b2, float omb1,
                   float omb2, float eps, float wd, cudaStream_t st) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = (int)(blocks < 132 * 8 ? blocks : 132 * 8);
  adamw_kernel<P, G><<<grid, kThreads, 0, st>>>(
      (P*)p, (float*)w, (float*)m, (float*)v, (const G*)g, (const float*)t,
      (const float*)gmul, (const float*)skip, n, lr, b1, b2, omb1, omb2, eps,
      wd);
  return cudaGetLastError();
}

template <typename P>
cudaError_t by_grad(void* p, void* w, void* m, void* v, const void* g,
                    int g_dtype, const void* t, const void* gmul,
                    const void* skip, long long n, float lr, float b1,
                    float b2, float omb1, float omb2, float eps, float wd,
                    cudaStream_t st) {
  if (g_dtype == ptt::kFloat32)
    return launch<P, float>(p, w, m, v, g, t, gmul, skip, n, lr, b1, b2,
                            omb1, omb2, eps, wd, st);
  if (g_dtype == ptt::kBFloat16)
    return launch<P, __nv_bfloat16>(p, w, m, v, g, t, gmul, skip, n, lr, b1,
                                    b2, omb1, omb2, eps, wd, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// p|NULL (p_dtype), w, m, v float32, g (g_dtype), t float32 [1], gmul|NULL
// and skip|NULL float32 [1]; omb1 and omb2 are 1 - b1 and 1 - b2 as the
// caller rounds them
extern "C" int ptt_fused_adamw(void* p, void* w, void* m, void* v,
                               const void* g, const void* t,
                               const void* gmul, const void* skip,
                               long long n, float lr, float b1, float b2,
                               float omb1, float omb2, float eps, float wd,
                               int p_dtype, int g_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  if (p == nullptr || p_dtype == ptt::kFloat32)
    return (int)by_grad<float>(p, w, m, v, g, g_dtype, t, gmul, skip, n, lr,
                               b1, b2, omb1, omb2, eps, wd, st);
  if (p_dtype == ptt::kBFloat16)
    return (int)by_grad<__nv_bfloat16>(p, w, m, v, g, g_dtype, t, gmul, skip,
                                       n, lr, b1, b2, omb1, omb2, eps, wd,
                                       st);
  return (int)cudaErrorInvalidValue;
}
