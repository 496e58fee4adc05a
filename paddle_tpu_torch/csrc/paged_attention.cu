// Paged-KV attention core of blha_attention (kernel K4).
//
// Not a TPU kernel: paddle_tpu/ops/paged_attention.py:blha_attention leaves
// its attention (steps 6-8, :237-316) to XLA, gathering every sequence's
// whole context into [B, KV, L, D] first.  This kernel reads the keys and
// values in place through the block tables instead.  Its algorithm is that
// of paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel and
// decode_attention.py:_decode_kernel: online softmax with float32 state.
//
// Semantics (those of blha_attention steps 6-8 with cache_quant="none"):
// packed token i belongs to row b = searchsorted(cu, i, right) - 1, sits at
// absolute position dec[b] + (i - cu[b]) and attends keys 0 .. that position
// of its own row (at most P * block_size keys); softmax in float32 with
// scale 1/sqrt(D); query head h reads KV head h / (H / KV).  A key whose
// block-table entry is out of the pool reads as zeros, as the reference's
// gather fills it.  Tokens past cu[B], past their row's now, or at local
// index >= max_q_len give zeros.
//
// Bound on the H100: bytes, from reading the context (each key and value of
// a row is needed once per query token; a decode step is pure streaming).
// Design: one block per (token, KV head) covering the head group, so a key
// row fetched for the group serves all its query heads.  The context is
// walked in tiles of kTile keys, one key per thread for the scores: each
// thread streams its key row in 16-byte loads, all independent, so a tile
// keeps kTile * D * sizeof(T) bytes in flight.  The tile's probabilities
// stay in shared memory; for P @ V, threads split into key groups of
// D / VEC threads, each thread owning VEC consecutive dims of a value row
// (16-byte loads again), and the groups' partial sums are added in shared
// memory.  Nothing is staged through device memory.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;  // keys per tile: one per thread

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

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, T* __restrict__ out,
    const int* __restrict__ dec, const int* __restrict__ now,
    const int* __restrict__ cu, const int* __restrict__ bt, int B, int P,
    int NB, int H, int KV, int D, int bs, int max_q_len, float scale) {
  using V = Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = H / KV;
  const int DC = D / V::N;        // threads per value row in P @ V
  const int KG = kThreads / DC;   // key groups in P @ V
  long long* koff = (long long*)smem_raw;  // kTile element offsets, -1 = zeros
  float* qs = (float*)(koff + kTile);      // G * D
  float* sc = qs + G * D;                  // G * kTile scores / probabilities
  float* part = sc + G * kTile;            // KG * D partial P @ V of one head
  float* acc = part + KG * D;              // G * D
  float* m = acc + G * D;                  // G running max
  float* l = m + G;                        // G running sum
  float* corr = l + G;                     // G rescale of this tile

  const int tok = blockIdx.x, kh = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t qo = ((size_t)tok * H + (size_t)kh * G) * D;

  const int total = cu[B];
  int b = 0;
  for (int i = 1; i < B; ++i)
    if (cu[i] <= tok) b = i;
  const int local = tok - cu[b];
  if (tok >= total || local >= now[b] || local >= max_q_len) {
    for (int i = tid; i < G * D; i += kThreads)
      out[qo + i] = ptt::from_f<T>(0.f);
    return;
  }
  const int n = min(dec[b] + local + 1, P * bs);  // visible keys 0 .. n-1

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = ptt::to_f(q[qo + i]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m[tid] = -INFINITY;
    l[tid] = 0.f;
  }
  const int kg = tid / DC, dc = tid - kg * DC;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int cnt = min(kTile, n - t0);
    long long off = -1;
    if (tid < cnt) {
      const int j = t0 + tid;
      const int blk = bt[(size_t)b * P + j / bs];
      if (blk >= 0 && blk < NB)
        off = (((long long)blk * KV + kh) * bs + j % bs) * D;
    }
    koff[tid] = off;
    __syncthreads();  // also orders the q/acc/m/l setup before first use

    // scores: thread tid scores key t0 + tid for every head of the group
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
      if (off >= 0) {
        const float* qg = qs + g * D;
        for (int c = 0; c < D; c += V::N) {
          float kv[V::N];
          V::load(kc + off + c, kv);
#pragma unroll
          for (int e = 0; e < V::N; ++e) s += qg[c + e] * kv[e];
        }
      }
      sc[g * kTile + tid] = tid < cnt ? s * scale : -INFINITY;
    }
    __syncthreads();

    // online softmax: warp w updates heads w, w + kWarps, ...
    for (int g = warp; g < G; g += kWarps) {
      float* row = sc + g * kTile;
      float mx = -INFINITY;
      for (int jj = lane; jj < kTile; jj += 32) mx = fmaxf(mx, row[jj]);
      mx = ptt::warp_max(mx);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, mx);  // finite: cnt >= 1
      float sum = 0.f;
      for (int jj = lane; jj < kTile; jj += 32) {
        const float p = expf(row[jj] - m_new);  // masked keys: exp(-inf) = 0
        row[jj] = p;
        sum += p;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m_new);  // first tile: exp(-inf) = 0
        corr[g] = c;
        l[g] = l[g] * c + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // P @ V, one head at a time: key group kg sums keys kg, kg + KG, ...
    // over dims [dc * N, dc * N + N); the groups then add up in `part`
    for (int g = 0; g < G; ++g) {
      if (kg < KG) {
        float a[V::N];
#pragma unroll
        for (int e = 0; e < V::N; ++e) a[e] = 0.f;
        const float* p = sc + g * kTile;
        for (int jj = kg; jj < cnt; jj += KG) {
          const long long o = koff[jj];
          if (o < 0) continue;
          float vv[V::N];
          V::load(vc + o + dc * V::N, vv);
          const float pj = p[jj];
#pragma unroll
          for (int e = 0; e < V::N; ++e) a[e] += pj * vv[e];
        }
#pragma unroll
        for (int e = 0; e < V::N; ++e) part[kg * D + dc * V::N + e] = a[e];
      }
      __syncthreads();
      for (int d = tid; d < D; d += kThreads) {
        float s = 0.f;
        for (int k = 0; k < KG; ++k) s += part[k * D + d];
        acc[g * D + d] = acc[g * D + d] * corr[g] + s;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < G * D; i += kThreads)
    out[qo + i] = ptt::from_f<T>(acc[i] / l[i / D]);
}

// dynamic shared memory of one block
template <typename T>
size_t smem_bytes(int H, int KV, int D) {
  const int G = H / KV;
  const int KG = kThreads / (D / Vec16<T>::N);
  return kTile * sizeof(long long) +
         (size_t)(2 * G * D + G * kTile + KG * D + 3 * G) * sizeof(float);
}

template <typename T>
cudaError_t launch(const void* q, const void* kc, const void* vc, void* out,
                   const void* dec, const void* now, const void* cu,
                   const void* bt, int T_, int B, int P, int NB, int H, int KV,
                   int D, int bs, int max_q_len, float scale,
                   cudaStream_t st) {
  // a head group too large for the 48 KB default of one block is refused
  const size_t smem = smem_bytes<T>(H, KV, D);
  if (smem > ptt::kMaxDynamicSmem) return cudaErrorInvalidConfiguration;
  paged_attention_kernel<T><<<dim3(T_, KV), kThreads, smem, st>>>(
      (const T*)q, (const T*)kc, (const T*)vc, (T*)out, (const int*)dec,
      (const int*)now, (const int*)cu, (const int*)bt, B, P, NB, H, KV, D, bs,
      max_q_len, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_paged_attention(const void* q, const void* kc,
                                   const void* vc, void* out, const void* dec,
                                   const void* now, const void* cu,
                                   const void* bt, int T, int B, int P, int NB,
                                   int H, int KV, int D, int bs,
                                   int max_q_len, float scale, int dtype,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ptt::kFloat32)
    return (int)launch<float>(q, kc, vc, out, dec, now, cu, bt, T, B, P, NB,
                              H, KV, D, bs, max_q_len, scale, st);
  if (dtype == ptt::kBFloat16)
    return (int)launch<__nv_bfloat16>(q, kc, vc, out, dec, now, cu, bt, T, B,
                                      P, NB, H, KV, D, bs, max_q_len, scale,
                                      st);
  return (int)cudaErrorInvalidValue;
}
