// Decode attention over the static KV ring (kernel B2) and the in-place ring
// write (kernel B3).
//
// B2 replaces paddle_tpu/ops/pallas/decode_attention.py:decode_attention
// (its _decode_kernel): one query token per row, q [B, 1, H, D], against
// the ring kbuf/vbuf [B, L, KVH, D] in its native layout, columns
// 0 .. pos (pos read from device memory, clamped to [0, L - 1]), softmax in
// float32 with scale 1/sqrt(D) by default; query head h reads KV head
// h / (H / KVH).
//
// Bound on the H100: bytes.  Each visible key and value row is needed once
// per (row, KV head), and a decode step does ~2 operations per byte read.
// Design (flash-decoding): the ring is cut into chunks of `chunk` keys and
// one block of 128 threads takes one (chunk, KV head, row), and with it all
// query heads of the KV head's group (up to R of them, R in {1, 2, 4, 8}),
// so every key and value row loaded serves the whole group.  That gives
// B * KVH * ceil(L / chunk) blocks, enough to fill the card at small
// batches, where one block per (row, KV head) would not.  Chunks past pos
// exit at once, so the bytes read follow pos, not L.  Scores: each thread
// takes one key of a 128-key step and streams its row in 16-byte loads, all
// independent, for every head of the group; the chunk's max and sum per
// head are one warp reduction per head (no per-key shuffle chain).  P @ V:
// threads form key groups of D / VEC threads, each thread owning VEC dims of
// a value row (16-byte loads again), and the groups' sums are added in
// shared memory.  With more than one chunk each block writes its (max, sum,
// unnormalised output) in float32, and a second small kernel combines the
// chunks of each (row, head).
//
// B3 replaces decode_attention.py:kv_ring_write: new [B, S, KVH, D] is
// written into the ring at rows start .. start + S - 1, in place, with
// start = clamp(pos, 0, L - S) read from device memory (the clamp is that
// of dynamic_update_slice, which the reference's S > 1 path uses).  One
// launch writes the K and the V ring.  Bound by bytes; one block per (row,
// token) copies its [KVH, D] rows of K and V in 16-byte vectors.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

template <typename T, int R>  // R: query heads per block
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ kbuf,
    const T* __restrict__ vbuf, T* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    const int* __restrict__ pos_ptr, int L, int H, int KVH, int D, int chunk,
    int n_split, int n_hc, float scale) {
  using V = ptt::Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int TPR = D / V::N;            // threads per value row in P @ V
  const int KG = kThreads / TPR;       // key groups in P @ V
  float* qs = (float*)smem_raw;        // R * D, scaled queries
  float* ps = qs + R * D;              // R * chunk scores, then probabilities
  float* part = ps + R * chunk;        // KG * R * D partial P @ V
  float* m_b = part + KG * R * D;      // R chunk max
  float* l_b = m_b + R;                // R chunk sum

  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / n_hc, hc = blockIdx.y - kh * n_hc;
  const int rep = H / KVH;
  const int h0 = kh * rep + hc * R;    // first query head of this block
  const int nh = min(R, rep - hc * R);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pos = max(0, min(*pos_ptr, L - 1));
  const int start = split * chunk;
  const int cnt = min(chunk, pos + 1 - start);  // visible keys of the chunk
  const long long row_stride = (long long)KVH * D;
  const long long bh0 = (long long)b * H + h0;

  if (cnt <= 0) {  // the whole chunk lies past pos
    if (tid < nh) {
      part_ml[((bh0 + tid) * n_split + split) * 2] = kNegInf;
      part_ml[((bh0 + tid) * n_split + split) * 2 + 1] = 0.f;
    }
    return;
  }

  for (int i = tid; i < nh * D; i += kThreads)
    qs[i] = ptt::to_f(q[bh0 * D + i]) * scale;
  __syncthreads();

  const T* kc = kbuf + ((long long)b * L + start) * row_stride +
                (long long)kh * D;
  const T* vc = vbuf + ((long long)b * L + start) * row_stride +
                (long long)kh * D;

  // scores: thread tid takes key j0 + tid of each 128-key step
  for (int j0 = 0; j0 < chunk; j0 += kThreads) {
    const int j = j0 + tid;
    float s[R];
#pragma unroll
    for (int h = 0; h < R; ++h) s[h] = 0.f;
    if (j < cnt) {
      const T* kr = kc + j * row_stride;
      for (int c = 0; c < D; c += V::N) {
        float kv[V::N];
        V::load(kr + c, kv);
#pragma unroll
        for (int h = 0; h < R; ++h) {
          if (h < nh) {
#pragma unroll
            for (int e = 0; e < V::N; ++e)
              s[h] = fmaf(qs[h * D + c + e], kv[e], s[h]);
          }
        }
      }
    }
    if (j < chunk) {
#pragma unroll
      for (int h = 0; h < R; ++h)
        if (h < nh) ps[h * chunk + j] = j < cnt ? s[h] : -INFINITY;
    }
  }
  __syncthreads();

  // the chunk's softmax statistics: warp w takes heads w, w + 4, ...
  for (int h = warp; h < nh; h += kWarps) {
    float* row = ps + h * chunk;
    float mx = -INFINITY;
    for (int j = lane; j < chunk; j += 32) mx = fmaxf(mx, row[j]);
    mx = ptt::warp_max(mx);  // finite: key `start` is visible
    float sum = 0.f;
    for (int j = lane; j < chunk; j += 32) {
      const float p = expf(row[j] - mx);  // masked: exp(-inf) = 0
      row[j] = p;
      sum += p;
    }
    sum = ptt::warp_sum(sum);
    if (lane == 0) {
      m_b[h] = mx;
      l_b[h] = sum;
    }
  }
  __syncthreads();

  // P @ V: key group kg sums keys kg, kg + KG, ... over dims
  // [dc * VEC, dc * VEC + VEC) for every head of the group
  const int kg = tid / TPR, dc = tid - kg * TPR;
  if (kg < KG) {
    float a[R][V::N];
#pragma unroll
    for (int h = 0; h < R; ++h)
#pragma unroll
      for (int e = 0; e < V::N; ++e) a[h][e] = 0.f;
    for (int j = kg; j < cnt; j += KG) {
      float vv[V::N];
      V::load(vc + j * row_stride + dc * V::N, vv);
#pragma unroll
      for (int h = 0; h < R; ++h) {
        if (h < nh) {
          const float p = ps[h * chunk + j];
#pragma unroll
          for (int e = 0; e < V::N; ++e) a[h][e] = fmaf(p, vv[e], a[h][e]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < R; ++h)
      if (h < nh) {
#pragma unroll
        for (int e = 0; e < V::N; ++e)
          part[(kg * R + h) * D + dc * V::N + e] = a[h][e];
      }
  }
  __syncthreads();

  for (int i = tid; i < nh * D; i += kThreads) {
    const int h = i / D, d = i - h * D;
    float s = 0.f;
    for (int g = 0; g < KG; ++g) s += part[(g * R + h) * D + d];
    if (n_split == 1)
      out[(bh0 + h) * D + d] = ptt::from_f<T>(s / l_b[h]);
    else
      part_acc[((bh0 + h) * n_split + split) * D + d] = s;
  }
  if (n_split > 1 && tid < nh) {
    part_ml[((bh0 + tid) * n_split + split) * 2] = m_b[tid];
    part_ml[((bh0 + tid) * n_split + split) * 2 + 1] = l_b[tid];
  }
}

// out[bh, d] = sum_s e^(m_s - M) acc_s[d] / sum_s e^(m_s - M) l_s over the
// chunks s that saw a key (l_s > 0); one block per (row, head), D threads
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int n_split,
                                      int D) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * n_split * 2;
  float M = kNegInf;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s + 1] > 0.f) M = fmaxf(M, ml[2 * s]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    if (ml[2 * s + 1] > 0.f) {
      const float w = expf(ml[2 * s] - M);
      den += w * ml[2 * s + 1];
      num += w * part_acc[(bh * n_split + s) * D + d];
    }
  }
  out[bh * D + d] = ptt::from_f<T>(num / den);
}

template <typename T, int R>
size_t split_smem(int D, int chunk) {
  const int KG = kThreads / (D / ptt::Vec16<T>::N);
  return (size_t)(R * D + R * chunk + KG * R * D + 2 * R) * sizeof(float);
}

template <typename T, int R>
cudaError_t launch_split(const void* q, const void* kbuf, const void* vbuf,
                         void* out, void* part_acc, void* part_ml,
                         const void* pos, int B, int L, int H, int KVH, int D,
                         int chunk, int n_split, float scale,
                         cudaStream_t st) {
  const int rep = H / KVH;
  const int n_hc = (rep + R - 1) / R;
  const size_t smem = split_smem<T, R>(D, chunk);
  cudaError_t e = ptt::allow_smem(decode_split_kernel<T, R>, smem);
  if (e != cudaSuccess) return e;
  decode_split_kernel<T, R><<<dim3(n_split, KVH * n_hc, B), kThreads, smem,
                              st>>>(
      (const T*)q, (const T*)kbuf, (const T*)vbuf, (T*)out, (float*)part_acc,
      (float*)part_ml, (const int*)pos, L, H, KVH, D, chunk, n_split, n_hc,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t decode(const void* q, const void* kbuf, const void* vbuf,
                   void* out, void* part_acc, void* part_ml, const void* pos,
                   int B, int L, int H, int KVH, int D, int chunk, float scale,
                   cudaStream_t st) {
  if (D % 16 || D > 256 || KVH <= 0 || H % KVH || chunk <= 0 || L <= 0)
    return cudaErrorInvalidValue;
  const int n_split = (L + chunk - 1) / chunk;
  if (n_split > 1 && (part_acc == nullptr || part_ml == nullptr))
    return cudaErrorInvalidValue;
  const int rep = H / KVH;
  cudaError_t e;
  if (rep == 1)
    e = launch_split<T, 1>(q, kbuf, vbuf, out, part_acc, part_ml, pos, B, L,
                           H, KVH, D, chunk, n_split, scale, st);
  else if (rep == 2)
    e = launch_split<T, 2>(q, kbuf, vbuf, out, part_acc, part_ml, pos, B, L,
                           H, KVH, D, chunk, n_split, scale, st);
  else if (rep <= 4)
    e = launch_split<T, 4>(q, kbuf, vbuf, out, part_acc, part_ml, pos, B, L,
                           H, KVH, D, chunk, n_split, scale, st);
  else
    e = launch_split<T, 8>(q, kbuf, vbuf, out, part_acc, part_ml, pos, B, L,
                           H, KVH, D, chunk, n_split, scale, st);
  if (e != cudaSuccess || n_split == 1) return e;
  decode_combine_kernel<T><<<B * H, D, 0, st>>>(
      (const float*)part_acc, (const float*)part_ml, (T*)out, n_split, D);
  return cudaGetLastError();
}

__global__ void ring_write_kernel(uint4* __restrict__ kbuf,
                                  uint4* __restrict__ vbuf,
                                  const uint4* __restrict__ knew,
                                  const uint4* __restrict__ vnew,
                                  const int* __restrict__ pos_ptr, int L,
                                  int S, int row_vecs) {
  const int bs = blockIdx.x;  // b * S + s
  const int b = bs / S, s = bs - b * S;
  const int start = max(0, min(*pos_ptr, L - S));
  const long long dst = ((long long)b * L + start + s) * row_vecs;
  const long long src = (long long)bs * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    kbuf[dst + i] = knew[src + i];
    vbuf[dst + i] = vnew[src + i];
  }
}

}  // namespace

extern "C" int ptt_decode_attention(const void* q, const void* kbuf,
                                    const void* vbuf, void* out,
                                    void* part_acc, void* part_ml,
                                    const void* pos, int B, int L, int H,
                                    int KVH, int D, int chunk, float scale,
                                    int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ptt::kFloat32)
    return (int)decode<float>(q, kbuf, vbuf, out, part_acc, part_ml, pos, B,
                              L, H, KVH, D, chunk, scale, st);
  if (dtype == ptt::kBFloat16)
    return (int)decode<__nv_bfloat16>(q, kbuf, vbuf, out, part_acc, part_ml,
                                      pos, B, L, H, KVH, D, chunk, scale, st);
  return (int)cudaErrorInvalidValue;
}

// row_bytes: one token's [KVH, D] row, a multiple of 16
extern "C" int ptt_kv_ring_write(void* kbuf, void* vbuf, const void* knew,
                                 const void* vnew, const void* pos, int B,
                                 int L, int S, int row_bytes, void* stream) {
  if (row_bytes % 16 || S <= 0 || S > L) return (int)cudaErrorInvalidValue;
  ring_write_kernel<<<B * S, kThreads, 0, (cudaStream_t)stream>>>(
      (uint4*)kbuf, (uint4*)vbuf, (const uint4*)knew, (const uint4*)vnew,
      (const int*)pos, L, S, row_bytes / 16);
  return (int)cudaGetLastError();
}
