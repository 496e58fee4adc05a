// Flash attention forward (kernel B1).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_fwd (its
// _fwd_kernel): attention of q [B, Sq, H, D] over k/v [B, Sk, KVH, D] with
// float32 scores, an online softmax with float32 running max / sum /
// accumulator, and the per-row logsumexp (float32, [B, H, Sq]).  Query head
// h reads KV head h / (H / KVH).  Causal rows see the columns
// col <= row + q_off, q_off = Sk - Sq by default (FlashAttention-2's
// bottom-right rule, the reference's) or read from device memory (the static
// KV ring's prefill at position pos).  As the Pallas kernel: masked scores
// count as -1e30 in the running max and contribute exactly 0; a row that sees
// no key writes zeros and lse = -1e30 + log(1e-30) (= -1e30 in float32).
//
// Bound on the H100: operations at prefill lengths (4 * Sq * Sk * D per
// head, halved by the causal mask), bytes for a single query row.  This first
// version does its arithmetic in float32 on the SIMT cores (67 TFLOP/s at
// most), not on the tensor cores.  Design: one block of 256 threads per
// (64-row query tile, head, batch).  The query tile (pre-scaled) and each
// 64-key K and V tile are staged in shared memory as float32, read from
// device memory in 16-byte vectors; Q and K rows are padded by one float so
// the score loop reads them without bank conflicts.  Each thread owns a
// 4 x 4 block of scores (rows ty + 16 i, columns tx + 16 j) and the
// accumulator of those 4 rows at dims tx + 16 j; each warp runs the online
// softmax of 8 rows.  Key tiles wholly past the causal bound of the query
// tile's last row are never loaded.  Shared memory is 113 KB at D = 128 and
// 210 KB at D = 256, past the 48 KB default: the entry opts the kernel in.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: tx = column group, ty = row group
constexpr float kNegInf = -1e30f;

template <typename T, int DC>  // DC: the largest D / 16 this instance takes
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    const int* __restrict__ q_off_ptr, int Sq, int Sk, int H, int KVH, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int q_off_host, float scale) {
  using V = ptt::Vec16<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = D + 1;                // padded row of Q and K
  const int SP = kBK + 1;              // padded row of the scores
  float* qs = (float*)smem_raw;        // kBQ * DP, scaled queries
  float* ks = qs + kBQ * DP;           // kBK * DP
  float* vs = ks + kBK * DP;           // kBK * D
  float* ss = vs + kBK * D;            // kBQ * SP scores, then probabilities
  float* m_s = ss + kBQ * SP;          // kBQ running max
  float* l_s = m_s + kBQ;              // kBQ running sum
  float* c_s = l_s + kBQ;              // kBQ rescale of this tile

  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * kBQ;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int nd = D / 16;               // accumulator columns in use
  const int nv = D / V::N;             // 16-byte vectors per row
  const int off = q_off_ptr != nullptr ? *q_off_ptr : q_off_host;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int i = tid; i < kBQ * nv; i += kThreads) {
    const int r = i / nv, c = (i - r * nv) * V::N;
    float x[V::N];
    if (r0 + r < Sq) {
      V::load(qb + (r0 + r) * qss + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V::N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V::N; ++e) qs[r * DP + c + e] = x[e] * scale;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // key tiles any row of this query tile can see
  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const long long last = (long long)r0 + kBQ - 1 + off;
    const long long lim = last < 0 ? 0 : last / kBK + 1;
    if (lim < n_tiles) n_tiles = (int)lim;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kBK;
    // the previous tile's P @ V is done with ks/vs/ss (before the first
    // tile: the query tile and m/l are written)
    __syncthreads();
    for (int i = tid; i < kBK * nv; i += kThreads) {
      const int r = i / nv, c = (i - r * nv) * V::N;
      float kx[V::N], vx[V::N];
      if (c0 + r < Sk) {
        V::load(kb + (c0 + r) * kss + c, kx);
        V::load(vb + (c0 + r) * vss + c, vx);
      } else {
#pragma unroll
        for (int e = 0; e < V::N; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        ks[r * DP + c + e] = kx[e];
        vs[r * D + c + e] = vx[e];
      }
    }
    __syncthreads();

    // scores of rows ty + 16 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool ok = row < Sq && col < Sk && (!causal || col <= row + off);
        ss[(ty + 16 * i) * SP + tx + 16 * j] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w + 7
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      float* row = ss + r * SP;
      const float x0 = row[lane], x1 = row[lane + 32];
      // a masked score counts as -1e30 in the max, as the Pallas kernel's
      const float mx = ptt::warp_max(fmaxf(fmaxf(x0, x1), kNegInf));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = x0 == -INFINITY ? 0.f : expf(x0 - m_new);
      const float p1 = x1 == -INFINITY ? 0.f : expf(x1 - m_new);
      const float sum = ptt::warp_sum(p0 + p1);
      row[lane] = p0;
      row[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        c_s[r] = c;
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * c + P @ V over this tile's keys
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= c;
    }
    for (int jj = 0; jj < kBK; ++jj) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * SP + jj];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        if (j < nd) {
          const float vv = vs[jj * D + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // m/l final (also when no tile was visible)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = r0 + r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* o = out + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (j < nd) o[tx + 16 * j] = ptt::from_f<T>(acc[i][j] * inv);
  }
  if (tid < kBQ && r0 + tid < Sq)
    lse[((long long)b * H + h) * Sq + r0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

size_t smem_bytes(int D) {
  return (size_t)(2 * kBQ * (D + 1) + kBK * D + kBQ * (kBK + 1) + 3 * kBQ) *
         sizeof(float);
}

template <typename T, int DC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* q_off, int B, int Sq, int Sk, int H,
                   int KVH, int D, long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh, long long vsb,
                   long long vss, long long vsh, int causal, int q_off_host,
                   float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(D);
  cudaError_t e = ptt::allow_smem(flash_fwd_kernel<T, DC>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, DC><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse,
      (const int*)q_off, Sq, Sk, H, KVH, D, qsb, qss, qsh, ksb, kss, ksh, vsb,
      vss, vsh, causal, q_off_host, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     void* lse, const void* q_off, int B, int Sq, int Sk,
                     int H, int KVH, int D, long long qsb, long long qss,
                     long long qsh, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, int causal, int q_off_host, float scale,
                     cudaStream_t st) {
  if (D % 16 || D > 256 || KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  if (D <= 64)
    return launch<T, 4>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KVH, D, qsb,
                        qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal,
                        q_off_host, scale, st);
  if (D <= 128)
    return launch<T, 8>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KVH, D, qsb,
                        qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal,
                        q_off_host, scale, st);
  return launch<T, 16>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KVH, D, qsb,
                       qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal,
                       q_off_host, scale, st);
}

}  // namespace

extern "C" int ptt_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* q_off, int B, int Sq, int Sk, int H, int KVH, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int q_off_host, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ptt::kFloat32)
    return (int)dispatch<float>(q, k, v, out, lse, q_off, B, Sq, Sk, H, KVH,
                                D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss,
                                vsh, causal, q_off_host, scale, st);
  if (dtype == ptt::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, lse, q_off, B, Sq, Sk,
                                        H, KVH, D, qsb, qss, qsh, ksb, kss,
                                        ksh, vsb, vss, vsh, causal,
                                        q_off_host, scale, st);
  return (int)cudaErrorInvalidValue;
}
