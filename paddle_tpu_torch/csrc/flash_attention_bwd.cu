// Flash attention backward (kernel B8): dQ and dK/dV.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_bwd, its two
// pallas_calls _dq_kernel and _dkv_kernel: the FlashAttention-2 backward
// from the forward's saved per-row logsumexp (B1's lse, [B, H, Sq]), with no
// Sq x Sk matrix in device memory.  For q [B, Sq, H, D], k/v [B, Sk, KVH, D]
// (query head h reads KV head h / (H / KVH)), the output o and its gradient
// dO ([B, Sq, H, D], contiguous):
//
//   delta = rowsum(dO * O)                      (dQ kernel)
//   P     = exp(scale * Q K^T - lse)            (recomputed tile by tile)
//   dS    = P * (dO V^T - delta)
//   dQ    = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
//
// Causal masking is bottom-right (col <= row + Sk - Sq), as the forward and
// the reference; masked and padding entries give P = 0 exactly, so a row
// that sees no key (Sq > Sk) gets zero gradients whatever its lse.  The tile
// loops skip the tiles the mask removes, with the reference's bounds
// (_dq_kernel: key tiles up to the query tile's last visible column;
// _dkv_kernel: query tiles from the first row that sees the key tile).
//
// Two kernels, launched in this order on one stream:
// - dQ: one block per (query tile, head, batch).  It stages its Q and dO
//   rows, computes delta for them (writing it for the second kernel), then
//   streams the visible K/V tiles: S and dP in one pass over D, dS into shared memory, dQ += dS K in registers.
// - dK/dV: one block per (key tile, KV head, batch).  K and V stay in shared
//   memory while the block streams the Q and dO tiles of EVERY query head of
//   its GQA group, so dK and dV are summed over the group in float32
//   registers and cast once: K and V are never repeated, and no per-head
//   buffer is reduced afterwards.
//
// Bound on the H100: operations, 10 D per visible (row, key) pair (S, dP,
// dQ, dK, dV).  This first version, like B1's, does its arithmetic in
// float32 on the SIMT cores (67 TFLOP/s at most), not on the tensor cores,
// and computes S and dP in both kernels (14 D per pair).  Layout as B1: 256
// threads, 16 x 16; tiles of BT rows staged as float32 with rows padded by
// one float (no bank conflicts); each thread owns R x R entries of a score
// tile (R = BT / 16) and R rows x D / 16 dims of its accumulators.  Shared
// memory: dQ 149 KB and dK/dV 166 KB at D = 128 (BT 64); at D = 256 the
// tiles shrink to 32 rows (136 / 140 KB), so D = 256 fits the opt-in limit.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx = column group, ty = row group

template <typename T>
__device__ __forceinline__ void load_row(const T* src, bool ok, float* x) {
  using V = ptt::Vec16<T>;
  if (ok) {
    V::load(src, x);
  } else {
#pragma unroll
    for (int e = 0; e < V::N; ++e) x[e] = 0.f;
  }
}

// rows [r0, r0 + BT) of a [S, D] matrix with row stride rs into smem (DP
// floats a row); rows past S are zeros
template <typename T, int BT>
__device__ __forceinline__ void stage(const T* base, long long rs, int r0,
                                      int S, int D, float* dst) {
  using V = ptt::Vec16<T>;
  const int DP = D + 1, nv = D / V::N;
  for (int i = threadIdx.x; i < BT * nv; i += kThreads) {
    const int r = i / nv, c = (i - r * nv) * V::N;
    float x[V::N];
    load_row(base + (r0 + r) * rs + c, r0 + r < S, x);
#pragma unroll
    for (int e = 0; e < V::N; ++e) dst[r * DP + c + e] = x[e];
  }
}

template <typename T, int BT, int DC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int Sq,
    int Sk, int H, int KVH, int D, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int causal, float scale) {
  constexpr int R = BT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = D + 1, SP = BT + 1;
  float* qs = (float*)smem_raw;  // BT * DP
  float* gs = qs + BT * DP;      // BT * DP, dO
  float* ks = gs + BT * DP;      // BT * DP
  float* vs = ks + BT * DP;      // BT * DP
  float* ss = vs + BT * DP;      // BT * SP, dS
  float* lse_s = ss + BT * SP;   // BT
  float* dl_s = lse_s + BT;      // BT

  const int h = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * BT;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int nd = D / 16;
  const int off = Sk - Sq;
  const long long rs = (long long)H * D;  // row stride of o, dO, dQ
  const long long bh = (long long)b * H + h;

  const T* ob = o + (long long)b * Sq * rs + (long long)h * D;
  const T* gb = dout + (long long)b * Sq * rs + (long long)h * D;
  stage<T, BT>(q + b * qsb + h * qsh, qss, r0, Sq, D, qs);
  stage<T, BT>(gb, rs, r0, Sq, D, gs);
  if (tid < BT) {
    const int row = r0 + tid;
    lse_s[tid] = row < Sq ? lse[bh * Sq + row] : 0.f;
  }
  __syncthreads();
  // delta = rowsum(dO * O): warp w takes rows w, w + 8, ...
  for (int r = warp; r < BT; r += kThreads / 32) {
    const int row = r0 + r;
    float acc = 0.f;
    if (row < Sq)
      for (int d = lane; d < D; d += 32)
        acc += gs[r * DP + d] * ptt::to_f(ob[row * rs + d]);
    acc = ptt::warp_sum(acc);
    if (lane == 0) {
      dl_s[r] = acc;
      if (row < Sq) delta[bh * Sq + row] = acc;
    }
  }

  // key tiles any row of this query tile can see
  int n_tiles = (Sk + BT - 1) / BT;
  if (causal) {
    const long long last = (long long)r0 + BT - 1 + off;
    const long long lim = last < 0 ? 0 : last / BT + 1;
    if (lim < n_tiles) n_tiles = (int)lim;
  }
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  float acc[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BT;
    // the previous tile's dS K is done with ks/ss (before the first tile:
    // Q, dO, lse and delta are written)
    __syncthreads();
    stage<T, BT>(kb, kss, c0, Sk, D, ks);
    stage<T, BT>(vb, vss, c0, Sk, D, vs);
    __syncthreads();

    // S and dP of rows ty + 16 i and keys tx + 16 j
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[R], g[R], kk[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        a[i] = qs[(ty + 16 * i) * DP + d];
        g[i] = gs[(ty + 16 * i) * DP + d];
        kk[i] = ks[(tx + 16 * i) * DP + d];
        vv[i] = vs[(tx + 16 * i) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i, row = r0 + r;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j, col = c0 + c;
        const bool ok =
            row < Sq && col < Sk && (!causal || col <= row + off);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ss[r * SP + c] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();

    // dQ += dS K over this tile's keys
    for (int c = 0; c < BT; ++c) {
      float ds[R];
#pragma unroll
      for (int i = 0; i < R; ++i) ds[i] = ss[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        if (j < nd) {
          const float kv = ks[c * DP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][j] = fmaf(ds[i], kv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* dst = dq + ((long long)b * Sq + row) * rs + (long long)h * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (j < nd) dst[tx + 16 * j] = ptt::from_f<T>(acc[i][j] * scale);
  }
}

template <typename T, int BT, int DC>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KVH,
    int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, float scale) {
  constexpr int R = BT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = D + 1, SP = BT + 1;
  float* ks = (float*)smem_raw;  // BT * DP
  float* vs = ks + BT * DP;      // BT * DP
  float* qs = vs + BT * DP;      // BT * DP
  float* gs = qs + BT * DP;      // BT * DP, dO
  float* pt = gs + BT * DP;      // BT * SP, P^T
  float* dst = pt + BT * SP;     // BT * SP, dS^T
  float* lse_s = dst + BT * SP;  // BT
  float* dl_s = lse_s + BT;      // BT

  const int kh = blockIdx.y, b = blockIdx.z, c0 = blockIdx.x * BT;
  const int rep = H / KVH;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nd = D / 16;
  const int off = Sk - Sq;
  const long long rs = (long long)H * D;  // row stride of dO

  stage<T, BT>(k + b * ksb + kh * ksh, kss, c0, Sk, D, ks);
  stage<T, BT>(v + b * vsb + kh * vsh, vss, c0, Sk, D, vs);

  // query tiles whose rows can see a key of this tile: rows >= c0 - off
  const int nq = (Sq + BT - 1) / BT;
  int lo = 0;
  if (causal) {
    const long long first = (long long)c0 - off;
    lo = first <= 0 ? 0 : (int)(first / BT < nq ? first / BT : nq);
  }

  float acc_k[R][DC], acc_v[R][DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = kh * rep + hh;
    const long long bh = (long long)b * H + h;
    const T* qb = q + b * qsb + h * qsh;
    const T* gb = dout + (long long)b * Sq * rs + (long long)h * D;
    for (int qt = lo; qt < nq; ++qt) {
      const int r0 = qt * BT;
      // the previous tile is done with qs/gs/pt/dst (before the first:
      // K and V are written)
      __syncthreads();
      stage<T, BT>(qb, qss, r0, Sq, D, qs);
      stage<T, BT>(gb, rs, r0, Sq, D, gs);
      if (tid < BT) {
        const int row = r0 + tid;
        lse_s[tid] = row < Sq ? lse[bh * Sq + row] : 0.f;
        dl_s[tid] = row < Sq ? delta[bh * Sq + row] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T of keys ty + 16 i and rows tx + 16 j
      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float kk[R], vv[R], a[R], g[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kk[i] = ks[(ty + 16 * i) * DP + d];
          vv[i] = vs[(ty + 16 * i) * DP + d];
          a[i] = qs[(tx + 16 * i) * DP + d];
          g[i] = gs[(tx + 16 * i) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(kk[i], a[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], g[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int c = ty + 16 * i, col = c0 + c;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = tx + 16 * j, row = r0 + r;
          const bool ok =
              row < Sq && col < Sk && (!causal || col <= row + off);
          const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          pt[c * SP + r] = p;
          dst[c * SP + r] = p * (dp[i][j] - dl_s[r]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over this tile's rows
      for (int r = 0; r < BT; ++r) {
        float pv[R], dsv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = pt[(ty + 16 * i) * SP + r];
          dsv[i] = dst[(ty + 16 * i) * SP + r];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          if (j < nd) {
            const float gd = gs[r * DP + tx + 16 * j];
            const float qd = qs[r * DP + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              acc_v[i][j] = fmaf(pv[i], gd, acc_v[i][j]);
              acc_k[i][j] = fmaf(dsv[i], qd, acc_k[i][j]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int col = c0 + ty + 16 * i;
    if (col >= Sk) continue;
    const long long base = (((long long)b * Sk + col) * KVH + kh) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (j < nd) {
        dk[base + tx + 16 * j] = ptt::from_f<T>(acc_k[i][j] * scale);
        dv[base + tx + 16 * j] = ptt::from_f<T>(acc_v[i][j]);
      }
  }
}

size_t dq_smem(int BT, int D) {
  return (size_t)(4 * BT * (D + 1) + BT * (BT + 1) + 2 * BT) * sizeof(float);
}

size_t dkv_smem(int BT, int D) {
  return (size_t)(4 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT) *
         sizeof(float);
}

template <typename T, int BT, int DC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* delta, void* dq, void* dk, void* dv,
                   int B, int Sq, int Sk, int H, int KVH, int D,
                   long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, int causal,
                   float scale, cudaStream_t st) {
  const size_t s1 = dq_smem(BT, D), s2 = dkv_smem(BT, D);
  cudaError_t e = ptt::allow_smem(flash_bwd_dq_kernel<T, BT, DC>, s1);
  if (e != cudaSuccess) return e;
  e = ptt::allow_smem(flash_bwd_dkv_kernel<T, BT, DC>, s2);
  if (e != cudaSuccess) return e;
  const dim3 g1((Sq + BT - 1) / BT, H, B);
  flash_bwd_dq_kernel<T, BT, DC><<<g1, kThreads, s1, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      (const float*)lse, (float*)delta, (T*)dq, Sq, Sk, H, KVH,
      D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 g2((Sk + BT - 1) / BT, KVH, B);
  flash_bwd_dkv_kernel<T, BT, DC><<<g2, kThreads, s2, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, Sq, Sk, H, KVH,
      D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const void* lse,
                     void* delta, void* dq, void* dk, void* dv,
                     int B, int Sq, int Sk, int H, int KVH, int D,
                     long long qsb, long long qss, long long qsh,
                     long long ksb, long long kss, long long ksh,
                     long long vsb, long long vss, long long vsh, int causal,
                     float scale, cudaStream_t st) {
  if (D % 16 || D > 256 || KVH <= 0 || H % KVH) return cudaErrorInvalidValue;
  if (D <= 64)
    return launch<T, 64, 4>(q, k, v, o, dout, lse, delta, dq, dk,
                            dv, B, Sq, Sk, H, KVH, D, qsb, qss, qsh, ksb, kss,
                            ksh, vsb, vss, vsh, causal, scale, st);
  if (D <= 128)
    return launch<T, 64, 8>(q, k, v, o, dout, lse, delta, dq, dk,
                            dv, B, Sq, Sk, H, KVH, D, qsb, qss, qsh, ksb, kss,
                            ksh, vsb, vss, vsh, causal, scale, st);
  return launch<T, 32, 16>(q, k, v, o, dout, lse, delta, dq, dk,
                           dv, B, Sq, Sk, H, KVH, D, qsb, qss, qsh, ksb, kss,
                           ksh, vsb, vss, vsh, causal, scale, st);
}

}  // namespace

extern "C" int ptt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int KVH,
    int D, long long qsb, long long qss, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ptt::kFloat32)
    return (int)dispatch<float>(q, k, v, o, dout, lse, delta, dq,
                                dk, dv, B, Sq, Sk, H, KVH, D, qsb, qss, qsh,
                                ksb, kss, ksh, vsb, vss, vsh, causal, scale,
                                st);
  if (dtype == ptt::kBFloat16)
    return (int)dispatch<__nv_bfloat16>(
        q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H,
        KVH, D, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, causal, scale,
        st);
  return (int)cudaErrorInvalidValue;
}
