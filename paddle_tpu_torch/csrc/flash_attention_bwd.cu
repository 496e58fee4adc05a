// Flash attention backward (kernel B8): dQ, dK and dV.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py:_pallas_bwd, its two
// pallas_calls _dq_kernel and _dkv_kernel: the FlashAttention-2 backward
// from the forward's saved per-row logsumexp (B1's lse, [B, H, Sq]), with no
// Sq x Sk matrix in device memory.  For q [B, Sq, H, D], k/v [B, Sk, KVH, D]
// (query head h reads KV head h / (H / KVH)), the output o and its gradient
// dO ([B, Sq, H, D], contiguous):
//
//   delta = rowsum(dO * O)
//   P     = exp(scale * Q K^T - lse)            (recomputed tile by tile)
//   dS    = P * (dP - delta),  dP = dO V^T
//   dQ    = scale * dS K,  dK = scale * dS^T Q,  dV = P^T dO
//
// Causal masking is bottom-right (col <= row + Sk - Sq), as the forward and
// the reference; masked and padding entries give P = 0 exactly, so a row
// that sees no key (Sq > Sk) gets zero gradients whatever its lse.  Only the
// tiles the mask leaves visible are visited, with the reference's bounds.
//
// Bound on the H100: operations, 10 D per visible (row, key) pair (S, dP,
// dQ, dK, dV; 989 TFLOP/s in bf16 on the tensor cores).
//
// bfloat16 runs on the tensor cores, computing S and dP once (10 D per
// pair), in up to four launches on one stream:
// - a pre-pass writes delta (float32, [B, H, Sq]) and zeroes a float32 dQ
//   accumulator [B, Sq, H, D];
// - the main kernel runs one block per (key tile of 64 NWG keys, query head
//   or GQA group, batch), 64 keys per warpgroup.  K and V stay
//   in shared memory (128-byte swizzled); the visible query tiles (64 rows:
//   Q, dO, lse, delta) stream through a two-stage cp.async ring, from the
//   diagonal down.  Per tile, on wgmma: S^T = K Q^T and dP^T = V dO^T (both
//   operands in shared memory); P^T and dS^T in registers, masked only on
//   tiles that cross the bound or an end; dV += P^T dO and dK += dS^T Q with
//   P^T and dS^T as register A operands (dO and Q MN-major through the
//   transpose bit), dK and dV in float32 registers for the whole walk;
//   dS^T to shared memory in bf16 and dQ += dS K (both operands MN-major),
//   added into the accumulator with 16-byte float32 atomics (two
//   warpgroups at D = 128 compute dQ once over the block's 128 keys, half
//   the columns each, which halves the atomics);
// - a post-pass casts scale * dQ;
// - for GQA with one query head per block, a last pass sums each group's
//   float32 dK/dV partials ([B, Sk, H, D]) before the cast.  The other GQA
//   mode walks a group's heads in one block and needs no partials; the
//   wrapper picks the mode (hpb).
// At D = 256 a warpgroup's float32 dK and dV for 64 keys x 256 would take
// 256 registers a thread: two warpgroups share one 64-key tile, one
// computing S^T and the other dP^T over all of D, swapping them through 16
// KB of shared memory (two barriers), then each owns one 128-column half of
// dK, dV and dQ; S and dP stay computed once (10 D per pair) and the
// elementwise part runs in both.  The atomics let dQ's summation order vary from run to run:
// bf16 dQ is not guaranteed bitwise deterministic (it stays within
// chip_smoke.py's tolerance);
// dK and dV, and the float32 path, are.  What it leaves on the table: no
// producer warp or TMA, little overlap of the elementwise part with the
// products (only P's with the dP product),
// register atomics for dQ where a TMA reduce-add of a shared tile would
// move fewer transactions, and register spills at D 128 and 256 (dK and
// dV hold 128 float32 registers a thread).
//
// float32 stays on the SIMT cores (67 TFLOP/s at most; the port pins TF32
// off): two kernels.  dQ: one block per (query tile, head, batch); it stages
// its Q and dO rows, computes delta for them (writing it for the second
// kernel), then streams the visible K/V tiles: S and dP in one pass over D,
// dS into shared memory, dQ += dS K in registers.  dK/dV: one block per
// (key tile, KV head, batch); K and V stay in shared memory while the block
// streams the Q and dO tiles of every query head of its GQA group, so dK
// and dV are summed over the group in float32 registers and cast once.
// Layout: 256 threads, 16 x 16; tiles of BT rows staged as float32 with
// rows padded by one float; each thread owns R x R entries of a score tile
// (R = BT / 16).  S and dP are computed in both kernels (14 D per pair).
// Shared memory: dQ 149 KB and dK/dV 166 KB at D = 128 (BT 64); at D = 256
// the tiles shrink to 32 rows (136 / 140 KB).
#include <math.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

// ---------------------------------------------- float32: SIMT instances
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


// ------------------------------------------ bfloat16: tensor-core instances
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  float* dq_acc;            // [B, Sq, H, D], zeroed by the pre-pass
  __nv_bfloat16* dq;        // [B, Sq, H, D]
  __nv_bfloat16 *dk, *dv;   // [B, Sk, KVH, D], written when dkp is null
  float *dkp, *dvp;         // [B, Sk, H, D] per query head (GQA) or null
  int Sq, Sk, H, KVH, D, hpb;  // hpb: query heads per block, 1 or H / KVH
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal;
  float scale;
};

// one instance per (DP, NWG): DP the head dim rounded up to 64, NWG
// warpgroups of 64 keys each (block_k = 64 NWG), 64 query rows a tile
// (block_q = 64).  A warpgroup's dK and dV cover DO <= 128 columns.  At
// D = 256 (kSplitD) two warpgroups share one 64-key tile (block_k = 64):
// one computes S, the other dP, each hands its result to the other through
// shared memory, and each owns one 128-column half of dK, dV and dQ.
template <int DP, int NWG>
struct BwdTile {
  static constexpr bool kSplitD = DP == 256;
  static_assert(!kSplitD || NWG == 2, "D 256 takes two warpgroups");
  static constexpr int kDO = DP < 128 ? DP : 128;
  static constexpr int kBK = kSplitD ? 64 : 64 * NWG;
  static constexpr int kThreads = 128 * NWG;
  static constexpr int kKBytes = kBK * DP * 2;  // K (and V)
  static constexpr int kQBytes = 64 * DP * 2;   // Q (and dO) of a stage
  static constexpr int kStage = 2 * kQBytes + 1024;  // + lse, delta
  static constexpr int kDSBytes = 64 * 64 * 2;  // dS^T of 64 keys
  static constexpr int kDSBufs = kSplitD ? 1 : NWG;
  static constexpr int kXBytes = kSplitD ? 32 * 128 * 4 : 0;  // S/dP hand-over
  static constexpr int kSmem = 2 * kKBytes + 2 * kStage +
                               kDSBufs * kDSBytes + kXBytes + 1024;
};

template <int DP, int NWG>
__global__ void __launch_bounds__(BwdTile<DP, NWG>::kThreads, 1)
    flash_bwd_tc_kernel(const BwdArgs a) {
  using Tl = BwdTile<DP, NWG>;
  using namespace ptt::tc;
  // two warpgroups at D 128 share dQ: one product over the block's 128
  // keys, half the columns each, half the atomics of one per warpgroup
  constexpr bool kSharedDQ = NWG == 2 && DP == 128;
  constexpr int kDQBlocks = kSharedDQ ? 1 : Tl::kDO / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (k_s - smem_u32(smem_raw));
  const uint32_t v_s = k_s + Tl::kKBytes;
  const uint32_t st_s = v_s + Tl::kKBytes;  // two stages
  const uint32_t ds_s = st_s + 2 * Tl::kStage;
  const uint32_t x_s = ds_s + Tl::kDSBufs * Tl::kDSBytes;

  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int g = lane / 4, cq = 2 * (lane % 4);
  const int nhb = a.H / a.hpb;
  const int h0 = (blockIdx.x % nhb) * a.hpb, b = blockIdx.x / nhb;
  const int slice = Tl::kSplitD ? wg : 0;  // this warpgroup's dK/dV columns
  const int kh = h0 / (a.H / a.KVH);
  // the first key tiles see the most query tiles: they run first
  const int wkey = Tl::kSplitD ? 0 : wg * 64;  // the warpgroup's first key
  const int c0 = blockIdx.y * Tl::kBK, c0w = c0 + wkey;
  const int off = a.Sk - a.Sq;
  const long long rs = (long long)a.H * a.D;  // row stride of dO, dQ acc

  // query tiles whose rows can see a key of this block: rows >= c0 - off
  const int nq = (a.Sq + 63) / 64;
  int lo = 0;
  if (a.causal) {
    const long long first = (long long)c0 - off;
    lo = first <= 0 ? 0 : (int)(first / 64 < nq ? first / 64 : nq);
  }
  const int nqv = nq - lo, n_items = a.hpb * nqv;

  load_tile<Tl::kBK, DP, Tl::kThreads>(
      k_s, a.k + b * a.ksb + kh * a.ksh, a.kss, c0, a.Sk, a.D, tid);
  load_tile<Tl::kBK, DP, Tl::kThreads>(
      v_s, a.v + b * a.vsb + kh * a.vsh, a.vss, c0, a.Sk, a.D, tid);
  // item it: query head h0 + it / nqv, query tile lo + it % nqv
  auto load_item = [&](int it, uint32_t stage) {
    const int h = h0 + it / nqv, r0 = (lo + it % nqv) * 64;
    load_tile<64, DP, Tl::kThreads>(stage, a.q + b * a.qsb + h * a.qsh,
                                    a.qss, r0, a.Sq, a.D, tid);
    load_tile<64, DP, Tl::kThreads>(
        stage + Tl::kQBytes,
        a.dout + (long long)b * a.Sq * rs + (long long)h * a.D, rs, r0,
        a.Sq, a.D, tid);
    if (tid < 128) {
      const int r = tid % 64;
      const bool ok = r0 + r < a.Sq;
      const float* src = (tid < 64 ? a.lse : a.delta) +
                         ((long long)b * a.H + h) * a.Sq + r0 + r;
      cp_async4(stage + 2 * Tl::kQBytes + (tid < 64 ? 0 : 256) + 4 * r,
                ok ? src : a.lse, ok);
    }
  };
  if (n_items > 0) load_item(0, st_s);
  cp_async_commit();

  float dk[Tl::kDO / 2], dv[Tl::kDO / 2];
#pragma unroll
  for (int i = 0; i < Tl::kDO / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_wg = k_s + wkey * 128, v_wg = v_s + wkey * 128;
  const uint32_t ds_w = ds_s + (Tl::kSplitD ? 0 : wg * Tl::kDSBytes);
  const int cb0 = slice * Tl::kDO / 64;  // the slice's first column block
  const int key = c0w + warp * 16 + g;   // this thread's first key row
  const float sl2 = a.scale * kLog2e;

  for (int it = 0; it < n_items; ++it) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_items) load_item(it + 1, st_s + ((it + 1) & 1) * Tl::kStage);
    cp_async_commit();
    const int h = h0 + it / nqv, r0 = (lo + it % nqv) * 64;
    // whether some row of this tile sees this warpgroup's keys; with a
    // shared dQ only the block's first keys decide a skip (both warpgroups
    // meet at the barrier before dQ)
    const bool vis = !a.causal || (long long)c0w <= (long long)r0 + 63 + off;
    if (!(kSharedDQ ? !a.causal || (long long)c0 <= (long long)r0 + 63 + off
                    : vis))
      continue;
    const uint32_t q_t = opaque(st_s + (it & 1) * Tl::kStage);
    const uint32_t do_t = q_t + Tl::kQBytes;
    const uint32_t k_d = opaque(k_wg), v_d = opaque(v_wg);
    const uint32_t ds_d = opaque(ds_w);
    const float* lse_s =
        reinterpret_cast<const float*>(base + (q_t - k_s) + 2 * Tl::kQBytes);
    const float* dl_s = lse_s + 64;

    if (vis) {
      // S^T = K Q^T and dP^T = V dO^T, once each: keys are the rows
      float st[32], dpt[32];
      if constexpr (Tl::kSplitD) {
        // warpgroup 0 computes S^T, warpgroup 1 dP^T, each over all of D
        // (the operands are picked as values: no product under a branch);
        // thread t of one warpgroup holds the entries thread t of the
        // other needs, handed over through shared memory
        float x[32], y[32];
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          SS<64, 0, 0>::mma(x, desc_k(wg ? v_d : k_d, Tl::kBK, kk),
                            desc_k(wg ? do_t : q_t, 64, kk), kk);
        wg_commit();
        wg_wait<0>();
        fence_regs<32>(x);
        float* xb = reinterpret_cast<float*>(base + (x_s - k_s)) + tid % 128;
        if (wg == 0)
#pragma unroll
          for (int i = 0; i < 32; ++i) xb[128 * i] = x[i];
        named_sync(3, 256);
        if (wg == 1)
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            y[i] = xb[128 * i];
            xb[128 * i] = x[i];
          }
        named_sync(3, 256);
        if (wg == 0)
#pragma unroll
          for (int i = 0; i < 32; ++i) y[i] = xb[128 * i];
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          st[i] = wg ? y[i] : x[i];
          dpt[i] = wg ? x[i] : y[i];
        }
      } else {
        // P is computed while the dP product runs
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          SS<64, 0, 0>::mma(st, desc_k(k_d, Tl::kBK, kk),
                            desc_k(q_t, 64, kk), kk);
        wg_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          SS<64, 0, 0>::mma(dpt, desc_k(v_d, Tl::kBK, kk),
                            desc_k(do_t, 64, kk), kk);
        wg_commit();
        wg_wait<1>();
        fence_regs<32>(st);
      }

      // P = exp(S scale - lse) and dS = P (dP - delta), masked to exact
      // zeros only where the tile crosses the causal bound or an end
      const bool edge =
          r0 + 64 > a.Sq || c0w + 64 > a.Sk ||
          (a.causal && (long long)c0w + 63 > (long long)r0 + off);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qc = 8 * (i / 4) + cq + (i & 1);
          const int kr = key + ((i & 2) ? 8 : 0);
          const bool ok = r0 + qc < a.Sq && kr < a.Sk &&
                          (!a.causal || kr <= r0 + qc + off);
          st[i] = ok ? exp2f(st[i] * sl2 - lse_s[qc] * kLog2e) : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          st[i] = exp2f(st[i] * sl2 -
                        lse_s[8 * (i / 4) + cq + (i & 1)] * kLog2e);
      }
      fence_regs<32>(st);  // P before the wait for dP (see B1's softmax)
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(st, kk, pa[kk]);
      if constexpr (!Tl::kSplitD) {
        wg_wait<0>();
        fence_regs<32>(dpt);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dpt[i] = st[i] * (dpt[i] - dl_s[8 * (i / 4) + cq + (i & 1)]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) acc_to_a(dpt, kk, da[kk]);
      // dS^T in bf16 into shared memory ([64 keys, 64 rows], swizzled) for
      // dQ = dS K; the same rounding as the registers' copy (at D 256 both
      // warpgroups hold the same dS: the first writes it)
      if (!Tl::kSplitD || wg == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = warp * 16 + g + ((e & 1) ? 8 : 0);
            const int c = 2 * kk + (e >> 1);
            *reinterpret_cast<uint32_t*>(base + (ds_d - k_s) + swz(r, c) +
                                         2 * cq) = da[kk][e];
          }
        fence_proxy_async();
      }

      // dV += P^T dO and dK += dS^T Q over the slice's columns
      fence_regs<Tl::kDO / 2>(dv);
      fence_regs<Tl::kDO / 2>(dk);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        RS<Tl::kDO, 1>::mma(dv, pa[kk], desc_mn(do_t + cb0 * 64 * 128, 64, kk),
                            1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        RS<Tl::kDO, 1>::mma(dk, da[kk], desc_mn(q_t + cb0 * 64 * 128, 64, kk),
                            1);
      wg_commit();
    }  // vis
    // the dS^T that dQ reads is written: this warpgroup's, or both
    if (kSharedDQ || Tl::kSplitD)
      __syncthreads();
    else
      named_sync(1 + wg, 128);

    // dQ += dS K, 64 columns at a time, into the float32 accumulator with
    // 16-byte atomics: the two threads of a lane pair swap halves so each
    // holds 4 adjacent columns of one row (the even lane row g, the odd
    // lane row g + 8).  Shared: warpgroup w takes columns 64 w .. over the
    // block's 128 keys (its partner's only where they are visible); else
    // each warpgroup its own 64 keys.
    const bool odd = lane & 1;
    const int qr = r0 + warp * 16 + g + (odd ? 8 : 0);
    const int c4 = cq & ~3;  // 4 (lane % 4 / 2): the float4's column
    const int nk = kSharedDQ && (!a.causal || (long long)c0 + 64 <=
                                                  (long long)r0 + 63 + off)
                       ? 8
                       : 4;  // k steps of 16 keys
    const uint32_t ds_a = kSharedDQ ? opaque(ds_s) : ds_d;
    const uint32_t k_b = kSharedDQ ? opaque(k_s) : k_d;
#pragma unroll
    for (int hq = 0; hq < kDQBlocks; ++hq) {
      const int cblk = kSharedDQ ? wg : cb0 + hq;  // dQ's column block
      float dq[32];
      __syncwarp();  // the warp reconverged after the atomics' predicates
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        if (kk < nk)
          SS<64, 1, 1>::mma(dq, desc_mn(ds_a, 64, kk),
                            desc_mn(k_b + cblk * Tl::kBK * 128, Tl::kBK, kk),
                            kk);
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(dq);
      const int col0 = cblk * 64;
      float4* dst = reinterpret_cast<float4*>(
          a.dq_acc + ((long long)b * a.Sq + qr) * rs + (long long)h * a.D +
          col0 + c4);
      const bool store = qr < a.Sq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s0 = odd ? dq[4 * j] : dq[4 * j + 2];
        const float s1 = odd ? dq[4 * j + 1] : dq[4 * j + 3];
        const float r0v = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1v = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 val =
            odd ? make_float4(r0v, r1v, dq[4 * j + 2], dq[4 * j + 3])
                : make_float4(dq[4 * j], dq[4 * j + 1], r0v, r1v);
        if (store && col0 + 8 * j + c4 < a.D) atomicAdd(dst + 2 * j, val);
      }
    }
    wg_wait<0>();
    fence_regs<Tl::kDO / 2>(dv);
    fence_regs<Tl::kDO / 2>(dk);
  }
  cp_async_wait<0>();  // no copy outlives the block (a block may see no tile)

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int kr = key + 8 * rh;
    if (kr >= a.Sk) continue;
#pragma unroll
    for (int j = 0; j < Tl::kDO / 8; ++j) {
      const int col = slice * Tl::kDO + 8 * j + cq;
      if (col >= a.D) continue;
      const float k0 = dk[4 * j + 2 * rh] * a.scale;
      const float k1 = dk[4 * j + 2 * rh + 1] * a.scale;
      const float v0 = dv[4 * j + 2 * rh], v1 = dv[4 * j + 2 * rh + 1];
      if (a.dkp != nullptr) {
        const long long o = (((long long)b * a.Sk + kr) * a.H + h0) * a.D + col;
        *reinterpret_cast<float2*>(a.dkp + o) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(a.dvp + o) = make_float2(v0, v1);
      } else {
        const long long o =
            (((long long)b * a.Sk + kr) * a.KVH + kh) * a.D + col;
        *reinterpret_cast<__nv_bfloat162*>(a.dk + o) =
            __floats2bfloat162_rn(k0, k1);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + o) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// delta = rowsum(dO * O) and a zeroed dQ accumulator: one warp per
// (batch, row, head) row of D
__global__ void flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                                      const __nv_bfloat16* __restrict__ dout,
                                      float* __restrict__ delta,
                                      float* __restrict__ dq_acc,
                                      long long rows, int Sq, int H, int D) {
  const long long i = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= rows) return;
  float acc = 0.f;
  if (lane * 8 < D) {
    float x[8], y[8];
    ptt::Vec16<__nv_bfloat16>::load(o + i * D + lane * 8, x);
    ptt::Vec16<__nv_bfloat16>::load(dout + i * D + lane * 8, y);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc += x[e] * y[e];
    float4* z = reinterpret_cast<float4*>(dq_acc + i * D + lane * 8);
    z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  acc = ptt::warp_sum(acc);
  if (lane == 0) {
    const long long bs = i / H;  // b * Sq + s
    delta[((bs / Sq) * H + i % H) * Sq + bs % Sq] = acc;
  }
}

// dQ = scale * the float32 accumulator, cast once
__global__ void flash_bwd_dq_kernel(const float* __restrict__ acc,
                                    __nv_bfloat16* __restrict__ dq,
                                    long long n4, float scale) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 x = reinterpret_cast<const float4*>(acc)[i];
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dq) + 2 * i;
    d[0] = __floats2bfloat162_rn(x.x * scale, x.y * scale);
    d[1] = __floats2bfloat162_rn(x.z * scale, x.w * scale);
  }
}

// GQA: dK, dV of a KV head = the float32 sum of its group's per-head
// partials, cast once
__global__ void flash_bwd_group_sum_kernel(const float* __restrict__ dkp,
                                           const float* __restrict__ dvp,
                                           __nv_bfloat16* __restrict__ dk,
                                           __nv_bfloat16* __restrict__ dv,
                                           long long n, int KVH, int rep,
                                           int D) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const int d = (int)(i % D);
    const long long row = i / D;  // (b * Sk + s) * KVH + kh
    const long long src = (row * rep) * D + d;  // head kh * rep of that row
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < rep; ++r) {
      sk += dkp[src + (long long)r * D];
      sv += dvp[src + (long long)r * D];
    }
    dk[i] = __float2bfloat16(sk);
    dv[i] = __float2bfloat16(sv);
  }
}

template <int DP, int NWG>
cudaError_t launch_tc(const BwdArgs& a, int B, cudaStream_t st) {
  using Tl = BwdTile<DP, NWG>;
  cudaError_t e = ptt::allow_smem(flash_bwd_tc_kernel<DP, NWG>, Tl::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * (a.H / a.hpb), (a.Sk + Tl::kBK - 1) / Tl::kBK);
  flash_bwd_tc_kernel<DP, NWG><<<grid, Tl::kThreads, Tl::kSmem, st>>>(a);
  return cudaGetLastError();
}

// the compiled (dtype, D, tile) table; the Python side mirrors it
// (ops/hopper/autotune.py INSTANCES) and a pair missing here is refused
cudaError_t dispatch_tc(const BwdArgs& a, int B, int bq, int bk,
                        cudaStream_t st) {
  const int DP = a.D <= 64 ? 64 : a.D <= 128 ? 128 : 256;
  if (bq != 64) return cudaErrorInvalidValue;
#define PTT_BWD(dp, k_, nwg) \
  if (DP == dp && bk == k_) return launch_tc<dp, nwg>(a, B, st)
  PTT_BWD(64, 64, 1);
  PTT_BWD(128, 64, 1);
  PTT_BWD(128, 128, 2);
  PTT_BWD(256, 64, 2);  // two warpgroups on one 64-key tile
#undef PTT_BWD
  return cudaErrorInvalidValue;
}

// pre-pass, main kernel, dQ cast and (GQA, one head per block) the
// group sum, in this order on one stream
cudaError_t bwd_tc(const BwdArgs& a, const void* o, float* delta, int B,
                   int bq, int bk, cudaStream_t st) {
  const int rep = a.H / a.KVH;
  if ((a.hpb != 1 && a.hpb != rep) || (a.dkp != nullptr) != (a.hpb < rep))
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * a.Sq * a.H;
  flash_bwd_prep_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      (const __nv_bfloat16*)o, a.dout, delta, a.dq_acc, rows, a.Sq, a.H,
      a.D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = dispatch_tc(a, B, bq, bk, st);
  if (e != cudaSuccess) return e;
  const long long n4 = rows * a.D / 4;
  flash_bwd_dq_kernel<<<(unsigned)((n4 + 255) / 256 < 8192 ? (n4 + 255) / 256
                                                           : 8192),
                        256, 0, st>>>(a.dq_acc, a.dq, n4, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.dkp == nullptr) return e;
  const long long n = (long long)B * a.Sk * a.KVH * a.D;
  flash_bwd_group_sum_kernel<<<(unsigned)((n + 255) / 256 < 8192
                                              ? (n + 255) / 256
                                              : 8192),
                               256, 0, st>>>(a.dkp, a.dvp, a.dk, a.dv, n,
                                             a.KVH, rep, a.D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ptt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq_acc, void* dkp,
    void* dvp, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
    int KVH, int D, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, int causal, float scale, int block_q, int block_k,
    int hpb, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D % 16 || D > 256 || KVH <= 0 || H % KVH)
    return (int)cudaErrorInvalidValue;
  if (dtype == ptt::kFloat32) {
    // the SIMT instances: square tiles of 64 rows, 32 at D > 128
    const int bt = D <= 128 ? 64 : 32;
    if (block_q != bt || block_k != bt) return (int)cudaErrorInvalidValue;
    if (D <= 64)
      return (int)launch<float, 64, 4>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, Sq, Sk, H, KVH, D, qsb, qss,
                                       qsh, ksb, kss, ksh, vsb, vss, vsh,
                                       causal, scale, st);
    if (D <= 128)
      return (int)launch<float, 64, 8>(q, k, v, o, dout, lse, delta, dq, dk,
                                       dv, B, Sq, Sk, H, KVH, D, qsb, qss,
                                       qsh, ksb, kss, ksh, vsb, vss, vsh,
                                       causal, scale, st);
    return (int)launch<float, 32, 16>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, B, Sq, Sk, H, KVH, D, qsb, qss, qsh,
                                      ksb, kss, ksh, vsb, vss, vsh, causal,
                                      scale, st);
  }
  if (dtype == ptt::kBFloat16) {
    using bf = __nv_bfloat16;
    const BwdArgs a{(const bf*)q, (const bf*)k, (const bf*)v,
                    (const bf*)dout, (const float*)lse, (const float*)delta,
                    (float*)dq_acc, (bf*)dq, (bf*)dk, (bf*)dv, (float*)dkp,
                    (float*)dvp, Sq, Sk, H, KVH, D, hpb, qsb, qss, qsh, ksb,
                    kss, ksh, vsb, vss, vsh, causal, scale};
    return (int)bwd_tc(a, o, (float*)delta, B, block_q, block_k, st);
  }
  return (int)cudaErrorInvalidValue;
}
