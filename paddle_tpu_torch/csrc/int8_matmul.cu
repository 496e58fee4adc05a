// Weight-only int8 matrix product (kernel B7).
//
// Replaces paddle_tpu/ops/pallas/int8_matmul.py:_int8_mm_impl (its _kernel):
//
//   out[m, n] = (sum_k x[m, k] * float(qw[k, n])) * scale[n]
//
// x [M, K] float32 or bfloat16 with a row stride (lda) and unit column
// stride, qw [K, N] int8 row-major, scale [N] float32, out [M, N] in x's
// dtype, row-major.  The semantics are the TPU kernel's: the int8 weight is
// widened per tile in on-chip memory (never written back dequantized), the
// products are summed in float32, and the per-column scale is applied once,
// in float32, after the last K step, before the one cast to x's dtype.
//
// Bound on the H100: at the predictor's shapes (M = 4096 rows of
// [32, 128] tokens, K and N 768 or 3072) by operations, 2 M N K, at the
// bf16 tensor-core rate; at a few rows (decode, M = 8) by the bytes of the
// weight, K N, which is where int8 storage pays.  Design, a first version:
//   bfloat16 x: one block of 8 warps per 128 x 128 output tile.  K steps of
//   32 go through a ring of 3 shared-memory stages filled by cp.async
//   (16-byte copies of the x tile and of the raw int8 tile), so two steps
//   are in flight while one is multiplied; per step the block widens the
//   int8 tile to bf16 (exact for |q| <= 128) into one more shared tile, and
//   each warp runs nvcuda::wmma 16x16x16 bf16 products into 4 x 2 float32
//   accumulator fragments (a 64 x 32 sub-tile).  The epilogue passes each
//   fragment through a per-warp float32 scratch, scales, casts and stores
//   with masks.  Two blocks share an SM (51 KB of shared memory and at
//   most 128 registers each).
//   float32 x: SIMT float32 (no TF32: float32 means float32 in this port),
//   64 x 64 tiles of 256 threads, 4 x 4 outputs per thread, K steps of 16.
// Every shape runs: edge tiles are zero-filled on load and masked on store,
// so M = 1, N = 2 or K = 100 need no fallback.  16-byte copies are used
// only where the pointer, the row stride and N allow them (flags computed
// here); elsewhere the tiles are filled element by element.
#include <stdint.h>

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;

// ------------------------------------------------ bfloat16 x: wmma tiles
constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3;
// padded x rows: a multiple of 8 elements (wmma ldm, 16-byte copies) whose
// stride is not a multiple of 128 bytes (fewer bank conflicts); the same
// for the widened weight tile
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
// dynamic shared memory: STAGES x tiles and int8 weight tiles in flight,
// one widened bf16 weight tile (the epilogue reuses the x tiles): 51 KB
constexpr int A_STAGE = BM * A_LD;  // bf16 elements
constexpr int Q_STAGE = BK * BN;    // bytes
constexpr size_t SMEM_BF16 =
    STAGES * A_STAGE * 2 + STAGES * Q_STAGE + BK * B_LD * 2;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  // copies src_bytes (0-16) and zero-fills the rest of the 16 bytes
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// start the copies of K step kt into the stage at As / Bq: cp.async where
// the pointer and row stride allow 16-byte copies (a short copy zero-fills a
// tail), plain loads and shared stores otherwise
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* As, int8_t* Bq, const __nv_bfloat16* x, const int8_t* qw,
    int M, int N, int K, long long lda, int a_vec, int b_vec, int m0, int n0,
    int kt, int tid) {
  const int k0 = kt * BK;
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / kThreads; ++i) {
    const int v = tid + i * kThreads;
    const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
    const int gm = m0 + r, gk = k0 + c;
    __nv_bfloat16* dst = As + r * A_LD + c;
    if (a_vec) {
      const int n = (gm < M && gk < K) ? min(8, K - gk) * 2 : 0;
      cp_async16(dst, n ? x + (long long)gm * lda + gk : x, n);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < M && gk + e < K) ? x[(long long)gm * lda + gk + e]
                                        : __float2bfloat16(0.f);
    }
  }
#pragma unroll
  for (int i = 0; i < BK * BN / 16 / kThreads; ++i) {
    const int v = tid + i * kThreads;
    const int r = v / (BN / 16), c = (v % (BN / 16)) * 16;
    const int gk = k0 + r, gn = n0 + c;
    int8_t* dst = Bq + r * BN + c;
    if (b_vec) {
      const int n = (gk < K && gn < N) ? min(16, N - gn) : 0;
      cp_async16(dst, n ? qw + (long long)gk * N + gn : qw, n);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (gk < K && gn + e < N) ? qw[(long long)gk * N + gn + e]
                                        : (int8_t)0;
    }
  }
}

// two blocks per SM: at most 128 registers a thread (on the H100 this beat
// one block per SM at the predictor's shapes; the K loop waits on barriers)
__global__ void __launch_bounds__(kThreads, 2)
    int8_mm_bf16(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ qw,
                 const float* __restrict__ scale,
                 __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 long long lda, int a_vec, int b_vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int8_t* Bq = reinterpret_cast<int8_t*>(smem_raw + STAGES * A_STAGE * 2);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + STAGES * A_STAGE * 2 + STAGES * Q_STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64;  // 2 x 4 warps, each 64 rows x 32 cols
  const int wn = (warp & 3) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // a ring of STAGES K steps: step kt + STAGES - 1 is copied while step kt
  // is widened and multiplied
  const int KT = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT)
      load_stage(As + s * A_STAGE, Bq + s * Q_STAGE, x, qw, M, N, K, lda,
                 a_vec, b_vec, m0, n0, s, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step kt landed
    // every thread's copies landed, and every warp is done with step kt - 1
    // (its stage and the widened tile may be overwritten)
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < KT)
      load_stage(As + (nk % STAGES) * A_STAGE, Bq + (nk % STAGES) * Q_STAGE,
                 x, qw, M, N, K, lda, a_vec, b_vec, m0, n0, nk, tid);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < BK * BN / 16 / kThreads; ++i) {
      // widen 16 int8 weights to bf16 (exact for |q| <= 128)
      const int v = tid + i * kThreads;
      const int r = v / (BN / 16), c = (v % (BN / 16)) * 16;
      alignas(16) int8_t w[16];
      *reinterpret_cast<int4*>(w) = *reinterpret_cast<const int4*>(
          Bq + (kt % STAGES) * Q_STAGE + r * BN + c);
      alignas(16) __nv_bfloat162 h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = __floats2bfloat162_rn((float)w[2 * e], (float)w[2 * e + 1]);
      uint4* dst = reinterpret_cast<uint4*>(Bs + r * B_LD + c);
      dst[0] = reinterpret_cast<const uint4*>(h)[0];
      dst[1] = reinterpret_cast<const uint4*>(h)[1];
    }
    __syncthreads();
    const __nv_bfloat16* Ak = As + (kt % STAGES) * A_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], Ak + (wm + 16 * i) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * B_LD + wn + 16 * j, B_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the x stages are free: the epilogue's scratch

  // epilogue: each fragment through the warp's float32 scratch; each lane
  // scales 8 columns of one row once, casts and stores them with masks
  float* cs = reinterpret_cast<float*>(smem_raw) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int gm = m0 + wm + 16 * i + r, gn = n0 + wn + 16 * j + c;
      if (gm < M) {
        __nv_bfloat16* o = out + (long long)gm * N;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (gn + e < N)
            o[gn + e] = __float2bfloat16(cs[r * 16 + c + e] * scale[gn + e]);
      }
      __syncwarp();
    }
  }
}

// ------------------------------------------------- float32 x: SIMT tiles
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(kThreads)
    int8_mm_f32(const float* __restrict__ x, const int8_t* __restrict__ qw,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int N, int K, long long lda) {
  // k-major tiles: a thread reads 4 consecutive rows (columns) as a float4
  __shared__ __align__(16) float As[FK][FM + 4];
  __shared__ __align__(16) float Bs[FK][FN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int v = tid; v < FM * FK; v += kThreads) {
      const int r = v / FK, c = v % FK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[(long long)gm * lda + gk] : 0.f;
    }
#pragma unroll
    for (int v = tid; v < FK * FN; v += kThreads) {
      const int r = v / FN, c = v % FN, gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? (float)qw[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) out[(long long)gm * N + gn] = acc[i][j] * scale[gn];
    }
  }
}

}  // namespace

// x (dtype, rows lda elements apart), qw int8 [K, N], scale float32 [N],
// out (dtype) [M, N]; returns the launch's cudaError_t
extern "C" int ptt_int8_matmul(const void* x, const void* qw,
                               const void* scale, void* out, int M, int N,
                               int K, long long lda, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (dtype == ptt::kBFloat16) {
    const int a_vec = ((uintptr_t)x % 16 == 0) && (lda % 8 == 0);
    const int b_vec = ((uintptr_t)qw % 16 == 0) && (N % 16 == 0);
    const cudaError_t e = ptt::allow_smem(int8_mm_bf16, SMEM_BF16);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    int8_mm_bf16<<<grid, kThreads, SMEM_BF16, st>>>(
        (const __nv_bfloat16*)x, (const int8_t*)qw, (const float*)scale,
        (__nv_bfloat16*)out, M, N, K, lda, a_vec, b_vec);
  } else if (dtype == ptt::kFloat32) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    int8_mm_f32<<<grid, kThreads, 0, st>>>(
        (const float*)x, (const int8_t*)qw, (const float*)scale, (float*)out,
        M, N, K, lda);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
