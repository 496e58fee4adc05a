// Weight-only int8 matrix product (kernel B7).
//
// Replaces paddle_tpu/ops/pallas/int8_matmul.py:_int8_mm_impl (its _kernel):
//
//   out[m, n] = (sum_k x[m, k] * float(qw[k, n])) * scale[n]   (+ bias[n])
//
// x [M, K] float32 or bfloat16 with a row stride (lda) and unit column
// stride, qw [K, N] int8 row-major, scale [N] float32, bias [N] in x's dtype
// or none, out [M, N] in x's dtype, row-major.  The semantics are the TPU
// kernel's: the int8 weight is widened on the chip (never written back
// dequantized), the products are summed in float32, and the per-column
// scale is applied once, in float32, after the last K step, before the one
// cast to x's dtype.  The bias is the reference's separate add, in the
// epilogue: out = cast(cast(acc *rn scale) +rn bias) (__fmul_rn /
// __fadd_rn, no contraction), bit for bit the two-step result.
//
// Bound on the H100: at the predictor's shapes (M = 4096 rows of
// [32, 128] tokens, K and N 768 or 3072) by operations, 2 M N K, at the
// bf16 tensor-core rate; at a few rows (decode, M = 8) by the bytes of the
// weight, K N, which is where int8 storage pays.
//
// Design, bfloat16 x and N >= 64 (the plan's "wgmma" kind): the transposed
// product out^T[N, M] = W^T[N, K] x^T[K, M] on wgmma m64nNk16, so the
// weight's output columns fill wgmma's 64 rows and the token rows are its
// N (8 .. 256, the plan's token tile): a decode's 8 rows run without 120
// rows of zeros.  The widened weight is the A operand, in registers; x is
// the B operand, K-major, in 128-byte-swizzled shared memory.  A block has
// one or two consumer warpgroups (64 or 128 weight rows) and walks K in
// steps of 64 through a ring of cp.async 16-byte copies (raw int8 tile and
// x tile; 4 to 8 stages by token tile), one barrier a step.  Each thread
// reads its A-fragment bytes with two ldmatrix.x4.trans per step: the
// transpose of the [k][n] byte tile, taken as 16-bit pairs, hands thread t
// the bytes of k rows 2 (t % 4) (+1) at n columns 2 (t / 4) (+1).  The
// block's output columns are ordered so that A row g is column 2 g and row
// g + 8 is column 2 g + 1; a thread's two fragment rows are then one byte
// pair, and no second shared tile is written.  The bytes widen to bf16
// pairs exactly (|q| <= 128): __byte_perm into the float 2^23 + (q + 128),
// a subtract, and the high halves of two floats as a pair.  A split of K
// (the plan's `splits`, where the grid would give the card fewer than 132
// blocks) runs in the same launch: the splits of one output tile form a
// thread-block cluster, each sums its tile-aligned share of K, and the
// leader adds the others' float32 partials in split order through
// distributed shared memory (no atomics: a plan gives the same bits on
// every run).  The epilogue scales (two registers a thread: the thread's
// two output columns), adds the bias, and stages the tile through shared
// memory so that out's rows leave in 16-byte stores, tails masked.
//
// N < 64 (the classifier's 2-way head; "narrow", both dtypes): 1-8 warps
// a row of x (as many as give each lane about one 16-byte piece of it),
// the row read in place at its own stride with 16-byte loads, K split
// across the lanes, the weight's few columns per k row read as bytes, a
// shuffle reduction and the row's warps added in order, the same epilogue.
//
// float32 x, N >= 64 ("simt"): SIMT float32 (no TF32: float32 means
// float32 in this port), 64 x 64 tiles of 256 threads, 4 x 4 outputs per
// thread, K steps of 16.
//
// Every shape runs: edge tiles are zero-filled on load and masked on store,
// so M = 1, N = 130 or K = 100 need no fallback.  16-byte copies are used
// only where the pointer, the row stride and N allow them (flags computed
// here); elsewhere the tiles are filled element by element.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf = __nv_bfloat16;

constexpr int kKStep = 64;     // k per ring stage
constexpr int kMaxSplits = 8;  // blocks of a cluster (the portable size)

// ring depth by token tile: small x tiles leave room for more weight tiles
// in flight
constexpr int stages_for(int NT) { return NT <= 32 ? 8 : NT <= 64 ? 6 : 4; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int NT, int WG>
struct Tile {
  static constexpr int kThreads = 128 * WG;
  static constexpr int kRows = 64 * WG;  // weight rows (output columns)
  static constexpr int kStages = stages_for(NT);
  static constexpr int kXBytes = NT * 128;        // [NT, 64] bf16, swizzled
  static constexpr int kWBytes = kKStep * kRows;  // [64, kRows] int8
  static constexpr int kRing = kStages * (kXBytes + kWBytes);
  static constexpr int kPitch = 2 * kRows + 16;  // a staged out row, bytes
  static constexpr int kOut = NT * kPitch;
  static constexpr int kPart = NT / 2 * kThreads * 4;  // a split's partials
  // +1024 to align the base (x tiles are 1024-byte swizzle atoms)
  static constexpr int kSmem = cmax(kRing, cmax(kOut, kPart)) + 1024;
};

struct Args {
  const void* x;
  const int8_t* qw;
  const float* scale;
  const void* bias;  // x's dtype, or null
  void* out;
  int M, N, K;
  long long lda;
  int a_vec, b_vec, o_vec;
  int chunk;  // k steps a split takes
};

// 16 bytes global -> shared, of which `bytes` are read (0-16; the rest
// zero-filled)
__device__ __forceinline__ void cp_async_n(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const void* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(v);
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w)
               : "memory");
}

// four 8 x 8 16-bit matrices, transposed: lane l names row l of the four
// (8 rows each, in order); register i holds matrix i
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// byte offset of the 16-byte chunk c (16 weight columns) of k row r in a
// [64, ROWS] int8 tile, swizzled so that the 8 rows an ldmatrix matrix
// reads fall in 8 distinct 16-byte bank groups
template <int ROWS>
__device__ __forceinline__ uint32_t wsw(int r, int c) {
  if constexpr (ROWS == 128)
    return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
  else
    return (uint32_t)(r * 64 + ((c ^ ((r >> 1) & 3)) << 4));
}

// the ldmatrix.trans word {(k, n), (k, n + 1), (k + 1, n), (k + 1, n + 1)}
// of int8 weights -> the bf16 pairs (k, k + 1) of column n (lo) and of
// column n + 1 (hi); exact for |q| <= 128
__device__ __forceinline__ void widen(uint32_t w, uint32_t& lo,
                                      uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // q + 128 as unsigned bytes
  const float f0 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f2), 0x7632);
  hi = __byte_perm(__float_as_uint(f1), __float_as_uint(f3), 0x7632);
}

template <typename T>
__device__ __forceinline__ T epilogue(float acc, float s, const T* bias,
                                      int n) {
  const T y = ptt::from_f<T>(__fmul_rn(acc, s));
  if (bias == nullptr) return y;
  return ptt::from_f<T>(__fadd_rn(ptt::to_f(y), ptt::to_f(bias[n])));
}

// ---------------------------------------- bfloat16 x, N >= 64: wgmma tiles

// start the copies of K step kt into the stage at xs / ws (no commit)
template <int NT, int WG>
__device__ __forceinline__ void load_stage(const Args& a, uint32_t xs,
                                           uint32_t ws, int m0, int n0,
                                           int kt, int tid) {
  using Tl = Tile<NT, WG>;
  const int k0 = kt * kKStep;
  const bf* x = static_cast<const bf*>(a.x);
  constexpr int kX = NT * 8;  // 16-byte chunks of the x tile
#pragma unroll
  for (int it = 0; it < (kX + Tl::kThreads - 1) / Tl::kThreads; ++it) {
    const int i = tid + it * Tl::kThreads;
    if (kX % Tl::kThreads == 0 || i < kX) {
      const int r = i >> 3, c = i & 7;
      const int gm = m0 + r, gk = k0 + 8 * c;
      const uint32_t dst = xs + ptt::tc::swz(r, c);
      const bool in = gm < a.M && gk < a.K;
      const bf* src = x + (long long)gm * a.lda + gk;
      if (a.a_vec) {
        cp_async_n(dst, in ? src : x, in ? min(8, a.K - gk) * 2 : 0);
      } else {
        alignas(16) bf v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = in && gk + e < a.K ? src[e] : __float2bfloat16(0.f);
        st_shared16(dst, v);
      }
    }
  }
  constexpr int kWC = Tl::kRows / 16;  // 16-byte chunks of a k row
  constexpr int kW = kKStep * kWC;
#pragma unroll
  for (int it = 0; it < kW / Tl::kThreads; ++it) {
    const int i = tid + it * Tl::kThreads;
    const int r = i / kWC, c = i % kWC;
    const int gk = k0 + r, gn = n0 + 16 * c;
    const uint32_t dst = ws + wsw<Tl::kRows>(r, c);
    const bool in = gk < a.K && gn < a.N;
    const int8_t* src = a.qw + (long long)gk * a.N + gn;
    if (a.b_vec) {
      cp_async_n(dst, in ? src : a.qw, in ? 16 : 0);
    } else {
      alignas(16) int8_t v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        v[e] = in && gn + e < a.N ? src[e] : (int8_t)0;
      st_shared16(dst, v);
    }
  }
}

// grid (splits, N / kRows, M / NT); the splits of an output tile form a
// cluster.  Two blocks share an SM up to the 128-token tile.
template <int NT, int WG>
__global__ void __launch_bounds__(Tile<NT, WG>::kThreads, NT >= 256 ? 1 : 2)
    int8_tc_kernel(const Args a) {
  using Tl = Tile<NT, WG>;
  using namespace ptt::tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_p = smem_raw + (base - raw);
  const uint32_t x_s = base;  // stage s: x_s + s kXBytes
  const uint32_t w_s = base + Tl::kStages * Tl::kXBytes;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int split = blockIdx.x, splits = gridDim.x;
  const int n0 = blockIdx.y * Tl::kRows, m0 = blockIdx.z * NT;
  const int KT = (a.K + kKStep - 1) / kKStep;
  const int t0 = split * a.chunk;
  const int nt = max(0, min(KT, t0 + a.chunk) - t0);  // this split's steps

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < Tl::kStages - 1; ++s) {
    if (s < nt)
      load_stage<NT, WG>(a, x_s + s * Tl::kXBytes, w_s + s * Tl::kWBytes, m0,
                         n0, t0 + s, tid);
    cp_async_commit();
  }
  // this warp's 16 weight rows: chunk wc of every k row of the w tile
  const int wc = 4 * wg + warp;
  for (int it = 0; it < nt; ++it) {
    // this thread's copies of step it landed; after the barrier, every
    // thread's have, and every warpgroup is done with step it - 1 (it
    // waited for its products), whose stage the next copies take
    cp_async_wait<Tl::kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    const int nx = it + Tl::kStages - 1;
    if (nx < nt)
      load_stage<NT, WG>(a, x_s + (nx % Tl::kStages) * Tl::kXBytes,
                         w_s + (nx % Tl::kStages) * Tl::kWBytes, m0, n0,
                         t0 + nx, tid);
    cp_async_commit();

    const int st = it % Tl::kStages;
    const uint32_t xs = opaque(x_s + st * Tl::kXBytes);
    const uint32_t ws = w_s + st * Tl::kWBytes;
    // k rows 0-31 (k steps 0, 1) and 32-63 (k steps 2, 3): register 2 kk
    // holds k step kk's rows 0-7, register 2 kk + 1 its rows 8-15
    uint32_t wr[8];
    ldsm_x4_t(ws + wsw<Tl::kRows>(lane, wc), wr);
    ldsm_x4_t(ws + wsw<Tl::kRows>(32 + lane, wc), wr + 4);
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      widen(wr[2 * kk], af[kk][0], af[kk][1]);
      widen(wr[2 * kk + 1], af[kk][2], af[kk][3]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      RS<NT, 0>::mma(acc, af[kk], desc_k(xs, NT, kk), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs<NT / 2>(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: partials, then the staged tile

  if (splits > 1) {
    // the leader adds the other splits' partials in split order
    float* part = reinterpret_cast<float*>(base_p);
    cg::cluster_group cl = cg::this_cluster();
    if (split != 0) {
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) part[i * Tl::kThreads + tid] = acc[i];
    }
    cl.sync();
    if (split == 0) {
      for (int s = 1; s < splits; ++s) {
        const float* rp = cl.map_shared_rank(part, s);
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] += rp[i * Tl::kThreads + tid];
      }
    }
    cl.sync();  // no split leaves while the leader still reads it
    if (split != 0) return;
  }

  // this thread's output columns n, n + 1 (A rows g and g + 8 of its warp)
  // and tokens 8 j + 2 (lane % 4) (+1)
  const int nl = 64 * wg + 16 * warp + 2 * (lane >> 2);
  const int n = n0 + nl;
  const float s0 = n < a.N ? a.scale[n] : 0.f;
  const float s1 = n + 1 < a.N ? a.scale[n + 1] : 0.f;
  const bf* bias = static_cast<const bf*>(a.bias);
  const int b0 = n < a.N ? n : 0, b1 = n + 1 < a.N ? n + 1 : 0;
  const int q2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int m = 8 * j + q2;
    *reinterpret_cast<__nv_bfloat162*>(base_p + m * Tl::kPitch + 2 * nl) =
        __halves2bfloat162(epilogue(acc[4 * j], s0, bias, b0),
                           epilogue(acc[4 * j + 2], s1, bias, b1));
    *reinterpret_cast<__nv_bfloat162*>(base_p + (m + 1) * Tl::kPitch +
                                       2 * nl) =
        __halves2bfloat162(epilogue(acc[4 * j + 1], s0, bias, b0),
                           epilogue(acc[4 * j + 3], s1, bias, b1));
  }
  __syncthreads();
  constexpr int kCpr = Tl::kRows / 8;  // 16-byte chunks of an out row
  const int rows = min(NT, a.M - m0);
  bf* out = static_cast<bf*>(a.out);
  for (int i = tid; i < rows * kCpr; i += Tl::kThreads) {
    const int r = i / kCpr, c = i % kCpr;
    const int gn = n0 + 8 * c;
    if (gn >= a.N) continue;
    const unsigned char* src = base_p + r * Tl::kPitch + 16 * c;
    bf* dst = out + (long long)(m0 + r) * a.N + gn;
    if (a.o_vec && gn + 8 <= a.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const bf* v = reinterpret_cast<const bf*>(src);
      for (int e = 0; e < 8 && gn + e < a.N; ++e) dst[e] = v[e];
    }
  }
}

template <int NT, int WG>
cudaError_t launch_tc(const Args& a, int splits, cudaStream_t st) {
  using Tl = Tile<NT, WG>;
  const auto kern = int8_tc_kernel<NT, WG>;
  cudaError_t e = ptt::allow_smem(kern, Tl::kSmem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (a.N + Tl::kRows - 1) / Tl::kRows,
                     (a.M + NT - 1) / NT);
  cfg.blockDim = dim3(Tl::kThreads);
  cfg.dynamicSmemBytes = Tl::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int WG>
cudaError_t launch_tc_tile(const Args& a, int tile, int splits,
                           cudaStream_t st) {
  switch (tile) {
    case 8: return launch_tc<8, WG>(a, splits, st);
    case 16: return launch_tc<16, WG>(a, splits, st);
    case 32: return launch_tc<32, WG>(a, splits, st);
    case 64: return launch_tc<64, WG>(a, splits, st);
    case 128: return launch_tc<128, WG>(a, splits, st);
    case 256: return launch_tc<256, WG>(a, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------ N < 64: warps along a row
constexpr int kNarrowThreads = 256;
constexpr int kNarrowCols = 8;  // output columns per pass over the row

// warps that share a row of x: enough that each lane loads about one 16-byte
// piece of the row (1, 2, 4 or 8); 8 / W rows a block
int narrow_warps(int K, int V) {
  int w = 1;
  while (w < 8 && 32 * w * V < K) w *= 2;
  return w;
}

template <typename T>
__global__ void __launch_bounds__(kNarrowThreads)
    int8_narrow_kernel(const T* __restrict__ x, const int8_t* __restrict__ qw,
                       const float* __restrict__ scale,
                       const T* __restrict__ bias, T* __restrict__ out,
                       int M, int N, int K, long long lda, int a_vec, int W) {
  constexpr int V = 16 / sizeof(T);  // elements of a 16-byte load
  __shared__ float red[kNarrowThreads / 32][kNarrowCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp / W, part = warp % W;  // row of the block, its part
  const int m = blockIdx.x * (kNarrowThreads / 32 / W) + rw;
  const bool live = m < M;  // every warp reaches the barriers
  const int li = 32 * part + lane, lanes = 32 * W;
  const T* xr = x + (long long)(live ? m : 0) * lda;
  for (int c0 = 0; c0 < N; c0 += kNarrowCols) {
    const int nc = min(kNarrowCols, N - c0);
    float acc[kNarrowCols];
#pragma unroll
    for (int c = 0; c < kNarrowCols; ++c) acc[c] = 0.f;
    // lane li of the row takes k in [V li, V li + V), then V lanes further
    for (int k = V * li; live && k < K; k += V * lanes) {
      float xv[V];
      if (a_vec && k + V <= K) {
        ptt::Vec16<T>::load(xr + k, xv);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          xv[e] = k + e < K ? ptt::to_f(xr[k + e]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (k + e < K) {
          const int8_t* wr = qw + (long long)(k + e) * N + c0;
#pragma unroll
          for (int c = 0; c < kNarrowCols; ++c)
            if (c < nc) acc[c] = fmaf(xv[e], (float)__ldg(wr + c), acc[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kNarrowCols; ++c) {
      const float v = ptt::warp_sum(acc[c]);
      if (lane == 0) red[warp][c] = v;
    }
    __syncthreads();
    // the row's first warp adds its warps' sums in order
    if (live && part == 0 && lane < nc) {
      float v = 0.f;
      for (int w = 0; w < W; ++w) v += red[rw * W + w][lane];
      const int n = c0 + lane;
      out[(long long)m * N + n] = epilogue<T>(v, scale[n], bias, n);
    }
    __syncthreads();
  }
}

// ------------------------------------------ float32 x, N >= 64: SIMT tiles
constexpr int kSimtThreads = 256;
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(kSimtThreads)
    int8_simt_kernel(const float* __restrict__ x,
                     const int8_t* __restrict__ qw,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int M, int N, int K, long long lda) {
  // k-major tiles: a thread reads 4 consecutive rows (columns) as a float4
  __shared__ __align__(16) float As[FK][FM + 4];
  __shared__ __align__(16) float Bs[FK][FN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int v = tid; v < FM * FK; v += kSimtThreads) {
      const int r = v / FK, c = v % FK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[(long long)gm * lda + gk] : 0.f;
    }
#pragma unroll
    for (int v = tid; v < FK * FN; v += kSimtThreads) {
      const int r = v / FN, c = v % FN, gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? (float)qw[(long long)gk * N + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
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
      if (gn < N)
        out[(long long)gm * N + gn] =
            epilogue<float>(acc[i][j], scale[gn], bias, gn);
    }
  }
}

enum Kind { kWgmma = 0, kNarrow = 1, kSimt = 2 };

bool valid_plan(int kind, int dtype, int M, int N, int K, int tile, int rows,
                int splits) {
  if (M <= 0 || N <= 0 || K < 0) return false;
  if (dtype != ptt::kFloat32 && dtype != ptt::kBFloat16) return false;
  if (kind == kNarrow) return splits == 1;
  if (kind == kSimt)
    return dtype == ptt::kFloat32 && splits == 1 && (M + FM - 1) / FM <= 65535;
  if (kind != kWgmma || dtype != ptt::kBFloat16) return false;
  if (!(tile == 8 || tile == 16 || tile == 32 || tile == 64 || tile == 128 ||
        tile == 256) ||
      !(rows == 64 || rows == 128) ||
      !(splits == 1 || splits == 2 || splits == 4 || splits == kMaxSplits))
    return false;
  if ((N + rows - 1) / rows > 65535 || (M + tile - 1) / tile > 65535)
    return false;
  const int KT = (K + kKStep - 1) / kKStep;
  const int chunk = splits == 1 ? KT : (KT + splits - 1) / splits;
  // every split has at least one K step
  return splits == 1 || (long long)(splits - 1) * chunk < KT;
}

}  // namespace

// x (dtype, rows lda elements apart), qw int8 [K, N], scale float32 [N],
// bias (dtype) [N] or null, out (dtype) [M, N]; kind 0 wgmma (bfloat16),
// 1 narrow (either dtype), 2 SIMT (float32), with the plan's token tile,
// weight rows and splits (the wgmma kind's; 1 otherwise).  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a plan the instances do
// not take).
extern "C" int ptt_int8_matmul(const void* x, const void* qw,
                               const void* scale, const void* bias, void* out,
                               int M, int N, int K, long long lda, int kind,
                               int tile, int rows, int splits, int dtype,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!valid_plan(kind, dtype, M, N, K, tile, rows, splits))
    return (int)cudaErrorInvalidValue;
  if (kind == kNarrow) {
    const int V = dtype == ptt::kBFloat16 ? 8 : 4;
    const int W = narrow_warps(K, V);
    const int rows = kNarrowThreads / 32 / W;
    const int grid = (M + rows - 1) / rows;
    const int a_vec = ((uintptr_t)x % 16 == 0) && (lda % V == 0);
    if (dtype == ptt::kBFloat16)
      int8_narrow_kernel<bf><<<grid, kNarrowThreads, 0, st>>>(
          (const bf*)x, (const int8_t*)qw, (const float*)scale,
          (const bf*)bias, (bf*)out, M, N, K, lda, a_vec, W);
    else
      int8_narrow_kernel<float><<<grid, kNarrowThreads, 0, st>>>(
          (const float*)x, (const int8_t*)qw, (const float*)scale,
          (const float*)bias, (float*)out, M, N, K, lda, a_vec, W);
    return (int)cudaGetLastError();
  }
  if (kind == kSimt) {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    int8_simt_kernel<<<grid, kSimtThreads, 0, st>>>(
        (const float*)x, (const int8_t*)qw, (const float*)scale,
        (const float*)bias, (float*)out, M, N, K, lda);
    return (int)cudaGetLastError();
  }
  Args a;
  a.x = x;
  a.qw = (const int8_t*)qw;
  a.scale = (const float*)scale;
  a.bias = bias;
  a.out = out;
  a.M = M, a.N = N, a.K = K;
  a.lda = lda;
  a.a_vec = ((uintptr_t)x % 16 == 0) && (lda % 8 == 0);
  a.b_vec = ((uintptr_t)qw % 16 == 0) && (N % 16 == 0);
  a.o_vec = ((uintptr_t)out % 16 == 0) && (N % 8 == 0);
  const int KT = (K + kKStep - 1) / kKStep;
  a.chunk = (KT + splits - 1) / splits;
  return rows == 64 ? (int)launch_tc_tile<1>(a, tile, splits, st)
                    : (int)launch_tc_tile<2>(a, tile, splits, st);
}
