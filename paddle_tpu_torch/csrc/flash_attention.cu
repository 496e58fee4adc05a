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
// head, halved by the causal mask; 989 TFLOP/s in bf16 on the tensor
// cores), bytes for a single query row (3.35 TB/s).
//
// bfloat16 runs on the tensor cores (flash_fwd_tc_kernel).  One block per
// (head, batch, query tile of BQ rows), 64 rows per consumer warpgroup.
// The query tile is copied once into shared memory in the 128-byte swizzled
// layout the wgmma descriptors name; K and V tiles of BK keys arrive through
// two-stage cp.async rings (16-byte copies by every thread, zero-filled past
// Sk and past D), V one tile behind K.  S = Q K^T is a wgmma with both
// operands in shared memory; the online softmax runs on the accumulator
// fragment in registers (a row's max and sum over the 4 threads of a quad,
// exp2 with the scale folded into log2 units); P is converted to bf16 in
// registers and is the A operand of O += P V (the RS form), V read in its
// natural [keys, D] layout through the transpose bit.  Scores never touch
// shared memory.  Iteration t issues S_t and, behind it, the previous
// tile's P V, and runs tile t's softmax while that product is on the tensor
// cores (FlashAttention-3's intra-warpgroup overlap); the two warpgroups of
// a 128-row tile interleave on their own.  The causal mask is applied only
// on tiles that cross the bound or the keys' end; tiles past the bound of
// the tile's last row are never loaded (the first warpgroup of a 128-row
// tile computes the one or two diagonal tiles that only its partner sees:
// products issued under a condition make ptxas serialize every wgmma).  The
// grid runs the longest causal query tiles first.  Tiles
// (BQ, BK) by D come from ops/hopper/autotune.py's table; a pair with no
// instance here is refused.  What it leaves on the table: no producer warp
// or TMA (every thread issues copies), no ping-pong scheduling between the
// warpgroups, and a 64-row tile for a single query row (the growing-cache
// step wastes 63 of 64 rows of the products; it is bound by K/V bytes).
//
// float32 stays on the SIMT cores (67 TFLOP/s at most; the port pins TF32
// off): one block of 256 threads per (64-row query tile, head, batch).  The
// query tile (pre-scaled) and each 64-key K and V tile are staged in shared
// memory as float32, read from device memory in 16-byte vectors; Q and K
// rows are padded by one float so the score loop reads them without bank
// conflicts.  Each thread owns a 4 x 4 block of scores (rows ty + 16 i,
// columns tx + 16 j) and the accumulator of those 4 rows at dims tx + 16 j;
// each warp runs the online softmax of 8 rows.  Key tiles wholly past the
// causal bound of the query tile's last row are never loaded.  Shared memory
// is 113 KB at D = 128 and 210 KB at D = 256, past the 48 KB default: the
// entry opts the kernel in.
//
// Head dims.  The entry takes any D that is a multiple of 8 (the
// wrapper zero-pads q, k and v to the next multiple of 8 and slices the
// output: exact, the padded columns add 0 to every score and give 0
// outputs; the scale stays that of the true D).  Up to 256 the tensor-core
// instances zero-fill the columns past D to their width (64, 128 or 256)
// and store only columns < D; the SIMT instance's threads own the columns
// tx + 16 j < D.  Past 256 the columns of a 64-row tile do not fit the
// 227 KB a block may use (about 400 KB in float32 at D 512), so a SIMT
// instance with 32-row query and key tiles (201 KB at D 512) serves both
// float32 and bfloat16: simple and right, not fast.  Past 512 (Queue C8)
// a row does not fit at all: the wide instance (flash_fwd_wide_kernel,
// the walk of wide_attention.cuh) streams Q and K through shared memory
// in 64-column chunks for the scores, and each block writes one slice of
// at most 512 output columns (a grid axis takes the slices; the scores
// are recomputed for each), 32 query rows and 32-key tiles a block, in
// both dtypes; the first slice writes the logsumexp.
#include <math.h>

#include "common.cuh"
#include "wgmma.cuh"
#include "wide_attention.cuh"

namespace {

// ------------------------------------- float32 (and D > 256): SIMT instances
constexpr int kThreads = 256;  // 16 x 16: tx = column group, ty = row group
constexpr float kNegInf = -1e30f;

// DC: the largest ceil(D / 16) this instance takes; BQ query rows a block,
// BK keys a tile (64 x 64 up to D 256, 32 x 32 past it)
template <typename T, int DC, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    const int* __restrict__ q_off_ptr, int Sq, int Sk, int H, int KVH, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int q_off_host, float scale) {
  using V = ptt::Vec16<T>;
  constexpr int RI = BQ / 16;          // score rows a thread owns
  constexpr int CJ = BK / 16;          // score columns a thread owns
  constexpr int LJ = BK / 32;          // a row's entries a lane takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int DP = D + 1;                // padded row of Q and K
  const int SP = BK + 1;               // padded row of the scores
  float* qs = (float*)smem_raw;        // BQ * DP, scaled queries
  float* ks = qs + BQ * DP;            // BK * DP
  float* vs = ks + BK * DP;            // BK * D
  float* ss = vs + BK * D;             // BQ * SP scores, then probabilities
  float* m_s = ss + BQ * SP;           // BQ running max
  float* l_s = m_s + BQ;               // BQ running sum
  float* c_s = l_s + BQ;               // BQ rescale of this tile

  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * BQ;
  const int kh = h / (H / KVH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // column groups in use, the same for every thread (a group past D reads
  // shared memory past the row and is never stored)
  const int nd = (D + 15) / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int nv = D / V::N;             // 16-byte vectors per row (D % 8 == 0)
  const int off = q_off_ptr != nullptr ? *q_off_ptr : q_off_host;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int i = tid; i < BQ * nv; i += kThreads) {
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
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // key tiles any row of this query tile can see
  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const long long last = (long long)r0 + BQ - 1 + off;
    const long long lim = last < 0 ? 0 : last / BK + 1;
    if (lim < n_tiles) n_tiles = (int)lim;
  }

  float acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BK;
    // the previous tile's P @ V is done with ks/vs/ss (before the first
    // tile: the query tile and m/l are written)
    __syncthreads();
    for (int i = tid; i < BK * nv; i += kThreads) {
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
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RI], kk[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kk[j] = ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = r0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool ok = row < Sq && col < Sk && (!causal || col <= row + off);
        ss[(ty + 16 * i) * SP + tx + 16 * j] = ok ? s[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows w BQ / 8 .. (w + 1) BQ / 8 - 1
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = ss + r * SP;
      float x[LJ];
      // a masked score counts as -1e30 in the max, as the Pallas kernel's
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < LJ; ++e) {
        x[e] = row[lane + 32 * e];
        mx = fmaxf(mx, x[e]);
      }
      mx = ptt::warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < LJ; ++e) {
        const float p = x[e] == -INFINITY ? 0.f : expf(x[e] - m_new);
        row[lane + 32 * e] = p;
        part += p;
      }
      const float sum = ptt::warp_sum(part);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        c_s[r] = c;
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * c + P @ V over this tile's keys; thread tx owns the
    // columns tx + 16 j < D
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float c = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= c;
    }
    for (int jj = 0; jj < BK; ++jj) {
      float p[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = ss[(ty + 16 * i) * SP + jj];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        if (j < nd) {
          const float vv = vs[jj * D + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();  // m/l final (also when no tile was visible)

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, row = r0 + r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* o = out + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (tx + 16 * j < D)
        o[tx + 16 * j] = ptt::from_f<T>(acc[i][j] * inv);
  }
  if (tid < BQ && r0 + tid < Sq)
    lse[((long long)b * H + h) * Sq + r0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

size_t smem_bytes(int D, int BQ, int BK) {
  return (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) +
                  3 * BQ) *
         sizeof(float);
}

template <typename T, int DC, int BQ, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* q_off, int B, int Sq, int Sk, int H,
                   int KVH, int D, long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh, long long vsb,
                   long long vss, long long vsh, int causal, int q_off_host,
                   float scale, cudaStream_t st) {
  const size_t smem = smem_bytes(D, BQ, BK);
  cudaError_t e = ptt::allow_smem(flash_fwd_kernel<T, DC, BQ, BK>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DC, BQ, BK><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse,
      (const int*)q_off, Sq, Sk, H, KVH, D, qsb, qss, qsh, ksb, kss, ksh, vsb,
      vss, vsh, causal, q_off_host, scale);
  return cudaGetLastError();
}


// ------------------------------------------ bfloat16: tensor-core instances
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdArgs {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* out;
  float* lse;
  const int* q_off_ptr;
  int Sq, Sk, H, KVH, D;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, q_off_host;
  float scale;
};

// one instance per (DP, BQ, BK): DP the head dim rounded up to 64 (columns
// past D are zero-filled), BQ = 64 rows per consumer warpgroup, BK keys
template <int DP, int BQ, int BK>
struct FwdTile {
  static constexpr int kWG = BQ / 64;
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kQBytes = BQ * DP * 2;
  static constexpr int kKVBytes = BK * DP * 2;  // one K or V tile
  // Q, then two stages of (K, V); +1024 to align the base
  static constexpr int kSmem = kQBytes + 4 * kKVBytes + 1024;
};

template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(FwdTile<DP, BQ, BK>::kThreads, 1)
    flash_fwd_tc_kernel(const FwdArgs a) {
  using Tl = FwdTile<DP, BQ, BK>;
  using namespace ptt::tc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + Tl::kQBytes;  // stage s: K, then V

  const int tid = threadIdx.x, wg = tid / 128;
  const int lane = tid % 32, warp = (tid % 128) / 32;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  // the longest causal query tiles first: the grid's tail is short
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kh = h / (a.H / a.KVH);
  const int off = a.q_off_ptr != nullptr ? *a.q_off_ptr : a.q_off_host;

  const __nv_bfloat16* qb = a.q + b * a.qsb + h * a.qsh;
  const __nv_bfloat16* kb = a.k + b * a.ksb + kh * a.ksh;
  const __nv_bfloat16* vb = a.v + b * a.vsb + kh * a.vsh;

  // key tiles any row of this query tile can see
  int n_tiles = (a.Sk + BK - 1) / BK;
  if (a.causal) {
    const int rows = a.Sq - r0 < BQ ? a.Sq - r0 : BQ;
    const long long last = (long long)r0 + rows - 1 + off;
    const long long lim = last < 0 ? 0 : last / BK + 1;
    if (lim < n_tiles) n_tiles = (int)lim;
  }

  load_tile<BQ, DP, Tl::kThreads>(q_s, qb, a.qss, r0, a.Sq, a.D, tid);
  if (n_tiles > 0)
    load_tile<BK, DP, Tl::kThreads>(kv_s, kb, a.kss, 0, a.Sk, a.D, tid);
  cp_async_commit();

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  // running max (log2 units; a masked score counts as -1e30) and this
  // thread's share of the running sum, for rows g and g + 8
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int wrow0 = r0 + wg * 64;  // this warpgroup's first row
  const int row = wrow0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float sl2 = a.scale * kLog2e;
  const uint32_t q_wg = q_s + wg * 64 * 128;

  float s[BK / 2];
  uint32_t pa[BK / 16][4];  // P of the previous tile, bf16 A fragments
  float c[2];               // this tile's rescale of O

  // the tile's scores in s -> probabilities, m and l updated, c set
  auto softmax = [&](int t) {
    const int c0 = t * BK;
    // masked only where the tile crosses the causal bound or the keys' end
    // (both warpgroups walk the block's tiles; a tile past one warpgroup's
    // rows is all masked there and adds nothing)
    const bool edge =
        c0 + BK > a.Sk ||
        (a.causal && (long long)c0 + BK - 1 > (long long)wrow0 + off);
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int col = c0 + 8 * (i / 4) + cq + (i & 1);
        const int r = row + ((i & 2) ? 8 : 0);
        const bool out = col >= a.Sk || (a.causal && col > r + off);
        s[i] = out ? -INFINITY : s[i] * sl2;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= sl2;
    }
    // a row lives in the 4 threads of a quad
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * rh], s[4 * j + 2 * rh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rh], mx);
      c[rh] = exp2f(m[rh] - m_new);
      m[rh] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[4 * j + 2 * rh + e] - m_new);
          s[4 * j + 2 * rh + e] = p;
          sum += p;
        }
      l[rh] = l[rh] * c[rh] + sum;
    }
  };
  // wait for the copies, make them visible to every thread and the async
  // proxy; then K_{t+1} and V_t load, each into the stage its tile t - 1
  // left (every warpgroup is past the barrier, so done with it)
  auto advance = [&](int t) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (t + 1 < n_tiles)
      load_tile<BK, DP, Tl::kThreads>(
          kv_s + ((t + 1) & 1) * 2 * Tl::kKVBytes, kb, a.kss, (t + 1) * BK,
          a.Sk, a.D, tid);
    if (t < n_tiles)
      load_tile<BK, DP, Tl::kThreads>(
          kv_s + (t & 1) * 2 * Tl::kKVBytes + Tl::kKVBytes, vb, a.vss,
          t * BK, a.Sk, a.D, tid);
    cp_async_commit();
  };
  auto issue_s = [&](int t) {
    const uint32_t q_d = opaque(q_wg);
    const uint32_t k_t = opaque(kv_s + (t & 1) * 2 * Tl::kKVBytes);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      SS<BK, 0, 0>::mma(s, desc_k(q_d, BQ, kk), desc_k(k_t, BK, kk), kk);
    wg_commit();
  };
  // O += P V of tile t: P from pa, V MN-major
  auto issue_pv = [&](int t) {
    const uint32_t v_t =
        opaque(kv_s + (t & 1) * 2 * Tl::kKVBytes + Tl::kKVBytes);
    fence_regs<DP / 2>(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      RS<DP, 1>::mma(o, pa[kk], desc_mn(v_t, BK, kk), 1);
    wg_commit();
  };

  // Iteration t issues S_t and, behind it, tile t - 1's O += P V, and runs
  // tile t's softmax while that product is on the tensor cores.  Tile 0's
  // scores come first, the last product after the loop: no product is
  // issued under a condition (ptxas would serialize every wgmma).
  if (n_tiles > 0) {
    advance(0);
    issue_s(0);
    wg_wait<0>();
    fence_regs<BK / 2>(s);
    softmax(0);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(s, kk, pa[kk]);
  }
  for (int t = 1; t < n_tiles; ++t) {
    advance(t);
    issue_s(t);
    issue_pv(t - 1);
    wg_wait<1>();  // S_t is done; the product may still run
    fence_regs<BK / 2>(s);
    softmax(t);
    // pin the softmax before the wait: the compiler would otherwise sink
    // the exponentials below it and lose the overlap with the product
    fence_regs<BK / 2>(s);
    fence_regs<2>(c);
    fence_regs<2>(l);
    wg_wait<0>();
    fence_regs<DP / 2>(o);
    // O, now holding tile t - 1's product, to tile t's max; P to bf16
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= c[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) acc_to_a(s, kk, pa[kk]);
  }
  if (n_tiles > 0) {
    advance(n_tiles);  // V of the last tile
    issue_pv(n_tiles - 1);
    wg_wait<0>();
    fence_regs<DP / 2>(o);
  }
  cp_async_wait<0>();  // no copy outlives the block (a block may see no tile)

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
    const int r = row + 8 * rh;
    if (r >= a.Sq) continue;
    // a row that saw no key: zeros and lse -1e30, as the reference
    const float inv = 1.f / fmaxf(l[rh], 1e-30f);
    __nv_bfloat16* dst = a.out + (((long long)b * a.Sq + r) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < a.D)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            o[4 * j + 2 * rh] * inv, o[4 * j + 2 * rh + 1] * inv);
    }
    if (lane % 4 == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + r] =
          l[rh] > 0.f ? m[rh] * kLn2 + logf(l[rh]) : kNegInf;
  }
}

template <int DP, int BQ, int BK>
cudaError_t launch_tc(const FwdArgs& a, int B, cudaStream_t st) {
  using Tl = FwdTile<DP, BQ, BK>;
  cudaError_t e = ptt::allow_smem(flash_fwd_tc_kernel<DP, BQ, BK>, Tl::kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(B * a.H, (a.Sq + BQ - 1) / BQ);
  flash_fwd_tc_kernel<DP, BQ, BK><<<grid, Tl::kThreads, Tl::kSmem, st>>>(a);
  return cudaGetLastError();
}

// ------------------------------- past 512 columns (Queue C8): both dtypes
constexpr int kWideRows = 32;  // query rows a block (the (32, 32) pair)

// the rows of one block for the shared walk: query rows r0 .. r0 + R - 1
// of one head, its KV head's keys, causal rows seeing col <= row + off
template <typename T>
struct FwdRows {
  const T *qb, *kb, *vb;
  T* ob;  // output row r0 (rows H * D apart)
  long long qss, kss, vss, ors;
  int r0, Sq, off, causal;
  __device__ const T* q(int r) const { return qb + (r0 + r) * qss; }
  __device__ const T* k(int key) const { return kb + key * kss; }
  __device__ const T* v(int key) const { return vb + key * vss; }
  __device__ bool vis(int r, int key) const {
    return !causal || key <= r0 + r + off;
  }
  __device__ void put(int r, int d, float x) const {
    ob[r * ors + d] = ptt::from_f<T>(x);
  }
};

// one block per (32-row query tile, head x slice, batch)
template <typename T>
__global__ void __launch_bounds__(ptt::wide::kThreads) flash_fwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    const int* __restrict__ q_off_ptr, int Sq, int Sk, int H, int KVH, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int q_off_host, float scale, int W, int NS) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y / NS, s = blockIdx.y - h * NS, b = blockIdx.z;
  const int r0 = blockIdx.x * kWideRows;
  const int R = min(kWideRows, Sq - r0);
  const int kh = h / (H / KVH);
  const int off = q_off_ptr != nullptr ? *q_off_ptr : q_off_host;
  // the keys any row of this tile can see
  int c1 = Sk;
  if (causal) {
    const long long last = (long long)r0 + R - 1 + off;
    c1 = last < 0 ? 0 : (int)(last + 1 < Sk ? last + 1 : Sk);
  }
  const FwdRows<T> src{q + b * qsb + h * qsh,
                       k + b * ksb + kh * ksh,
                       v + b * vsb + kh * vsh,
                       out + (((long long)b * Sq + r0) * H + h) * D,
                       qss, kss, vss, (long long)H * D, r0, Sq, off,
                       causal};
  const ptt::wide::Stats st = ptt::wide::attend<T>(
      src, R, D, 0, c1, s * W, W, scale * kLog2e, smem_raw);
  if (s == 0)
    for (int r = threadIdx.x; r < R; r += ptt::wide::kThreads)
      lse[((long long)b * H + h) * Sq + r0 + r] =
          st.l[r] > 0.f ? st.m[r] * kLn2 + logf(st.l[r]) : kNegInf;
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v,
                        void* out, void* lse, const void* q_off, int B,
                        int Sq, int Sk, int H, int KVH, int D, long long qsb,
                        long long qss, long long qsh, long long ksb,
                        long long kss, long long ksh, long long vsb,
                        long long vss, long long vsh, int causal,
                        int q_off_host, float scale, cudaStream_t st) {
  const int W = ptt::wide::slice_cols(kWideRows, D);
  const int NS = (D + W - 1) / W;
  if ((long long)H * NS > 65535) return cudaErrorInvalidConfiguration;
  const size_t smem = ptt::wide::smem_bytes(kWideRows, W);
  cudaError_t e = ptt::allow_smem(flash_fwd_wide_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + kWideRows - 1) / kWideRows, H * NS, B);
  flash_fwd_wide_kernel<T><<<grid, ptt::wide::kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse,
      (const int*)q_off, Sq, Sk, H, KVH, D, qsb, qss, qsh, ksb, kss, ksh, vsb,
      vss, vsh, causal, q_off_host, scale, W, NS);
  return cudaGetLastError();
}

// the compiled (dtype, D, tile) table; the Python side mirrors it
// (ops/hopper/autotune.py INSTANCES) and a pair missing here is refused
cudaError_t dispatch_tc(const FwdArgs& a, int B, int bq, int bk,
                        cudaStream_t st) {
  const int DP = a.D <= 64 ? 64 : a.D <= 128 ? 128 : 256;
#define PTT_FWD(dp, q_, k_) \
  if (DP == dp && bq == q_ && bk == k_) return launch_tc<dp, q_, k_>(a, B, st)
  PTT_FWD(64, 64, 64);
  PTT_FWD(128, 128, 64);
  PTT_FWD(128, 64, 64);
  PTT_FWD(256, 128, 64);
  PTT_FWD(256, 64, 64);
#undef PTT_FWD
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int ptt_flash_attention(
    const void* q, const void* k, const void* v, void* out, void* lse,
    const void* q_off, int B, int Sq, int Sk, int H, int KVH, int D,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, int causal,
    int q_off_host, float scale, int block_q, int block_k, int dtype,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 0 || D % 8 || KVH <= 0 || H % KVH)
    return (int)cudaErrorInvalidValue;
  if (dtype != ptt::kFloat32 && dtype != ptt::kBFloat16)
    return (int)cudaErrorInvalidValue;
  if (dtype == ptt::kFloat32 || D > 256) {
    // the SIMT instances: one square tile pair each, 64 up to D 256, 32
    // past it (those past 256 columns also serve bfloat16)
    const int bt = D <= 256 ? 64 : 32;
    if (block_q != bt || block_k != bt) return (int)cudaErrorInvalidValue;
#define PTT_FWD_ARGS                                                        \
  q, k, v, out, lse, q_off, B, Sq, Sk, H, KVH, D, qsb, qss, qsh, ksb, kss, \
      ksh, vsb, vss, vsh, causal, q_off_host, scale, st
    if (D > 512)
      return dtype == ptt::kFloat32
                 ? (int)launch_wide<float>(PTT_FWD_ARGS)
                 : (int)launch_wide<__nv_bfloat16>(PTT_FWD_ARGS);
    if (D > 256)
      return dtype == ptt::kFloat32
                 ? (int)launch<float, 32, 32, 32>(PTT_FWD_ARGS)
                 : (int)launch<__nv_bfloat16, 32, 32, 32>(PTT_FWD_ARGS);
    if (D <= 64) return (int)launch<float, 4, 64, 64>(PTT_FWD_ARGS);
    if (D <= 128) return (int)launch<float, 8, 64, 64>(PTT_FWD_ARGS);
    return (int)launch<float, 16, 64, 64>(PTT_FWD_ARGS);
#undef PTT_FWD_ARGS
  }
  const FwdArgs a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                  (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (float*)lse,
                  (const int*)q_off, Sq, Sk, H, KVH, D, qsb, qss, qsh, ksb,
                  kss, ksh, vsb, vss, vsh, causal, q_off_host, scale};
  return (int)dispatch_tc(a, B, block_q, block_k, st);
}
