// Decode attention over the static KV ring (kernel B2) and the in-place ring
// write (kernel B3).
//
// B2 replaces paddle_tpu/ops/pallas/decode_attention.py:decode_attention
// (its _decode_kernel): one query token per row, q [B, 1, H, D], against
// the ring kbuf/vbuf [B, L, KVH, D] in its native layout, columns
// 0 .. pos (pos read from device memory, clamped to [0, L - 1]), softmax in
// float32 with scale 1/sqrt(D) by default; query head h reads KV head
// h / (H / KVH); the output in q's dtype, rounded once.
//
// Bound on the H100: bytes, plus a fixed cost per launch at small contexts.
// Every visible key and value row is needed once per (row, KV head), and a
// step does ~2 operations per byte read (at most G = H / KVH times that),
// far below the ~295 a byte the card needs before arithmetic bounds.  At
// generation's contexts (a few hundred keys a row) a call moves a few tens
// of MB, a handful of microseconds at 3.35 TB/s, so reading pos, the first
// tile's latency and the merge weigh as much as the stream.  The design:
// * One block takes one row, one KV head and up to 16 of its query heads
//   (the rows of one m16 tile), so every key and value row loaded serves
//   the whole group; a group of more than 16 heads takes several blocks,
//   which re-read the context.
// * The context is split by the device's own pos.  The grid,
//   (splits, KVH * head chunks, B), comes from host sizes alone, so a
//   decode loop needs no host sync and can be captured; each of the
//   `splits` blocks of a (row, head chunk) reads pos and takes an even,
//   key-tile-aligned share of keys 0 .. pos, so every split carries work
//   whatever pos is (a split past the keys keeps m = -inf, l = 0).
// * One launch per call: the splits of a (row, head chunk) form a thread
//   block cluster, and after cluster.sync() the leader merges the others'
//   (m, l, acc) through distributed shared memory, every remote load of a
//   row in flight at once, and writes the output.  Nothing but the output
//   goes to device memory.
// * K and V tiles of KT keys (64 on the tensor cores, 32 on SIMT) arrive
//   together by 16-byte cp.async (consecutive threads on consecutive 16
//   bytes of a row: every load coalesced) in a ring of two tiles, the next
//   in flight while one is computed on; only a share's last tile is
//   masked; the online softmax keeps float32 (m, l, acc) per head across
//   tiles.  The copies are evict-first in L2 (a step reads each row once:
//   the lines it evicts are its own, not what the kernels around it keep
//   there).  Rows are padded to an odd number of 16-byte chunks in shared
//   memory, so neighbouring rows' 16-byte reads (and ldmatrix's) hit no
//   bank twice.  Deeper rings, larger tiles and the copy engine (TMA)
//   measured no faster at generation's contexts: a tile's critical path
//   in the block, not its load, sets the pace there.
// * bfloat16 runs on the tensor cores: the block's heads are the rows of
//   mma.sync.m16n8k16 (padded to 16), each warp takes a quarter of every
//   key tile with its own online softmax in registers, P goes to bf16 for
//   P @ V without leaving registers, and the warps' (m, l, O) merge at the
//   end.  float32 (TF32 stays off) runs a SIMT instance of the same walk:
//   thread-per-key scores and column-chunk P @ V from shared memory.
// Head dims.  Every D.  The tensor-core instance takes bfloat16
// with D a multiple of 8 up to 256 (columns past D zero to 64, 128 or 256).
// The SIMT instance takes the rest: float32, and bfloat16 with D not a
// multiple of 8 or past 256.  It holds D padded to a multiple of 8 (DA) in
// shared memory, zero past D, and reads the ring in place in the largest
// pieces a row's bytes allow (16, 8, 4 or 2; a per-call pad would copy
// the whole ring); past 256 columns float32 takes 16-key tiles, so a block
// stays within 227 KB (about 200 KB at D 512).  Past 512 (Queue C8) a
// row does not fit a block whole: the wide instance (decode_wide_kernel,
// the walk of wide_attention.cuh, both dtypes, no cluster split) streams
// the query rows and K through shared memory in 64-column chunks for the
// scores, and each block writes one slice of at most 512 output columns
// (a grid axis takes the slices; the scores are recomputed for each).
// A negative pos sees no key: the output is zeros, as the Pallas kernel
// gives (it skips every tile past pos, and its l stays 0).
// The number of splits comes from ops/hopper/decode_attention.py:
// decode_plan; the entry refuses any other (not 1, 2, 4 or 8, more splits
// than the ring has key tiles) and a block past the shared memory it may
// use.
//
// B3 replaces decode_attention.py:kv_ring_write: new [B, S, KVH, D] is
// written into the ring at rows start .. start + S - 1, in place, with
// start read from device memory as dynamic_update_slice takes it (which
// the reference's S > 1 path uses, and the Pallas kernel's index map
// matches): a negative pos first counts from the end (pos + L), then the
// start is clamped to [0, L - S].  One launch writes the K and the V ring.
// Bound by bytes; one block per (row, token) copies its [KVH, D] rows of K
// and V in the largest pieces (16, 8, 4 or 2 bytes) the row and the
// pointers allow.  The generation path folds it into K2's launch
// (fused_ops.cu, the ring mode); this entry serves kv_ring_write's own
// callers.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"
#include "wide_attention.cuh"

namespace cg = cooperative_groups;

namespace {

using bf = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;        // query heads a block takes (an m16 tile)
constexpr int kVec = 8;          // elements of a row a SIMT thread takes
constexpr int kRowsPerPass = 4;  // query rows a SIMT thread carries
constexpr int kMaxSplits = 8;    // blocks of a cluster (the portable size)
constexpr int kStages = 2;       // tiles of the K/V ring
constexpr int kTcKeys = 64;      // keys of a tile, tensor cores
constexpr int kSimtKeys = 32;    // keys of a tile, SIMT

// 16-byte chunks of one K or V row in shared memory: `cols` elements,
// padded to an odd count so that 8 threads reading chunk c of 8
// neighbouring rows (or ldmatrix's 8 row addresses) hit 32 different banks
__host__ __device__ inline int row_chunks(int cols, int es) {
  const int c = cols * es / 16;
  return c + !(c & 1);
}

// the tensor-core instance's head-dim class (columns past D are zeros)
__host__ __device__ inline int tc_cols(int D) {
  return D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// which instance a call runs: the tensor cores for bfloat16 with D a
// multiple of 8 up to 256, SIMT otherwise
__host__ __device__ inline bool uses_tc(int es, int D) {
  return es == 2 && D % 8 == 0 && D <= 256;
}

// the SIMT instance's columns: D padded to a multiple of kVec (zeros past D)
__host__ __device__ inline int simt_cols(int D) {
  return (D + kVec - 1) / kVec * kVec;
}

// the SIMT instance's key tile: 16 keys for float32 past 256 columns (the
// ring of two tiles stays within the block's shared memory), else 32
__host__ __device__ inline int simt_keys(int es, int D) {
  return es == 4 && D > 256 ? 16 : kSimtKeys;
}

// query heads of a block: the whole group, at most one m16 tile
__host__ __device__ inline int block_rows(int G) {
  return G < kRows ? G : kRows;
}

// The shared-memory layout of one block, in bytes; mirrored by
// ops/hopper/decode_attention.py:_smem_bytes, by which the plan picks its
// tiles.  A launch whose layout needs more than the card grants is refused
// (cudaErrorInvalidConfiguration, ptt::allow_smem).
struct Layout {
  int KG;       // key groups (partial accumulators)
  int RP;       // query rows held (the tensor-core instance pads to 16)
  int rstride;  // elements between two K (V) rows of a tile
  // byte offsets: the K/V ring, query rows, SIMT scores, accumulators, row
  // statistics, the key groups' (m, l), the leader's merge weights
  size_t stage, q, s, acc, stats, part, ws, total;
};

__host__ __device__ inline Layout layout(bool tc, int R, int D, int es,
                                         int splits) {
  Layout L = {};
  size_t off = 0;
  const int KT = tc ? kTcKeys : simt_keys(es, D);
  if (tc) {
    const int DP = tc_cols(D);
    L.KG = kWarps;
    L.RP = kRows;
    L.rstride = row_chunks(DP, 2) * 8;
    L.stage = off;  // kStages x (K tile, V tile), bf16
    off += (size_t)2 * kStages * KT * L.rstride * 2;
    L.acc = L.stage;  // KG x RP x DP float, after the walk (fits the ring)
    L.q = off;  // RP x DP query rows, bf16, zero-padded
    off += (size_t)L.RP * L.rstride * 2;
    L.stats = off;  // m, l (float) by row
    off += (size_t)2 * L.RP * 4;
    L.part = off;  // each key group's m and l by row
    off += (size_t)2 * L.KG * L.RP * 4;
  } else {
    const int DA = simt_cols(D);
    const int slots = kThreads / (DA / kVec);  // threads on a column chunk
    L.KG = 1;
    while (L.KG * 2 * R <= slots) L.KG *= 2;
    L.RP = R;
    L.rstride = row_chunks(DA, es) * 16 / es;
    L.stage = off;  // kStages x (K tile, V tile)
    off += (size_t)2 * kStages * KT * L.rstride * es;
    L.q = off;  // R x DA query rows, float, pre-scaled
    off += (size_t)R * DA * 4;
    L.s = off;  // R x KT scores, then probabilities
    off += (size_t)R * KT * 4;
    L.acc = off;  // KG x R x DA float accumulators
    off += (size_t)L.KG * R * DA * 4;
    L.stats = off;  // m, l, corr (float) by row
    off += (size_t)3 * R * 4;
  }
  L.ws = off;  // the leader's merge: splits x RP weights (first the
  off += (size_t)(2 * splits + 1) * L.RP * 4;  // m), splits x RP l, 1 / L
  L.total = off;
  return L;
}

// What a block works on: row b, KV head kh, query heads h0 .. h0 + nr - 1
// (from the grid), and keys c0 .. c1 - 1 of the visible 0 .. pos, its
// split's share (from pos)
struct Work {
  int b, kh, h0, nr, c0, c1;
};

__device__ __forceinline__ Work block_heads(int H, int KVH, int n_hc) {
  Work w;
  const int G = H / KVH;
  w.b = blockIdx.z;
  w.kh = blockIdx.y / n_hc;
  const int hc = blockIdx.y - w.kh * n_hc;
  w.h0 = w.kh * G + hc * kRows;
  w.nr = min(kRows, G - hc * kRows);
  w.c0 = w.c1 = 0;
  return w;
}

// The split's share: keys [s chunk, (s + 1) chunk) cut at pos + 1,
// chunk = ceil(ceil((pos + 1) / splits) / KT) KT; mirrored by the tests'
// split_ranges.  Returns the share's key tiles (none for a negative pos).
__device__ __forceinline__ int block_keys(Work& w,
                                          const int* __restrict__ pos_ptr,
                                          int L, int KT) {
  const int n = max(0, min(*pos_ptr, L - 1) + 1);  // visible keys
  const int splits = gridDim.x;
  const int chunk = ((n + splits - 1) / splits + KT - 1) / KT * KT;
  w.c0 = min((int)blockIdx.x * chunk, n);
  w.c1 = min(w.c0 + chunk, n);
  return (w.c1 - w.c0 + KT - 1) / KT;
}

// How a thread copies K and V rows in pieces of `bytes` (16, 8, 4 or 2:
// the largest a row's D * sizeof(T) bytes allow): where a row has at most
// kThreads pieces, the piece c of rows j0, j0 + jstep, ... of every tile
// (the same piece every tile); else (jstep 0) the block walks the tile's
// pieces in order.  The copies of 16 bytes are marked evict-first in L2: a
// step reads each K/V row once, and what the cache holds for the kernels
// around it stays.
template <typename T>
struct Copier {
  int c, j0, jstep;
  int cpr, pe, bytes;  // pieces a row, elements and bytes a piece
  long long rstride;   // elements between two keys of the ring
  const T* kb;         // key 0 of the block's (row, KV head)
  const T* vb;
  uint64_t policy;     // the L2 eviction policy of the copies
};

template <typename T>
__device__ __forceinline__ Copier<T> make_copier(const T* kbuf, const T* vbuf,
                                                 const Work& w, int L,
                                                 int KVH, int D) {
  Copier<T> cp;
  cp.bytes = ptt::tc::piece_bytes(D * (int)sizeof(T));
  cp.pe = cp.bytes / (int)sizeof(T);
  const int cpr = D / cp.pe;  // pieces of a row
  cp.cpr = cpr;
  cp.jstep = cpr <= kThreads ? kThreads / cpr : 0;
  cp.c = threadIdx.x % cpr;
  // threads past jstep * cpr copy nothing
  cp.j0 = (int)threadIdx.x < cp.jstep * cpr ? threadIdx.x / cpr : 1 << 30;
  cp.rstride = (long long)KVH * D;
  const long long o = (long long)w.b * L * KVH * D + (long long)w.kh * D;
  cp.kb = kbuf + o;
  cp.vb = vbuf + o;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(cp.policy));
  return cp;
}

// 16 bytes global -> shared under an L2 policy, the L2 fetching the whole
// 128-byte line; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16_hint(uint32_t dst, const void* src,
                                                bool valid, uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint.L2::128B [%0], [%1], 16, %2, "
      "%3;\n" ::
          "r"(dst),
      "l"(src), "r"(valid ? 16 : 0), "l"(policy)
      : "memory");
}

// piece c of K and V row j of a tile (key t0 + j) into its stage;
// zero-filled without a read at or past c1.  P: the piece's bytes where
// the instance fixes them (16 on the tensor cores), 0 to take the
// copier's
template <typename T, int P>
__device__ __forceinline__ void copy_kv(T* ks, T* vs, const Copier<T>& cp,
                                        int j, int c, int t0, int c1,
                                        int rs) {
  const int pe = P ? P / (int)sizeof(T) : cp.pe;
  const int bytes = P ? P : cp.bytes;
  const int key = t0 + j;
  const bool ok = key < c1;
  const long long o = (ok ? key * cp.rstride : 0) + c * pe;
  const int so = j * rs + c * pe;
  if (bytes == 16) {
    cp_async16_hint(ptt::tc::smem_u32(ks + so), cp.kb + o, ok, cp.policy);
    cp_async16_hint(ptt::tc::smem_u32(vs + so), cp.vb + o, ok, cp.policy);
  } else {
    ptt::tc::copy_piece(ptt::tc::smem_u32(ks + so), cp.kb + o, ok, bytes);
    ptt::tc::copy_piece(ptt::tc::smem_u32(vs + so), cp.vb + o, ok, bytes);
  }
}

// K and V rows t0 .. t0 + KT - 1 into a stage (rows `rs` elements apart);
// keys at or past c1 are zero-filled without a read.  One commit group.
template <typename T, int KT, int P>
__device__ __forceinline__ void issue_tile(T* ks, const Copier<T>& cp,
                                           int t0, int c1, int rs) {
  T* vs = ks + KT * rs;
  if (P == 16 || cp.jstep > 0) {
    for (int j = cp.j0; j < KT; j += cp.jstep)
      copy_kv<T, P>(ks, vs, cp, j, cp.c, t0, c1, rs);
  } else {
    for (int i = threadIdx.x; i < KT * cp.cpr; i += kThreads) {
      const int j = i / cp.cpr;
      copy_kv<T, P>(ks, vs, cp, j, i - j * cp.cpr, t0, c1, rs);
    }
  }
  ptt::tc::cp_async_commit();
}

// Reads pos and issues the share's first tile; returns the share's tiles
template <typename T, int KT, int P>
__device__ __forceinline__ int ring_open(T* stage, Work& w,
                                         const Copier<T>& cp,
                                         const int* __restrict__ pos_ptr,
                                         int L, int rs) {
  const int ntile = block_keys(w, pos_ptr, L, KT);
  if (ntile > 0) issue_tile<T, KT, P>(stage, cp, w.c0, w.c1, rs);
  return ntile;
}

// The ring of two K/V tiles: before tile `it`, issue tile it + 1 into the
// stage that tile it - 1 left (the caller's barrier after tile it - 1 freed
// it), then wait until tile it has landed for every thread (tile it + 1
// stays in flight).  Returns tile it's stage.  The block's older cp.async
// groups (its query rows) have landed too.
template <typename T, int KT, int P>
__device__ __forceinline__ const T* ring_wait(T* stage, int it, int ntile,
                                              const Copier<T>& cp,
                                              const Work& w, int rs) {
  const size_t step = (size_t)2 * KT * rs;
  if (it + 1 < ntile) {
    issue_tile<T, KT, P>(stage + ((it + 1) % kStages) * step, cp,
                      w.c0 + (it + 1) * KT, w.c1, rs);
    ptt::tc::cp_async_wait<1>();
  } else {
    ptt::tc::cp_async_wait<0>();
  }
  __syncthreads();
  return stage + (it % kStages) * step;
}

// The output of a block's rows (o: row 0, rows D apart) from its (m, l,
// acc) (acc rows `astride` floats apart, unnormalised).  With one split,
// acc / l; with a cluster, the leader weighs split s by exp2(m_s - M), M
// the largest m (a split that saw no key, m = -inf, weighs 0), reading the
// others' shared memory.  Every block of a cluster reaches both syncs.
// The caller synchronises the block first.
template <typename T>
__device__ void finish(T* __restrict__ o, int D, int nr, int astride, int RP,
                       float* mrow, float* lrow, float* acc, float* ws) {
  const int tid = threadIdx.x;
  const int splits = gridDim.x;
  if (splits == 1) {
    for (int idx = tid; idx < nr * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const float l = lrow[r];
      o[idx] = ptt::from_f<T>(l > 0.f ? acc[(size_t)r * astride + d] / l
                                      : 0.f);
    }
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every split's (m, l, acc) is in its shared memory
  if (blockIdx.x == 0) {
    // every split's (m, l) of every row, all remote loads in flight at once
    float* wl = ws + splits * RP;
    for (int i = tid; i < splits * nr; i += kThreads) {
      const int s = i / nr, r = i - s * nr;
      ws[s * RP + r] = cl.map_shared_rank(mrow, s)[r];
      wl[s * RP + r] = cl.map_shared_rank(lrow, s)[r];
    }
    __syncthreads();
    for (int r = tid; r < nr; r += kThreads) {
      float M = -INFINITY;
      for (int s = 0; s < splits; ++s) M = fmaxf(M, ws[s * RP + r]);
      float Lsum = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float ms = ws[s * RP + r];
        const float w = ms == -INFINITY ? 0.f : exp2f(ms - M);
        ws[s * RP + r] = w;
        Lsum += w * wl[s * RP + r];
      }
      wl[splits * RP + r] = Lsum > 0.f ? 1.f / Lsum : 0.f;
    }
    __syncthreads();
    // 4 columns a thread (acc rows hold at least D rounded up to 4)
    const int nq = (D + 3) / 4;
    for (int idx = tid; idx < nr * nq; idx += kThreads) {
      const int r = idx / nq, d = (idx - r * nq) * 4;
      const size_t ai = (size_t)r * astride + d;
      // a split that saw no key holds finite zeros: it weighs 0
      float4 v[kMaxSplits];
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < splits)
          v[s] = *reinterpret_cast<const float4*>(
              cl.map_shared_rank(acc, s) + ai);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s < splits) {
          const float w = ws[s * RP + r];
          sum.x += w * v[s].x;
          sum.y += w * v[s].y;
          sum.z += w * v[s].z;
          sum.w += w * v[s].w;
        }
      }
      const float inv = wl[splits * RP + r];
      const float x[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) o[(size_t)r * D + d + e] = ptt::from_f<T>(x[e] * inv);
    }
  }
  cl.sync();  // no split leaves while the leader still reads it
}

// 8 consecutive elements of T (16-byte aligned) as floats
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  if constexpr (sizeof(T) == 2) {
    ptt::Vec16<T>::load(p, out);
  } else {
    ptt::Vec16<T>::load(p, out);
    ptt::Vec16<T>::load(p + 4, out + 4);
  }
}

// ---------------------------------------------------------------- SIMT
// float32, and bfloat16 with D not a multiple of 8 or past 256.  The
// query rows, the K/V tiles' rows and the accumulators hold DA = D padded
// to 8 columns, zero past D.  Scores and probabilities in shared memory;
// thread (rg, j) scores key j for rows rg, rg + NRG, ...; thread (kg, rsl,
// dc) adds keys kg, kg + KG, ... into columns [8 dc, 8 dc + 8) of rows rsl,
// rsl + RSL, ... of partial kg.  P: 16 where a row is whole 16-byte
// pieces (the copies' sizes fixed at compile time), else 0.
template <typename T, int KT, int P>
__global__ void __launch_bounds__(kThreads) decode_simt_kernel(
    const T* __restrict__ q, const T* __restrict__ kbuf,
    const T* __restrict__ vbuf, T* __restrict__ out,
    const int* __restrict__ pos_ptr, int L, int H, int KVH, int D, int n_hc,
    float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = block_rows(H / KVH);
  const Layout Ly = layout(false, R, D, sizeof(T), gridDim.x);
  T* stage = reinterpret_cast<T*>(smem + Ly.stage);
  float* qs = reinterpret_cast<float*>(smem + Ly.q);
  float* sc = reinterpret_cast<float*>(smem + Ly.s);
  float* acc = reinterpret_cast<float*>(smem + Ly.acc);
  float* mrow = reinterpret_cast<float*>(smem + Ly.stats);
  float* lrow = mrow + R;
  float* corr = lrow + R;
  float* ws = reinterpret_cast<float*>(smem + Ly.ws);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  Work w = block_heads(H, KVH, n_hc);
  const int nr = w.nr;
  const int rs = Ly.rstride;
  const int DA = simt_cols(D);
  // the columns D .. DA - 1 of every stage row stay zero (the copies write
  // columns < D only; the first ring_wait's barrier publishes these)
  for (int idx = tid; idx < 2 * kStages * KT * (DA - D); idx += kThreads) {
    const int row = idx / (DA - D);
    stage[row * rs + D + idx - row * (DA - D)] = ptt::from_f<T>(0.f);
  }
  const Copier<T> cp = make_copier<T>(kbuf, vbuf, w, L, KVH, D);
  const int ntile = ring_open<T, KT, P>(stage, w, cp, pos_ptr, L, rs);
  const int c1 = w.c1;
  // the query rows and the state while the first tile is in flight
  const T* qb = q + ((size_t)w.b * H + w.h0) * D;
  for (int idx = tid; idx < nr * DA; idx += kThreads) {
    const int r = idx / DA, d = idx - r * DA;
    qs[idx] = d < D ? ptt::to_f(qb[r * D + d]) * scale_log2 : 0.f;
  }
  for (int idx = tid; idx < Ly.KG * R * DA; idx += kThreads) acc[idx] = 0.f;
  for (int r = tid; r < nr; r += kThreads) {
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }

  const int DC = DA / kVec;
  const int slots = kThreads / DC;
  const int RSL = slots / Ly.KG;
  const int dc = tid % DC, slot = tid / DC;
  const int kg = slot % Ly.KG, rsl = slot / Ly.KG;
  const bool pv = slot < RSL * Ly.KG;  // past that, a thread idles in P @ V
  constexpr int NRG = kThreads / KT;
  const int sj = tid % KT, rg = tid / KT;

  for (int it = 0; it < ntile; ++it) {
    const T* ks =
        ring_wait<T, KT, P>(stage, it, ntile, cp, w, rs);
    const T* vs = ks + KT * rs;
    const int t0 = w.c0 + it * KT;
    const int kcount = min(KT, c1 - t0);

    {  // scores (log2 domain); keys past the share masked
      const T* krow = ks + sj * rs;
      const bool vis = sj < kcount;
      for (int r0 = rg; r0 < nr; r0 += NRG * kRowsPerPass) {
        float s[kRowsPerPass];
#pragma unroll
        for (int k = 0; k < kRowsPerPass; ++k) s[k] = 0.f;
        for (int c = 0; c < DA; c += kVec) {
          float kf[kVec];
          load8(krow + c, kf);
#pragma unroll
          for (int k = 0; k < kRowsPerPass; ++k) {
            const int r = r0 + k * NRG;
            if (r < nr) {
              const float4 a =
                  *reinterpret_cast<const float4*>(qs + r * DA + c);
              const float4 e =
                  *reinterpret_cast<const float4*>(qs + r * DA + c + 4);
              s[k] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
                      e.x * kf[4] + e.y * kf[5] + e.z * kf[6] + e.w * kf[7];
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kRowsPerPass; ++k) {
          const int r = r0 + k * NRG;
          if (r < nr) sc[r * KT + sj] = vis ? s[k] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows w, w + kWarps, ...
    for (int r = warp; r < nr; r += kWarps) {
      float* row = sc + r * KT;
      float mx = -INFINITY;
      for (int jj = lane; jj < KT; jj += 32) mx = fmaxf(mx, row[jj]);
      mx = ptt::warp_max(mx);  // finite: key t0 is visible
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int jj = lane; jj < KT; jj += 32) {
        const float p = exp2f(row[jj] - m_new);  // masked: exp2(-inf) = 0
        row[jj] = p;
        sum += p;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float c = exp2f(m_old - m_new);  // m_old = -inf: 0
        corr[r] = c;
        lrow[r] = lrow[r] * c + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();

    if (pv) {  // P @ V
      for (int r0 = rsl; r0 < nr; r0 += RSL * kRowsPerPass) {
        float a[kRowsPerPass][kVec];
#pragma unroll
        for (int k = 0; k < kRowsPerPass; ++k) {
          const int r = r0 + k * RSL;
#pragma unroll
          for (int e = 0; e < kVec; ++e) a[k][e] = 0.f;
          if (r < nr) {
            const float* ap = acc + ((size_t)kg * R + r) * DA + dc * kVec;
            const float cr = corr[r];
#pragma unroll
            for (int e = 0; e < kVec; ++e) a[k][e] = ap[e] * cr;
          }
        }
        for (int jj = kg; jj < kcount; jj += Ly.KG) {
          float vf[kVec];
          load8(vs + jj * rs + dc * kVec, vf);
#pragma unroll
          for (int k = 0; k < kRowsPerPass; ++k) {
            const int r = r0 + k * RSL;
            if (r < nr) {
              const float p = sc[r * KT + jj];
#pragma unroll
              for (int e = 0; e < kVec; ++e) a[k][e] += p * vf[e];
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kRowsPerPass; ++k) {
          const int r = r0 + k * RSL;
          if (r < nr) {
            float* ap = acc + ((size_t)kg * R + r) * DA + dc * kVec;
#pragma unroll
            for (int e = 0; e < kVec; ++e) ap[e] = a[k][e];
          }
        }
      }
    }
    __syncthreads();  // stage it % 2 and the probabilities are free
  }

  __syncthreads();  // with no tile, the state written above
  // the key groups' partials add up into partial 0
  if (Ly.KG > 1) {
    for (int idx = tid; idx < nr * DA; idx += kThreads) {
      float s = 0.f;
      for (int g = 0; g < Ly.KG; ++g) s += acc[(size_t)g * R * DA + idx];
      acc[idx] = s;
    }
    __syncthreads();
  }
  finish<T>(out + ((size_t)w.b * H + w.h0) * D, D, nr, DA, R, mrow, lrow,
            acc, ws);
}

// -------------------------------------------------------- tensor cores
// bfloat16 with D a multiple of 8 up to 256: mma.sync.m16n8k16 (bf16 ->
// f32) on ldmatrix fragments of the padded tiles.  The block's heads are
// the 16 rows (zero past nr); warp w
// takes keys [w KT / 4, (w + 1) KT / 4) of every tile with its own online
// softmax (float32 m, l and the output in registers); the probabilities
// become the P @ V operand without leaving registers.  After the walk the
// 4 key groups merge in shared memory.  The fragment helpers are those of
// paged_attention.cu's tensor-core instance.

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(ptt::tc::smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(ptt::tc::smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int DP>
__global__ void __launch_bounds__(kThreads) decode_tc_kernel(
    const bf* __restrict__ q, const bf* __restrict__ kbuf,
    const bf* __restrict__ vbuf, bf* __restrict__ out,
    const int* __restrict__ pos_ptr, int L, int H, int KVH, int D, int n_hc,
    float scale_log2) {
  constexpr int KT = kTcKeys;
  constexpr int KG = kWarps;
  constexpr int KW = KT / KG;  // keys of a tile a warp takes
  constexpr int NK = KW / 8;   // its score n-tiles
  constexpr int ND = DP / 8;   // output n-tiles
  constexpr int RP = kRows;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout Ly = layout(true, RP, D, 2, gridDim.x);
  const int rs = Ly.rstride;
  bf* stage = reinterpret_cast<bf*>(smem + Ly.stage);
  bf* qs = reinterpret_cast<bf*>(smem + Ly.q);
  float* acc = reinterpret_cast<float*>(smem + Ly.acc);
  float* mrow = reinterpret_cast<float*>(smem + Ly.stats);
  float* lrow = mrow + RP;
  float* mpart = reinterpret_cast<float*>(smem + Ly.part);  // KG x RP
  float* lpart = mpart + KG * RP;
  float* ws = reinterpret_cast<float*>(smem + Ly.ws);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  Work w = block_heads(H, KVH, n_hc);
  const int nr = w.nr;
  // query rows as bf16 (rows past nr and columns past D zero), in flight
  // while pos is read
  const bf* qb = q + ((size_t)w.b * H + w.h0) * D;
  for (int idx = tid; idx < RP * ND; idx += kThreads) {
    const int r = idx / ND, c = (idx - r * ND) * 8;
    const bool ok = r < nr && c < D;
    ptt::tc::cp_async16(ptt::tc::smem_u32(qs + r * rs + c),
                        ok ? qb + (size_t)r * D + c : qb, ok);
  }
  ptt::tc::cp_async_commit();
  if (D < DP) {  // the columns past D of every stage stay zero
    const int pc = (DP - D) / 8;
    for (int idx = tid; idx < 2 * kStages * KT * pc; idx += kThreads) {
      const int row = idx / pc, c = D + (idx - row * pc) * 8;
      *reinterpret_cast<uint4*>(stage + row * rs + c) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  const Copier<bf> cp = make_copier<bf>(kbuf, vbuf, w, L, KVH, D);
  const int ntile = ring_open<bf, KT, 16>(stage, w, cp, pos_ptr, L, rs);
  const int c1 = w.c1;
  const int kbase = warp * KW;
  const int g = lane / 4, tig = lane % 4;  // rows g and g + 8
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntile; ++it) {
    const bf* ks =
        ring_wait<bf, KT, 16>(stage, it, ntile, cp, w, rs);
    const bf* vs = ks + KT * rs;
    const int t0 = w.c0 + it * KT;
    // S = Q K^T over this warp's KW keys
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qs + (lane % 16) * rs + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int n2 = 0; n2 < NK / 2; ++n2) {
        uint32_t bk[4];
        const int key = kbase + n2 * 16 + lane % 8 + (lane / 16) * 8;
        ldsm_x4(bk, ks + key * rs + kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * n2], a, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], a, bk[2], bk[3]);
      }
    }
    // scale into the log2 domain; the mask only in a share's last tile
    const bool full = t0 + KT <= c1;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[n][e] * scale_log2;
        if (!full && t0 + kbase + n * 8 + 2 * tig + (e & 1) >= c1)
          v = -INFINITY;
        s[n][e] = v;
      }
    // online softmax of rows g and g + 8 (a quad holds a row)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // a warp whose keys are all past the share keeps m = -inf and p = 0
    const bool none0 = mn0 == -INFINITY, none1 = mn1 == -INFINITY;
    const float cr0 = none0 ? 1.f : exp2f(m0 - mn0);  // -inf -> 0
    const float cr1 = none1 ? 1.f : exp2f(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      s[n][0] = none0 ? 0.f : exp2f(s[n][0] - mn0);
      s[n][1] = none0 ? 0.f : exp2f(s[n][1] - mn0);
      s[n][2] = none1 ? 0.f : exp2f(s[n][2] - mn1);
      s[n][3] = none1 ? 0.f : exp2f(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * cr0 + sum0;  // this thread's share; the quad adds at the end
    l1 = l1 * cr1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= cr0;
      o[n][1] *= cr0;
      o[n][2] *= cr1;
      o[n][3] *= cr1;
    }
    // O += P V: the score accumulators of two n-tiles are one A operand
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n2 = 0; n2 < ND / 2; ++n2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (kbase + kk * 16 + lane % 16) * rs + n2 * 16 +
                          (lane / 16) * 8);
        mma_bf16(o[2 * n2], a, bv[0], bv[1]);
        mma_bf16(o[2 * n2 + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // stage it % 2 is free again
  }
  ptt::tc::cp_async_wait<0>();  // the query rows, where no tile waited

  // each key group's (m, l, O) into shared memory (O over the idle ring)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (tig == 0) {
    mpart[warp * RP + g] = m0;
    lpart[warp * RP + g] = l0;
    mpart[warp * RP + g + 8] = m1;
    lpart[warp * RP + g + 8] = l1;
  }
  float* ap = acc + ((size_t)warp * RP + g) * DP + 2 * tig;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<float2*>(ap + n * 8) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(ap + 8 * DP + n * 8) =
        make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();
  // the key groups merge into (mrow, lrow, acc partial 0), weighed by
  // exp2(m_g - M)
  for (int r = tid; r < nr; r += kThreads) {
    float M = -INFINITY;
#pragma unroll
    for (int k = 0; k < KG; ++k) M = fmaxf(M, mpart[k * RP + r]);
    float Lsum = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float mk = mpart[k * RP + r];
      const float wk = mk == -INFINITY ? 0.f : exp2f(mk - M);
      mpart[k * RP + r] = wk;  // now the weight
      Lsum += wk * lpart[k * RP + r];
    }
    mrow[r] = M;
    lrow[r] = Lsum;
  }
  __syncthreads();
  for (int idx = tid; idx < nr * D; idx += kThreads) {
    const int r = idx / D, d = idx - r * D;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < KG; ++k) {
      const float wk = mpart[k * RP + r];
      if (wk != 0.f) sum += wk * acc[((size_t)k * RP + r) * DP + d];
    }
    acc[(size_t)r * DP + d] = sum;
  }
  __syncthreads();
  finish<bf>(out + ((size_t)w.b * H + w.h0) * D, D, nr, DP, RP, mrow, lrow,
             acc, ws);
}

// grid (splits, KVH x head chunks, B); the splits of a (row, head chunk)
// form a cluster
template <typename T, typename K>
cudaError_t launch_kernel(K kern, size_t smem, int splits, int n_hc, int B,
                          int KVH, cudaStream_t st, const void* q,
                          const void* kbuf, const void* vbuf, void* out,
                          const void* pos, int L, int H, int D, float scale) {
  cudaError_t e = ptt::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KVH * n_hc, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  // log2(e) * scale: the scores live in the log2 domain (exp2f)
  const float scale_log2 = scale * 1.4426950408889634f;
  e = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)kbuf,
                         (const T*)vbuf, (T*)out, (const int*)pos, L, H, KVH,
                         D, n_hc, scale_log2);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the plans the instances take: 1, 2, 4 or 8 splits, no more than the
// ring has key tiles; past 512 columns one (the wide instance)
bool valid_plan(int es, int B, int L, int H, int KVH, int D, int splits) {
  if (!(B > 0 && B <= 65535 && L > 0 && KVH > 0 && H % KVH == 0 && D > 0 &&
        (splits == 1 || splits == 2 || splits == 4 || splits == kMaxSplits)))
    return false;
  const int G = H / KVH;
  const long long n_hc = (G + kRows - 1) / kRows;
  if (KVH * n_hc > 65535) return false;
  if (D > 512) return splits == 1;
  const int KT = uses_tc(es, D) ? kTcKeys : simt_keys(es, D);
  return (long long)(splits - 1) * KT < L;
}

// ---------------------------------------------- past 512 columns (C8)
// the rows of one block for the shared walk: the block's query heads of
// row b (rows D apart) and its KV head's keys (rows KVH * D apart)
template <typename T>
struct DecodeRows {
  const T *qb, *kb, *vb;
  T* ob;
  long long ks;
  int D;
  __device__ const T* q(int r) const { return qb + (long long)r * D; }
  __device__ const T* k(int key) const { return kb + key * ks; }
  __device__ const T* v(int key) const { return vb + key * ks; }
  __device__ bool vis(int, int) const { return true; }
  __device__ void put(int r, int d, float x) const {
    ob[(long long)r * D + d] = ptt::from_f<T>(x);
  }
};

// one block per (KV head x head chunk x slice, row): keys 0 .. pos
template <typename T>
__global__ void __launch_bounds__(ptt::wide::kThreads) decode_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ kbuf,
    const T* __restrict__ vbuf, T* __restrict__ out,
    const int* __restrict__ pos_ptr, int L, int H, int KVH, int D, int n_hc,
    float scale_log2, int W, int NS) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KVH;
  const int b = blockIdx.z, y = blockIdx.y / NS, sl = blockIdx.y % NS;
  const int kh = y / n_hc, hc = y - kh * n_hc;
  const int h0 = kh * G + hc * kRows;
  const int nr = min(kRows, G - hc * kRows);
  const int n = max(0, min(*pos_ptr, L - 1) + 1);  // visible keys
  const long long o = (long long)b * L * KVH * D + (long long)kh * D;
  const long long qo = ((long long)b * H + h0) * D;
  const DecodeRows<T> src{q + qo, kbuf + o, vbuf + o, out + qo,
                          (long long)KVH * D, D};
  ptt::wide::attend<T>(src, nr, D, 0, n, sl * W, W, scale_log2, smem);
}

template <typename T>
cudaError_t launch_wide(int B, int L, int H, int KVH, int D, int n_hc,
                        cudaStream_t st, const void* q, const void* kbuf,
                        const void* vbuf, void* out, const void* pos,
                        float scale) {
  const int R = block_rows(H / KVH);
  const int W = ptt::wide::slice_cols(R, D);
  const int NS = (D + W - 1) / W;
  if ((long long)KVH * n_hc * NS > 65535)
    return cudaErrorInvalidConfiguration;
  const size_t smem = ptt::wide::smem_bytes(R, W);
  cudaError_t e = ptt::allow_smem(decode_wide_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  decode_wide_kernel<T><<<dim3(1, KVH * n_hc * NS, B), ptt::wide::kThreads,
                          smem, st>>>(
      (const T*)q, (const T*)kbuf, (const T*)vbuf, (T*)out, (const int*)pos,
      L, H, KVH, D, n_hc, scale * 1.4426950408889634f, W, NS);
  return cudaGetLastError();
}

// V: the piece a thread copies (uint4, uint2, uint32_t or uint16_t)
template <typename V>
__global__ void ring_write_kernel(V* __restrict__ kbuf, V* __restrict__ vbuf,
                                  const V* __restrict__ knew,
                                  const V* __restrict__ vnew,
                                  const int* __restrict__ pos_ptr, int L,
                                  int S, int row_vecs) {
  const int bs = blockIdx.x;  // b * S + s
  const int b = bs / S, s = bs - b * S;
  // dynamic_update_slice's start: a negative pos counts from the end
  // first, then the start is clamped to [0, L - S]
  const int p = *pos_ptr;
  const int start = max(0, min(p < 0 ? p + L : p, L - S));
  const long long dst = ((long long)b * L + start + s) * row_vecs;
  const long long src = (long long)bs * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) {
    kbuf[dst + i] = knew[src + i];
    vbuf[dst + i] = vnew[src + i];
  }
}

}  // namespace

// splits: the plan's cluster size; bfloat16 runs the tensor-core instance,
// float32 the SIMT one, a head dim past 512 the wide one
extern "C" int ptt_decode_attention(const void* q, const void* kbuf,
                                    const void* vbuf, void* out,
                                    const void* pos, int B, int L, int H,
                                    int KVH, int D, float scale, int splits,
                                    int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != ptt::kFloat32 && dtype != ptt::kBFloat16)
    return (int)cudaErrorInvalidValue;
  const int es = dtype == ptt::kFloat32 ? 4 : 2;
  if (!valid_plan(es, B, L, H, KVH, D, splits))
    return (int)cudaErrorInvalidValue;
  const bool tc = uses_tc(es, D);
  const int G = H / KVH;
  const int n_hc = (G + kRows - 1) / kRows;
  if (D > 512)
    return es == 4 ? (int)launch_wide<float>(B, L, H, KVH, D, n_hc, st, q,
                                             kbuf, vbuf, out, pos, scale)
                   : (int)launch_wide<bf>(B, L, H, KVH, D, n_hc, st, q, kbuf,
                                          vbuf, out, pos, scale);
  const size_t smem = layout(tc, block_rows(G), D, es, splits).total;
#define PTT_B2_ARGS                                                          \
  smem, splits, n_hc, B, KVH, st, q, kbuf, vbuf, out, pos, L, H, D, scale
  if (!tc) {
    // the SIMT instance by type, key tile and whether a row is whole
    // 16-byte pieces
    const bool p16 = ptt::tc::piece_bytes(D * es) == 16;
#define PTT_B2_SIMT(T, kt)                                                 \
  return p16 ? (int)launch_kernel<T>(decode_simt_kernel<T, kt, 16>,        \
                                     PTT_B2_ARGS)                          \
             : (int)launch_kernel<T>(decode_simt_kernel<T, kt, 0>, PTT_B2_ARGS)
    if (es == 2) PTT_B2_SIMT(bf, kSimtKeys);
    if (simt_keys(es, D) == 16) PTT_B2_SIMT(float, 16);
    PTT_B2_SIMT(float, kSimtKeys);
#undef PTT_B2_SIMT
  }
  const int DP = tc_cols(D);
  return DP == 64 ? (int)launch_kernel<bf>(decode_tc_kernel<64>, PTT_B2_ARGS)
         : DP == 128
             ? (int)launch_kernel<bf>(decode_tc_kernel<128>, PTT_B2_ARGS)
             : (int)launch_kernel<bf>(decode_tc_kernel<256>, PTT_B2_ARGS);
#undef PTT_B2_ARGS
}

namespace {

template <typename V>
cudaError_t ring_write(void* kbuf, void* vbuf, const void* knew,
                       const void* vnew, const void* pos, int B, int L, int S,
                       int row_bytes, cudaStream_t st) {
  ring_write_kernel<V><<<B * S, kThreads, 0, st>>>(
      (V*)kbuf, (V*)vbuf, (const V*)knew, (const V*)vnew, (const int*)pos, L,
      S, row_bytes / (int)sizeof(V));
  return cudaGetLastError();
}

}  // namespace

// row_bytes: one token's [KVH, D] row, an even count; the pieces are the
// largest that the row and every pointer allow
extern "C" int ptt_kv_ring_write(void* kbuf, void* vbuf, const void* knew,
                                 const void* vnew, const void* pos, int B,
                                 int L, int S, int row_bytes, void* stream) {
  if (row_bytes <= 0 || row_bytes % 2 || S <= 0 || S > L)
    return (int)cudaErrorInvalidValue;
  const uintptr_t bits = (uintptr_t)kbuf | (uintptr_t)vbuf |
                         (uintptr_t)knew | (uintptr_t)vnew;
  int piece = ptt::tc::piece_bytes(row_bytes);
  while (bits % piece) piece /= 2;
  if (piece < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (piece) {
    case 16:
      return (int)ring_write<uint4>(kbuf, vbuf, knew, vnew, pos, B, L, S,
                                    row_bytes, st);
    case 8:
      return (int)ring_write<uint2>(kbuf, vbuf, knew, vnew, pos, B, L, S,
                                    row_bytes, st);
    case 4:
      return (int)ring_write<uint32_t>(kbuf, vbuf, knew, vnew, pos, B, L, S,
                                       row_bytes, st);
    default:
      return (int)ring_write<uint16_t>(kbuf, vbuf, knew, vnew, pos, B, L, S,
                                       row_bytes, st);
  }
}
