// Paged-KV attention core of blha_attention (kernel K4).
//
// Replaces no Pallas kernel: paddle_tpu/ops/paged_attention.py:blha_attention
// leaves its attention (steps 6-8, :237-316) to XLA, gathering every
// sequence's whole context into [B, KV, L, D] first.  This kernel reads the
// keys and values in place through the block tables.  Its algorithm is that
// of paddle_tpu/ops/pallas/flash_attention.py:_fwd_kernel: online softmax
// with float32 state.
//
// Semantics (those of blha_attention steps 6-8 with cache_quant="none"):
// packed token i belongs to row b = searchsorted(cu, i, right) - 1, sits at
// absolute position dec[b] + (i - cu[b]) and attends keys 0 .. that position
// of its own row (at most P * block_size keys); softmax in float32 with
// scale 1/sqrt(D); query head h reads KV head h / (H / KV).  A key whose
// block-table entry is out of the pool reads as zeros, as the reference's
// gather fills it.  Tokens past cu[B], past their row's now, or at local
// index >= max_q_len give zeros.  The output is q's dtype, or float32
// where the entry's out_f32 asks (blha_attention's shift/smooth epilogue
// and output quantization read the float32 value and round once).
// The pre-caches (blha_attention's pre_key_cache / pre_value_cache,
// :255-260 and :274-279): with pre_len Lp > 0 the keys of row b are Lp
// prefix rows pk / pv [B, KV, Lp, D] (the cache's dtype, contiguous), seen by
// every query, followed by its paged context: key j >= Lp is paged key j -
// Lp, visible at positions >= j - Lp.  The prefix is a second source of
// key rows in the copier (a key below Lp reads pre[b, kh, key, :]; a tile
// may straddle Lp, so the source is chosen row by row); the split, the
// masks and the block window run over the combined axis of Lp + P *
// block_size keys, the window covering only its paged part.  Nothing is
// written for the prefix.
// The additive masks (blha_attention's mask / tgt_mask, :285-308): float32
// [B, 1 | H, Sq, Lm], `mask` added to the scores of the rows in prefill
// (seq_lens_encoder > 0), `tgt_mask` to the other rows.  Query head h
// reads mask head h (head 0 where the mask has one), a token reads mask
// row s = its local index, and key j of the combined axis (the prefix
// first) reads column j; rows s >= Sq and columns j >= Lm add 0.  The
// term goes in after the scale, in the log2 domain (m * log2(e)), on the
// visible keys only: a key outside causal visibility stays -inf.  The
// masked instances are the same kernels with kMask set, compiled from
// this file a second time (paged_attention_masked.cu, PTT_PAGED_MASKED),
// so that nvcc builds them in parallel with the unmasked ones; an entry
// given a mask hands the call to that build's entry.  The serving engine
// passes no mask and launches the unmasked instances as they were.  The
// mask is read straight from global memory in the score loop (L2-resident
// at serving sizes); nothing of it is staged in shared memory.  The
// reference gives an invisible key the logit -1e30 + m, not -inf, so a
// row whose visible logits all sit at or below about -1e30 (all -inf, or
// finfo.min, under its mask) takes its softmax from the invisible keys,
// or is NaN where every key is -inf (Queue C10).  The walks skip invisible
// keys; in the masked builds only, a row that ends with such a largest
// score (merged across the cluster) is computed once more over its whole
// combined axis in plain float32 (RefRows, a warp a row) and written in
// place of the walk's result.  No other row pays for it.
//
// The cache's dtype (Queue C12): the pools and the pre-caches are q's
// dtype, or bfloat16 under a float32 q (a float32 engine whose
// cache_dtype is bfloat16; the reference stores k and v in the cache's
// dtype and attends in float32).  That pair runs the SIMT instance (and
// past 512 columns the wide one) with the cache's element type C apart
// from q's T: the ring holds the tiles at their stored bf16 width, filled
// by the same cp.async pieces, and every read from shared memory widens
// them exactly; the plan counts the ring at that width.  A bfloat16 q over
// a float32 cache is widened to float32 by the wrapper (exact) and takes
// the float32 instances, the output rounded once.
//
// Bound on the H100: bytes.  Every serving shape reads each visible key and
// value row once and does ~4 operations per (query row, key, column) on it,
// below the ~295 operations a byte the card needs before arithmetic bounds
// (bf16 tensor cores).  What the design does about it:
// * Query tiles.  A block takes one tile of up to QT consecutive tokens of
//   one row and one KV head with its G query heads: QT * G query rows share
//   every key and value row the block reads, so a prefill row of n tokens
//   reads its context ceil(n / QT) times, not n times.  Decode (max_q_len
//   1) has QT = 1 and the GQA group alone fills the rows.
// * A ring of two key tiles.  KT keys of K and V arrive together by 16-byte
//   cp.async through the block table (zero-filled, nothing read, for blocks
//   outside the pool and keys past the block's range) while the previous
//   tile is computed on; rows are padded to an odd number of 16-byte
//   chunks, so neighbouring rows' 16-byte reads (and ldmatrix's) hit no
//   bank twice.
// * Tensor cores for bfloat16 (D a multiple of 8 up to 256, zero columns
//   to 64, 128 or 256): mma.sync m16n8k16 on ldmatrix fragments; each warp
//   takes 16 query rows and a quarter, half or all of every 64-key tile
//   (tiles of <= 16, 32, 64 rows) with its own online softmax in
//   registers, and the warps' (m, l, O) merge at the end.  A SIMT instance
//   of the same tiling serves float32 and the other bf16 head dims:
//   per-tile arithmetic, not bytes, is what a first SIMT version of this
//   design spent its time on.
// * Every head dim, read in place (a per-call pad would copy the pool):
//   the SIMT instance holds D padded to a multiple of 8 (DA) in shared
//   memory, zero past D, and copies rows in the largest pieces their
//   bytes allow (16, 8, 4 or 2); past 256 columns a ring of 16-key tiles
//   keeps a block within 227 KB.  Past 512 (Queue C8) a row does not fit
//   a block whole: the wide instance (paged_attention_wide_kernel, the
//   walk of wide_attention.cuh, both dtypes, no cluster split, 32-key
//   tiles, "stages" 1) streams the query rows and K through shared
//   memory in 64-column chunks for the scores, and each block writes one
//   slice of at most 512 output columns (the grid's x takes the slices;
//   the scores are recomputed for each).
// * The context split across a thread-block cluster.  Where the grid would
//   leave the card's block slots mostly empty (decode: 8 rows x KV heads),
//   the `splits` blocks of one (tile, head) form a cluster, each walking a
//   contiguous chunk of the keys; after cluster.sync() the leader merges
//   the others' (m, l, acc) through distributed shared memory and writes
//   the output.
// * One launch per call, nothing in device memory but the output, and a
//   grid from host-known sizes only (T, B, max_q_len, P, block_size, H, KV,
//   D): it holds the most query tiles T tokens in B rows can fill, and a
//   block finds its row and tile from the row lengths on the device (a
//   prefix sum in shared memory), so the call needs no host sync and can
//   be captured.  The first split of every tile also writes the zeros of
//   its share of the tokens that no tile owns.
// QT, KT, the number of splits and the chunk come from
// ops/hopper/paged_attention.py:paged_plan; the entry refuses a cache dtype
// other than q's or bfloat16 under float32, a KT without
// an instance, more than 4 splits, a ring other than 2 stages on the tensor
// cores (2 or 3 on SIMT; past 512 columns 32-key tiles, 1 stage and 1
// split), 16-key tiles at 256 columns or fewer, a chunk
// that is not a multiple of KT or does not
// cover P * block_size keys, a tensor-core tile of more than 64 query rows,
// and a block past the shared memory it may use (227 KB).
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"
#include "wide_attention.cuh"

namespace cg = cooperative_groups;

// 1 in paged_attention_masked.cu: that build holds the masked instances
#ifndef PTT_PAGED_MASKED
#define PTT_PAGED_MASKED 0
#endif

namespace {

constexpr bool kMasked = PTT_PAGED_MASKED;
constexpr int kThreads = 128;
// K4-int8's tensor-core kernel pins its occupancy target in the masked
// build: without it, the rare rows' code (RefRows) moves ptxas to 128
// registers and spills in the walk at D <= 128 (the unmasked build keeps
// its bounds: 160-170 registers there, no spill)
#if PTT_PAGED_MASKED
#define PTT_K4I_BOUNDS(DP) __launch_bounds__(kThreads, (DP) <= 128 ? 3 : 1)
#else
#define PTT_K4I_BOUNDS(DP) __launch_bounds__(kThreads)
#endif
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;          // elements of a row a thread takes at once
constexpr int kRowsPerPass = 4;  // query rows a SIMT thread carries
constexpr int kMaxSplits = 4;    // blocks of a cluster (paged_plan's cap)
constexpr int kTcKeys = 64;      // the tensor-core instance's key tile
constexpr int kTcRows = 64;      // the most query rows it takes

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

// the SIMT instance's columns: D padded to a multiple of kVec (zeros past D)
__host__ __device__ inline int simt_cols(int D) {
  return (D + kVec - 1) / kVec * kVec;
}

// key groups of the tensor-core instance: 4 warps split a 64-key tile
// four ways for a tile of <= 16 query rows, two ways for <= 32, and each
// warp walks all 64 keys for 16 rows of its own up to 64 rows
__host__ __device__ inline int tc_key_groups(int R) {
  return R <= 16 ? 4 : R <= 32 ? 2 : 1;
}

// The shared-memory layout of one block, in bytes; mirrored by
// ops/hopper/paged_attention.py:_smem_bytes, by which the plan picks its
// tiles.  A launch whose layout needs more than the card grants is refused
// (cudaErrorInvalidConfiguration, ptt::allow_smem).
struct Layout {
  int KG;       // key groups (partial accumulators)
  int RP;       // query rows held (the tensor-core instance pads to 16)
  int rstride;  // elements between two K (V) rows of a tile
  // byte offsets: the K/V ring, query rows, SIMT scores, accumulators,
  // row statistics, the key groups' (m, l), merge weights, row tables
  size_t stage, q, s, acc, stats, part, ws, tables, total;
};

__host__ __device__ inline Layout layout(bool tc, int R, int D, int es,
                                         int KT, int stages, int splits,
                                         int B, int chunk, int bs) {
  Layout L = {};
  size_t off = 0;
  if (tc) {
    const int DP = tc_cols(D);
    L.KG = tc_key_groups(R);
    L.RP = 16 * (kWarps / L.KG);
    L.rstride = row_chunks(DP, 2) * 8;
    L.stage = off;  // `stages` x (K tile, V tile), bf16
    off += (size_t)2 * stages * KT * L.rstride * 2;
    L.acc = L.stage;  // KG x RP x DP float, after the walk (fits the ring)
    L.q = off;  // RP x DP query rows, bf16, zero-padded
    off += (size_t)L.RP * L.rstride * 2;
    L.stats = off;  // m, l (float) and the last visible key (int) by row
    off += (size_t)3 * L.RP * 4;
    L.part = off;  // each key group's m and l by row
    off += (size_t)2 * L.KG * L.RP * 4;
  } else {
    const int DA = simt_cols(D);
    const int slots = kThreads / (DA / kVec);  // threads on a column chunk
    L.KG = 1;
    while (L.KG * 2 * R <= slots) L.KG *= 2;
    L.RP = R;
    L.rstride = row_chunks(DA, es) * 16 / es;
    L.stage = off;  // `stages` x (K tile, V tile)
    off += (size_t)2 * stages * KT * L.rstride * es;
    L.q = off;  // R x DA query rows, float, pre-scaled
    off += (size_t)R * DA * 4;
    L.s = off;  // R x KT scores, then probabilities
    off += (size_t)R * KT * 4;
    L.acc = off;  // KG x R x DA float accumulators
    off += (size_t)L.KG * R * DA * 4;
    L.stats = off;  // m, l, corr (float) and the last visible key (int)
    off += (size_t)4 * R * 4;
  }
  L.ws = off;  // the leader's merge weights: splits x RP, then 1 / L
  off += (size_t)(splits + 1) * L.RP * 4;
  L.tables = off;  // int: cu, len, pt, dec by row; a split's block ids
  off += (size_t)(4 * B + 2 + chunk / bs + 2) * 4;
  L.total = off;
  return L;
}

// 8 consecutive elements of T (16-byte aligned) as floats: bfloat16
// widens exactly
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  if constexpr (sizeof(T) == 2) {
    ptt::Vec16<T>::load(p, out);
  } else {
    ptt::Vec16<T>::load(p, out);
    ptt::Vec16<T>::load(p + 4, out + 4);
  }
}

// What a block works on: query tile k of the grid is the (k - pt[b])-th
// tile of row b, its tokens t_first .. t_first + nt - 1 (local indices);
// split `rank` walks keys c0 .. c1 - 1 of the row's visible 0 .. n_max - 1.
struct Tile {
  int b, t_first, nt, nr, pos0, ctx, c0, c1, b0;
  size_t qo;  // q / out offset of row 0 (token t_first, head kh * G)
  // keys 0 .. Lp - 1 are the prefix rows pk / pv (at row b, head kh, of
  // the cache's element type); key j >= Lp is paged key j - Lp, whose
  // blocks from b0 on are the split's s_blk
  int Lp;
  const void *pk, *pv;
};

// The additive masks of a call: m[0] `mask` (the rows in prefill, enc[b]
// > 0), m[1] `tgt_mask` (the others), each float32 [B, heads, sq, lm]
// with heads 1 or H, or null; enc is seq_lens_encoder [B] (null without
// masks).  The unmasked instances never read it.
struct Masks {
  const float* m[2];
  int heads[2], sq[2], lm[2];
  const int* enc;
};

// Row b's mask (its row 0 of head 0), or null where the row's mask was
// not given; rows `sq` and columns `lm` wide, heads `hstride` elements
// apart (0 for a mask of one head).
struct RowMask {
  const float* p;
  int hstride, sq, lm;
  // the row of query head h at local index s, or null past the mask's rows
  __device__ __forceinline__ const float* row(int h, int s) const {
    return p != nullptr && s < sq
               ? p + (size_t)h * hstride + (size_t)s * lm
               : nullptr;
  }
};

// the block's row b picks `mask` or `tgt_mask` (a tile's row has now > 0)
__device__ __forceinline__ RowMask row_mask(const Masks& mk, int b) {
  const int w = mk.enc[b] > 0 ? 0 : 1;
  RowMask r;
  r.sq = mk.sq[w];
  r.lm = mk.lm[w];
  r.hstride = mk.heads[w] > 1 ? r.sq * r.lm : 0;
  r.p = mk.m[w] != nullptr
            ? mk.m[w] + (size_t)b * mk.heads[w] * r.sq * r.lm
            : nullptr;
  return r;
}

// the additive term of combined key `key` on a mask row (RowMask::row), in
// the log2 domain; 0 without a row and past its columns
__device__ __forceinline__ float mask_term(const float* row, int lm,
                                           int key) {
  return row != nullptr && key < lm ? __ldg(row + key) * kLog2e : 0.f;
}

// Queue C10: the rows whose visible logits all sit at or below -1e30.
// The reference (blha_attention :273-311) gives every causally invisible
// key the logit fl(-1e30 + m), m the mask's column (0 past its columns),
// and takes the softmax over the whole combined axis of Lp + P * bs keys.
// Such a key carries weight only where no visible logit lies above about
// -1e30; the walks skip invisible keys, so a row whose largest visible
// score M (log2 domain) is at or below kRareLog2, or that saw no key (l
// = 0: every visible score -inf, or a mask of finfo.min scaled past the
// float range), is computed once more by RefRows.  The threshold sits
// well above -1e30 * log2(e) so that the rounding of the log2 scores does
// not decide: RefRows is the reference on every row it takes.
constexpr float kRareLog2 = -1e29f;

__device__ __forceinline__ bool rare_row(float m, float l) {
  return !(l > 0.f) || m <= kRareLog2;
}

// The unmasked builds' stand-in: no row is rare.
struct NoRef {
  static constexpr bool kOn = false;
  __device__ __forceinline__ void operator()(int, int, int) const {}
};

// The reference's softmax of one query row of a tile over its whole
// combined key axis, in plain float32, by one warp (a lane a key): a
// visible key's logit fl(qk / sqrt(D) + m), an invisible key's fl(-1e30 +
// m), a -inf logit no weight, NaN where every logit is -inf (the
// reference's softmax of such a row).  The keys' rows are those of the
// reference's k_all / v_all: the prefix rows, the paged rows (zeros for a
// block outside the pool), and with kInt8 the codes dequantized as (u -
// 128) * kd (vd) with the step's own tokens of the row overlaid at full
// precision.  Speed does not matter here: only rare rows come this way.
// C: the element type of the pools and the prefix rows (K4 over a cache
// whose dtype is not q's, Queue C12; T with kInt8).
template <typename T, bool kInt8, typename C = T>
struct RefRows {
  static_assert(!kInt8 || std::is_same<C, T>::value,
                "K4-int8's full-precision rows are q's dtype");
  static constexpr bool kOn = true;
  const T* q;                      // query row 0 of the tile
  void* out;
  size_t qo, hd;                   // out's element of row 0; a token's
  bool f32;
  int G, D, Lp, P, NB, bs;
  const C *pk, *pv;                // the row's prefix rows
  const void *kc, *vc;             // the pools (C, or uint8 with kInt8)
  const int* bt;                   // the row's block table
  size_t head, blk_stride;
  int b, pos0, t_first, h0;        // row, token 0's position and index
  float scale;                     // 1 / sqrt(D)
  RowMask rm;
  // kInt8: the step's k / v at head kh (a token `stride` elements apart),
  // the row's fresh positions fresh0 .. fresh0 + nfresh - 1 (token tok0
  // first), its dequantization scales
  const T *kf, *vf;
  long long kstride, vstride;
  int fresh0, nfresh, tok0;
  float kd, vd;

  // key j's K (V where `val`) row as k_all (v_all) holds it: its elements
  // (C), or uint8 codes dequantized as (u - 128) * s, or none (zeros; with
  // kInt8 the code 0 of a block outside the pool)
  struct Row {
    const void* p;
    bool u8;
    float s;
    __device__ __forceinline__ float at(int d) const {
      if (kInt8 && u8)
        return ((p != nullptr ? (float)static_cast<const uint8_t*>(p)[d]
                              : 0.f) - 128.f) * s;
      return p != nullptr ? ptt::to_f(static_cast<const C*>(p)[d]) : 0.f;
    }
  };

  __device__ __forceinline__ Row row_of(bool val, int j) const {
    if (j < Lp) return {(val ? pv : pk) + (size_t)j * D, false, 0.f};
    const int p = j - Lp;
    if constexpr (kInt8) {
      if (p >= fresh0 && p < fresh0 + nfresh)
        return {(val ? vf : kf) +
                    (long long)(tok0 + p - fresh0) * (val ? vstride : kstride),
                false, 0.f};
    }
    const int kb = p / bs;
    const int blk = bt[kb];
    const size_t o = (size_t)blk * blk_stride + head + (size_t)(p - kb * bs) * D;
    const bool in = blk >= 0 && blk < NB;
    if constexpr (kInt8)
      return {in ? static_cast<const uint8_t*>(val ? vc : kc) + o : nullptr,
              true, val ? vd : kd};
    return {in ? static_cast<const C*>(val ? vc : kc) + o : nullptr, false,
            0.f};
  }

  // the logit of query row r at key j
  __device__ __forceinline__ float logit(int r, int j) const {
    const float* mr = rm.row(h0 + r % G, t_first + r / G);
    const float m = mr != nullptr && j < rm.lm ? __ldg(mr + j) : 0.f;
    if (j >= Lp && j - Lp > pos0 + r / G) return -1e30f + m;
    if (m == -INFINITY) return -INFINITY;
    const T* qr = q + (size_t)(r / G) * hd + (size_t)(r % G) * D;
    const Row k = row_of(false, j);
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot = fmaf(ptt::to_f(qr[d]), k.at(d), dot);
    return dot * scale + m;
  }

  // columns d0 .. d1 - 1 of query row r's output (the whole warp calls)
  __device__ __forceinline__ void operator()(int r, int d0, int d1) const {
    const int lane = threadIdx.x % 32;
    const int Lf = Lp + P * bs;
    const size_t o = qo + (size_t)(r / G) * hd + (size_t)(r % G) * D;
    float M = -INFINITY;
    for (int j = lane; j < Lf; j += 32) M = fmaxf(M, logit(r, j));
    M = ptt::warp_max(M);
    if (M == -INFINITY) {
      for (int d = d0 + lane; d < d1; d += 32)
        ptt::put_out<T>(out, o + d, NAN, f32);
      return;
    }
    // a lane's columns d = c + lane, one pass of the keys for each
    for (int c = d0; c < d1; c += 32) {
      const int d = c + lane;
      float a = 0.f, l = 0.f;
      for (int jb = 0; jb < Lf; jb += 32) {
        const float w = jb + lane < Lf ? expf(logit(r, jb + lane) - M) : 0.f;
        l += w;
        for (int k = 0; k < 32; ++k) {
          const float wk = __shfl_sync(0xffffffffu, w, k);
          if (wk != 0.f && d < d1) a = fmaf(wk, row_of(true, jb + k).at(d), a);
        }
      }
      l = ptt::warp_sum(l);
      if (d < d1) ptt::put_out<T>(out, o + d, a / l, f32);
    }
  }
};

// The row tables, the zeros of the tokens that no tile owns, and the
// block's tile and key range over the combined axis (Lp prefix keys, then
// the paged context); false for a spare tile (nothing to attend).  Leaves
// s_blk filled (the split's block ids of its paged keys, -1 outside the
// pool); the caller synchronises before reading it.  kSliced: the grid's
// x takes output slices, not splits (the wide instance): every block
// walks the whole context, and the first slice writes the zeros.  C: the
// prefix rows' element type (the cache's).
template <typename T, bool kSliced = false, typename C = T>
__device__ bool setup_tile(Tile& t, int* tables, void* __restrict__ out,
                           bool f32,
                           const int* __restrict__ dec,
                           const int* __restrict__ now,
                           const int* __restrict__ cu,
                           const int* __restrict__ bt, const C* pk,
                           const C* pv, int T_, int B, int P, int NB, int H,
                           int G, int D, int bs, int Lp, int mq, int QT,
                           int chunk) {
  int* s_cu = tables;         // B + 1
  int* s_len = s_cu + B + 1;  // tokens of a row that a tile owns
  int* s_pt = s_len + B;      // B + 1: tiles before a row
  int* s_dec = s_pt + B + 1;
  int* s_blk = s_dec + B;
  const int rank = kSliced ? 0 : blockIdx.x, k = blockIdx.y, kh = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the row tables, all loads in flight together
  for (int i = tid; i <= B; i += kThreads) {
    s_cu[i] = cu[i];
    if (i < B) {
      s_len[i] = now[i];
      s_dec[i] = dec[i];
    }
  }
  __syncthreads();
  // a row owns its tokens at local index < min(now, max_q_len) inside its
  // cu range (and inside the buffer); pt by a scan of warp 0
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < B; base += 32) {
      const int i = base + lane;
      int n = 0;
      if (i < B) {
        const int span = min(s_cu[i + 1], T_) - s_cu[i];
        n = max(0, min(min(s_len[i], mq), span));
        s_len[i] = n;
      }
      const int tiles = (n + QT - 1) / QT;
      int incl = tiles;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      if (i < B) s_pt[i] = carry + incl - tiles;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_pt[B] = carry;
  }
  __syncthreads();

  // the zeros of the tokens no tile owns (past cu[B], past their row's
  // now, at a local index >= max_q_len): the first split (or slice) of
  // tile k takes tokens k, k + tiles, ...
  if (blockIdx.x == 0) {
    const int total = s_cu[B];
    for (int i = k; i < T_; i += gridDim.y) {
      bool owned = false;
      if (i < total) {
        int lo = 0, hi = B - 1;  // the last row b with cu[b] <= i
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (s_cu[mid] <= i)
            lo = mid;
          else
            hi = mid - 1;
        }
        const int local = i - s_cu[lo];
        owned = local >= 0 && local < s_len[lo];
      }
      if (!owned) {
        const size_t o = ((size_t)i * H + (size_t)kh * G) * D;
        for (int d = tid; d < G * D; d += kThreads)
          ptt::put_out<T>(out, o + d, 0.f, f32);
      }
    }
  }
  if (k >= s_pt[B]) return false;  // the same in the whole cluster

  int b = 0, hi = B - 1;  // the last row with pt[b] <= k owns tile k
  while (b < hi) {
    const int mid = (b + hi + 1) / 2;
    if (s_pt[mid] <= k)
      b = mid;
    else
      hi = mid - 1;
  }
  t.b = b;
  t.t_first = (k - s_pt[b]) * QT;
  t.nt = min(QT, s_len[b] - t.t_first);
  t.nr = t.nt * G;  // query rows: r = token * G + head
  t.ctx = P * bs;
  t.pos0 = s_dec[b] + t.t_first;
  t.Lp = Lp;
  const size_t pre = ((size_t)b * (H / G) + kh) * Lp * D;
  t.pk = Lp > 0 ? pk + pre : nullptr;
  t.pv = Lp > 0 ? pv + pre : nullptr;
  // the whole prefix, then paged keys up to the tile's last position
  const int n_max = Lp + min(t.pos0 + t.nt - 1, t.ctx - 1) + 1;
  t.c0 = rank * chunk;
  t.c1 = min(t.c0 + chunk, n_max);
  t.qo = (((size_t)s_cu[b] + t.t_first) * H + (size_t)kh * G) * D;
  // the paged part of [c0, c1): paged keys p0 .. p1 - 1
  const int p0 = max(t.c0 - Lp, 0), p1 = t.c1 - Lp;
  t.b0 = p0 / bs;
  const int nblk = p1 > p0 ? (p1 - 1) / bs - t.b0 + 1 : 0;
  for (int i = tid; i < nblk; i += kThreads) {
    const int blk = bt[(size_t)b * P + t.b0 + i];
    s_blk[i] = blk >= 0 && blk < NB ? blk : -1;
  }
  return true;
}

// How a thread copies K and V rows, through the block ids, in pieces of
// `bytes` (16, 8, 4 or 2: the largest a row's D * sizeof(T) bytes allow):
// where a row has at most kThreads pieces, the piece c of rows j0,
// j0 + jstep, ... of every tile (the same piece every tile, so the index
// arithmetic is done once); else (jstep 0) the block walks the tile's
// pieces in order.  block_size a power of two is a shift.
struct Copier {
  int c, j0, jstep, bsh;
  int cpr, pe, bytes;       // pieces a row, elements and bytes a piece
  size_t head, blk_stride;  // element offsets of head kh, of one block
};

template <typename T>
__device__ __forceinline__ Copier make_copier(int KV, int kh, int D, int bs) {
  Copier cp;
  cp.bytes = ptt::tc::piece_bytes(D * (int)sizeof(T));
  cp.pe = cp.bytes / (int)sizeof(T);
  const int cpr = D / cp.pe;  // pieces of a row
  cp.cpr = cpr;
  cp.jstep = cpr <= kThreads ? kThreads / cpr : 0;
  cp.c = threadIdx.x % cpr;
  // threads past jstep * cpr copy nothing
  cp.j0 = (int)threadIdx.x < cp.jstep * cpr ? threadIdx.x / cpr : 1 << 30;
  cp.bsh = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  cp.head = (size_t)kh * bs * D;
  cp.blk_stride = (size_t)KV * bs * D;
  return cp;
}

// piece c of K and V row j of a tile (key t0 + j) into its stage: a prefix
// key's from its row of pk / pv, a paged key's through its block id; keys
// past c1 and blocks outside the pool are zero-filled without a read.  PB:
// the piece's bytes where the instance fixes them (16 on the tensor
// cores), 0 to take the copier's
template <typename T, int PB>
__device__ __forceinline__ void copy_kv(T* ks, T* vs, const T* kc,
                                        const T* vc, const int* s_blk,
                                        const Tile& t, const Copier& cp,
                                        int j, int c, int t0, int rs, int D,
                                        int bs) {
  const int pe = PB ? PB / (int)sizeof(T) : cp.pe;
  const int bytes = PB ? PB : cp.bytes;
  const int key = t0 + j;
  size_t o = 0;
  bool ok = false;
  if (key < t.c1) {
    if (key < t.Lp) {  // a prefix row (contiguous)
      kc = static_cast<const T*>(t.pk);
      vc = static_cast<const T*>(t.pv);
      o = (size_t)key * D + (size_t)c * pe;
      ok = true;
    } else {
      const int pk = key - t.Lp;  // the paged key
      const int kb = cp.bsh >= 0 ? pk >> cp.bsh : pk / bs;
      const int blk = s_blk[kb - t.b0];
      if (blk >= 0) {
        o = blk * cp.blk_stride + cp.head + (size_t)(pk - kb * bs) * D +
            (size_t)c * pe;
        ok = true;
      }
    }
  }
  const int so = j * rs + c * pe;
  ptt::tc::copy_piece(ptt::tc::smem_u32(ks + so), kc + o, ok, bytes);
  ptt::tc::copy_piece(ptt::tc::smem_u32(vs + so), vc + o, ok, bytes);
}

// K and V rows t0 .. t0 + KT - 1 of the split into a stage (rows `rs`
// elements apart); keys past c1 and blocks outside the pool are
// zero-filled without a read.  One commit group.
template <typename T, int KT, int PB>
__device__ __forceinline__ void issue_tile(T* ks, const T* kc, const T* vc,
                                           const int* s_blk, const Tile& t,
                                           const Copier& cp, int t0, int rs,
                                           int D, int bs) {
  T* vs = ks + KT * rs;
  if (PB == 16 || cp.jstep > 0) {
    for (int j = cp.j0; j < KT; j += cp.jstep)
      copy_kv<T, PB>(ks, vs, kc, vc, s_blk, t, cp, j, cp.c, t0, rs, D, bs);
  } else {
    for (int i = threadIdx.x; i < KT * cp.cpr; i += kThreads) {
      const int j = i / cp.cpr;
      copy_kv<T, PB>(ks, vs, kc, vc, s_blk, t, cp, j, i - j * cp.cpr, t0, rs,
                    D, bs);
    }
  }
  ptt::tc::cp_async_commit();
}

// Wait until tile `it` of a ring of `stages` has landed for every thread
// (the later ones stay in flight).
__device__ __forceinline__ void ring_land(int stages, int it, int ntile) {
  const int pending = min(stages - 1, ntile - 1 - it);
  if (pending >= 2)
    ptt::tc::cp_async_wait<2>();
  else if (pending == 1)
    ptt::tc::cp_async_wait<1>();
  else
    ptt::tc::cp_async_wait<0>();
  __syncthreads();
}

// The ring of `stages` K/V tiles: before tile `it`, issue tile
// it + stages - 1 into the stage that tile it - 1 left, then wait until
// tile it has landed for every thread (the later ones stay in flight).
// Returns tile it's stage.
template <typename T, int KT, int PB>
__device__ __forceinline__ const T* ring_wait(T* stage, int stages, int it,
                                              int ntile, const T* kc,
                                              const T* vc, const int* s_blk,
                                              const Tile& t, const Copier& cp,
                                              int rs, int D, int bs) {
  const size_t step = (size_t)2 * KT * rs;
  const int nx = it + stages - 1;
  if (nx < ntile)
    issue_tile<T, KT, PB>(stage + (nx % stages) * step, kc, vc, s_blk, t, cp,
                      t.c0 + nx * KT, rs, D, bs);
  ring_land(stages, it, ntile);
  return stage + (it % stages) * step;
}

// RefRows for the block's tile (the masked builds), recomputed where it is
// used from the row tables in shared memory (setup_tile's), blockIdx and
// the kernel's parameters: no value of the walk is kept live for it, so
// the walk is allocated as in a build without the rare rows.
template <typename T, bool kInt8, typename C = T>
__device__ __forceinline__ RefRows<T, kInt8, C> ref_rows(
    const int* tables, const T* q, void* out, bool f32, const void* kc,
    const void* vc, const C* pk, const C* pv, const int* bt, int B, int P,
    int NB, int H, int KV, int D, int bs, int Lp, int QT, float scale_log2,
    const Masks& mk) {
  const int* s_cu = tables;
  const int* s_pt = s_cu + 2 * B + 1;
  const int* s_dec = s_pt + B + 1;
  const int k = blockIdx.y, kh = blockIdx.z, G = H / KV;
  int b = 0, hi = B - 1;  // the last row with pt[b] <= k owns tile k
  while (b < hi) {
    const int mid = (b + hi + 1) / 2;
    if (s_pt[mid] <= k)
      b = mid;
    else
      hi = mid - 1;
  }
  RefRows<T, kInt8, C> f = {};
  f.b = b;
  f.t_first = (k - s_pt[b]) * QT;
  f.pos0 = s_dec[b] + f.t_first;
  f.qo = (((size_t)s_cu[b] + f.t_first) * H + (size_t)kh * G) * D;
  f.q = q + f.qo;
  f.out = out;
  f.hd = (size_t)H * D;
  f.f32 = f32;
  f.G = G;
  f.D = D;
  f.Lp = Lp;
  f.P = P;
  f.NB = NB;
  f.bs = bs;
  const size_t pre = ((size_t)b * KV + kh) * Lp * D;
  f.pk = Lp > 0 ? pk + pre : nullptr;
  f.pv = Lp > 0 ? pv + pre : nullptr;
  f.kc = kc;
  f.vc = vc;
  f.bt = bt + (size_t)b * P;
  f.head = (size_t)kh * bs * D;
  f.blk_stride = (size_t)KV * bs * D;
  f.h0 = kh * G;
  f.scale = scale_log2 / kLog2e;
  f.rm = row_mask(mk, b);
  return f;
}

// the int8 fields of RefRows: the step's tokens of row b are the valid
// ones of the reference (local index < now[b], inside cu and the buffer)
template <typename T>
__device__ __forceinline__ void ref_int8(RefRows<T, true>& f,
                                         const int* tables, const T* kf,
                                         const T* vf, long long kstride,
                                         long long vstride, const float* kdq,
                                         const float* vdq, const int* now,
                                         int T_, int KV) {
  const int* s_cu = tables;
  const int b = f.b, kh = blockIdx.z;
  f.kf = kf + (size_t)kh * f.D;
  f.vf = vf + (size_t)kh * f.D;
  f.kstride = kstride;
  f.vstride = vstride;
  f.fresh0 = f.pos0 - f.t_first;
  f.tok0 = s_cu[b];
  f.nfresh = max(0, min(now[b], min(s_cu[b + 1], T_) - f.tok0));
  f.kd = kdq[(size_t)b * KV + kh];
  f.vd = vdq[(size_t)b * KV + kh];
}

// The output of a block's rows from its (m, l, acc) (acc rows `astride`
// floats apart, unnormalised), row 0 at element qo of out (T, or float32
// where f32).  With one split, acc / l; with a cluster, the leader weighs
// split s by exp2(m_s - M), M the largest m (a split that saw no key, m =
// -inf, weighs 0), reading the others' shared memory.  A rare row (Queue
// C10, the masked builds) takes `ref` instead, a warp a row, after the
// merge.  The caller synchronises the block first.
template <typename T, typename Ref = NoRef>
__device__ void finish(void* __restrict__ out, size_t qo, bool f32,
                       size_t hd, int G, int D, int nr, int astride, int RP,
                       float* mrow, float* lrow, float* acc, float* ws,
                       const Ref& ref = Ref()) {
  const int tid = threadIdx.x, warp = tid / 32;
  const int splits = gridDim.x;
  if (splits == 1) {
    for (int idx = tid; idx < nr * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      const float l = lrow[r];
      if constexpr (Ref::kOn) {
        if (rare_row(mrow[r], l)) continue;
      }
      ptt::put_out<T>(out, qo + (size_t)(r / G) * hd + (r % G) * D + d,
                      l > 0.f ? acc[(size_t)r * astride + d] / l : 0.f, f32);
    }
    if constexpr (Ref::kOn) {
      for (int r = warp; r < nr; r += kWarps)
        if (rare_row(mrow[r], lrow[r])) ref(r, 0, D);
    }
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every split's (m, l, acc) is in its shared memory
  if (blockIdx.x == 0) {
    for (int r = tid; r < nr; r += kThreads) {
      float M = -INFINITY;
      for (int s = 0; s < splits; ++s)
        M = fmaxf(M, cl.map_shared_rank(mrow, s)[r]);
      float Lsum = 0.f;
      for (int s = 0; s < splits; ++s) {
        const float ms = cl.map_shared_rank(mrow, s)[r];
        const float w = ms == -INFINITY ? 0.f : exp2f(ms - M);
        ws[s * RP + r] = w;
        Lsum += w * cl.map_shared_rank(lrow, s)[r];
      }
      // a rare row's -1 sends it to `ref`
      ws[splits * RP + r] = Ref::kOn && rare_row(M, Lsum) ? -1.f
                            : Lsum > 0.f                  ? 1.f / Lsum
                                                          : 0.f;
    }
    __syncthreads();
    // 4 columns a thread (acc rows hold at least D rounded up to 4)
    const int nq = (D + 3) / 4;
    for (int idx = tid; idx < nr * nq; idx += kThreads) {
      const int r = idx / nq, d = (idx - r * nq) * 4;
      const size_t ai = (size_t)r * astride + d;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < splits; ++s) {
        const float w = ws[s * RP + r];
        if (w != 0.f) {
          const float4 v = *reinterpret_cast<const float4*>(
              cl.map_shared_rank(acc, s) + ai);
          sum.x += w * v.x;
          sum.y += w * v.y;
          sum.z += w * v.z;
          sum.w += w * v.w;
        }
      }
      const float inv = ws[splits * RP + r];
      if (Ref::kOn && inv < 0.f) continue;
      const size_t od = qo + (size_t)(r / G) * hd + (r % G) * D + d;
      const float x[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < D) ptt::put_out<T>(out, od + e, x[e] * inv, f32);
    }
    if constexpr (Ref::kOn) {
      for (int r = warp; r < nr; r += kWarps)
        if (ws[splits * RP + r] < 0.f) ref(r, 0, D);
    }
  }
  cl.sync();  // no split leaves while the leader still reads it
}

// ---------------------------------------------------------------- SIMT
// float32, and bfloat16 with D not a multiple of 8 or past 256.  The
// query rows, the K/V tiles' rows and the accumulators hold DA = D padded
// to 8 columns, zero past D.  Scores and probabilities in shared memory;
// thread (rg, j) scores key j for rows rg, rg + NRG, ...; thread (kg, rsl,
// dc) adds keys kg, kg + KG, ... into columns [8 dc, 8 dc + 8) of rows rsl,
// rsl + RSL, ... of partial kg.  PB: 16 where a row is whole 16-byte
// pieces (the copies' sizes fixed at compile time), else 0.  kMask: the
// masks' term on every visible score.  C: the element type of the pools
// and the pre-caches, T's but for a float32 q over a bfloat16 cache
// (Queue C12: the cache_dtype of a float32 engine): the ring holds the
// tiles at their stored width, by the same cp.async pieces, and the reads
// from shared memory (load8) widen them to float32.
template <typename T, typename C, int KT, int PB, bool kMask>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const C* __restrict__ kc,
    const C* __restrict__ vc, void* __restrict__ out,
    const int* __restrict__ dec, const int* __restrict__ now,
    const int* __restrict__ cu, const int* __restrict__ bt, const C* pk,
    const C* pv, int T_, int B, int P, int NB, int H, int KV, int D, int bs,
    int Lp, int mq, int QT, int chunk, int stages, float scale_log2,
    int out_f32, Masks mk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int R = QT * G;
  const Layout L =
      layout(false, R, D, sizeof(C), KT, stages, gridDim.x, B, chunk, bs);
  C* stage = reinterpret_cast<C*>(smem + L.stage);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.s);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* mrow = reinterpret_cast<float*>(smem + L.stats);
  float* lrow = mrow + R;
  float* corr = lrow + R;
  int* lim = reinterpret_cast<int*>(corr + R);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  int* tables = reinterpret_cast<int*>(smem + L.tables);
  const int* s_blk = tables + 4 * B + 2;
  const int kh = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  Tile t;
  if (!setup_tile<T, false, C>(t, tables, out, out_f32, dec, now, cu, bt, pk,
                               pv, T_, B, P, NB, H, G, D, bs, Lp, mq, QT,
                               chunk))
    return;
  const int nr = t.nr, c0 = t.c0, c1 = t.c1;
  const size_t hd = (size_t)H * D;
  const int DA = simt_cols(D);
  const int rs = L.rstride;
  RowMask rm = {};
  if constexpr (kMask) rm = row_mask(mk, t.b);
  for (int idx = tid; idx < nr * DA; idx += kThreads) {
    const int r = idx / DA, d = idx - r * DA;
    qs[idx] = d < D ? ptt::to_f(q[t.qo + (size_t)(r / G) * hd + (r % G) * D +
                                 d]) *
                          scale_log2
                    : 0.f;
  }
  for (int idx = tid; idx < L.KG * R * DA; idx += kThreads) acc[idx] = 0.f;
  for (int r = tid; r < nr; r += kThreads) {
    // the last visible key on the combined axis: the prefix, then the
    // row's paged keys up to its position
    lim[r] = Lp + min(t.pos0 + r / G, t.ctx - 1);
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
  // the columns D .. DA - 1 of every stage row stay zero (the copies write
  // columns < D only)
  for (int idx = tid; idx < 2 * stages * KT * (DA - D); idx += kThreads) {
    const int row = idx / (DA - D);
    stage[row * rs + D + idx - row * (DA - D)] = ptt::from_f<C>(0.f);
  }
  __syncthreads();  // s_blk before the first copies

  const int ntile = c1 > c0 ? (c1 - c0 + KT - 1) / KT : 0;
  const int DC = DA / kVec;
  const int slots = kThreads / DC;
  const int RSL = slots / L.KG;
  const int dc = tid % DC, slot = tid / DC;
  const int kg = slot % L.KG, rsl = slot / L.KG;
  const bool in_pv = slot < RSL * L.KG;  // past that, a thread idles in P @ V
  constexpr int NRG = kThreads / KT;
  const int sj = tid % KT, rg = tid / KT;

  const Copier cp = make_copier<C>(KV, kh, D, bs);
  for (int i = 0; i < stages - 1 && i < ntile; ++i)
    issue_tile<C, KT, PB>(stage + (size_t)i * 2 * KT * rs, kc, vc, s_blk, t,
                         cp, c0 + i * KT, rs, D, bs);
  for (int it = 0; it < ntile; ++it) {
    const C* ks = ring_wait<C, KT, PB>(stage, stages, it, ntile, kc, vc,
                                      s_blk, t, cp, rs, D, bs);
    const C* vs = ks + KT * rs;
    const int t0 = c0 + it * KT;
    const int kcount = min(KT, c1 - t0);
    // the mask only where a row's last visible key or the split's end
    // falls inside this tile (lim grows with the row)
    const bool full = t0 + KT <= c1 && t0 + KT - 1 <= lim[0];

    {  // scores (log2 domain)
      const C* krow = ks + sj * rs;
      const int key = t0 + sj;
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
          if (r < nr) {
            float v = full || (key < c1 && key <= lim[r]) ? s[k] : -INFINITY;
            if constexpr (kMask) {
              if (v != -INFINITY)
                v += mask_term(rm.row(kh * G + r % G, t.t_first + r / G),
                               rm.lm, key);
            }
            sc[r * KT + sj] = v;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows w, w + kWarps, ...
    for (int r = warp; r < nr; r += kWarps) {
      float* row = sc + r * KT;
      float mx = -INFINITY;
      for (int jj = lane; jj < KT; jj += 32) mx = fmaxf(mx, row[jj]);
      mx = ptt::warp_max(mx);
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      // a row with no visible key yet keeps m = -inf and p = 0
      const bool none = m_new == -INFINITY;
      for (int jj = lane; jj < KT; jj += 32) {
        const float p = none ? 0.f : exp2f(row[jj] - m_new);
        row[jj] = p;
        sum += p;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float c = none ? 1.f : exp2f(m_old - m_new);  // -inf -> 0
        corr[r] = c;
        lrow[r] = lrow[r] * c + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();

    if (in_pv) {  // P @ V
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
        for (int jj = kg; jj < kcount; jj += L.KG) {
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
    __syncthreads();  // stage it % stages and the probabilities are free
  }

  // the key groups' partials add up into partial 0
  if (L.KG > 1) {
    for (int idx = tid; idx < nr * DA; idx += kThreads) {
      float s = 0.f;
      for (int g = 0; g < L.KG; ++g) s += acc[(size_t)g * R * DA + idx];
      acc[idx] = s;
    }
    __syncthreads();
  }
  if constexpr (kMask)
    finish<T>(out, t.qo, out_f32, hd, G, D, nr, DA, R, mrow, lrow, acc, ws,
              ref_rows<T, false, C>(tables, q, out, out_f32, kc, vc, pk, pv,
                                    bt, B, P, NB, H, KV, D, bs, Lp, QT,
                                    scale_log2, mk));
  else
    finish<T>(out, t.qo, out_f32, hd, G, D, nr, DA, R, mrow, lrow, acc, ws);
}

// -------------------------------------------------------- tensor cores
// bfloat16 with D a multiple of 8 up to 256: mma.sync.m16n8k16 (bf16 -> f32) on
// ldmatrix fragments of the padded tiles.  Warp w takes 16 query rows
// (slab w / KG) and keys [(w % KG) * 64 / KG, ...) of every 64-key tile,
// with its own online softmax (float32 m, l and the output in registers);
// the probabilities become the P @ V operand without leaving registers.
// After the walk the KG key groups merge in shared memory.

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

// What K4-int8's tensor-core instance reads beside K4's operands (the
// K4-int8 section below): its uint8 pools, this step's k / v rows and the
// row's dequantization scales
struct Int8Src {
  const uint8_t *kc, *vc;              // the uint8 pools
  const __nv_bfloat16 *kf, *vf;        // this step's k / v at head kh
  long long kstride, vstride;          // elements between two tokens
  // the row's first fresh key on the combined axis (Lp + its dec); a
  // fresh key k's token is tok0 + k; keys Lp .. dec - 1 are cached
  int dec, tok0;
  float kd, vd;   // the row's dequantization scales
};

// K4-int8's copier: pieces of 16 columns where D % 16 == 0, else 8 (a
// cached key's piece is that many uint8 codes, a fresh key's twice as
// many bytes of bf16); piece c of rows j0, j0 + jstep, ... of every tile
__device__ __forceinline__ Copier make_copier_int8(int KV, int kh, int D,
                                                   int bs) {
  Copier cp;
  cp.pe = D % 16 == 0 ? 16 : 8;
  cp.bytes = cp.pe;
  cp.cpr = D / cp.pe;  // at most 32 (D <= 256)
  cp.jstep = kThreads / cp.cpr;
  cp.c = threadIdx.x % cp.cpr;
  cp.j0 = (int)threadIdx.x < cp.jstep * cp.cpr ? threadIdx.x / cp.cpr
                                                : 1 << 30;
  cp.bsh = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  cp.head = (size_t)kh * bs * D;
  cp.blk_stride = (size_t)KV * bs * D;
  return cp;
}

// K and V rows t0 .. t0 + 63 of the split into a stage of bf16-sized rows
// (`rs` elements apart): a cached key's (Lp <= key < dec) codes into the
// first D bytes of its rows, zeros (uint8 0) for a block outside the pool,
// to be expanded in place once they land (expand_codes); a prefix key's
// (key < Lp) bf16 rows whole from pk / pv, a fresh key's from k / v; zeros
// for a key past c1.  One commit group.
__device__ __forceinline__ void issue_tile_int8(
    __nv_bfloat16* ks, const Int8Src& s8, const int* s_blk, const Tile& t,
    const Copier& cp, int t0, int rs, int D, int bs) {
  using bf = __nv_bfloat16;
  bf* vs = ks + kTcKeys * rs;
  for (int j = cp.j0; j < kTcKeys; j += cp.jstep) {
    const int key = t0 + j;
    const int so = j * rs + cp.c * cp.pe;  // the piece's first element
    if (key < t.c1 && key >= t.Lp && key < s8.dec) {
      const int pk = key - t.Lp;  // the paged key
      const int kb = cp.bsh >= 0 ? pk >> cp.bsh : pk / bs;
      const int blk = s_blk[kb - t.b0];
      size_t o = 0;
      if (blk >= 0)
        o = blk * cp.blk_stride + cp.head + (size_t)(pk - kb * bs) * D +
            (size_t)cp.c * cp.pe;
      // code c * pe of the row at its byte c * pe
      const uint32_t kd = ptt::tc::smem_u32(ks + j * rs) + cp.c * cp.pe;
      const uint32_t vd = ptt::tc::smem_u32(vs + j * rs) + cp.c * cp.pe;
      ptt::tc::copy_piece(kd, s8.kc + o, blk >= 0, cp.pe);
      ptt::tc::copy_piece(vd, s8.vc + o, blk >= 0, cp.pe);
    } else {  // a prefix or fresh key's full-precision row, or zeros
      const bool ok = key < t.c1;
      const bf *kp, *vp;
      if (ok && key < t.Lp) {
        kp = static_cast<const bf*>(t.pk) + (size_t)key * D;
        vp = static_cast<const bf*>(t.pv) + (size_t)key * D;
      } else {
        const long long tok = ok ? (long long)s8.tok0 + key : 0;
        kp = s8.kf + tok * s8.kstride;
        vp = s8.vf + tok * s8.vstride;
      }
      kp += cp.c * cp.pe;
      vp += cp.c * cp.pe;
      for (int h = 0; h < cp.pe; h += 8) {
        ptt::tc::cp_async16(ptt::tc::smem_u32(ks + so + h), kp + h, ok);
        ptt::tc::cp_async16(ptt::tc::smem_u32(vs + so + h), vp + h, ok);
      }
    }
  }
  ptt::tc::cp_async_commit();
}

// 8 codes u (the bytes of w) as the bf16 values u - 128, exactly: a byte
// in the low mantissa of 2^23 is the float 2^23 + u, and less 2^23 + 128
// it is u - 128, a float whose low 16 bits are zero, so that its high
// half is its bf16
__device__ __forceinline__ uint4 codes8_bf16(uint2 w) {
  constexpr uint32_t kMagic = 0x4B000000u;  // 2^23
  constexpr float kBias = 8388736.f;        // 2^23 + 128
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = i < 2 ? w.x : w.y;
    const uint32_t sel = 0x7650u + 2 * (i & 1);
    const float lo = __uint_as_float(__byte_perm(x, kMagic, sel)) - kBias;
    const float hi =
        __uint_as_float(__byte_perm(x, kMagic, sel + 1)) - kBias;
    r[i] = __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// One row's D codes, in its first D bytes, as bf16 u - 128 over its first
// 2 D bytes, in place: from the last codes to the first (8 where D % 16 ==
// 8, then 16 at a time), so that no code is overwritten before it is read
__device__ __forceinline__ void expand_row(unsigned char* p, int D) {
  if (D % 16)
    *reinterpret_cast<uint4*>(p + 2 * (D - 8)) =
        codes8_bf16(*reinterpret_cast<const uint2*>(p + D - 8));
  for (int c = D / 16 - 1; c >= 0; --c) {
    const uint4 w = *reinterpret_cast<const uint4*>(p + 16 * c);
    const uint4 lo = codes8_bf16(make_uint2(w.x, w.y));
    const uint4 hi = codes8_bf16(make_uint2(w.z, w.w));
    *reinterpret_cast<uint4*>(p + 32 * c) = lo;
    *reinterpret_cast<uint4*>(p + 32 * c + 16) = hi;
  }
}

// The codes of a landed stage's cached keys (lo <= key < clim, lo the
// prefix's length and clim = min(dec, c1)) that key group kgrp reads,
// expanded in place by the group itself: its 64 / KG keys' K and V rows,
// one row a thread of its 4 / KG warps; then the group's warps wait for
// each other only (one warp at 4 key groups, a named barrier at 2, the
// block at 1).
template <int KG>
__device__ __forceinline__ void expand_codes(__nv_bfloat16* ks, int t0,
                                             int lo, int clim, int rs, int D,
                                             int warp, int lane) {
  constexpr int KW = kTcKeys / KG;
  const int kgrp = warp % KG;
  const int li = (warp / KG) * 32 + lane;  // 0 .. 2 KW - 1
  const int j = kgrp * KW + li % KW;
  if (t0 + j >= lo && t0 + j < clim)
    expand_row(reinterpret_cast<unsigned char*>(
                   ks + ((li < KW ? 0 : kTcKeys) + j) * rs),
               D);
  if (KG == 4)
    __syncwarp();
  else if (KG == 2)
    ptt::tc::named_sync(1 + kgrp, 64);
  else
    __syncthreads();
}

// The tensor-core walk of K4 (kInt8 false: bf16 pools kc / vc) and of
// K4-int8 (kInt8: uint8 pools k8 / v8 with the row's scales, this step's
// keys from kf / vf), both after the prefix pk / pv where Lp > 0.
// K4-int8's stage rows take a cached key's codes, expanded in place to
// bf16 u - 128 once they land, or a prefix or fresh key's bf16 row; a
// cached key's score is kd (q . code) and its probability is weighed by vd
// before the P V product packs it to bf16, the others' by 1, so that (m,
// l, O) are in value units throughout.
template <int DP, int KG, bool kInt8, bool kMask>
__device__ __forceinline__ void tc_attend(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const uint8_t* __restrict__ k8,
    const uint8_t* __restrict__ v8, const __nv_bfloat16* __restrict__ kf,
    const __nv_bfloat16* __restrict__ vf, const float* __restrict__ kdq,
    const float* __restrict__ vdq, long long kstride, long long vstride,
    void* __restrict__ out, const int* __restrict__ dec,
    const int* __restrict__ now, const int* __restrict__ cu,
    const int* __restrict__ bt, const __nv_bfloat16* pk,
    const __nv_bfloat16* pv, int T_, int B, int P, int NB, int H, int KV,
    int D, int bs, int Lp, int mq, int QT, int chunk, int stages,
    float scale_log2, bool f32, const Masks& mk) {
  using bf = __nv_bfloat16;
  constexpr int KT = kTcKeys;
  constexpr int KW = KT / KG;    // keys of a tile a warp takes
  constexpr int NK = KW / 8;     // its score n-tiles
  constexpr int ND = DP / 8;     // output n-tiles
  constexpr int RP = 16 * (kWarps / KG);
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const Layout L =
      layout(true, QT * G, D, 2, KT, stages, gridDim.x, B, chunk, bs);
  const int rs = L.rstride;
  bf* stage = reinterpret_cast<bf*>(smem + L.stage);
  bf* qs = reinterpret_cast<bf*>(smem + L.q);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* mrow = reinterpret_cast<float*>(smem + L.stats);
  float* lrow = mrow + RP;
  int* lim = reinterpret_cast<int*>(lrow + RP);
  float* mpart = reinterpret_cast<float*>(smem + L.part);  // KG x RP
  float* lpart = mpart + KG * RP;
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  int* tables = reinterpret_cast<int*>(smem + L.tables);
  const int* s_blk = tables + 4 * B + 2;
  const int kh = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  Tile t;
  if (!setup_tile<bf>(t, tables, out, f32, dec, now, cu, bt, pk, pv, T_, B,
                      P, NB, H, G, D, bs, Lp, mq, QT, chunk))
    return;
  const int nr = t.nr, c0 = t.c0, c1 = t.c1;
  const size_t hd = (size_t)H * D;
  Int8Src s8 = {};
  if constexpr (kInt8) {
    s8.kc = k8;
    s8.vc = v8;
    s8.kf = kf + (size_t)kh * D;
    s8.vf = vf + (size_t)kh * D;
    s8.kstride = kstride;
    s8.vstride = vstride;
    s8.dec = Lp + t.pos0 - t.t_first;
    s8.tok0 = tables[t.b] - s8.dec;  // s_cu[b]: the token of key dec
    s8.kd = kdq[(size_t)t.b * KV + kh];
    s8.vd = vdq[(size_t)t.b * KV + kh];
  }
  // keys Lp .. clim - 1 read codes; a cached key's scores take kd too
  const int clim = kInt8 ? min(s8.dec, c1) : 0;
  const float scale_kd = scale_log2 * s8.kd;
  // query rows as bf16, rows past nr and columns past D zero
  for (int idx = tid; idx < RP * ND; idx += kThreads) {
    const int r = idx / ND, c = (idx - r * ND) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < nr && c < D)
      v = *reinterpret_cast<const uint4*>(
          q + t.qo + (size_t)(r / G) * hd + (r % G) * D + c);
    *reinterpret_cast<uint4*>(qs + r * rs + c) = v;
  }
  for (int r = tid; r < RP; r += kThreads)
    lim[r] = r < nr ? Lp + min(t.pos0 + r / G, t.ctx - 1) : -1;
  if (D < DP) {  // the columns past D of both stages stay zero
    const int pc = (DP - D) / 8;
    for (int idx = tid; idx < 2 * stages * KT * pc; idx += kThreads) {
      const int row = idx / pc, c = D + (idx - row * pc) * 8;
      *reinterpret_cast<uint4*>(stage + row * rs + c) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();  // s_blk, q, lim

  const int ntile = c1 > c0 ? (c1 - c0 + KT - 1) / KT : 0;
  const int slab = warp / KG, kgrp = warp % KG;
  const int kbase = kgrp * KW;
  const int g = lane / 4, tig = lane % 4;
  const int row0 = slab * 16 + g;  // this thread's rows: row0, row0 + 8
  const bool active = slab * 16 < nr;
  const int lim0 = lim[row0], lim1 = lim[row0 + 8];
  // the mask rows of this thread's rows row0 and row0 + 8 (null past nr)
  const float *mrow0 = nullptr, *mrow1 = nullptr;
  int mlm = 0;
  if constexpr (kMask) {
    const RowMask rm = row_mask(mk, t.b);
    mlm = rm.lm;
    if (row0 < nr) mrow0 = rm.row(kh * G + row0 % G, t.t_first + row0 / G);
    if (row0 + 8 < nr)
      mrow1 = rm.row(kh * G + (row0 + 8) % G, t.t_first + (row0 + 8) / G);
  }
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  const size_t step = (size_t)2 * KT * rs;
  const Copier cp = kInt8 ? make_copier_int8(KV, kh, D, bs)
                          : make_copier<bf>(KV, kh, D, bs);
  for (int i = 0; i < stages - 1 && i < ntile; ++i) {
    if constexpr (kInt8)
      issue_tile_int8(stage + i * step, s8, s_blk, t, cp, c0 + i * KT, rs, D,
                      bs);
    else
      issue_tile<bf, KT, 16>(stage + i * step, kc, vc, s_blk, t, cp,
                             c0 + i * KT, rs, D, bs);
  }
  for (int it = 0; it < ntile; ++it) {
    const int t0 = c0 + it * KT;
    const bf* ks;
    if constexpr (kInt8) {
      const int nx = it + stages - 1;
      if (nx < ntile)
        issue_tile_int8(stage + (nx % stages) * step, s8, s_blk, t, cp,
                        c0 + nx * KT, rs, D, bs);
      ring_land(stages, it, ntile);
      bf* st = stage + (it % stages) * step;
      // the same in the whole block
      if (t0 < clim && t0 + KT > Lp)
        expand_codes<KG>(st, t0, Lp, clim, rs, D, warp, lane);
      ks = st;
    } else {
      ks = ring_wait<bf, KT, 16>(stage, stages, it, ntile, kc, vc, s_blk, t,
                                 cp, rs, D, bs);
    }
    const bf* vs = ks + KT * rs;
    if (active) {
      // S = Q K^T over this warp's KW keys
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, qs + (slab * 16 + lane % 16) * rs + kk * 16 +
                       (lane / 16) * 8);
#pragma unroll
        for (int n2 = 0; n2 < NK / 2; ++n2) {
          uint32_t bk[4];
          const int key = kbase + n2 * 16 + lane % 8 + (lane / 16) * 8;
          ldsm_x4(bk, ks + key * rs + kk * 16 + ((lane / 8) % 2) * 8);
          mma_bf16(s[2 * n2], a, bk[0], bk[1]);
          mma_bf16(s[2 * n2 + 1], a, bk[2], bk[3]);
        }
      }
      // scale into the log2 domain (a cached key's by kd too); the causal
      // mask only where a row's last visible key or the split's end falls
      // inside this tile; the additive masks' term (kMask) on every
      // visible key, after the scale
      const bool full = t0 + KT <= c1 && t0 + KT - 1 <= lim[0];
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = t0 + kbase + n * 8 + 2 * tig + (e & 1);
          float v = s[n][e] * (kInt8 && key >= Lp && key < clim ? scale_kd
                                                                : scale_log2);
          if (!full) {
            if (!(key < c1 && key <= (e < 2 ? lim0 : lim1))) v = -INFINITY;
          }
          if constexpr (kMask) {
            if (v != -INFINITY)
              v += mask_term(e < 2 ? mrow0 : mrow1, mlm, key);
          }
          s[n][e] = v;
        }
      // online softmax of rows row0 and row0 + 8 (a quad holds a row)
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      // a row with no visible key yet keeps m = -inf and p = 0
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
      // (K4-int8: a cached key's probability weighed by vd first)
#pragma unroll
      for (int kk = 0; kk < NK / 2; ++kk) {
        float w[4] = {1.f, 1.f, 1.f, 1.f};  // keys k0, k0 + 1, +8, +9
        if constexpr (kInt8) {
          const int k0 = t0 + kbase + 16 * kk + 2 * tig;
          const int off[4] = {0, 1, 8, 9};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = k0 + off[i] >= Lp && k0 + off[i] < clim ? s8.vd : 1.f;
        }
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0] * w[0], s[2 * kk][1] * w[1]);
        a[1] = pack_bf16(s[2 * kk][2] * w[0], s[2 * kk][3] * w[1]);
        a[2] = pack_bf16(s[2 * kk + 1][0] * w[2], s[2 * kk + 1][1] * w[3]);
        a[3] = pack_bf16(s[2 * kk + 1][2] * w[2], s[2 * kk + 1][3] * w[3]);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vs + (kbase + kk * 16 + lane % 16) * rs + n2 * 16 +
                            (lane / 16) * 8);
          mma_bf16(o[2 * n2], a, bv[0], bv[1]);
          mma_bf16(o[2 * n2 + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // stage it % stages is free again
  }

  // each key group's (m, l, O) into shared memory (O over the idle ring)
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (active) {
    if (tig == 0) {
      mpart[kgrp * RP + row0] = m0;
      lpart[kgrp * RP + row0] = l0;
      mpart[kgrp * RP + row0 + 8] = m1;
      lpart[kgrp * RP + row0 + 8] = l1;
    }
    float* ap = acc + ((size_t)kgrp * RP + row0) * DP + 2 * tig;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<float2*>(ap + n * 8) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(ap + 8 * DP + n * 8) =
          make_float2(o[n][2], o[n][3]);
    }
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
      const float w = mk == -INFINITY ? 0.f : exp2f(mk - M);
      mpart[k * RP + r] = w;  // now the weight
      Lsum += w * lpart[k * RP + r];
    }
    mrow[r] = M;
    lrow[r] = Lsum;
  }
  __syncthreads();
  if (KG > 1) {
    for (int idx = tid; idx < nr * D; idx += kThreads) {
      const int r = idx / D, d = idx - r * D;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < KG; ++k) {
        const float w = mpart[k * RP + r];
        if (w != 0.f) sum += w * acc[((size_t)k * RP + r) * DP + d];
      }
      acc[(size_t)r * DP + d] = sum;
    }
    __syncthreads();
  }
  if constexpr (kMask) {
    auto ref = ref_rows<bf, kInt8>(
        tables, q, out, f32, kInt8 ? static_cast<const void*>(k8) : kc,
        kInt8 ? static_cast<const void*>(v8) : vc, pk, pv, bt, B, P, NB, H,
        KV, D, bs, Lp, QT, scale_log2, mk);
    if constexpr (kInt8)
      ref_int8(ref, tables, kf, vf, kstride, vstride, kdq, vdq, now, T_, KV);
    finish<bf>(out, t.qo, f32, hd, G, D, nr, DP, RP, mrow, lrow, acc, ws,
               ref);
  } else {
    finish<bf>(out, t.qo, f32, hd, G, D, nr, DP, RP, mrow, lrow, acc, ws);
  }
}

template <int DP, int KG, bool kMask>
__global__ void __launch_bounds__(kThreads) paged_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, void* __restrict__ out,
    const int* __restrict__ dec, const int* __restrict__ now,
    const int* __restrict__ cu, const int* __restrict__ bt,
    const __nv_bfloat16* pk, const __nv_bfloat16* pv, int T_, int B, int P,
    int NB, int H, int KV, int D, int bs, int Lp, int mq, int QT, int chunk,
    int stages, float scale_log2, int out_f32, Masks mk) {
  tc_attend<DP, KG, false, kMask>(
      q, kc, vc, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0,
      out, dec, now, cu, bt, pk, pv, T_, B, P, NB, H, KV, D, bs, Lp, mq, QT,
      chunk, stages, scale_log2, out_f32, mk);
}

// query tiles in the grid: at most ceil(max_q_len / QT) a row, and at most
// what T tokens can fill (each row's last tile may be partial); one at
// least (max_q_len 0: a tile that owns nothing, every token is zeros)
long long grid_tiles(int T_, int B, int mq, int QT) {
  const long long by_rows = (long long)B * (((mq > 1 ? mq : 1) + QT - 1) / QT);
  const long long by_tokens = ((long long)T_ + (long long)B * (QT - 1)) / QT;
  const long long t = by_rows < by_tokens ? by_rows : by_tokens;
  return t > 1 ? t : 1;
}

// which instance a call runs: tensor cores for bfloat16 with D a multiple
// of 8 up to 256 (and at most 64 query rows a tile), SIMT otherwise
bool uses_tc(int dtype, int D) {
  return dtype == ptt::kBFloat16 && D % 8 == 0 && D <= 256;
}

// T: q's and the output's element type, C: the pools' and the pre-caches'
template <typename K, typename T, typename C = T>
cudaError_t launch_kernel(K kern, size_t smem, int splits, long long tiles,
                          int KV, cudaStream_t st, const void* q,
                          const void* kc, const void* vc, void* out,
                          const void* dec, const void* now, const void* cu,
                          const void* bt, const void* pk, const void* pv,
                          int T_, int B, int P, int NB, int H, int D, int bs,
                          int Lp, int mq, int QT, int chunk, int stages,
                          float scale, int out_f32, const Masks& mk) {
  if (tiles > 65535 || KV > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t e = ptt::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (unsigned)tiles, KV);
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
  // log2(e) / sqrt(D): the scores live in the log2 domain (exp2f)
  const float scale_log2 = scale * 1.4426950408889634f;
  e = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const C*)kc, (const C*)vc,
                         out, (const int*)dec, (const int*)now,
                         (const int*)cu, (const int*)bt, (const C*)pk,
                         (const C*)pv, T_, B, P, NB, H, KV, D, bs, Lp, mq, QT,
                         chunk, stages, scale_log2, out_f32, mk);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int DP, bool kMask>
cudaError_t launch_tc(size_t smem, int KG, int splits, long long tiles,
                      int KV, cudaStream_t st, const void* q, const void* kc,
                      const void* vc, void* out, const void* dec,
                      const void* now, const void* cu, const void* bt,
                      const void* pk, const void* pv, int T_, int B, int P,
                      int NB, int H, int D, int bs, int Lp, int mq, int QT,
                      int chunk, int stages, float scale, int out_f32,
                      const Masks& mk) {
#define PTT_K4_TC(kg)                                                        \
  if (KG == kg)                                                              \
    return launch_kernel<                                                    \
        decltype(&paged_attention_tc_kernel<DP, kg, kMask>),                 \
        __nv_bfloat16>(                                                      \
        paged_attention_tc_kernel<DP, kg, kMask>, smem, splits, tiles, KV,   \
        st, q, kc, vc, out, dec, now, cu, bt, pk, pv, T_, B, P, NB, H, D,    \
        bs, Lp, mq, QT, chunk, stages, scale, out_f32, mk);
  PTT_K4_TC(4)
  PTT_K4_TC(2)
  PTT_K4_TC(1)
#undef PTT_K4_TC
  return cudaErrorInvalidValue;
}

// the SIMT instance whose copies are whole 16-byte pieces where a row (of
// the cache's C) is, else the one that takes the row's pieces at run time
template <typename T, typename C, int KT, bool kMask>
cudaError_t launch_simt(size_t smem, int splits, long long tiles, int KV,
                        cudaStream_t st, const void* q, const void* kc,
                        const void* vc, void* out, const void* dec,
                        const void* now, const void* cu, const void* bt,
                        const void* pk, const void* pv, int T_, int B, int P,
                        int NB, int H, int D, int bs, int Lp, int mq, int QT,
                        int chunk, int stages, float scale, int out_f32,
                        const Masks& mk) {
  if (ptt::tc::piece_bytes(D * (int)sizeof(C)) == 16)
    return launch_kernel<
        decltype(&paged_attention_kernel<T, C, KT, 16, kMask>), T, C>(
        paged_attention_kernel<T, C, KT, 16, kMask>, smem, splits, tiles, KV,
        st, q, kc, vc, out, dec, now, cu, bt, pk, pv, T_, B, P, NB, H, D, bs,
        Lp, mq, QT, chunk, stages, scale, out_f32, mk);
  return launch_kernel<
      decltype(&paged_attention_kernel<T, C, KT, 0, kMask>), T, C>(
      paged_attention_kernel<T, C, KT, 0, kMask>, smem, splits, tiles, KV,
      st, q, kc, vc, out, dec, now, cu, bt, pk, pv, T_, B, P, NB, H, D, bs,
      Lp, mq, QT, chunk, stages, scale, out_f32, mk);
}

// ---------------------------------------------- past 512 columns (C8)
// the rows of one block for the shared walk: query row r is token r / G,
// head kh G + r % G of the tile; a key below Lp is a prefix row of pk /
// pv, the others come through the split's block ids (none outside the
// pool: zeros); row r sees the prefix and the paged keys up to its
// position; kMask: the masks' term (query head h0 + r % G, local index
// t_first + r / G) on its visible scores; C: the element type of the pools
// and the pre-caches (the walk widens each element as it stages it)
template <typename T, typename C, bool kMask>
struct PagedRows {
  static constexpr bool kBias = kMask;
  const T* qb;
  const C *kc, *vc, *pk, *pv;
  void* out;
  size_t qo;  // q's and out's element of the tile's row 0
  bool f32;   // out is float32 (else T)
  const int* s_blk;
  size_t hd, head, blk_stride;
  int G, D, bs, b0, pos0, last, Lp;
  RowMask rm;
  int h0, t_first;
  __device__ size_t row(int r) const {
    return (size_t)(r / G) * hd + (size_t)(r % G) * D;
  }
  __device__ const T* q(int r) const { return qb + row(r); }
  __device__ const C* key_row(const C* c, const C* pre, int key) const {
    if (key < Lp) return pre + (size_t)key * D;
    key -= Lp;
    const int kb = key / bs;
    const int blk = s_blk[kb - b0];
    return blk < 0 ? nullptr
                   : c + blk * blk_stride + head + (size_t)(key - kb * bs) * D;
  }
  __device__ const C* k(int key) const { return key_row(kc, pk, key); }
  __device__ const C* v(int key) const { return key_row(vc, pv, key); }
  __device__ bool vis(int r, int key) const {
    return key <= Lp + min(pos0 + r / G, last);
  }
  __device__ void put(int r, int d, float x) const {
    ptt::put_out<T>(out, qo + row(r) + d, x, f32);
  }
  __device__ float bias(int r, int key) const {
    return mask_term(rm.row(h0 + r % G, t_first + r / G), rm.lm, key);
  }
};

// one block per (slice, query tile, KV head)
template <typename T, typename C, bool kMask>
__global__ void __launch_bounds__(ptt::wide::kThreads)
    paged_attention_wide_kernel(
        const T* __restrict__ q, const C* __restrict__ kc,
        const C* __restrict__ vc, void* __restrict__ out,
        const int* __restrict__ dec, const int* __restrict__ now,
        const int* __restrict__ cu, const int* __restrict__ bt, const C* pk,
        const C* pv, int T_, int B, int P, int NB, int H, int KV, int D,
        int bs, int Lp, int mq, int QT, int chunk, float scale_log2, int W,
        int out_f32, Masks mk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV, kh = blockIdx.z;
  int* tables =
      reinterpret_cast<int*>(smem + ptt::wide::smem_bytes(QT * G, W));
  Tile t;
  if (!setup_tile<T, true, C>(t, tables, out, out_f32, dec, now, cu, bt, pk,
                              pv, T_, B, P, NB, H, G, D, bs, Lp, mq, QT,
                              chunk))
    return;
  // the walk's first barrier comes before its first read of s_blk
  RowMask rm = {};
  if constexpr (kMask) rm = row_mask(mk, t.b);
  const PagedRows<T, C, kMask> src{q + t.qo, kc, vc,
                                   static_cast<const C*>(t.pk),
                                   static_cast<const C*>(t.pv), out, t.qo,
                                out_f32 != 0, tables + 4 * B + 2,
                                (size_t)H * D, (size_t)kh * bs * D,
                                (size_t)KV * bs * D, G, D, bs, t.b0, t.pos0,
                                t.ctx - 1, Lp, rm, kh * G, t.t_first};
  const ptt::wide::Stats st = ptt::wide::attend<T>(
      src, t.nr, D, t.c0, t.c1, blockIdx.x * W, W, scale_log2, smem);
  if constexpr (kMask) {  // rare rows (Queue C10): the slice once more
    const auto ref =
        ref_rows<T, false, C>(tables, q, out, out_f32, kc, vc, pk, pv, bt, B,
                              P, NB, H, KV, D, bs, Lp, QT, scale_log2, mk);
    __syncthreads();  // after the walk's writes of the slice
    const int cs = blockIdx.x * W, ce = min(cs + W, D);
    for (int r = threadIdx.x / 32; r < t.nr; r += ptt::wide::kWarps)
      if (rare_row(st.m[r], st.l[r])) ref(r, cs, ce);
  }
}

template <typename T, typename C, bool kMask>
cudaError_t launch_wide(long long tiles, int KV, cudaStream_t st,
                        const void* q, const void* kc, const void* vc,
                        void* out, const void* dec, const void* now,
                        const void* cu, const void* bt, const void* pk,
                        const void* pv, int T_, int B, int P, int NB, int H,
                        int D, int bs, int Lp, int mq, int QT, int chunk,
                        float scale, int out_f32, const Masks& mk) {
  const int R = QT * (H / KV);
  const int W = ptt::wide::slice_cols(R, D);
  if (W == 0 || tiles > 65535 || KV > 65535)
    return cudaErrorInvalidConfiguration;
  const size_t smem = ptt::wide::smem_bytes(R, W) +
                      (size_t)(4 * B + 2 + chunk / bs + 2) * sizeof(int);
  const auto kern = paged_attention_wide_kernel<T, C, kMask>;
  cudaError_t e = ptt::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((D + W - 1) / W, (unsigned)tiles, KV);
  kern<<<grid, ptt::wide::kThreads, smem, st>>>(
      (const T*)q, (const C*)kc, (const C*)vc, out, (const int*)dec,
      (const int*)now, (const int*)cu, (const int*)bt, (const C*)pk,
      (const C*)pv, T_, B, P, NB, H, KV, D, bs, Lp, mq, QT, chunk,
      scale * 1.4426950408889634f, W, out_f32, mk);
  return cudaGetLastError();
}

bool valid_plan(int B, int P, int H, int KV, int D, int bs, int Lp, int mq,
                int QT, int KT, int stages, int splits, int chunk,
                int dtype) {
  const long long ctx = (long long)P * bs + Lp;  // the combined key axis
  if (!(B > 0 && KV > 0 && H % KV == 0 && D > 0 && bs > 0 && Lp >= 0 &&
        mq >= 0 && QT > 0 && splits >= 1 &&
        splits <= kMaxSplits && chunk > 0 && chunk % KT == 0 &&
        (long long)chunk * splits >= ctx &&
        (splits == 1 || (long long)chunk * (splits - 1) < ctx)))
    return false;
  if (D > 512) return KT == ptt::wide::kKeys && stages == 1 && splits == 1;
  if (uses_tc(dtype, D))
    return KT == kTcKeys && stages == 2 && QT * (H / KV) <= kTcRows;
  // 16-key tiles only past 256 columns, where the larger rings do not fit
  return (KT == 64 || KT == 32 || (KT == 16 && D > 256)) &&
         (stages == 2 || stages == 3);
}

// ------------------------------------------------------------ K4-int8
// The attention of blha_attention over the int8 cache (cache_quant
// "static" or "dynamic"; paddle_tpu/ops/paged_attention.py:237-254 with
// :262-316), which the JAX package leaves to XLA: gather the uint8 blocks,
// dequantize them as (u8 - 128) * d[b, kv], overlay this step's keys and
// values at full precision, then the padded-batch attention.  Here, per
// block of one query tile and one KV head (the tiling of K4's SIMT
// instance, one split): key tiles of KT keys are read through the block
// table and dequantized into float32 in shared memory on the way in.  A
// row's keys 0 .. dec - 1 come from its uint8 blocks with its scales
// d[b, kh]; its keys dec .. dec + now - 1, the last of its context, come
// from the fresh k and v [T, KV, D] at token cu[b] + (key - dec), never
// from the cache (the reference's overlay, which keeps prefill outputs
// exact and is attended even where the cache write was dropped).  A block
// id outside the pool reads as uint8 0, i.e. -128 * d, as the reference's
// gather fills it.  Float32 online softmax with scale 1/sqrt(D), as K4.
//
// Bound on the H100: bytes (one byte a cached element, the fresh rows in
// their dtype), as K4.  Two instances:
// * Tensor cores (paged_attention_int8_mma_kernel, tc_attend above), for
//   bfloat16 where K4 runs its own (D a multiple of 8 up to 256, at most 64
//   query rows a tile): K4's tiles, warps, cluster split and merge over a
//   cp.async ring whose rows take a cached key's D uint8 codes (half K4's
//   bytes; 16-byte pieces where D % 16 == 0, else 8) or a fresh key's bf16
//   row.  Once a stage lands each thread expands one row's codes in place
//   to bf16 u - 128, an integer in [-128, 127] that bf16 holds exactly, so
//   q . code on mma.sync (bf16 in, float32 sums) is exact products; the
//   row's d factors out: kd scales a cached key's score, vd its
//   probability before P V packs it to bf16 (fresh keys: 1).
// * SIMT (paged_attention_int8_kernel), for float32, the other bf16 head
//   dims and groups past 64 query rows: 16-byte (8-byte for uint8) loads,
//   a thread's next four issued together and then converted into float32
//   tiles in registers, no ring; K4's cluster split of the context where
//   the grid leaves SMs idle (the leader merges through distributed shared
//   memory, finish()); every D (the rows padded to 8 columns, key tiles of
//   64 down to 8 keys as D grows, query tiles that shrink until the block
//   fits 227 KB).
// The quantized write folded into the launch is later work (ROADMAP
// Paged-write).

// key groups of the P @ V step: the 8-column pieces of a row take
// DA / 8 threads, and the rest of the block's threads split the keys
// (as K4's SIMT instance)
__host__ __device__ inline int int8_key_groups(int R, int D) {
  const int DC = simt_cols(D) / kVec;
  const int slots = DC >= kThreads ? 1 : kThreads / DC;
  int KG = 1;
  while (KG * 2 * R <= slots) KG *= 2;
  return KG;
}

// The shared-memory layout of a K4-int8 block, in bytes; mirrored by
// ops/hopper/paged_attention.py:_int8_smem_bytes
struct Int8Layout {
  int KG;       // key groups (partial accumulators of P @ V)
  int rstride;  // floats between two K (V) rows of a tile
  size_t k, v, q, s, acc, stats, ws, tables, total;
};

__host__ __device__ inline Int8Layout int8_layout(int R, int D, int KT,
                                                  int splits, int B,
                                                  int chunk, int bs) {
  Int8Layout L = {};
  const int DA = simt_cols(D);
  L.KG = int8_key_groups(R, D);
  L.rstride = row_chunks(DA, 4) * 4;
  size_t off = 0;
  L.k = off;  // KT x DA float, dequantized keys
  off += (size_t)KT * L.rstride * 4;
  L.v = off;  // KT x DA float, dequantized values
  off += (size_t)KT * L.rstride * 4;
  L.q = off;  // R x DA float, pre-scaled
  off += (size_t)R * DA * 4;
  L.s = off;  // R x KT scores, then probabilities
  off += (size_t)R * KT * 4;
  L.acc = off;  // KG x R x DA float accumulators
  off += (size_t)L.KG * R * DA * 4;
  L.stats = off;  // m, l, corr (float) and the last visible key (int)
  off += (size_t)4 * R * 4;
  L.ws = off;  // the leader's merge weights: splits x R, then 1 / L
  off += (size_t)(splits + 1) * R * 4;
  L.tables = off;  // int: cu, len, pt, dec by row; a split's block ids
  off += (size_t)(4 * B + 2 + chunk / bs + 2) * 4;
  L.total = off;
  return L;
}

// Where one row's keys come from, on the combined axis: the prefix rows
// pk / pv for keys < Lp, the uint8 pools at KV head kh through the block
// ids for keys Lp .. dec - 1 (paged key key - Lp), the fresh k / v rows
// (token tok0 + key, head kh) for keys >= dec, and the row's
// dequantization scales.
template <typename T>
struct Int8Rows {
  const uint8_t *kc, *vc;
  const T *kf, *vf, *pk, *pv;
  const int* s_blk;
  size_t blk_stride, head;    // bytes of one block, of head kh's offset
  long long kstride, vstride; // elements between two tokens of k, v
  int D, bs, b0, dec, tok0, Lp;
  float kd, vd;
};

// 8 uint8 values of the cache as (u8 - 128) * d; columns past D as 0
__device__ __forceinline__ void deq8(const uint8_t* p, float d, int left,
                                     float* out) {
#pragma unroll
  for (int e = 0; e < kVec; ++e)
    out[e] = e < left ? ((float)p[e] - 128.f) * d : 0.f;
}

// 8 values of a fresh row; past D as 0
template <typename T>
__device__ __forceinline__ void fresh8(const T* p, int left, float* out) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) out[e] = e < left ? ptt::to_f(p[e]) : 0.f;
}

// The raw bytes of one 8-column piece of a K or V row: 8 uint8 codes (a.x,
// a.y) or 8 fresh values of T (a, and b for float32)
struct Piece8 {
  uint4 a, b;
};

template <typename T>
__device__ __forceinline__ Piece8 load_piece(const T* p) {
  Piece8 r;
  r.a = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(T) == 4) r.b = *reinterpret_cast<const uint4*>(p + 4);
  return r;
}

template <typename T>
__device__ __forceinline__ void unpack_fresh(const Piece8& r, float* out) {
  if constexpr (sizeof(T) == 4) {
    const uint32_t w[8] = {r.a.x, r.a.y, r.a.z, r.a.w,
                           r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = __uint_as_float(w[e]);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.a);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void unpack_codes(const Piece8& r, float d,
                                             float* out) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const uint32_t w = e < 4 ? r.a.x : r.a.y;
    out[e] = ((float)((w >> (8 * (e & 3))) & 0xffu) - 128.f) * d;
  }
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// K and V rows t0 .. t0 + KT - 1 into ks / vs as float32 (rows `rs` floats
// apart, DA columns, zeros past D and for keys >= c1).  kAligned (D % 8 ==
// 0, 16-byte fresh and prefix rows, 8-byte cache rows): a thread first
// issues the loads of kBatch pieces, then converts and stores them, so
// their latencies overlap; else element by element.
template <typename T, int KT, bool kAligned>
__device__ void int8_tile(float* ks, float* vs, const Int8Rows<T>& s,
                          int t0, int c1, int rs, int DA) {
  const int DC = DA / kVec, n = KT * DC;
  if constexpr (kAligned) {
    constexpr int kBatch = 4;
    for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * kThreads) {
      Piece8 rk[kBatch], rv[kBatch];
      int kind[kBatch];  // 0 zeros, 1 fresh, 2 cached, 3 outside the pool
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        const int j = i / DC, c = (i - j * DC) * kVec, key = t0 + j;
        kind[u] = 0;
        if (i < n && key < c1) {
          if (key < s.Lp) {  // a prefix row: full precision
            rk[u] = load_piece(s.pk + (size_t)key * s.D + c);
            rv[u] = load_piece(s.pv + (size_t)key * s.D + c);
            kind[u] = 1;
          } else if (key >= s.dec) {  // this step's own key: full precision
            const long long tok = (long long)s.tok0 + key;
            rk[u] = load_piece(s.kf + tok * s.kstride + c);
            rv[u] = load_piece(s.vf + tok * s.vstride + c);
            kind[u] = 1;
          } else {
            const int pk = key - s.Lp;  // the paged key
            const int kb = pk / s.bs;
            const int blk = s.s_blk[kb - s.b0];
            kind[u] = 3;
            if (blk >= 0) {
              const size_t o = blk * s.blk_stride + s.head +
                               (size_t)(pk - kb * s.bs) * s.D + c;
              const uint2 a = *reinterpret_cast<const uint2*>(s.kc + o);
              const uint2 b = *reinterpret_cast<const uint2*>(s.vc + o);
              rk[u].a.x = a.x, rk[u].a.y = a.y;
              rv[u].a.x = b.x, rv[u].a.y = b.y;
              kind[u] = 2;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n) {
          const int j = i / DC, c = (i - j * DC) * kVec;
          float kx[kVec], vx[kVec];
          if (kind[u] == 1) {
            unpack_fresh<T>(rk[u], kx);
            unpack_fresh<T>(rv[u], vx);
          } else if (kind[u] == 2) {
            unpack_codes(rk[u], s.kd, kx);
            unpack_codes(rv[u], s.vd, vx);
          } else {  // uint8 0 outside the pool, zeros past c1
            const float kz = kind[u] == 3 ? -128.f * s.kd : 0.f;
            const float vz = kind[u] == 3 ? -128.f * s.vd : 0.f;
#pragma unroll
            for (int e = 0; e < kVec; ++e) kx[e] = kz, vx[e] = vz;
          }
          store8(ks + j * rs + c, kx);
          store8(vs + j * rs + c, vx);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int j = i / DC, c = (i - j * DC) * kVec;
      const int key = t0 + j, left = s.D - c;
      float kx[kVec], vx[kVec];
      if (key >= c1) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kx[e] = vx[e] = 0.f;
      } else if (key < s.Lp) {  // a prefix row: full precision
        fresh8<T>(s.pk + (size_t)key * s.D + c, left, kx);
        fresh8<T>(s.pv + (size_t)key * s.D + c, left, vx);
      } else if (key >= s.dec) {  // this step's own key: full precision
        const long long tok = (long long)s.tok0 + key;
        fresh8<T>(s.kf + tok * s.kstride + c, left, kx);
        fresh8<T>(s.vf + tok * s.vstride + c, left, vx);
      } else {
        const int pk = key - s.Lp;  // the paged key
        const int kb = pk / s.bs;
        const int blk = s.s_blk[kb - s.b0];
        if (blk < 0) {  // outside the pool: uint8 0
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            kx[e] = e < left ? -128.f * s.kd : 0.f;
            vx[e] = e < left ? -128.f * s.vd : 0.f;
          }
        } else {
          const size_t o = blk * s.blk_stride + s.head +
                           (size_t)(pk - kb * s.bs) * s.D + c;
          deq8(s.kc + o, s.kd, left, kx);
          deq8(s.vc + o, s.vd, left, vx);
        }
      }
      store8(ks + j * rs + c, kx);
      store8(vs + j * rs + c, vx);
    }
  }
}

// One block per (split, query tile, KV head).  Scores: thread (rg, sj) takes key
// sj for rows rg, rg + NRG, ...; P @ V: work item (kg, rsl, dc) adds keys
// kg, kg + KG, ... into columns [8 dc, 8 dc + 8) of rows rsl, rsl + RSL,
// ... of partial kg (a grid-stride loop over the items: past 1024 columns
// a thread takes several).  kAligned: D % 8 == 0 with 16-byte aligned
// fresh rows and 8-byte aligned cache rows.  kMask: the masks' term on
// every visible score.
template <typename T, int KT, bool kAligned, bool kMask>
__global__ void __launch_bounds__(kThreads) paged_attention_int8_kernel(
    const T* __restrict__ q, const T* __restrict__ kf,
    const T* __restrict__ vf, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ vc, const float* __restrict__ kdq,
    const float* __restrict__ vdq, void* __restrict__ out,
    const int* __restrict__ dec, const int* __restrict__ now,
    const int* __restrict__ cu, const int* __restrict__ bt, const T* pk,
    const T* pv, int T_, int B, int P, int NB, int H, int KV, int D, int bs,
    int Lp, int mq, int QT, int chunk, long long kstride, long long vstride,
    float scale_log2, int out_f32, Masks mk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = H / KV;
  const int R = QT * G;
  const Int8Layout L = int8_layout(R, D, KT, gridDim.x, B, chunk, bs);
  float* ks = reinterpret_cast<float*>(smem + L.k);
  float* vs = reinterpret_cast<float*>(smem + L.v);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* sc = reinterpret_cast<float*>(smem + L.s);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* mrow = reinterpret_cast<float*>(smem + L.stats);
  float* lrow = mrow + R;
  float* corr = lrow + R;
  int* lim = reinterpret_cast<int*>(corr + R);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  int* tables = reinterpret_cast<int*>(smem + L.tables);
  const int kh = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  Tile t;
  if (!setup_tile<T>(t, tables, out, out_f32, dec, now, cu, bt, pk, pv, T_,
                     B, P, NB, H, G, D, bs, Lp, mq, QT, chunk))
    return;
  const int nr = t.nr, c0 = t.c0, c1 = t.c1;
  const size_t hd = (size_t)H * D;
  const int DA = simt_cols(D);
  const int rs = L.rstride;
  const int row_dec = Lp + t.pos0 - t.t_first;  // on the combined axis
  Int8Rows<T> src;
  src.kc = kc;
  src.vc = vc;
  src.kf = kf + (size_t)kh * D;
  src.vf = vf + (size_t)kh * D;
  src.pk = static_cast<const T*>(t.pk);
  src.pv = static_cast<const T*>(t.pv);
  src.Lp = Lp;
  src.s_blk = tables + 4 * B + 2;
  src.blk_stride = (size_t)KV * bs * D;
  src.head = (size_t)kh * bs * D;
  src.kstride = kstride;
  src.vstride = vstride;
  src.D = D;
  src.bs = bs;
  src.b0 = t.b0;
  src.dec = row_dec;
  src.tok0 = tables[t.b] - row_dec;  // s_cu[b]: token of key dec
  src.kd = kdq[(size_t)t.b * KV + kh];
  src.vd = vdq[(size_t)t.b * KV + kh];
  RowMask rm = {};
  if constexpr (kMask) rm = row_mask(mk, t.b);
  for (int idx = tid; idx < nr * DA; idx += kThreads) {
    const int r = idx / DA, d = idx - r * DA;
    qs[idx] = d < D ? ptt::to_f(q[t.qo + (size_t)(r / G) * hd +
                                  (r % G) * D + d]) *
                          scale_log2
                    : 0.f;
  }
  for (int idx = tid; idx < L.KG * R * DA; idx += kThreads) acc[idx] = 0.f;
  for (int r = tid; r < nr; r += kThreads) {
    lim[r] = Lp + min(t.pos0 + r / G, t.ctx - 1);
    mrow[r] = -INFINITY;
    lrow[r] = 0.f;
  }
  __syncthreads();  // s_blk, q, lim

  const int ntile = c1 > c0 ? (c1 - c0 + KT - 1) / KT : 0;
  const int DC = DA / kVec;
  const int slots = DC >= kThreads ? 1 : kThreads / DC;
  const int RSL = slots / L.KG;
  const int items = RSL * L.KG * DC;
  constexpr int NRG = kThreads / KT;
  const int sj = tid % KT, rg = tid / KT;

  for (int it = 0; it < ntile; ++it) {
    const int t0 = c0 + it * KT;
    int8_tile<T, KT, kAligned>(ks, vs, src, t0, c1, rs, DA);
    __syncthreads();
    const int kcount = min(KT, c1 - t0);
    const bool full = t0 + KT <= c1 && t0 + KT - 1 <= lim[0];

    // scores (log2 domain)
    const float* krow = ks + sj * rs;
    const int key = t0 + sj;
    for (int r0 = rg; r0 < nr; r0 += NRG * kRowsPerPass) {
      float s[kRowsPerPass];
#pragma unroll
      for (int k = 0; k < kRowsPerPass; ++k) s[k] = 0.f;
      for (int c = 0; c < DA; c += kVec) {
        float kx[kVec];
        load8(krow + c, kx);
#pragma unroll
        for (int k = 0; k < kRowsPerPass; ++k) {
          const int r = r0 + k * NRG;
          if (r < nr) {
            const float4 a =
                *reinterpret_cast<const float4*>(qs + r * DA + c);
            const float4 e =
                *reinterpret_cast<const float4*>(qs + r * DA + c + 4);
            s[k] += a.x * kx[0] + a.y * kx[1] + a.z * kx[2] + a.w * kx[3] +
                    e.x * kx[4] + e.y * kx[5] + e.z * kx[6] + e.w * kx[7];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerPass; ++k) {
        const int r = r0 + k * NRG;
        if (r < nr) {
          float v = full || (key < c1 && key <= lim[r]) ? s[k] : -INFINITY;
          if constexpr (kMask) {
            if (v != -INFINITY)
              v += mask_term(rm.row(kh * G + r % G, t.t_first + r / G),
                             rm.lm, key);
          }
          sc[r * KT + sj] = v;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows w, w + kWarps, ...
    for (int r = warp; r < nr; r += kWarps) {
      float* row = sc + r * KT;
      float mx = -INFINITY;
      for (int jj = lane; jj < KT; jj += 32) mx = fmaxf(mx, row[jj]);
      mx = ptt::warp_max(mx);
      const float m_old = mrow[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      // a row with no visible key yet keeps m = -inf and p = 0
      const bool none = m_new == -INFINITY;
      for (int jj = lane; jj < KT; jj += 32) {
        const float p = none ? 0.f : exp2f(row[jj] - m_new);
        row[jj] = p;
        sum += p;
      }
      sum = ptt::warp_sum(sum);
      if (lane == 0) {
        const float cr = none ? 1.f : exp2f(m_old - m_new);  // -inf -> 0
        corr[r] = cr;
        lrow[r] = lrow[r] * cr + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();

    // P @ V
    for (int item = tid; item < items; item += kThreads) {
      const int dc = item % DC, slot = item / DC;
      const int kg = slot % L.KG, rsl = slot / L.KG;
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
        for (int jj = kg; jj < kcount; jj += L.KG) {
          float vx[kVec];
          load8(vs + jj * rs + dc * kVec, vx);
#pragma unroll
          for (int k = 0; k < kRowsPerPass; ++k) {
            const int r = r0 + k * RSL;
            if (r < nr) {
              const float p = sc[r * KT + jj];
#pragma unroll
              for (int e = 0; e < kVec; ++e) a[k][e] += p * vx[e];
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
    __syncthreads();  // the tiles and the probabilities are free
  }

  // the key groups' partials add up into partial 0
  if (L.KG > 1) {
    for (int idx = tid; idx < nr * DA; idx += kThreads) {
      float s = 0.f;
      for (int g = 0; g < L.KG; ++g) s += acc[(size_t)g * R * DA + idx];
      acc[idx] = s;
    }
    __syncthreads();
  }
  if constexpr (kMask) {
    auto ref = ref_rows<T, true>(tables, q, out, out_f32, kc, vc, pk, pv, bt,
                                 B, P, NB, H, KV, D, bs, Lp, QT, scale_log2,
                                 mk);
    ref_int8(ref, tables, kf, vf, kstride, vstride, kdq, vdq, now, T_, KV);
    finish<T>(out, t.qo, out_f32, hd, G, D, nr, DA, R, mrow, lrow, acc, ws,
              ref);
  } else {
    finish<T>(out, t.qo, out_f32, hd, G, D, nr, DA, R, mrow, lrow, acc, ws);
  }
}

// The tensor-core instance (tc_attend with kInt8): one block per (split,
// query tile, KV head), a ring of kInt8Stages; bfloat16 only
constexpr int kInt8Stages = 2;

template <int DP, int KG, bool kMask>
__global__ void PTT_K4I_BOUNDS(DP) paged_attention_int8_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kf,
    const __nv_bfloat16* __restrict__ vf, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ vc, const float* __restrict__ kdq,
    const float* __restrict__ vdq, void* __restrict__ out,
    const int* __restrict__ dec, const int* __restrict__ now,
    const int* __restrict__ cu, const int* __restrict__ bt,
    const __nv_bfloat16* pk, const __nv_bfloat16* pv, int T_, int B, int P,
    int NB, int H, int KV, int D, int bs, int Lp, int mq, int QT, int chunk,
    long long kstride, long long vstride, float scale_log2, int out_f32,
    Masks mk) {
  tc_attend<DP, KG, true, kMask>(q, nullptr, nullptr, kc, vc, kf, vf, kdq,
                                 vdq, kstride, vstride, out, dec, now, cu, bt,
                                 pk, pv, T_, B, P, NB, H, KV, D, bs, Lp, mq,
                                 QT, chunk, kInt8Stages, scale_log2, out_f32,
                                 mk);
}

// either K4-int8 kernel over a grid of (splits, tiles, KV), a cluster of
// the splits
template <typename K, typename T>
cudaError_t launch_int8_kernel(K kern, size_t smem, int splits,
                               long long tiles, int KV, cudaStream_t st,
                               const void* q, const void* k, const void* v,
                               const void* kc, const void* vc,
                               const void* kd, const void* vd, void* out,
                               const void* dec, const void* now,
                               const void* cu, const void* bt, const void* pk,
                               const void* pv, int T_, int B, int P, int NB,
                               int H, int D, int bs, int Lp, int mq, int QT,
                               int chunk, long long kstride,
                               long long vstride, float scale, int out_f32,
                               const Masks& mk) {
  cudaError_t e = ptt::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (unsigned)tiles, KV);
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
  e = cudaLaunchKernelEx(
      &cfg, kern, (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)kc,
      (const uint8_t*)vc, (const float*)kd, (const float*)vd, out,
      (const int*)dec, (const int*)now, (const int*)cu, (const int*)bt,
      (const T*)pk, (const T*)pv, T_, B, P, NB, H, KV, D, bs, Lp, mq, QT,
      chunk, kstride, vstride, scale * 1.4426950408889634f, out_f32, mk);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int DP, bool kMask>
cudaError_t launch_int8_mma(int KG, size_t smem, int splits, long long tiles,
                            int KV, cudaStream_t st, const void* q,
                            const void* k, const void* v, const void* kc,
                            const void* vc, const void* kd, const void* vd,
                            void* out, const void* dec, const void* now,
                            const void* cu, const void* bt, const void* pk,
                            const void* pv, int T_, int B, int P, int NB,
                            int H, int D, int bs, int Lp, int mq, int QT,
                            int chunk, long long kstride, long long vstride,
                            float scale, int out_f32, const Masks& mk) {
#define PTT_K4I_MMA(kg)                                                       \
  if (KG == kg)                                                               \
    return launch_int8_kernel<                                                \
        decltype(&paged_attention_int8_mma_kernel<DP, kg, kMask>),            \
        __nv_bfloat16>(                                                       \
        paged_attention_int8_mma_kernel<DP, kg, kMask>, smem, splits,         \
        tiles, KV, st, q, k, v, kc, vc, kd, vd, out, dec, now, cu, bt, pk,    \
        pv, T_, B, P, NB, H, D, bs, Lp, mq, QT, chunk, kstride, vstride,      \
        scale, out_f32, mk);
  PTT_K4I_MMA(4)
  PTT_K4I_MMA(2)
  PTT_K4I_MMA(1)
#undef PTT_K4I_MMA
  return cudaErrorInvalidValue;
}

template <typename T, int KT, bool kMask>
cudaError_t launch_int8(bool aligned, size_t smem, int splits,
                        long long tiles, int KV, cudaStream_t st,
                        const void* q, const void* k, const void* v,
                        const void* kc, const void* vc, const void* kd,
                        const void* vd, void* out, const void* dec,
                        const void* now, const void* cu, const void* bt,
                        const void* pk, const void* pv, int T_, int B, int P,
                        int NB, int H, int D, int bs, int Lp, int mq, int QT,
                        int chunk, long long kstride, long long vstride,
                        float scale, int out_f32, const Masks& mk) {
  auto kern = aligned ? paged_attention_int8_kernel<T, KT, true, kMask>
                      : paged_attention_int8_kernel<T, KT, false, kMask>;
  return launch_int8_kernel<decltype(kern), T>(
      kern, smem, splits, tiles, KV, st, q, k, v, kc, vc, kd, vd, out, dec,
      now, cu, bt, pk, pv, T_, B, P, NB, H, D, bs, Lp, mq, QT, chunk,
      kstride, vstride, scale, out_f32, mk);
}

template <typename T, bool kMask>
cudaError_t launch_int8_kt(int KT, bool aligned, size_t smem, int splits,
                           long long tiles, int KV, cudaStream_t st,
                           const void* q, const void* k, const void* v,
                           const void* kc, const void* vc, const void* kd,
                           const void* vd, void* out, const void* dec,
                           const void* now, const void* cu, const void* bt,
                           const void* pk, const void* pv, int T_, int B,
                           int P, int NB, int H, int D, int bs, int Lp,
                           int mq, int QT, int chunk, long long kstride,
                           long long vstride, float scale, int out_f32,
                           const Masks& mk) {
#define PTT_K4I_ARGS                                                        \
  aligned, smem, splits, tiles, KV, st, q, k, v, kc, vc, kd, vd, out, dec,  \
      now, cu, bt, pk, pv, T_, B, P, NB, H, D, bs, Lp, mq, QT, chunk,       \
      kstride, vstride, scale, out_f32, mk
  switch (KT) {
    case 64: return launch_int8<T, 64, kMask>(PTT_K4I_ARGS);
    case 32: return launch_int8<T, 32, kMask>(PTT_K4I_ARGS);
    case 16: return launch_int8<T, 16, kMask>(PTT_K4I_ARGS);
    case 8: return launch_int8<T, 8, kMask>(PTT_K4I_ARGS);
  }
#undef PTT_K4I_ARGS
  return cudaErrorInvalidValue;
}

bool aligned_to(const void* p, int n) { return (uintptr_t)p % n == 0; }

// the pre-caches: none (Lp 0), or both, 16-byte aligned (their rows are
// read in the pieces of q's)
bool valid_pre(const void* pk, const void* pv, int Lp) {
  return Lp == 0 ||
         (Lp > 0 && pk && pv && aligned_to(pk, 16) && aligned_to(pv, 16));
}

// The masks of an entry's arguments: none, or seq_lens_encoder and each
// given mask with 1 or H heads and at least one row and column.
Masks make_masks(const void* mask, int mask_heads, int mask_sq, int mask_lm,
                 const void* tgt, int tgt_heads, int tgt_sq, int tgt_lm,
                 const void* enc) {
  Masks mk = {};
  mk.m[0] = static_cast<const float*>(mask);
  mk.m[1] = static_cast<const float*>(tgt);
  mk.heads[0] = mask_heads, mk.sq[0] = mask_sq, mk.lm[0] = mask_lm;
  mk.heads[1] = tgt_heads, mk.sq[1] = tgt_sq, mk.lm[1] = tgt_lm;
  mk.enc = static_cast<const int*>(enc);
  return mk;
}

bool valid_masks(const Masks& mk, int H) {
  if (mk.m[0] == nullptr && mk.m[1] == nullptr) return true;
  for (int w = 0; w < 2; ++w)
    if (mk.m[w] != nullptr &&
        (!(mk.heads[w] == 1 || mk.heads[w] == H) || mk.sq[w] <= 0 ||
         mk.lm[w] <= 0))
      return false;
  return mk.enc != nullptr;
}

}  // namespace

#if PTT_PAGED_MASKED
// this build's entries, which the unmasked build's hand a masked call
#define PTT_K4_ENTRY ptt_paged_attention_masked
#define PTT_K4_INT8_ENTRY ptt_paged_attention_int8_masked
#else
#define PTT_K4_ENTRY ptt_paged_attention
#define PTT_K4_INT8_ENTRY ptt_paged_attention_int8
extern "C" int ptt_paged_attention_masked(
    const void* q, const void* kc, const void* vc, void* out,
    const void* dec, const void* now, const void* cu, const void* bt,
    const void* pk, const void* pv, int T, int B, int P, int NB, int H,
    int KV, int D, int bs, int Lp, int max_q_len, float scale, int QT,
    int KT, int stages, int splits, int chunk, int out_f32, const void* mask,
    int mask_heads, int mask_sq, int mask_lm, const void* tgt_mask,
    int tgt_heads, int tgt_sq, int tgt_lm, const void* enc, int dtype,
    int cache_dtype, void* stream);
extern "C" int ptt_paged_attention_int8_masked(
    const void* q, const void* k, const void* v, const void* kc,
    const void* vc, const void* kd, const void* vd, void* out,
    const void* dec, const void* now, const void* cu, const void* bt,
    const void* pk, const void* pv, int T, int B, int P, int NB, int H,
    int KV, int D, int bs, int Lp, int max_q_len, long long k_stride,
    long long v_stride, float scale, int QT, int KT, int splits, int chunk,
    int tc, int out_f32, const void* mask, int mask_heads, int mask_sq,
    int mask_lm, const void* tgt_mask, int tgt_heads, int tgt_sq,
    int tgt_lm, const void* enc, int dtype, void* stream);
#endif

// K4: q [T, H, D] of `dtype`; pools kc / vc [NB, KV, bs, D] and the
// pre-caches pk / pv [B, KV, Lp, D] (NULL with Lp 0) of `cache_dtype`:
// q's, or bfloat16 under a float32 q (Queue C12: the SIMT and wide
// instances over a cache staged at its own width; a bfloat16 q over a
// float32 cache is widened by the wrapper and takes the float32
// instances); out [T, H, D], in q's dtype or (out_f32) float32.  The plan
// (QT, KT, stages, splits, chunk) is paged_plan's over Lp + P * bs keys.
// The masks: float32 [B, heads, sq, lm], NULL where not given, with
// seq_lens_encoder [B] int32 where one is; a mask launches the masked
// instances (ptt_paged_attention_masked).
extern "C" int PTT_K4_ENTRY(
    const void* q, const void* kc, const void* vc, void* out,
    const void* dec, const void* now, const void* cu, const void* bt,
    const void* pk, const void* pv, int T, int B, int P, int NB, int H,
    int KV, int D, int bs, int Lp, int max_q_len, float scale, int QT,
    int KT, int stages, int splits, int chunk, int out_f32, const void* mask,
    int mask_heads, int mask_sq, int mask_lm, const void* tgt_mask,
    int tgt_heads, int tgt_sq, int tgt_lm, const void* enc, int dtype,
    int cache_dtype, void* stream) {
  if (!kMasked && (mask != nullptr || tgt_mask != nullptr))
    return ptt_paged_attention_masked(
        q, kc, vc, out, dec, now, cu, bt, pk, pv, T, B, P, NB, H, KV, D, bs,
        Lp, max_q_len, scale, QT, KT, stages, splits, chunk, out_f32, mask,
        mask_heads, mask_sq, mask_lm, tgt_mask, tgt_heads, tgt_sq, tgt_lm,
        enc, dtype, cache_dtype, stream);
  cudaStream_t st = (cudaStream_t)stream;
  const Masks mk = make_masks(mask, mask_heads, mask_sq, mask_lm, tgt_mask,
                              tgt_heads, tgt_sq, tgt_lm, enc);
  // the cache's dtype: q's, or bfloat16 under a float32 q
  const bool widen = dtype == ptt::kFloat32 && cache_dtype == ptt::kBFloat16;
  if ((dtype != ptt::kFloat32 && dtype != ptt::kBFloat16) ||
      (cache_dtype != dtype && !widen) || !valid_pre(pk, pv, Lp) ||
      !valid_masks(mk, H) ||
      !valid_plan(B, P, H, KV, D, bs, Lp, max_q_len, QT, KT, stages, splits,
                  chunk, dtype))
    return (int)cudaErrorInvalidValue;
  const int es = cache_dtype == ptt::kFloat32 ? 4 : 2;  // a staged element
  const bool tc = uses_tc(dtype, D);
  const int R = QT * (H / KV);
  const long long tiles = grid_tiles(T, B, max_q_len, QT);
  if (D > 512) {
#define PTT_K4_ARGS                                                         \
  tiles, KV, st, q, kc, vc, out, dec, now, cu, bt, pk, pv, T, B, P, NB, H, \
      D, bs, Lp, max_q_len, QT, chunk, scale, out_f32, mk
    if (widen)
      return (int)launch_wide<float, __nv_bfloat16, kMasked>(PTT_K4_ARGS);
    return dtype == ptt::kFloat32
               ? (int)launch_wide<float, float, kMasked>(PTT_K4_ARGS)
               : (int)launch_wide<__nv_bfloat16, __nv_bfloat16, kMasked>(
                     PTT_K4_ARGS);
#undef PTT_K4_ARGS
  }
  const size_t smem =
      layout(tc, R, D, es, KT, stages, splits, B, chunk, bs).total;
  if (tc) {
    const int KG = tc_key_groups(R), DP = tc_cols(D);
#define PTT_K4_ARGS                                                     \
  smem, KG, splits, tiles, KV, st, q, kc, vc, out, dec, now, cu, bt, pk, \
      pv, T, B, P, NB, H, D, bs, Lp, max_q_len, QT, chunk, stages, scale, \
      out_f32, mk
    if (DP == 64) return (int)launch_tc<64, kMasked>(PTT_K4_ARGS);
    if (DP == 128) return (int)launch_tc<128, kMasked>(PTT_K4_ARGS);
    return (int)launch_tc<256, kMasked>(PTT_K4_ARGS);
#undef PTT_K4_ARGS
  }
#define PTT_K4_ARGS                                                     \
  smem, splits, tiles, KV, st, q, kc, vc, out, dec, now, cu, bt, pk, pv, \
      T, B, P, NB, H, D, bs, Lp, max_q_len, QT, chunk, stages, scale,    \
      out_f32, mk
  using bf = __nv_bfloat16;
  if (widen)
    return KT == 64   ? (int)launch_simt<float, bf, 64, kMasked>(PTT_K4_ARGS)
           : KT == 32 ? (int)launch_simt<float, bf, 32, kMasked>(PTT_K4_ARGS)
                      : (int)launch_simt<float, bf, 16, kMasked>(PTT_K4_ARGS);
  if (dtype == ptt::kFloat32)
    return KT == 64 ? (int)launch_simt<float, float, 64, kMasked>(PTT_K4_ARGS)
           : KT == 32
               ? (int)launch_simt<float, float, 32, kMasked>(PTT_K4_ARGS)
               : (int)launch_simt<float, float, 16, kMasked>(PTT_K4_ARGS);
  return KT == 64 ? (int)launch_simt<bf, bf, 64, kMasked>(PTT_K4_ARGS)
         : KT == 32 ? (int)launch_simt<bf, bf, 32, kMasked>(PTT_K4_ARGS)
                    : (int)launch_simt<bf, bf, 16, kMasked>(PTT_K4_ARGS);
#undef PTT_K4_ARGS
}

// K4-int8: q [T, H, D] and the fresh k / v [T, KV, D] (token strides
// k_stride / v_stride elements, each head's row contiguous) in `dtype`;
// uint8 pools kc / vc [NB, KV, bs, D]; float32 dequantization scales kd /
// vd [B, KV]; the pre-caches pk / pv [B, KV, Lp, D] in `dtype` (NULL with
// Lp 0); out [T, H, D], in `dtype` or (out_f32) float32; `splits` blocks
// of a cluster, each walking `chunk` of the Lp + P * block_size keys.  `tc` runs the
// tensor-core instance: bfloat16, D a multiple of 8 up to 256, at most 64
// query rows a tile, 64-key tiles, k and v 16-byte aligned with token
// strides of whole 16 bytes and the pools aligned to their rows' pieces (16
// bytes where D % 16 == 0, else 8); else the SIMT instance.  The entry
// refuses a plan outside these, a key tile without an instance, more than
// 4 splits, a chunk that is not a multiple of KT or does not cover P *
// block_size keys (or leaves a split without keys), a grid past 65535
// tiles or KV heads, and a block past the shared memory it may use (227
// KB).  The masks as K4's entry takes them (a mask launches the masked
// instances, ptt_paged_attention_int8_masked).
extern "C" int PTT_K4_INT8_ENTRY(
    const void* q, const void* k, const void* v, const void* kc,
    const void* vc, const void* kd, const void* vd, void* out,
    const void* dec, const void* now, const void* cu, const void* bt,
    const void* pk, const void* pv, int T, int B, int P, int NB, int H,
    int KV, int D, int bs, int Lp, int max_q_len, long long k_stride,
    long long v_stride, float scale, int QT, int KT, int splits, int chunk,
    int tc, int out_f32, const void* mask, int mask_heads, int mask_sq,
    int mask_lm, const void* tgt_mask, int tgt_heads, int tgt_sq,
    int tgt_lm, const void* enc, int dtype, void* stream) {
  if (!kMasked && (mask != nullptr || tgt_mask != nullptr))
    return ptt_paged_attention_int8_masked(
        q, k, v, kc, vc, kd, vd, out, dec, now, cu, bt, pk, pv, T, B, P, NB,
        H, KV, D, bs, Lp, max_q_len, k_stride, v_stride, scale, QT, KT,
        splits, chunk, tc, out_f32, mask, mask_heads, mask_sq, mask_lm,
        tgt_mask, tgt_heads, tgt_sq, tgt_lm, enc, dtype, stream);
  cudaStream_t st = (cudaStream_t)stream;
  const long long ctx = (long long)P * bs + Lp;  // the combined key axis
  const Masks mk = make_masks(mask, mask_heads, mask_sq, mask_lm, tgt_mask,
                              tgt_heads, tgt_sq, tgt_lm, enc);
  if ((dtype != ptt::kFloat32 && dtype != ptt::kBFloat16) ||
      !valid_pre(pk, pv, Lp) || !valid_masks(mk, H) || B <= 0 ||
      KV <= 0 || H % KV || D <= 0 || bs <= 0 || P <= 0 || max_q_len < 0 ||
      QT <= 0 || (KT != 64 && KT != 32 && KT != 16 && KT != 8) ||
      splits < 1 || splits > kMaxSplits || chunk <= 0 || chunk % KT ||
      (long long)chunk * splits < ctx ||
      (long long)chunk * (splits - 1) >= ctx)
    return (int)cudaErrorInvalidValue;
  const long long tiles = grid_tiles(T, B, max_q_len, QT);
  if (tiles > 65535 || KV > 65535) return (int)cudaErrorInvalidConfiguration;
  const int R = QT * (H / KV);
  if (tc) {
    const int piece = D % 16 == 0 ? 16 : 8;
    if (!uses_tc(dtype, D) || R > kTcRows || KT != kTcKeys ||
        !aligned_to(k, 16) || !aligned_to(v, 16) || (k_stride * 2) % 16 ||
        (v_stride * 2) % 16 || !aligned_to(kc, piece) ||
        !aligned_to(vc, piece))
      return (int)cudaErrorInvalidValue;
  }
  const int es = dtype == ptt::kFloat32 ? 4 : 2;
  const bool aligned = D % kVec == 0 && aligned_to(k, 16) &&
                       aligned_to(v, 16) && (k_stride * es) % 16 == 0 &&
                       (v_stride * es) % 16 == 0 && aligned_to(kc, 8) &&
                       aligned_to(vc, 8);
  const size_t smem =
      tc ? layout(true, R, D, 2, KT, kInt8Stages, splits, B, chunk, bs).total
         : int8_layout(R, D, KT, splits, B, chunk, bs).total;
  if (tc) {
    const int KG = tc_key_groups(R), DP = tc_cols(D);
#define PTT_K4I_ARGS                                                       \
  KG, smem, splits, tiles, KV, st, q, k, v, kc, vc, kd, vd, out, dec, now,  \
      cu, bt, pk, pv, T, B, P, NB, H, D, bs, Lp, max_q_len, QT, chunk,     \
      k_stride, v_stride, scale, out_f32, mk
    if (DP == 64) return (int)launch_int8_mma<64, kMasked>(PTT_K4I_ARGS);
    if (DP == 128) return (int)launch_int8_mma<128, kMasked>(PTT_K4I_ARGS);
    return (int)launch_int8_mma<256, kMasked>(PTT_K4I_ARGS);
#undef PTT_K4I_ARGS
  }
#define PTT_K4I_ARGS                                                         \
  KT, aligned, smem, splits, tiles, KV, st, q, k, v, kc, vc, kd, vd, out,    \
      dec, now, cu, bt, pk, pv, T, B, P, NB, H, D, bs, Lp, max_q_len, QT,    \
      chunk, k_stride, v_stride, scale, out_f32, mk
  if (dtype == ptt::kFloat32)
    return (int)launch_int8_kt<float, kMasked>(PTT_K4I_ARGS);
  return (int)launch_int8_kt<__nv_bfloat16, kMasked>(PTT_K4I_ARGS);
#undef PTT_K4I_ARGS
}
