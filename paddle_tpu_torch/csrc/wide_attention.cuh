// Attention past 512 head-dim columns (Queue C8): one SIMT walk that
// streams the head dim in chunks, shared by the forward kernels B1
// (flash_attention.cu), B2 (decode_attention.cu) and K4
// (paged_attention.cu) for every D > 512.
//
// The instances up to 512 columns hold whole rows in shared memory; a
// wider row does not fit a block (one 32-row tile of 1024 float32
// columns is 128 KB).  Here a block takes R query rows, a run of keys
// c0 .. c1 - 1 and one slice of the output's columns [cs, cs + W), W at
// most 512 (a grid axis takes the slices):
// * scores need every column: per tile of kKeys keys, the query rows
//   (scaled into the log2 domain) and the keys' K rows pass through
//   shared memory kChunk columns at a time, each thread summing kPer
//   scores over the chunks in registers (rows of kPassRows at a time);
// * an online softmax per row (float32 m, l; a warp a row, a lane a key);
// * the tile's V rows of the slice are staged, and each thread adds P V
//   into its own columns c = tid, tid + kThreads, ... of the float32
//   accumulators [R, W] in shared memory.
// The scores are recomputed once for each slice: simple and right, not
// fast.  Rows are read in place with scalar loads of T (any D, any
// alignment).  A row whose keys are all masked keeps m = -inf and l = 0:
// its output is zeros.  Bound on the H100 by bytes at decode and by the
// SIMT cores' float32 rate (67 TFLOP/s) at prefill lengths.
#pragma once

#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace ptt {
namespace wide {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;    // keys a tile: one a lane in the softmax
constexpr int kChunk = 64;   // columns of Q and K staged at a time
constexpr int kPer = 8;      // scores a thread sums in one pass
constexpr int kPassRows = kThreads * kPer / kKeys;  // query rows a pass
constexpr int kMaxCols = 512;                       // the widest slice
constexpr size_t kSmemLimit = 232448;               // 227 KB a block

// shared memory of a block of R query rows and a W-column slice, in bytes
// (mirrored by the Python plans' _wide_smem)
__host__ __device__ inline size_t smem_bytes(int R, int W) {
  return sizeof(float) *
         ((size_t)kPassRows * kChunk + (size_t)kKeys * (kChunk + 1) +
          (size_t)R * kKeys + (size_t)kKeys * W + (size_t)R * W + 3 * R);
}

// slices of D columns, the fewest of at most W, as even as multiples of 8
// allow (D 520, W 512: two of 264)
__host__ __device__ inline int even_slices(int D, int W) {
  const int ns = (D + W - 1) / W;
  return ((D + ns - 1) / ns + 7) / 8 * 8;
}

// the slice width of a block of R query rows: even_slices of the widest
// multiple of 8 up to 512 whose block fits 227 KB; 0 where not even 8
// columns fit
__host__ __device__ inline int slice_cols(int R, int D) {
  int W = (D + 7) / 8 * 8;
  if (W > kMaxCols) W = kMaxCols;
  while (W > 0 && smem_bytes(R, W) > kSmemLimit) W -= 8;
  return W == 0 ? 0 : even_slices(D, W);
}

// Attends R query rows to keys c0 .. c1 - 1 and writes the output's
// columns [cs, cs + W) of each row.  Src gives the rows:
//   const T* q(int r), k(int key), v(int key)  (nullptr reads as zeros)
//   bool vis(int r, int key)                    (key < c1 is given)
//   void put(int r, int d, float x)             (output row r, column d)
// and, where it declares `static constexpr bool kBias = true`,
//   float bias(int r, int key)                  (an additive term in the
//                                                log2 domain, on visible
//                                                scores only)
// Leaves each row's m (log2 domain) and l in the returned pointers.
struct Stats {
  const float* m;
  const float* l;
};

// whether a row source adds a term to its scores (Src::kBias); none for a
// source that does not declare it (B1's and B2's wide rows)
template <typename Src, typename = void>
struct HasBias : std::false_type {};
template <typename Src>
struct HasBias<Src, std::void_t<decltype(Src::kBias)>>
    : std::integral_constant<bool, Src::kBias> {};

template <typename T, typename Src>
__device__ Stats attend(const Src& src, int R, int D, int c0, int c1,
                        int cs, int W, float scale_log2,
                        unsigned char* smem) {
  float* qc = reinterpret_cast<float*>(smem);  // kPassRows x kChunk
  float* kc = qc + kPassRows * kChunk;         // kKeys x (kChunk + 1)
  float* sc = kc + kKeys * (kChunk + 1);       // R x kKeys
  float* vs = sc + R * kKeys;                  // kKeys x W
  float* acc = vs + kKeys * W;                 // R x W
  float* m = acc + (size_t)R * W;
  float* l = m + R;
  float* corr = l + R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < R * W; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < R; r += kThreads) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int t0 = c0; t0 < c1; t0 += kKeys) {
    // scores of rows r0 .. r0 + kPassRows - 1: entry i of a pass is row
    // r0 + i / kKeys, key t0 + i % kKeys (a lane's key)
    for (int r0 = 0; r0 < R; r0 += kPassRows) {
      float s[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) s[e] = 0.f;
      for (int d0 = 0; d0 < D; d0 += kChunk) {
        __syncthreads();  // the last chunk's products are done
        for (int i = tid; i < kPassRows * kChunk; i += kThreads) {
          const int r = i / kChunk, d = d0 + i - r * kChunk;
          const T* row = r0 + r < R && d < D ? src.q(r0 + r) : nullptr;
          qc[i] = row != nullptr ? to_f(row[d]) * scale_log2 : 0.f;
        }
        for (int i = tid; i < kKeys * kChunk; i += kThreads) {
          const int j = i / kChunk, c = i - j * kChunk, d = d0 + c;
          const T* row = t0 + j < c1 && d < D ? src.k(t0 + j) : nullptr;
          kc[j * (kChunk + 1) + c] = row != nullptr ? to_f(row[d]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int i = tid + e * kThreads;
          const float* a = qc + (i / kKeys) * kChunk;
          const float* b = kc + (i % kKeys) * (kChunk + 1);
          float x = 0.f;
#pragma unroll 16
          for (int c = 0; c < kChunk; ++c) x = fmaf(a[c], b[c], x);
          s[e] += x;
        }
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = tid + e * kThreads;
        const int r = r0 + i / kKeys, key = t0 + i % kKeys;
        if (r < R) {
          float x = key < c1 && src.vis(r, key) ? s[e] : -INFINITY;
          if constexpr (HasBias<Src>::value) {
            if (x != -INFINITY) x += src.bias(r, key);
          }
          sc[r * kKeys + i % kKeys] = x;
        }
      }
    }
    // the tile's V rows of the slice (the copies before the barrier)
    for (int i = tid; i < kKeys * W; i += kThreads) {
      const int j = i / W, d = cs + i - j * W;
      const T* row = t0 + j < c1 && d < D ? src.v(t0 + j) : nullptr;
      vs[i] = row != nullptr ? to_f(row[d]) : 0.f;
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + kWarps, ...
    for (int r = warp; r < R; r += kWarps) {
      const float x = sc[r * kKeys + lane];
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, warp_max(x));
      // a row that has seen no key yet keeps m = -inf and p = 0
      const bool none = m_new == -INFINITY;
      const float p = none ? 0.f : exp2f(x - m_new);
      sc[r * kKeys + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float c = none ? 1.f : exp2f(m_old - m_new);
        corr[r] = c;
        l[r] = l[r] * c + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over the slice's columns
    const int nk = min(kKeys, c1 - t0);
    for (int c = tid; c < W; c += kThreads) {
      for (int r = 0; r < R; ++r) {
        float a = acc[(size_t)r * W + c] * corr[r];
        for (int j = 0; j < nk; ++j)
          a = fmaf(sc[r * kKeys + j], vs[j * W + c], a);
        acc[(size_t)r * W + c] = a;
      }
    }
    __syncthreads();  // sc and vs are free for the next tile
  }
  __syncthreads();  // with no tile, the state written above

  for (int i = tid; i < R * W; i += kThreads) {
    const int r = i / W, d = cs + i - r * W;
    if (d < D) src.put(r, d, l[r] > 0.f ? acc[i] / l[r] : 0.f);
  }
  return Stats{m, l};
}

}  // namespace wide
}  // namespace ptt
