// Rotary embedding (kernel K2) and SwiGLU (kernel K3).
//
// K2 replaces paddle_tpu/ops/pallas/fused_ops.py:_rope_one_pallas (forward):
// the neox half-split rotation [x1*c - x2*s, x2*c + x1*s] in float32 of
// q [B, S, H, D] and k [B, S, KVH, D] by cos/sin [S, D/2].  With the
// interleaved flag it rotates the pairs (2j, 2j + 1) by cos/sin[j] instead,
// the other style of paddle_tpu/ops/paged_attention.py:rope_rotate (:52-56,
// blha_attention's use_neox_style=False): a thread loads the 2 CP elements
// of its CP pairs as two 16-byte pieces.  The serving
// engine passes B = 1, S = T packed tokens and the cos/sin rows gathered at
// each token's absolute position.  One launch rotates q and k together.
// The generation path passes the whole [Smax, D/2] table and its position
// offset on the device instead: the kernel reads it and takes rows
// clamp(off, 0, Smax - S) + s (a negative off first counts from the end),
// the reference's lax.dynamic_slice_in_dim (fused_ops.py's caller,
// models/llama.py:apply_rotary_pos_emb), so no window is gathered before
// the launch.  The rope backward
// (fused_ops.py:_rope_bwd) is K2 rotating by -theta: a sign flag negates
// each sin value as it is read (exact), so the arithmetic, and its bits,
// are those of K2 given an explicit -sin table.
// K2's ring mode folds B3 (decode_attention.py:kv_ring_write) into the
// same launch on the generation path: q is rotated into its output as
// always, the rotated k rows go straight into the static KV ring kbuf
// [B, L, KVH, D] and the v rows are copied into vbuf, at ring rows
// start .. start + S - 1.  Both offsets come from the one device pos and
// differ: the table row is clamp(wrap(pos, Smax), 0, Smax - S) + s, the
// ring row clamp(wrap(pos, L), 0, L - S) + s (dynamic_update_slice's start
// on the ring), wrap adding the length to a negative pos.  The ring's bits
// are those of K2's rotation then B3's copy; no k output, no ring-write
// launch.  v's rows are (token, head, chunk) items of the same flat grid,
// moved through the float conversions unchanged (exact for both types).
// K3 replaces fused_ops.py:_swiglu_pallas: silu(a) * b with float32 math.
// B6b replaces fused_ops.py:_swiglu_bwd_pallas (kernel _swiglu_bwd_kernel):
// da = g * b * (sig + silu * (1 - sig)), db = g * silu, with sig = sigmoid(a)
// recomputed from a (no activation stash), float32 math.
//
// Bound on the H100: bytes for all three (a handful of flops per element).
// Design: K2 gives one thread to each (token, head, chunk of 16 / sizeof(T)
// pairs): one 16-byte load of x1 and one of x2, the chunk's float32 cos and
// sin rows in 16-byte loads, two 16-byte stores; the grid is flat over
// tokens x (H + KVH) x chunks, decomposed once per thread, so a decode
// step's 8 tokens x 64 heads x 8 chunks are 4096 threads in 32 blocks.
// Where D / 2 is not a multiple of the chunk or a pointer or a stride is
// not 16-byte aligned, a thread takes one pair with scalar accesses.  q and
// k may be strided views over B and S (the columns of a packed qkv buffer;
// each head's [D] contiguous), the outputs are contiguous.  K3 and B6b are
// one grid-stride pass each, one read of each input and one write of each
// output; K3 moves 16 bytes of each a thread per step where the three
// pointers allow it.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRopeThreads = 128;

// CP consecutive elements of T (16 bytes, or one) as floats, and back
template <typename T, int CP>
__device__ __forceinline__ void load_f(const T* p, float* f) {
  if constexpr (CP == 1) {
    f[0] = ptt::to_f(*p);
  } else {
    ptt::Vec16<T>::load(p, f);
  }
}

template <typename T, int CP>
__device__ __forceinline__ void store_f(T* p, const float* f) {
  if constexpr (CP == 1) {
    *p = ptt::from_f<T>(f[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < CP; ++i) e[i] = ptt::from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// CP float32 values of a cos or sin row (CP / 4 16-byte loads)
template <int CP>
__device__ __forceinline__ void load_row(const float* p, float* f) {
  if constexpr (CP == 1) {
    f[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < CP; i += 4) ptt::Vec16<float>::load(p + i, f + i);
  }
}

struct RopeArgs {
  const void *q, *k, *v;  // v: ring mode only
  void *oq, *ok;
  void *kbuf, *vbuf;      // ring mode: the [B, L, KVH, D] rings, else null
  int L;                  // ring rows
  const float *cos_t, *sin_t;
  const void* off;  // the device's position offset, or null
  int off_bytes;    // 4 (int32) or 8 (int64)
  int smax;         // rows of the cos/sin table
  int S, H, KVH, D, chunks;
  unsigned items;   // B * S * (H + KVH) * chunks
  long long qsb, qss, ksb, kss, vsb, vss;
  float sign;       // 1, or -1 for the backward
  int interleaved;  // pairs (2j, 2j + 1), else the neox halves (j, j + D/2)
};

// the device's offset, a negative one counted from the end of `len` rows,
// clamped to [0, len - S]
__device__ __forceinline__ int device_start(const RopeArgs& a, int len) {
  long long o = a.off_bytes == 8 ? *(const long long*)a.off
                                 : (long long)*(const int*)a.off;
  if (o < 0) o += len;  // a negative index counts from the end
  return (int)(o < 0 ? 0 : o > len - a.S ? len - a.S : o);
}

// RING: the ring mode (a.kbuf set)
template <typename T, int CP, bool RING>
__global__ void __launch_bounds__(kRopeThreads) rope_kernel(RopeArgs a) {
  const unsigned i = blockIdx.x * kRopeThreads + threadIdx.x;
  if (i >= a.items) return;
  // (token, head, chunk), the chunk fastest; heads: q's, k's, and in ring
  // mode v's
  const unsigned heads = a.H + a.KVH * (RING ? 2 : 1);
  const unsigned rest = i / a.chunks, c = i - rest * a.chunks;
  const unsigned tok = rest / heads, head = rest - tok * heads;
  const unsigned b = tok / a.S, s = tok - b * a.S;
  int row = s;
  if (a.off != nullptr) row += device_start(a, a.smax);
  // the token's row of the ring
  const size_t rrow = RING ? (size_t)b * a.L + device_start(a, a.L) + s : 0;
  const int half = a.D / 2, j = c * CP;
  const T* src;
  T* dst;
  if (head < (unsigned)a.H) {
    src = (const T*)a.q + b * a.qsb + s * a.qss + (size_t)head * a.D;
    dst = (T*)a.oq + ((size_t)tok * a.H + head) * a.D;
  } else if (!RING || head < (unsigned)(a.H + a.KVH)) {
    const unsigned hk = head - a.H;
    src = (const T*)a.k + b * a.ksb + s * a.kss + (size_t)hk * a.D;
    dst = RING ? (T*)a.kbuf + (rrow * a.KVH + hk) * a.D
               : (T*)a.ok + ((size_t)tok * a.KVH + hk) * a.D;
  } else {  // the ring mode: v's row into vbuf, unrotated
    const unsigned hv = head - a.H - a.KVH;
    src = (const T*)a.v + b * a.vsb + s * a.vss + (size_t)hv * a.D;
    dst = (T*)a.vbuf + (rrow * a.KVH + hv) * a.D;
    float x[CP];
    load_f<T, CP>(src + j, x);
    store_f<T, CP>(dst + j, x);
    load_f<T, CP>(src + half + j, x);
    store_f<T, CP>(dst + half + j, x);
    return;
  }
  float x1[CP], x2[CP], cc[CP], sn[CP];
  if (a.interleaved) {  // elements 2j .. 2j + 2 CP - 1, pairs side by side
    float w[2 * CP];
    load_f<T, CP>(src + 2 * j, w);
    load_f<T, CP>(src + 2 * j + CP, w + CP);
#pragma unroll
    for (int e = 0; e < CP; ++e) {
      x1[e] = w[2 * e];
      x2[e] = w[2 * e + 1];
    }
  } else {
    load_f<T, CP>(src + j, x1);
    load_f<T, CP>(src + half + j, x2);
  }
  load_row<CP>(a.cos_t + (size_t)row * half + j, cc);
  load_row<CP>(a.sin_t + (size_t)row * half + j, sn);
  float o1[CP], o2[CP];
#pragma unroll
  for (int e = 0; e < CP; ++e) {
    const float se = sn[e] * a.sign;  // exact: the bits of a -sin table
    o1[e] = x1[e] * cc[e] - x2[e] * se;
    o2[e] = x2[e] * cc[e] + x1[e] * se;
  }
  if (a.interleaved) {
    float w[2 * CP];
#pragma unroll
    for (int e = 0; e < CP; ++e) {
      w[2 * e] = o1[e];
      w[2 * e + 1] = o2[e];
    }
    store_f<T, CP>(dst + 2 * j, w);
    store_f<T, CP>(dst + 2 * j + CP, w + CP);
  } else {
    store_f<T, CP>(dst + j, o1);
    store_f<T, CP>(dst + half + j, o2);
  }
}

template <typename T>
__device__ __forceinline__ T swiglu1(T a, T b) {
  const float av = ptt::to_f(a);
  const float sig = 1.f / (1.f + expf(-av));
  return ptt::from_f<T>(av * sig * ptt::to_f(b));
}

// vec: a, b and o are 16-byte aligned.  Then each thread reads 16 bytes of
// a and of b (8 bfloat16 or 4 float32) and writes 16 of o per step of a
// grid-stride loop, and the last numel % (16 / sizeof(T)) elements go
// element by element; otherwise the whole range does.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ o, long long n, int vec) {
  constexpr int V = 16 / sizeof(T);
  const long long step = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long nv = n / V;
    const uint4* a4 = reinterpret_cast<const uint4*>(a);
    const uint4* b4 = reinterpret_cast<const uint4*>(b);
    uint4* o4 = reinterpret_cast<uint4*>(o);
    for (long long i = t0; i < nv; i += step) {
      const uint4 ra = a4[i], rb = b4[i];
      uint4 ro;
      const T* ea = reinterpret_cast<const T*>(&ra);
      const T* eb = reinterpret_cast<const T*>(&rb);
      T* eo = reinterpret_cast<T*>(&ro);
#pragma unroll
      for (int e = 0; e < V; ++e) eo[e] = swiglu1(ea[e], eb[e]);
      o4[i] = ro;
    }
    tail = nv * V;
  }
  for (long long i = tail + t0; i < n; i += step) o[i] = swiglu1(a[i], b[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    swiglu_bwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const T* __restrict__ g, T* __restrict__ da,
                      T* __restrict__ db, long long n) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += step) {
    const float av = ptt::to_f(a[i]), bv = ptt::to_f(b[i]);
    const float gv = ptt::to_f(g[i]);
    const float sig = 1.f / (1.f + expf(-av));
    const float silu = av * sig;
    da[i] = ptt::from_f<T>(gv * bv * (sig + silu * (1.f - sig)));
    db[i] = ptt::from_f<T>(gv * silu);
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

// K3's grid: a block per 256 vectors, at most 8 blocks (2048 threads) an
// SM, 64 KB of a and b in flight on each
int swiglu_grid(long long n, int vec, int V) {
  const long long items = vec ? (n / V > 0 ? n / V : n) : n;
  const long long blocks = (items + kThreads - 1) / kThreads;
  return (int)(blocks < 132 * 8 ? blocks : 132 * 8);
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// vec: the 16-byte instance (the wrapper checks D and the alignment of
// every pointer and stride; the entry checks them again)
template <typename T>
cudaError_t rope_launch(RopeArgs a, long long tokens, int vec,
                        cudaStream_t st) {
  constexpr int CP = 16 / sizeof(T);
  const int half = a.D / 2;
  const bool ring = a.kbuf != nullptr;
  if (vec) {
    const long long es = sizeof(T);
    const bool ok = half % CP == 0 && aligned16(a.q) && aligned16(a.k) &&
                    aligned16(a.oq) && aligned16(a.cos_t) &&
                    aligned16(a.sin_t) && (a.qsb * es) % 16 == 0 &&
                    (a.qss * es) % 16 == 0 && (a.ksb * es) % 16 == 0 &&
                    (a.kss * es) % 16 == 0 &&
                    (ring ? aligned16(a.v) && aligned16(a.kbuf) &&
                                aligned16(a.vbuf) &&
                                (a.vsb * es) % 16 == 0 &&
                                (a.vss * es) % 16 == 0
                          : aligned16(a.ok));
    if (!ok) return cudaErrorInvalidValue;
    a.chunks = half / CP;
  } else {
    a.chunks = half;
  }
  const long long items =
      tokens * (a.H + a.KVH * (ring ? 2 : 1)) * a.chunks;
  if (items <= 0) return cudaSuccess;
  if (items >= (1ll << 31)) return cudaErrorInvalidValue;
  a.items = (unsigned)items;
  const int grid = (int)((items + kRopeThreads - 1) / kRopeThreads);
  if (vec && ring)
    rope_kernel<T, CP, true><<<grid, kRopeThreads, 0, st>>>(a);
  else if (vec)
    rope_kernel<T, CP, false><<<grid, kRopeThreads, 0, st>>>(a);
  else if (ring)
    rope_kernel<T, 1, true><<<grid, kRopeThreads, 0, st>>>(a);
  else
    rope_kernel<T, 1, false><<<grid, kRopeThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// kbuf null: q and k rotated into oq and ok.  Else the ring mode: q
// rotated into oq, k rotated and v copied into the rings kbuf/vbuf
// [B, L, KVH, D] at rows clamp(wrap(off, L), 0, L - S) + s (ok unused).
extern "C" int ptt_rope(const void* q, const void* k, const void* v,
                        void* oq, void* ok, void* kbuf, void* vbuf,
                        const void* cos_t, const void* sin_t,
                        const void* off, int off_bytes, int smax, int L,
                        int B, int S, int H, int KVH, int D, long long qsb,
                        long long qss, long long ksb, long long kss,
                        long long vsb, long long vss, float sign, int vec,
                        int interleaved, int dtype, void* stream) {
  const bool ring = kbuf != nullptr;
  if (D % 2 || S < 1 || smax < S ||
      (off && off_bytes != 4 && off_bytes != 8) ||
      (ring && (!off || !v || !vbuf || L < S)))
    return (int)cudaErrorInvalidValue;
  RopeArgs a = {};
  a.q = q, a.k = k, a.v = v, a.oq = oq, a.ok = ok;
  a.kbuf = kbuf, a.vbuf = vbuf, a.L = L;
  a.cos_t = (const float*)cos_t, a.sin_t = (const float*)sin_t;
  a.off = off, a.off_bytes = off_bytes, a.smax = smax;
  a.S = S, a.H = H, a.KVH = KVH, a.D = D;
  a.qsb = qsb, a.qss = qss, a.ksb = ksb, a.kss = kss, a.vsb = vsb,
  a.vss = vss, a.sign = sign, a.interleaved = interleaved;
  const long long tokens = (long long)B * S;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == ptt::kFloat32)
    return (int)rope_launch<float>(a, tokens, vec, st);
  if (dtype == ptt::kBFloat16)
    return (int)rope_launch<__nv_bfloat16>(a, tokens, vec, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ptt_swiglu(const void* a, const void* b, void* o, long long n,
                          int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaSuccess;
  const int vec = aligned16(a) && aligned16(b) && aligned16(o);
  if (dtype == ptt::kFloat32)
    swiglu_kernel<float><<<swiglu_grid(n, vec, 4), kThreads, 0, st>>>(
        (const float*)a, (const float*)b, (float*)o, n, vec);
  else if (dtype == ptt::kBFloat16)
    swiglu_kernel<__nv_bfloat16>
        <<<swiglu_grid(n, vec, 8), kThreads, 0, st>>>(
            (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
            (__nv_bfloat16*)o, n, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ptt_swiglu_bwd(const void* a, const void* b, const void* g,
                              void* da, void* db, long long n, int dtype,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int grid = grid_for(n);
  if (dtype == ptt::kFloat32)
    swiglu_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)a, (const float*)b, (const float*)g, (float*)da,
        (float*)db, n);
  else if (dtype == ptt::kBFloat16)
    swiglu_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b,
        (const __nv_bfloat16*)g, (__nv_bfloat16*)da, (__nv_bfloat16*)db, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
