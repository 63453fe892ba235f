// Segment combine over dst-sorted messages: out[v, d] = fold of
// vals[e, d] for e in [indptr[v], indptr[v+1]) under sum, min or max.
//
// Replaces the Pallas kernel repro/kernels/segment_reduce.py::
// segment_combine_kernel (one-hot MXU matmul for sum, segmented scan plus
// pick matmul for min/max). On Hopper the dst-sorted order gives every
// vertex a contiguous row of entries, so no one-hot work and no atomics
// are needed.
//
// Bound on the H100: bytes. Every message is read once and every output
// written once; the arithmetic is one add or compare per value.
//
// Schedule, balanced by entries rather than by rows (merge path):
//   * the rows and their entries are laid out as one path, each row's
//     entries followed by its end marker; tile t owns the K path items
//     [t*K, (t+1)*K) and so the rows whose end marker falls there, which
//     bounds both its rows and its entries whatever the degrees. A first
//     kernel finds every tile's first row by a 32-way search of indptr
//     (one warp per tile, one load per lane a step) and writes it with
//     its row pointers to a table, so no per-layout table is needed and a
//     compacted workset's row pointers take the same schedule;
//   * the tile reads its bounds from that table and copies its row
//     pointers and its rows' entries (one contiguous range of vals, and
//     of offsets for a compacted f32 sum) into shared memory with 16-byte
//     cp.async copies in one round, then folds: short rows one thread per
//     (row, column), longer rows one warp per (row, column) with lane k
//     holding partial k. Four tiles share an SM, so one's copies overlap
//     the others' folds;
//   * a heavy row (more than K entries: more than a tile stages) is the
//     tile's first row; the tile streams it through a ring of kStages
//     cp.async stages before its light rows, all warps folding (each
//     (partial, column) pair of an f32 sum in one lane, in order; any
//     split of the other monoids), and finishes it with the partials'
//     tree. A tile inside a heavy row owns no row and exits.
//
// The f32-sum order (float payloads, shared by both arms and by the
// single-leaf fused kernel): entry c of a row (c counting from the dense
// row's first entry, `offsets[e]` for a compacted row) goes into partial
// c % 32, each partial starts at 0.0 and adds its entries in row order,
// and the 32 partials are added as a fixed pairwise tree (lanes 2i and
// 2i+1 at each level, an xor butterfly). A partial never holds -0.0, so
// an empty partial (0.0) adds nothing; the thread-path folds below (the
// pairwise counter of a dense row of up to 32 entries, and the closed
// form for a compacted row of up to 3 entries) are that tree with the
// empty partials left out, bit for bit. Min, max and integer sums do not
// depend on the order.
//
// Semantics kept from the Pallas kernel:
//   * accumulation in f32 for f32/f16/bf16 payloads, int32 for int8/int16/
//     int32 (sums wrap in two's complement);
//   * a vertex with no entry gets the identity the caller passes (the
//     payload dtype's iinfo bound for ints, +-3.4e38 for floats);
//   * f32 min/max clamp +-inf to +-3.4e38 before folding;
//   * the f32 accumulator is rounded to the payload dtype once, at the end.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2, kI8 = 3, kI16 = 4, kI32 = 5 };

constexpr float kFloatBig = 3.4e38f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// stages of the heavy-row ring
constexpr int kStages = 4;
// a row of at most this many entries folds in one thread: dense rows
// (and every row of an order-free monoid), compacted f32-sum rows
constexpr int kThreadRow = 32;
constexpr int kThreadRowOffs = 3;
// columns of a heavy row folded per pass over it (its partials stay in
// shared memory between stages)
constexpr int kGroupCols = 64;

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ int to_acc(int8_t x) { return x; }
__device__ __forceinline__ int to_acc(int16_t x) { return x; }
__device__ __forceinline__ int to_acc(int32_t x) { return x; }

template <typename T>
__device__ __forceinline__ T from_acc(float x);
template <>
__device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_acc<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <typename T>
__device__ __forceinline__ T from_acc(int x) { return static_cast<T>(x); }

template <int OP>
__device__ __forceinline__ float fold(float a, float b) {
  if (OP == kSum) return __fadd_rn(a, b);
  if (OP == kMin) return fminf(a, b);
  return fmaxf(a, b);
}

template <int OP>
__device__ __forceinline__ int fold(int a, int b) {
  if (OP == kSum) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  if (OP == kMin) return a < b ? a : b;
  return a > b ? a : b;
}

__device__ __forceinline__ float clamp_big(float x) {
  return x > kFloatBig ? kFloatBig : (x < -kFloatBig ? -kFloatBig : x);
}

template <typename Acc, int OP, typename T>
__device__ __forceinline__ Acc load_acc(const T* p) {
  Acc x = to_acc(*p);
  if constexpr (std::is_floating_point<Acc>::value && OP != kSum) {
    x = clamp_big(x);  // float min/max only
  }
  return x;
}

__device__ __forceinline__ float lift(float x) { return __fadd_rn(0.0f, x); }

__device__ __forceinline__ int top_bit(int x) { return 31 - __clz(x); }

// ---- staging: 16-byte cp.async copies into shared memory ------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy elements [a, b) of `src` into `dst` (16-byte aligned shared
// memory) by the whole CTA: the 16-byte blocks of [floor16(&src[a]),
// floor16(&src[b])) by cp.async, the elements past the last whole block by
// plain loads. Returns the shift: element a lands at dst[shift]. The copy
// is complete for the CTA after cp_async_wait and __syncthreads.
template <typename E>
__device__ __forceinline__ int stage(E* dst, const E* __restrict__ src,
                                     int64_t a, int64_t b) {
  const uintptr_t pa = reinterpret_cast<uintptr_t>(src + a);
  const uintptr_t pb = reinterpret_cast<uintptr_t>(src + b);
  const uintptr_t lo = pa & ~uintptr_t(15);
  const uintptr_t hi = pb & ~uintptr_t(15);
  const int nvec = hi > lo ? static_cast<int>((hi - lo) >> 4) : 0;
  char* d = reinterpret_cast<char*>(dst);
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    cp_async16(d + 16 * i, reinterpret_cast<const void*>(lo + 16 * i));
  }
  const uintptr_t t0 = hi > pa ? hi : pa;
  const int ntail = static_cast<int>((pb - t0) / sizeof(E));
  for (int i = threadIdx.x; i < ntail; i += kThreads) {
    const E* p = reinterpret_cast<const E*>(t0) + i;
    dst[(reinterpret_cast<uintptr_t>(p) - lo) / sizeof(E)] = *p;
  }
  return static_cast<int>((pa - lo) / sizeof(E));
}

// ---- the merge-path search --------------------------------------------------

// Rows r of [0, V) whose end marker (path item indptr[r+1] + r) lies
// before path item d. Called by a whole warp: 32 probes a step.
__device__ int rows_before(const int* __restrict__ indptr, int V, int Eu,
                           int64_t d, int lane) {
  int64_t lo = d - Eu > 0 ? d - Eu : 0;
  int64_t hi = d < V ? d : V;  // the count lies in [lo, hi]
  while (true) {
    const int64_t n = hi - lo;
    if (n <= 32) {
      bool p = false;
      if (lane < n) {
        const int64_t r = lo + lane;
        p = static_cast<int64_t>(indptr[r + 1]) + r < d;
      }
      return static_cast<int>(lo + __popc(__ballot_sync(~0u, p)));
    }
    const int64_t stride = (n + 31) / 32;
    int64_t r = lo + (lane + 1) * stride - 1;
    if (r > hi - 1) r = hi - 1;
    const bool p = static_cast<int64_t>(indptr[r + 1]) + r < d;
    const int m = __popc(__ballot_sync(~0u, p));
    const int64_t nlo = lo + m * stride;
    if (nlo >= hi) return static_cast<int>(hi);
    int64_t nhi = lo + (m + 1) * stride - 1;
    if (nhi > hi - 1) nhi = hi - 1;
    lo = nlo;
    hi = nhi;  // probe m failed: the count is at most nhi
  }
}

// ---- f32-sum folds ------------------------------------------------------------

// A dense row of n <= 32 entries (x[c * D]) in one thread: the pairwise
// tree by a binary counter, s_k holding the pending node of 2^k entries;
// the pending nodes of n's bits then add right to left.
template <typename T>
__device__ __forceinline__ float fsum_row(const T* x, int n, int D) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, s4 = 0.0f;
  for (int c = 0; c < n; ++c) {
    float v = lift(to_acc(x[static_cast<int64_t>(c) * D]));
    if (!(c & 1)) { s0 = v; continue; }
    v = __fadd_rn(s0, v);
    if (!(c & 2)) { s1 = v; continue; }
    v = __fadd_rn(s1, v);
    if (!(c & 4)) { s2 = v; continue; }
    v = __fadd_rn(s2, v);
    if (!(c & 8)) { s3 = v; continue; }
    v = __fadd_rn(s3, v);
    if (!(c & 16)) { s4 = v; continue; }
    return __fadd_rn(s4, v);  // c == 31: all 32 partials
  }
  float r = 0.0f;
  if (n & 1) r = __fadd_rn(s0, r);
  if (n & 2) r = __fadd_rn(s1, r);
  if (n & 4) r = __fadd_rn(s2, r);
  if (n & 8) r = __fadd_rn(s3, r);
  if (n & 16) r = __fadd_rn(s4, r);
  return r;
}

// A compacted row of 1 <= n <= 3 entries in one thread: entry j goes to
// partial off[j] & 31; the tree over the non-empty partials.
template <typename T>
__device__ __forceinline__ float fsum_few(const T* x, const int* off, int n,
                                          int D) {
  const float x0 = to_acc(x[0]);
  const float a = lift(x0);
  const int ka = off[0] & 31;
  if (n == 1) return a;
  const float x1 = to_acc(x[D]);
  const int kb = off[1] & 31;
  if (n == 2) return ka == kb ? __fadd_rn(a, x1) : __fadd_rn(a, lift(x1));
  const float x2 = to_acc(x[2 * D]);
  const int kc = off[2] & 31;
  if (ka == kb && kb == kc) return __fadd_rn(__fadd_rn(a, x1), x2);
  if (ka == kb) return __fadd_rn(__fadd_rn(a, x1), lift(x2));
  if (kb == kc) return __fadd_rn(a, __fadd_rn(lift(x1), x2));
  if (ka == kc) return __fadd_rn(__fadd_rn(a, x2), lift(x1));
  // three partials: in partial order, the pair that meets lower first
  float v[3] = {a, lift(x1), lift(x2)};
  int k[3] = {ka, kb, kc};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2 - i; ++j) {
      if (k[j] > k[j + 1]) {
        const int tk = k[j]; k[j] = k[j + 1]; k[j + 1] = tk;
        const float tv = v[j]; v[j] = v[j + 1]; v[j + 1] = tv;
      }
    }
  }
  return top_bit(k[0] ^ k[1]) < top_bit(k[1] ^ k[2])
             ? __fadd_rn(__fadd_rn(v[0], v[1]), v[2])
             : __fadd_rn(v[0], __fadd_rn(v[1], v[2]));
}

// Lane k adds the entries of its mask (x[j * D] for bit j) into acc in
// bit order.
template <typename T>
__device__ __forceinline__ float add_mask(float acc, const T* x, int D,
                                          unsigned mine) {
  while (mine) {
    const int j = __ffs(mine) - 1;
    mine &= mine - 1u;
    acc = __fadd_rn(acc, to_acc(x[static_cast<int64_t>(j) * D]));
  }
  return acc;
}

// Lane k adds the entries [lo, hi) (x[e * D]) of partial k into acc: a
// dense run starting at a row offset that is a multiple of 32 (entry
// lo + c to partial c % 32), or with offsets, 32 entries a round: entry j
// sets bit j of its partial's mask (off[j] & 31) in the warp's 32 words
// `pm` of shared memory, and lane k adds the entries of its mask in bit
// order, which is their row order (add_mask).
template <bool OFFS, typename T>
__device__ __forceinline__ float fsum_lanes(float acc, const T* x,
                                            const int* off, int lo, int hi,
                                            int D, int lane, unsigned* pm) {
  if constexpr (!OFFS) {
#pragma unroll 8
    for (int e = lo + lane; e < hi; e += 32) {
      acc = __fadd_rn(acc, to_acc(x[static_cast<int64_t>(e) * D]));
    }
  } else {
    for (int base = lo; base < hi; base += 32) {
      pm[lane] = 0u;
      __syncwarp();
      if (base + lane < hi) atomicOr(&pm[off[base + lane] & 31], 1u << lane);
      __syncwarp();
      acc = add_mask(acc, x + static_cast<int64_t>(base) * D, D, pm[lane]);
      __syncwarp();
    }
  }
  return acc;
}

// The 32 partials' pairwise tree: lanes 2i and 2i+1, then 4i and 4i+2, ...
// (an f32 sum), or any order (the other monoids). Every lane gets it.
template <int OP, typename Acc>
__device__ __forceinline__ Acc warp_finish(Acc acc) {
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    acc = fold<OP>(acc, __shfl_xor_sync(~0u, acc, m));
  }
  return acc;
}

// ---- shared memory ------------------------------------------------------------

struct Layout {
  int stage_bytes;  // the tile's entries (values, then offsets), or the ring
  int ip_off;       // the tile's row pointers (K + 2, and the copy's shift)
  int list_off;     // its long rows (K / 2 + 2), or a heavy row's partials
  int pm_off;       // partial masks: 32 per warp, or per heavy ring stage
  int total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// `per` entries a heavy ring stage; a compacted f32 sum (`offs`) keeps
// one mask word per entry of a stage
__host__ __device__ inline Layout layout(int stage_bytes, int K, int per,
                                         bool offs) {
  const int list = 4 * (K / 2 + 2);
  const int part = 4 * 32 * kGroupCols;
  const int pm = 4 * (offs && per > 32 * kWarps ? per : 32 * kWarps);
  Layout l;
  l.stage_bytes = align16(stage_bytes);
  l.ip_off = l.stage_bytes;
  l.list_off = l.ip_off + align16(4 * (K + 8));
  l.pm_off = l.list_off + align16(list > part ? list : part);
  l.total = l.pm_off + align16(pm);
  return l;
}

// ---- the heavy row ------------------------------------------------------------

// Where element a of src lands in a buffer that `stage` filled from it.
template <typename E>
__device__ __forceinline__ int shift_of(const E* src, int64_t a) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src + a) & 15) /
                          sizeof(E));
}

// Row `row` (entries [lo, hi), more than a tile stages) by the whole CTA:
// for each group of up to kGroupCols columns, its entries stream through
// kStages ring stages of `per` entries (a multiple of 32, so a dense
// stage starts on partial 0). An f32 sum folds each (partial, column)
// pair in one lane, in order, keeping it in shared memory between
// stages; the other monoids fold any split, thread t holding the slot
// t / dg of column t % dg in a register. One warp per column finishes.
template <typename T, typename Acc, int OP, bool OFFS>
__device__ void heavy_row(const T* __restrict__ vals,
                          const int* __restrict__ offsets,
                          T* __restrict__ out, int row, int lo, int hi,
                          int D, int per, Acc ident, unsigned char* smem,
                          const Layout& L) {
  constexpr bool FSUM = std::is_floating_point<Acc>::value && OP == kSum;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sb = L.stage_bytes / kStages;  // bytes per ring stage
  const int vbytes = align16(per * D * static_cast<int>(sizeof(T)) + 16);
  Acc* part = reinterpret_cast<Acc*>(smem + L.list_off);
  unsigned* pm = reinterpret_cast<unsigned*>(smem + L.pm_off);
  const int n = hi - lo;
  const int npieces = (n + per - 1) / per;
  for (int g0 = 0; g0 < D; g0 += kGroupCols) {
    const int dg = D - g0 < kGroupCols ? D - g0 : kGroupCols;
    const int nslot = kThreads / dg;
    Acc acc = ident;
    if constexpr (FSUM) {
      for (int i = tid; i < 32 * dg; i += kThreads) part[i] = 0.0f;
    }
    auto fetch = [&](int p) {
      unsigned char* buf = smem + (p % kStages) * sb;
      const int a = lo + p * per;
      const int b = a + per < hi ? a + per : hi;
      stage(reinterpret_cast<T*>(buf), vals, static_cast<int64_t>(a) * D,
            static_cast<int64_t>(b) * D);
      if constexpr (OFFS && FSUM) {
        stage(reinterpret_cast<int*>(buf + vbytes), offsets, a, b);
      }
    };
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
      if (p < npieces) fetch(p);
      cp_async_commit();
    }
    for (int p = 0; p < npieces; ++p) {
      if (p + kStages - 1 < npieces) fetch(p + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncthreads();
      const unsigned char* buf = smem + (p % kStages) * sb;
      const int a = lo + p * per;
      const T* x = reinterpret_cast<const T*>(buf) +
                   shift_of(vals, static_cast<int64_t>(a) * D);
      const int m = n - p * per < per ? n - p * per : per;
      if constexpr (FSUM && OFFS) {
        // the stage's partial masks, a round of 32 entries per warp at a
        // time (fsum_lanes), then lane k adds its entries round by round
        const int* off = reinterpret_cast<const int*>(buf + vbytes) +
                         shift_of(offsets, a);
        const int rounds = (m + 31) / 32;
        for (int b = warp; b < rounds; b += kWarps) {
          pm[32 * b + lane] = 0u;
          __syncwarp();
          const int e = 32 * b + lane;
          if (e < m) atomicOr(&pm[32 * b + (off[e] & 31)], 1u << lane);
        }
        __syncthreads();
        for (int dd = warp; dd < dg; dd += kWarps) {
          float v = part[lane * dg + dd];
          for (int b = 0; b < rounds; ++b) {
            v = add_mask(v, x + static_cast<int64_t>(32 * b) * D + g0 + dd,
                         D, pm[32 * b + lane]);
          }
          part[lane * dg + dd] = v;
        }
      } else if constexpr (FSUM) {
        for (int dd = warp; dd < dg; dd += kWarps) {
          float v = part[lane * dg + dd];
          v = fsum_lanes<false>(v, x + g0 + dd, nullptr, 0, m, D, lane,
                                nullptr);
          part[lane * dg + dd] = v;
        }
      } else if (tid < nslot * dg) {
        const int dd = tid % dg;
        for (int c = tid / dg; c < m; c += nslot) {
          acc = fold<OP>(acc, load_acc<Acc, OP>(
                                  x + static_cast<int64_t>(c) * D + g0 + dd));
        }
      }
      __syncthreads();
    }
    if constexpr (!FSUM) {
      if (tid < nslot * dg) part[tid] = acc;  // slot tid / dg, column tid % dg
      __syncthreads();
    }
    // finish: one warp per column, partial k (or slots k, k + 32, ...) in
    // lane k
    for (int dd = warp; dd < dg; dd += kWarps) {
      Acc v;
      if constexpr (FSUM) {
        v = part[lane * dg + dd];
      } else {
        v = ident;
        for (int q = lane; q < nslot; q += 32) {
          v = fold<OP>(v, part[q * dg + dd]);
        }
      }
      v = warp_finish<OP>(v);
      if (lane == 0) {
        out[static_cast<int64_t>(row) * D + g0 + dd] = from_acc<T>(v);
      }
    }
    __syncthreads();
  }
}

// ---- the tile bounds --------------------------------------------------------

// One warp per tile bound t in [0, T]: the tile's first row i0 (the rows
// whose end marker lies before path item t*K), indptr[i0] and
// indptr[i0 + 1], so each tile reads its rows and entry ranges in one
// load instead of searching.
__global__ void __launch_bounds__(kThreads)
    segment_bounds_kernel(const int* __restrict__ indptr, int V, int K,
                          int T, int* __restrict__ table) {
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w > T) return;  // whole warps leave together
  const int Eu = indptr[V];
  const int64_t total = static_cast<int64_t>(V) + Eu;
  const int64_t d = w * K < total ? w * K : total;
  const int i0 = rows_before(indptr, V, Eu, d, lane);
  if (lane == 0) {
    table[3 * w] = i0;
    table[3 * w + 1] = indptr[i0];
    table[3 * w + 2] = indptr[i0 < V ? i0 + 1 : V];
  }
}

// ---- the tile kernel ------------------------------------------------------------

template <typename T, typename Acc, int OP, bool OFFS>
__global__ void __launch_bounds__(kThreads, 4)
    segment_tiles_kernel(const T* __restrict__ vals,
                         const int* __restrict__ indptr,
                         const int* __restrict__ offsets,
                         const int* __restrict__ table,
                         T* __restrict__ out, int D, int K, int per,
                         int stage_bytes, Acc ident) {
  constexpr bool FSUM = std::is_floating_point<Acc>::value && OP == kSum;
  constexpr bool FEW = FSUM && OFFS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_long;
  const Layout L = layout(stage_bytes, K, per, OFFS);
  int* longs = reinterpret_cast<int*>(smem + L.list_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int* tb = table + 3 * blockIdx.x;
  const int i0 = tb[0];
  const int nrows = tb[3] - i0;
  if (nrows == 0) return;  // inside a heavy row
  const int ip0 = tb[1], ip1 = tb[2], e = tb[4];
  // only the tile's first row can hold more than K entries
  const bool heavy = ip1 - ip0 > K;
  const int s = heavy ? ip1 : ip0;
  if (tid == 0) n_long = 0;
  int* ipb = reinterpret_cast<int*>(smem + L.ip_off);
  const int ishift = stage(ipb, indptr, i0, i0 + nrows + 1);
  const int* ip = ipb + ishift;
  T* stg = reinterpret_cast<T*>(smem);
  int* offs = nullptr;
  if constexpr (FEW) {
    const int vb = align16((2 * K * D) * static_cast<int>(sizeof(T)) + 16);
    offs = reinterpret_cast<int*>(smem + vb);
  }
  auto stage_light = [&]() {
    stage(stg, vals, static_cast<int64_t>(s) * D,
          static_cast<int64_t>(e) * D);
    if constexpr (FEW) stage(offs, offsets, s, e);
  };
  if (!heavy) stage_light();  // with the row pointers, in one round
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  int first = 0;
  if (heavy) {
    heavy_row<T, Acc, OP, OFFS>(vals, offsets, out, i0, ip0, ip1, D, per,
                                ident, smem, L);
    first = 1;
    stage_light();
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  const T* x = stg + shift_of(vals, static_cast<int64_t>(s) * D);
  const int* off = FEW ? offs + shift_of(offsets, s) : nullptr;

  // short rows: one thread per (row, column); longer rows to the list
  const int limit = FEW ? kThreadRowOffs : kThreadRow;
  for (int item = first * D + tid; item < nrows * D; item += kThreads) {
    const int rr = D == 1 ? item : item / D;
    const int d = item - rr * D;
    const int lo = ip[rr] - s;
    const int n = ip[rr + 1] - ip[rr];
    T* dst = out + static_cast<int64_t>(i0 + rr) * D + d;
    if (n > limit) {
      if (d == 0) longs[atomicAdd(&n_long, 1)] = rr;
      continue;
    }
    Acc r = ident;
    if (n > 0) {
      const T* xr = x + static_cast<int64_t>(lo) * D + d;
      if constexpr (FEW) {
        r = fsum_few(xr, off + lo, n, D);
      } else if constexpr (FSUM) {
        r = fsum_row(xr, n, D);
      } else {
        for (int c = 0; c < n; ++c) {
          r = fold<OP>(r,
                       load_acc<Acc, OP>(xr + static_cast<int64_t>(c) * D));
        }
      }
    }
    *dst = from_acc<T>(r);
  }
  __syncthreads();

  // long rows: one warp per (row, column), lane k holding partial k
  const int nl = n_long;
  unsigned* pm = reinterpret_cast<unsigned*>(smem + L.pm_off) + 32 * warp;
  for (int p = warp; p < nl * D; p += kWarps) {
    const int li = D == 1 ? p : p / D;
    const int d = p - li * D;
    const int rr = longs[li];
    const int lo = ip[rr] - s;
    const int hi = ip[rr + 1] - s;
    Acc acc;
    if constexpr (FSUM) {
      acc = fsum_lanes<OFFS>(0.0f, x + d, off, lo, hi, D, lane, pm);
    } else {
      acc = ident;
#pragma unroll 4
      for (int c = lo + lane; c < hi; c += 32) {
        acc = fold<OP>(acc,
                       load_acc<Acc, OP>(x + static_cast<int64_t>(c) * D + d));
      }
    }
    acc = warp_finish<OP>(acc);
    if (lane == 0) {
      out[static_cast<int64_t>(i0 + rr) * D + d] = from_acc<T>(acc);
    }
  }
}

// The tile size K (path items, a multiple of 16) and the heavy ring's
// stage (`per` entries, a multiple of 32) for D columns of `vsize`-byte
// values, with or without offsets, within `stage_bytes` of staging: a
// tile stages at most 2K entries (its first row up to K of them, the
// rest fewer than K).
struct Plan {
  int K, per;
};

inline Plan plan(int D, int vsize, bool offs, int stage_bytes) {
  const int entry = D * vsize + (offs ? 4 : 0);
  const int room = stage_bytes - 64;
  Plan p;
  p.K = (room / (2 * entry)) / 16 * 16;
  p.per = ((stage_bytes / kStages - 48) / entry) / 32 * 32;
  return p;
}

template <typename T, typename Acc, int OP, bool OFFS>
cudaError_t launch_op(const void* vals, const int* indptr,
                      const int* offsets, void* out, int V, int64_t E,
                      int D, double ident, int stage_bytes, int* table,
                      cudaStream_t stream) {
  const Plan p = plan(D, sizeof(T), OFFS, stage_bytes);
  if (p.K < 16 || p.per < 32) return cudaErrorInvalidValue;
  const Layout L = layout(stage_bytes, p.K, p.per, OFFS);
  const int64_t tiles = (static_cast<int64_t>(V) + E + p.K - 1) / p.K;
  if (tiles == 0) return cudaGetLastError();
  if ((tiles + 1) * 32 > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int64_t bound_blocks = ((tiles + 1) * 32 + kThreads - 1) / kThreads;
  segment_bounds_kernel<<<static_cast<unsigned>(bound_blocks), kThreads, 0,
                          stream>>>(indptr, V, p.K, static_cast<int>(tiles),
                                    table);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = segment_tiles_kernel<T, Acc, OP, OFFS>;
  // raise the kernel's shared-memory limit once per device and size
  static int raised[64] = {0};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || raised[dev] < L.total) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = L.total;
  }
  kernel<<<static_cast<unsigned>(tiles), kThreads, L.total, stream>>>(
      static_cast<const T*>(vals), indptr, offsets, table,
      static_cast<T*>(out), D, p.K, p.per, stage_bytes,
      static_cast<Acc>(ident));
  return cudaGetLastError();
}

template <typename T, typename Acc>
cudaError_t launch_typed(const void* vals, const int* indptr,
                         const int* offsets, void* out, int V, int64_t E,
                         int D, int op, double ident, int stage_bytes,
                         int* table, cudaStream_t stream) {
  switch (op) {
    case kSum:
      // offsets set the order of float sums only
      if constexpr (std::is_floating_point<Acc>::value) {
        if (offsets != nullptr) {
          return launch_op<T, Acc, kSum, true>(vals, indptr, offsets, out, V,
                                               E, D, ident, stage_bytes,
                                               table, stream);
        }
      }
      return launch_op<T, Acc, kSum, false>(vals, indptr, nullptr, out, V, E,
                                            D, ident, stage_bytes, table,
                                            stream);
    case kMin:
      return launch_op<T, Acc, kMin, false>(vals, indptr, nullptr, out, V, E,
                                            D, ident, stage_bytes, table,
                                            stream);
    case kMax:
      return launch_op<T, Acc, kMax, false>(vals, indptr, nullptr, out, V, E,
                                            D, ident, stage_bytes, table,
                                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface, bound with ctypes. Pointers and the stream are opaque;
// `offsets` is null for dense rows; `ident` is the identity as a double
// (exact for every int32 and for the float identities); `stage_bytes`
// sets the tile (K path items) and the heavy ring (see `plan`); `table`
// is 3 * (T + 1) ints of scratch for the T = ceil((V + E) / K) tiles'
// bounds. Returns the cudaError_t of the launches.
extern "C" int segment_combine(const void* vals, const int* indptr,
                               const int* offsets, void* out, int V,
                               int64_t E, int D, int dtype, int op,
                               double ident, int stage_bytes, int* table,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_typed<float, float>(vals, indptr, offsets, out, V, E, D,
                                        op, ident, stage_bytes, table, s);
    case kF16:
      return launch_typed<__half, float>(vals, indptr, offsets, out, V, E, D,
                                         op, ident, stage_bytes, table, s);
    case kBF16:
      return launch_typed<__nv_bfloat16, float>(vals, indptr, offsets, out, V,
                                                E, D, op, ident, stage_bytes,
                                                table, s);
    case kI8:
      return launch_typed<int8_t, int>(vals, indptr, offsets, out, V, E, D,
                                       op, ident, stage_bytes, table, s);
    case kI16:
      return launch_typed<int16_t, int>(vals, indptr, offsets, out, V, E, D,
                                        op, ident, stage_bytes, table, s);
    case kI32:
      return launch_typed<int32_t, int>(vals, indptr, offsets, out, V, E, D,
                                        op, ident, stage_bytes, table, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tile size (path items) `segment_combine` takes for these columns,
// value size and offsets within `stage_bytes`: the largest row a tile
// folds without its heavy ring. Lets the caller count heavy rows.
extern "C" int segment_tile_items(int D, int vsize, int offs,
                                  int stage_bytes) {
  return plan(D, vsize, offs != 0, stage_bytes).K;
}
