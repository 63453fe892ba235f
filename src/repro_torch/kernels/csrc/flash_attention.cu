// Causal GQA flash attention (online softmax), forward only.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention_kernel (`_kernel`, grid (B, Hq, nq, nk) with the online-
// softmax state carried across the sequential nk axis in VMEM). On Hopper
// the key axis is a loop inside one CTA instead of a grid axis, and the
// block skip becomes the loop's bounds.
//
// Layout: q [B, Hq, T, Dh], k/v [B, Hkv, S, Dh] with any batch/head/row
// strides (the last dim contiguous, every stride a multiple of 16 bytes);
// out [B, Hq, T, Dh] contiguous, in q's dtype. q head h reads kv head
// h / (Hq / Hkv) in place: no expansion.
//
// Semantics kept from the Pallas kernel (and its plain version
// flash_attention_plain):
//   * scores in f32, times sm_scale; masked scores take the sentinel -1e30;
//   * key kpos is live when kpos < S, kpos <= qpos when causal, and
//     kpos > qpos - window when a window is given; qpos is q_off + the
//     query row (q_off >= 0: a rank that holds queries q_off.. of a
//     sequence against all its keys; 0 counts from the first row even
//     when T != S), and the tile bounds below shift with it;
//   * while a row's running max is <= -5e29 its state stays at the
//     identity (no key seen yet); a row whose sum is 0 writes 0.
//
// Two variants; the wrapper picks one from the dtype and the head dim:
//
// 1. wgmma (bf16/fp16 at Dh 64, 128 and 256: every full-width config the
//    port builds), flash_fwd_wgmma_kernel. Persistent: one CTA per SM,
//    three warpgroups, walking the (b, q head, 128-row q tile) work items
//    round-robin in decode_tile's order (longest causal rows first, the q
//    heads of one kv group next to each other, as they read the same K/V
//    tiles from L2; at recurrentgemma-9b's MQA the 16 q heads of its one
//    kv head):
//    * a producer warpgroup (24 registers after setmaxnreg.dec) whose one
//      thread issues TMA loads: each item's Q (once both consumers are done
//      with the previous item's), then its K and V tiles of BK keys into a
//      ring of shared-memory stages with full/empty mbarriers (K and V
//      apart, so S = Q K^T starts before V lands; the ring runs on across
//      items). The tensor maps are 4-D (Dh, rows, heads, batch) over the
//      caller's strides, so the model's [B, T, H, Dh] projections are read
//      in place; rows past T or S arrive as zeros; tiles land as
//      128-byte-swizzled 64-column panels, the layout the wgmma
//      descriptors read (Q in 128-row boxes, K and V in BK-row boxes, one
//      box per panel: four each at Dh 256);
//    * two consumer warpgroups (240 registers after setmaxnreg.inc), each
//      owning 64 rows of the q tile: S = Q K^T with wgmma m64nBKk16 (Q and
//      K from shared memory, K-major), the online softmax in registers
//      (each thread holds rows gr and gr + 8 of its warp's 16, as with
//      mma.sync, so the mask and the quad shuffles carry over; the mask
//      runs only on tiles that cross the diagonal, the window or S), then
//      O += P V with wgmma m64nDHk16 (two m64n128k16 on O's halves at
//      Dh 256, the V descriptor moved two panels), P from registers (the
//      f32 S accumulator rounded in place, whose layout is the A
//      fragment's) and V from shared memory, MN-major (transposed); O is
//      written from registers, and those stores drain under the next
//      item's work;
//    * schedule: named barriers make the two consumers take turns issuing
//      their GEMMs (ping-pong), so one's softmax runs under the other's
//      products; and inside each, the next key tile's Q K^T is issued
//      before this tile's P V, so its own softmax runs under the tensor
//      cores too. At Dh 256 that keeps O (128 registers a thread), S (32)
//      and P (16) live at once; ptxas fits them in the 240 with no spill.
//    Shared memory: Q and as many K/V stages as fit, up to four; at Dh 256
//    (BK 64 only: Q 64 KiB, a K or V tile 32 KiB) two stages, 197,712
//    bytes. What bounds it: the tensor cores for the two products, and
//    beside them the softmax's instruction issue (an exp2, an FMA, a max,
//    an add per score, the O rescale), which the two warpgroups hide under
//    each other's GEMMs.
// 2. mma.sync (f32 at every head dim; bf16/fp16 at Dh 16 and 32):
//    * f32, flash_fwd_tf32_kernel: 3xTF32 on the tensor cores, eight warps
//      per 128-row q tile sharing each K/V tile (64 keys, two cp.async
//      stages; 32 keys, one stage at Dh 256). Each f32 operand is split in
//      registers as it is read, big = tf32(x) and small = tf32(x - big)
//      (cvt.rna's rounding, done on the bit pattern in two instructions
//      instead of its four), and each product is a_s b_b + a_b b_s + a_b
//      b_b with mma.sync m16n8k8, small terms first: each operand is then
//      carried to ~2^-22 of itself, where one-pass TF32 (2^-11) fails the
//      reference's 2e-5. The tensor cores truncate the sums they
//      accumulate, so S's products start from zero every 16 dims and are
//      added to S in f32 (round to nearest); O accumulates in the tensor
//      cores. Against a float64 oracle the kernel is then nearer the exact
//      answer than the plain f32 version (whose f32 sums round): with
//      inputs scaled by 8, 7-11 against 16-41 times the 2e-5 allowance.
//      Both products permute their k axis so no fragment is shuffled: Q and
//      K lanes read dims 4tg.. as one 16-byte load for two k steps; P's C
//      fragment (keys 2tg, 2tg + 1) is used in place as the A fragment of
//      logical keys tg and tg + 4, and V's B fragment reads the same keys
//      2tg, 2tg + 1 (no transpose, no staging); V's columns are permuted
//      across four 8-column blocks (two at Dh 256) so a lane reads them in
//      one load, and O is stored through the same permutation. Row strides
//      (Q, K: Dh + 16 floats; V: Dh + 4) keep every fragment load free of
//      bank conflicts. A warp whose 16 rows see no key of a tile skips it.
//      The accurate expf is kept for the softmax. What bounds it:
//      instruction issue and latency, not the tensor cores (three mma.sync
//      and the splits per product pair, two warps per scheduler). Next
//      step, not taken: wgmma with tf32 needs both operands K-major, so V
//      would need a transposed copy per tile (or a pre-pass).
//    * bf16/fp16 at Dh 16 and 32 (the smoke configs only; wgmma's k step is
//      16 and its smallest swizzled panel 32 bytes), flash_fwd_kernel: the
//      port's first design, not redesigned: four warps per 64-row q tile,
//      64-key K/V tiles double-buffered with cp.async, mma.sync m16n8k16,
//      the Q fragments read from the resident Q tile at every key tile.
//
// Bound on the H100 at the smoke's qwen3-14b prefill shape (B = 2, Hq = 40,
// Dh = 128, T = S = 4096, causal, bf16): operations. 4 * B * Hq * Dh *
// T(T+1)/2 = 343.7 GFLOP at 989 TFLOP/s dense bf16 is 0.347 ms; the bytes
// (q, k, v read once, out written once: ~0.2 GB) take 0.06 ms. At
// recurrentgemma-9b's local prefill (B = 2, Hq = 16, Hkv = 1, Dh = 256,
// T = S = 4096, window 2048, bf16): 6,292,480 live pairs a head, 206.2
// GFLOP, 0.208 ms; the bytes take 0.043 ms. f32 (3xTF32: three TF32
// products at 494.7 TFLOP/s) at the first shape cut to T = 1024: 21.50
// GFLOP, 0.130 ms (0.321 ms at the 67 TFLOP/s of f32 FMA).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_sm90.cuh"

namespace {

// ===========================================================================
// Variant 2: mma.sync (f32 by 3xTF32 at every head dim; bf16/fp16 at Dh 16
// and 32), and the helpers both variants share
// ===========================================================================

constexpr float kNegBig = -1e30f;
constexpr float kDeadMax = -5e29f;   // _NEG_INF * 0.5

enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [row0, row0 + ROWS) of a [rows, DH] slab with row stride `stride`
// (elements) into a smem tile of row stride STRIDE, by THREADS threads;
// rows >= nrows are zero-filled
template <typename T, int DH, int STRIDE, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t stride, int row0,
                                          int nrows) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int kChunks = DH / kVec;    // 16-byte chunks a row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool ok = row < nrows;
    const T* g = src + (ok ? (int64_t)row * stride : 0) + c * kVec;
    cp_async16(dst + r * STRIDE + c * kVec, g, ok);
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return expf(x);   // f32 inputs: the accurate exp, for parity at 2e-5
  } else {
    return __expf(x);
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Fragment layout of both mma.sync kernels (that of mma's C): lane =
// 4 * gr + tg; s[j][0..1] are row gr, keys k0 + 8j + 2tg + {0, 1};
// s[j][2..3] row gr + 8, the same keys. Scale every score by sm_scale,
// mask it on an `edge` tile, fold the tile into the running max and sum of
// the two rows, and turn it into probabilities; `alpha` gets the factor by
// which O's rows must be rescaled. qpos holds the rows' positions.
template <typename T, int NJ>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NJ][4], float (&m_run)[2], float (&l_part)[2],
    float (&alpha)[2], int k0, bool edge, const int (&qpos)[2], int tg,
    float sm_scale, int S_len, int causal, int has_window, int window) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * sm_scale;
      if (edge) {
        const int kpos = k0 + 8 * j + 2 * tg + (e & 1);
        const int qp = qpos[e >> 1];
        bool live = kpos < S_len;
        if (causal) live = live && kpos <= qp;
        if (has_window) live = live && kpos > qp - window;
        x = live ? x : kNegBig;
      }
      s[j][e] = x;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegBig;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run[r], mx);
    const bool dead = m_new <= kDeadMax;
    alpha[r] = dead ? 1.f : softmax_exp<T>(m_run[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = dead ? 0.f : softmax_exp<T>(s[j][2 * r + c] - m_new);
        s[j][2 * r + c] = p;
        sum += p;
      }
    }
    l_part[r] = l_part[r] * alpha[r] + sum;
    m_run[r] = m_new;
  }
}

// ---- bf16/fp16 at Dh 16 and 32: mma.sync m16n8k16 ------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <typename T, int DH>
struct Cfg {
  static constexpr int kVec = 16 / sizeof(T);       // elements per 16 bytes
  static constexpr int kStride = DH + kVec;         // smem row, padded
  static constexpr int kTile = kBlockQ * kStride;   // elements of one tile
  static constexpr size_t kSmem = 5 * kTile * sizeof(T);  // Q, 2 x (K, V)
};

// d += a (16x16, row) * b (16x8, col), f32 accumulation
template <typename T>
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two 8x8 b16 matrices, transposed: lanes 0-7 address the rows of the
// first, lanes 8-15 those of the second
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* row) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(s));
}

// acc[n][*] holds columns 8n + 2tg + {0, 1} of rows gr and gr + 8
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Hq,
                     int Hkv, int T_len, int S_len, int64_t qsb, int64_t qsh,
                     int64_t qst, int64_t ksb, int64_t ksh, int64_t kst,
                     int64_t vsb, int64_t vsh, int64_t vst, float sm_scale,
                     int causal, int has_window, int window,
                     int q_off) {
  using C = Cfg<T, DH>;
  constexpr int kN = DH / 8;  // 8-column fragments of the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + C::kTile;      // two stages
  T* sV = sK + 2 * C::kTile;  // two stages

  // grid: kv-group member fastest, then q tile (last first), kv head, batch
  const int G = Hq / Hkv;
  const int n_qt = (T_len + kBlockQ - 1) / kBlockQ;
  int bid = blockIdx.x;
  const int gm = bid % G;
  bid /= G;
  const int qt = n_qt - 1 - bid % n_qt;
  bid /= n_qt;
  const int hk = bid % Hkv;
  const int b = bid / Hkv;
  const int h = hk * G + gm;

  // rows are counted by position (q_off + row) from here on: the bounds,
  // masks, loads and stores read positions, over q and o moved back by
  // q_off rows (only rows from position q_off on are touched)
  const int T_end = q_off + T_len;  // one past the last row's position
  const int q_lo = q_off + qt * kBlockQ;
  const int q_hi = min(q_lo + kBlockQ, T_end) - 1;
  int k_end = S_len;  // exclusive
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q_lo - window + 1);
  const int t_begin = k_begin / kBlockK;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;

  const T* qb = q + b * qsb + h * qsh - (int64_t)q_off * qst;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tg = lane & 3;
  const int r0 = warp * 16 + gr;  // local rows r0 and r0 + 8
  const int qpos[2] = {q_lo + r0, q_lo + r0 + 8};

  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegBig, kNegBig};
  float l_part[2] = {0.f, 0.f};  // this thread's columns; quad-summed last

  auto load = [&](T* dst, const T* src, int64_t stride, int row0,
                  int nrows) {
    load_tile<T, DH, C::kStride, kBlockQ, kThreads>(dst, src, stride, row0,
                                                    nrows);
  };
  if (t_begin < t_end) {
    load(sQ, qb, qst, q_lo, T_end);
    load(sK, kb, kst, t_begin * kBlockK, S_len);
    load(sV, vb, vst, t_begin * kBlockK, S_len);
    cp_async_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load(sK + (stage ^ 1) * C::kTile, kb, kst, (t + 1) * kBlockK, S_len);
      load(sV + (stage ^ 1) * C::kTile, vb, vst, (t + 1) * kBlockK, S_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + stage * C::kTile;
    const T* cV = sV + stage * C::kTile;
    const int k0 = t * kBlockK;

    // ---- S = Q K^T: each 16-column Q fragment read from the resident
    // tile for all eight key fragments -------------------------------------
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      const T* p = sQ + r0 * C::kStride + kk * 16 + 2 * tg;
      a[0] = *reinterpret_cast<const uint32_t*>(p);
      a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * C::kStride);
      a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * C::kStride + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const T* pk = cK + (8 * j + gr) * C::kStride + kk * 16 + 2 * tg;
        mma16816<T>(s[j], a, *reinterpret_cast<const uint32_t*>(pk),
                    *reinterpret_cast<const uint32_t*>(pk + 8));
      }
    }

    // ---- scale, mask, online softmax (rows gr and gr + 8) ----------------
    const bool edge = k0 + kBlockK > S_len ||
                      (causal && k0 + kBlockK - 1 > q_lo) ||
                      (has_window && k0 <= q_hi - window);
    float alpha[2];
    softmax_tile<T, 8>(s, m_run, l_part, alpha, k0, edge, qpos, tg, sm_scale,
                       S_len, causal, has_window, window);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // ---- O += P V ---------------------------------------------------------
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const T* vrow = cV + (16 * kk + (lane & 15)) * C::kStride;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + 8 * n);
        mma16816<T>(acc[n], a, b0, b1);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // ---- epilogue: out = acc / l (0 for a row with no live key) ------------
  T* ob = o + ((int64_t)(b * Hq + h) * T_len - q_off) * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const int row = qpos[r];
    if (row < T_end) {
      T* orow = ob + (int64_t)row * DH + 2 * tg;
#pragma unroll
      for (int n = 0; n < kN; ++n)
        store2(orow + 8 * n, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

// ---- f32: 3xTF32 on mma.sync m16n8k8 -------------------------------------

template <int DH>
struct TfCfg {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBlockQ = 16 * kWarps;      // q rows, 16 a warp
  static constexpr int kBK = DH > 128 ? 32 : 64;   // keys a tile
  static constexpr int kStages = DH > 128 ? 1 : 2;
  static constexpr int kNJ = kBK / 8;              // 8-key blocks a tile
  // row strides (floats). Q and K: lanes (gr, tg) read 16 bytes at dim
  // 4tg of row gr, so a stride of 16 (mod 32) words spreads a quarter
  // warp over all 32 banks. V: lanes read keys 2tg and 2tg + 1 at column
  // kNG * gr, so 4 (mod 32) does.
  static constexpr int kQKStride = DH + (DH % 32 ? 32 : 16);
  static constexpr int kVStride = DH + 4;
  // 8-column V blocks a load: four (16 bytes), but two at Dh 256, where
  // ptxas spilled O's 128 registers a thread beside four
  static constexpr int kNG = DH > 128 ? 2 : DH / 8 < 4 ? DH / 8 : 4;
  static constexpr int kQTile = kBlockQ * kQKStride;
  static constexpr int kKTile = kBK * kQKStride;
  static constexpr int kVTile = kBK * kVStride;
  static constexpr size_t kSmem =
      (size_t)(kQTile + kStages * (kKTile + kVTile)) * sizeof(float);
  static_assert(kSmem <= 232448, "over the shared memory of a block");
};

// x rounded to tf32, to nearest with ties away from zero, on the bit
// pattern: what cvt.rna.tf32.f32 gives for every finite x (inf stays inf,
// NaN stays NaN), in two instructions where cvt.rna compiles to four
// (a guard for inf and NaN); the splits are most of the f32 kernel's
// instructions
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each rounded to tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col), tf32 inputs, f32 accumulation:
// a0 (row gr, k tg), a1 (gr + 8, tg), a2 (gr, tg + 4), a3 (gr + 8, tg + 4);
// b0 (k tg, column gr), b1 (k tg + 4, column gr). Not volatile: a pure
// function of its operands, so the compiler may interleave independent
// products
__device__ __forceinline__ void mma1688_tf32(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void load_vec(float (&y)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    y[0] = t.x, y[1] = t.y, y[2] = t.z, y[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    y[0] = t.x, y[1] = t.y;
  }
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&y)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(y[0], y[1]);
  }
}

// acc[n][*]: n-block n = kNG * m + i holds, through V's column
// permutation, dims 8 kNG m + kNG (2tg + {0, 1}) + i of rows gr, gr + 8
template <int DH>
__global__ void __launch_bounds__(TfCfg<DH>::kThreads, 1)
    flash_fwd_tf32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int Hq, int Hkv, int T_len, int S_len, int64_t qsb,
                          int64_t qsh, int64_t qst, int64_t ksb, int64_t ksh,
                          int64_t kst, int64_t vsb, int64_t vsh, int64_t vst,
                          float sm_scale, int causal, int has_window,
                          int window, int q_off) {
  using C = TfCfg<DH>;
  constexpr int BK = C::kBK, NJ = C::kNJ, ST = C::kStages, NG = C::kNG;
  constexpr int QKS = C::kQKStride, VS = C::kVStride, kN = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + C::kQTile;        // ST stages
  float* sV = sK + ST * C::kKTile;   // ST stages

  // grid: kv-group member fastest, then q tile (last first), kv head, batch
  const int G = Hq / Hkv;
  const int n_qt = (T_len + C::kBlockQ - 1) / C::kBlockQ;
  int bid = blockIdx.x;
  const int gm = bid % G;
  bid /= G;
  const int qt = n_qt - 1 - bid % n_qt;
  bid /= n_qt;
  const int hk = bid % Hkv;
  const int b = bid / Hkv;
  const int h = hk * G + gm;

  // rows are counted by position (q_off + row) from here on, over q and o
  // moved back by q_off rows, as in flash_fwd_kernel (bounds written
  // otherwise cost ptxas registers it has not got at Dh 256)
  const int T_end = q_off + T_len;  // one past the last row's position
  const int q_lo = q_off + qt * C::kBlockQ;
  const int q_hi = min(q_lo + C::kBlockQ, T_end) - 1;
  int k_end = S_len;  // exclusive
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q_lo - window + 1);
  const int t_begin = k_begin / BK;
  const int t_end = (k_end + BK - 1) / BK;

  const float* qb = q + b * qsb + h * qsh - (int64_t)q_off * qst;
  const float* kb = k + b * ksb + hk * ksh;
  const float* vb = v + b * vsb + hk * vsh;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tg = lane & 3;
  const int r0 = warp * 16 + gr;  // local rows r0 and r0 + 8
  const int w_lo = q_lo + 16 * warp, w_hi = w_lo + 15;  // this warp's rows
  // the thread's rows w_lo + gr and w_lo + gr + 8, with gr read from
  // threadIdx again where they are used: kept out of the loop's registers,
  // which ptxas otherwise spilled at Dh 256
  auto rows = [&](int (&qpos)[2]) {
    qpos[0] = w_lo + (int)(threadIdx.x % 32) / 4;
    qpos[1] = qpos[0] + 8;
  };

  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {kNegBig, kNegBig};
  float l_part[2] = {0.f, 0.f};  // this thread's columns; quad-summed last

  auto load_k = [&](int t, int st) {
    load_tile<float, DH, QKS, BK, C::kThreads>(sK + st * C::kKTile, kb, kst,
                                               t * BK, S_len);
  };
  auto load_v = [&](int t, int st) {
    load_tile<float, DH, VS, BK, C::kThreads>(sV + st * C::kVTile, vb, vst,
                                              t * BK, S_len);
  };
  // K and V of a tile are committed as two groups, K first, and one K
  // group and one V group (empty past the last tile) are committed per
  // tile, so wait_group's counts below are fixed
  if (t_begin < t_end) {
    load_tile<float, DH, QKS, C::kBlockQ, C::kThreads>(sQ, qb, qst, q_lo,
                                                      T_end);
#pragma unroll
    for (int i = 0; i < ST; ++i) {
      if (t_begin + i < t_end) load_k(t_begin + i, i);
      cp_async_commit();
      if (t_begin + i < t_end) load_v(t_begin + i, i);
      cp_async_commit();
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int st = (t - t_begin) % ST;
    const float* cK = sK + st * C::kKTile;
    const float* cV = sV + st * C::kVTile;
    const int k0 = t * BK;
    // this warp's rows see a key of the tile (a warp-uniform skip: a tile
    // no row sees leaves m, l and O as they are)
    const bool live = w_lo < T_end && !(causal && k0 > w_hi) &&
                      !(has_window && k0 + BK - 1 <= w_lo - window);
    cp_async_wait<2 * ST - 1>();  // K(t) (and Q) in
    __syncthreads();

    float s[NJ][4];
    if (live) {
      // ---- S = Q K^T in 3xTF32: per 16 dims, one 16-byte read of Q's two
      // rows and of each key row serves two k steps (logical k tg <- dim
      // 4tg + 2h, tg + 4 <- 4tg + 2h + 1 at step h). The tensor cores
      // truncate the sums they accumulate, so each 16 dims' products start
      // from zero and are added to S in f32 (round to nearest): S is then
      // nearer the exact scores than an f32 FMA chain's ---------------------
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const float* qa = sQ + r0 * QKS + 4 * tg;
      const float* kr = cK + gr * QKS + 4 * tg;
#pragma unroll 1
      for (int d = 0; d < DH; d += 16) {
        const float4 x0 = *reinterpret_cast<const float4*>(qa + d);
        const float4 x1 = *reinterpret_cast<const float4*>(qa + 8 * QKS + d);
        uint32_t ab[2][4], as[2][4];
        split_tf32(x0.x, ab[0][0], as[0][0]);
        split_tf32(x1.x, ab[0][1], as[0][1]);
        split_tf32(x0.y, ab[0][2], as[0][2]);
        split_tf32(x1.y, ab[0][3], as[0][3]);
        split_tf32(x0.z, ab[1][0], as[1][0]);
        split_tf32(x1.z, ab[1][1], as[1][1]);
        split_tf32(x0.w, ab[1][2], as[1][2]);
        split_tf32(x1.w, ab[1][3], as[1][3]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 y =
              *reinterpret_cast<const float4*>(kr + 8 * j * QKS + d);
          uint32_t bb[4], bs[4];
          split_tf32(y.x, bb[0], bs[0]);
          split_tf32(y.y, bb[1], bs[1]);
          split_tf32(y.z, bb[2], bs[2]);
          split_tf32(y.w, bb[3], bs[3]);
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int hs = 0; hs < 2; ++hs) {  // small terms first
            mma1688_tf32(part, as[hs], bb[2 * hs], bb[2 * hs + 1]);
            mma1688_tf32(part, ab[hs], bs[2 * hs], bs[2 * hs + 1]);
            mma1688_tf32(part, ab[hs], bb[2 * hs], bb[2 * hs + 1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += part[e];
        }
      }

      // ---- scale, mask, online softmax (rows gr and gr + 8) --------------
      const bool edge = k0 + BK > S_len || (causal && k0 + BK - 1 > w_lo) ||
                        (has_window && k0 <= w_hi - window);
      float alpha[2];
      int qpos[2];
      rows(qpos);
      softmax_tile<float, NJ>(s, m_run, l_part, alpha, k0, edge, qpos, tg,
                              sm_scale, S_len, causal, has_window, window);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
    }

    cp_async_wait<2 * ST - 2>();  // V(t) in
    __syncthreads();              // and every warp is done with K(t)
    if (t + ST < t_end) load_k(t + ST, st);
    cp_async_commit();

    if (live) {
      // ---- O += P V in 3xTF32: P's C fragment is the A fragment of
      // logical keys tg <- 2tg and tg + 4 <- 2tg + 1; V's B fragment reads
      // those keys, columns permuted so kNG blocks come in one load --------
      const float* vr = cV + 2 * tg * VS + NG * gr;
#pragma unroll
      for (int kk = 0; kk < NJ; ++kk) {
        uint32_t pb[4], ps[4];
        split_tf32(s[kk][0], pb[0], ps[0]);
        split_tf32(s[kk][2], pb[1], ps[1]);
        split_tf32(s[kk][1], pb[2], ps[2]);
        split_tf32(s[kk][3], pb[3], ps[3]);
        const float* v0 = vr + 8 * kk * VS;
#pragma unroll
        for (int m = 0; m < DH / (8 * NG); ++m) {
          float y0[NG], y1[NG];
          load_vec<NG>(y0, v0 + 8 * NG * m);
          load_vec<NG>(y1, v0 + VS + 8 * NG * m);
#pragma unroll
          for (int i = 0; i < NG; ++i) {  // small terms first
            uint32_t b0b, b0s, b1b, b1s;
            split_tf32(y0[i], b0b, b0s);
            split_tf32(y1[i], b1b, b1s);
            mma1688_tf32(acc[NG * m + i], ps, b0b, b1b);
            mma1688_tf32(acc[NG * m + i], pb, b0s, b1s);
            mma1688_tf32(acc[NG * m + i], pb, b0b, b1b);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with V(t)
    if (t + ST < t_end) load_v(t + ST, st);
    cp_async_commit();
  }

  // ---- epilogue: out = acc / l (0 for a row with no live key), each
  // kNG-float run of a row in one store -------------------------------------
  float* ob = o + ((int64_t)(b * Hq + h) * T_len - q_off) * DH;
  int qpos[2];
  rows(qpos);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    const int row = qpos[r];
    if (row < T_end) {
      float* orow = ob + (int64_t)row * DH;
#pragma unroll
      for (int m = 0; m < DH / (8 * NG); ++m) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float y[NG];
#pragma unroll
          for (int i = 0; i < NG; ++i) y[i] = acc[NG * m + i][2 * r + c] * inv;
          store_vec<NG>(orow + 8 * NG * m + NG * (2 * tg + c), y);
        }
      }
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int T_len, int S_len, const int64_t* st,
           float sm_scale, int causal, int has_window, int window, int q_off,
           cudaStream_t stream) {
  constexpr bool kF = std::is_same<T, float>::value;
  int block_q, threads;
  size_t smem;
  void (*kern)(const T*, const T*, const T*, T*, int, int, int, int, int64_t,
               int64_t, int64_t, int64_t, int64_t, int64_t, int64_t, int64_t,
               int64_t, float, int, int, int, int);
  if constexpr (kF) {
    using C = TfCfg<DH>;
    kern = flash_fwd_tf32_kernel<DH>;
    block_q = C::kBlockQ, threads = C::kThreads, smem = C::kSmem;
  } else {
    using C = Cfg<T, DH>;
    kern = flash_fwd_kernel<T, DH>;
    block_q = kBlockQ, threads = kThreads, smem = C::kSmem;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)B * Hq * ((T_len + block_q - 1) / block_q);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, T_len, S_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      sm_scale, causal, has_window, window, q_off);
  return cudaGetLastError();
}

// f32 at every head dim; bf16/fp16 at Dh 16 and 32 (64, 128 and 256 are
// the wgmma variant's)
template <typename T>
int launch_dh(int Dh, const void* q, const void* k, const void* v, void* o,
              int B, int Hq, int Hkv, int T_len, int S_len,
              const int64_t* st, float sm_scale, int causal, int has_window,
              int window, int q_off, cudaStream_t s) {
  constexpr bool kF = std::is_same<T, float>::value;
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, T_len, S_len, st,
                           sm_scale, causal, has_window, window, q_off, s);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, T_len, S_len, st,
                           sm_scale, causal, has_window, window, q_off, s);
    case 64:
      if constexpr (kF)
        return launch<T, 64>(q, k, v, o, B, Hq, Hkv, T_len, S_len, st,
                             sm_scale, causal, has_window, window, q_off, s);
      break;
    case 128:
      if constexpr (kF)
        return launch<T, 128>(q, k, v, o, B, Hq, Hkv, T_len, S_len, st,
                              sm_scale, causal, has_window, window, q_off, s);
      break;
    case 256:
      if constexpr (kF)
        return launch<T, 256>(q, k, v, o, B, Hq, Hkv, T_len, S_len, st,
                              sm_scale, causal, has_window, window, q_off, s);
      break;
    default:
      break;
  }
  return cudaErrorInvalidValue;
}

// ===========================================================================
// Variant 1: wgmma + TMA, warp-specialised (bf16/fp16, Dh 64, 128, 256)
// ===========================================================================

constexpr int kWgBlockQ = 128;    // two consumer warpgroups x 64 rows
constexpr int kWgThreads = 384;   // producer warpgroup + two consumers
constexpr int kPanelBytes = 128;  // one swizzled row of a 64-column panel
constexpr float kLog2e = 1.4426950408889634f;

template <int DH, int BK>
struct WgCfg {
  static constexpr int kPanels = DH / 64;
  static constexpr int kQPanel = kWgBlockQ * kPanelBytes;  // bytes
  static constexpr int kKVPanel = BK * kPanelBytes;
  static constexpr int kQBytes = kQPanel * kPanels;
  static constexpr int kKVBytes = kKVPanel * kPanels;  // one K or V tile
  // as many K/V stages as shared memory holds, up to four (three at
  // Dh 128, BK 128: 224 KB; two at Dh 256, BK 64: 193 KB)
  static constexpr int kFit = (232448 - 2048 - kQBytes) / (2 * kKVBytes);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "a K/V ring needs two stages");
  // byte offsets from the 1024-aligned base of dynamic shared memory
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;
  // barriers: full_q, empty_q, full_k[S], full_v[S], empty_k[S], empty_v[S]
  static constexpr int kBars = 2 + 4 * kStages;
  static constexpr int kSmem = kOffBar + 8 * kBars + 1024;  // + alignment
  static_assert(kSmem <= 232448, "over the SM's shared memory");
};

// one TMA box of 64 columns of a 4-D map whose dims 1..3 hold (row, head,
// batch) in the order `order` says: bits [0,2) the row's dim, [2,4) the
// head's, [4,6) the batch's
__device__ __forceinline__ void load_panel(void* dst, const CUtensorMap* tm,
                                           uint64_t* bar, int col, int row,
                                           int head, int batch, int order) {
  const int pr = order & 3, ph = (order >> 2) & 3;
  sm90::tma_load_4d(dst, tm, bar, col, pr == 1 ? row : ph == 1 ? head : batch,
                    pr == 2 ? row : ph == 2 ? head : batch,
                    pr == 3 ? row : ph == 3 ? head : batch);
}

// S (64 x BK, this warpgroup's rows) = Q K^T over the head dim
template <typename T, int DH, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint64_t dq,
                                         uint64_t dk) {
  using C = WgCfg<DH, BK>;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    // 16-deep k step: 32 bytes along a row, a new panel every four
    const uint64_t oq = ((kk / 4) * C::kQPanel + (kk % 4) * 32) >> 4;
    const uint64_t ok = ((kk / 4) * C::kKVPanel + (kk % 4) * 32) >> 4;
    if constexpr (BK == 64) {
      sm90::wgmma_ss_n64<T>(s, dq + oq, dk + ok, kk > 0);
    } else {
      sm90::wgmma_ss_n128<T>(s, dq + oq, dk + ok, kk > 0);
    }
  }
}

// O (64 x DH) += P V over the tile's keys; P as A fragments. At Dh 256,
// two m64n128k16 products on O's halves (the accumulator's first 64
// registers are columns 0-127), the second reading V's panels 2 and 3.
template <typename T, int DH, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t ov = (kk * 16 * kPanelBytes) >> 4;  // 16 key rows
    if constexpr (DH == 64) {
      sm90::wgmma_rs_n64<T>(o, p[kk], dv + ov);
    } else if constexpr (DH == 128) {
      sm90::wgmma_rs_n128<T>(o, p[kk], dv + ov);
    } else {
      static_assert(DH == 256, "wgmma head dims: 64, 128, 256");
      constexpr uint64_t kHalf = (2 * BK * kPanelBytes) >> 4;  // 2 panels
      sm90::wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(&o[0]), p[kk],
                             dv + ov);
      sm90::wgmma_rs_n128<T>(*reinterpret_cast<float(*)[64]>(&o[64]), p[kk],
                             dv + ov + kHalf);
    }
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scale and mask one tile of scores in place, fold it into the running
// max and sum of rows gr and gr + 8, and turn it into probabilities.
// Returns through `alpha` the factor by which O must be rescaled.
// Element 4j + e of s is row gr + 8 (e >> 1), key k0 + 8j + 2tg + (e & 1).
// `edge` tiles (those that cross a mask's edge, and every tile when
// sm_scale <= 0) are scaled and masked element by element; the others keep
// raw scores, take the max on them and fold sm_scale into the exponent's
// one FMA (max(s) * sm_scale is the max of the scaled scores).
template <int BK>
__device__ __forceinline__ void online_softmax(
    float (&s)[BK / 2], float (&m_run)[2], float (&l_part)[2],
    float (&alpha)[2], int k0, bool edge, const int (&qpos)[2], int tg,
    float sm_scale, int S_len, int causal, int has_window, int window,
    int q_off) {
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kpos = k0 + 8 * (i / 4) + 2 * tg + (i & 1);
      const int qp = qpos[(i >> 1) & 1] + q_off;
      bool live = kpos < S_len;
      if (causal) live = live && kpos <= qp;
      if (has_window) live = live && kpos > qp - window;
      s[i] = live ? s[i] * sm_scale : kNegBig;
    }
  }
  const float scale = edge ? 1.f : sm_scale;  // still to apply to s
  const float scale_l2 = scale * kLog2e;
  // the two rows' max and sum in four independent chains each: two warps
  // share a scheduler, so a chain of BK / 4 dependent ops would stall
  constexpr int kA = 4;
  float mx[2][kA], sum[2][kA], m_l2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int a = 0; a < kA; ++a) mx[r][a] = kNegBig, sum[r][a] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1, a = ((i >> 2) * 2 + (i & 1)) % kA;
    mx[r][a] = fmaxf(mx[r][a], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = mx[r][0];
#pragma unroll
    for (int a = 1; a < kA; ++a) m = fmaxf(m, mx[r][a]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_run[r], m * scale);
    const bool dead = m_new <= kDeadMax;
    // a dead row subtracts +inf: every p is exp2(-inf) = 0, no select
    m_l2[r] = dead ? __int_as_float(0x7f800000) : m_new * kLog2e;
    alpha[r] = dead ? 1.f : fast_exp2(fmaf(m_run[r], kLog2e, -m_l2[r]));
    m_run[r] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1, a = ((i >> 2) * 2 + (i & 1)) % kA;
    s[i] = fast_exp2(fmaf(s[i], scale_l2, -m_l2[r]));
    sum[r][a] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float t = sum[r][0];
#pragma unroll
    for (int a = 1; a < kA; ++a) t += sum[r][a];
    l_part[r] = l_part[r] * alpha[r] + t;
  }
}

template <int DH>
__device__ __forceinline__ void rescale(float (&o)[DH / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// probabilities (f32 accumulator layout) -> A fragments of P V, rounded to
// the input type: keys 16kk + 2tg (+8) of rows gr and gr + 8
template <typename T, int BK>
__device__ __forceinline__ void to_fragments(const float (&s)[BK / 2],
                                             uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = pack2<T>(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The q tiles in the order the persistent CTAs take them, round-robin:
// longest first across all heads (causal rows grow with the q tile), and
// within one q tile the q heads of a kv group next to each other (they
// read the same K/V tiles from L2).
struct Tile {
  int qt, b, hk, h;
};
__device__ __forceinline__ Tile decode_tile(int idx, int n_qt, int B,
                                            int Hkv, int G) {
  const int gm = idx % G;
  idx /= G;
  const int hk = idx % Hkv;
  idx /= Hkv;
  const int b = idx % B;
  return {n_qt - 1 - idx / B, b, hk, hk * G + gm};
}

template <typename T, int DH, int BK>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o, int B,
    int Hq, int Hkv, int T_len, int S_len, float sm_scale, int causal,
    int has_window, int window, int q_off, int q_order, int k_order,
    int v_order) {
  using C = WgCfg<DH, BK>;
  constexpr int ST = C::kStages;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = sm90::smem_u32(wg_smem);
  unsigned char* base = wg_smem + (((raw + 1023) & ~1023u) - raw);
  unsigned char* sQ = base;
  unsigned char* sK = base + C::kOffK;
  unsigned char* sV = base + C::kOffV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + C::kOffBar);
  uint64_t* full_q = bars;
  uint64_t* empty_q = bars + 1;
  uint64_t* full_k = bars + 2;
  uint64_t* full_v = bars + 2 + ST;
  uint64_t* empty_k = bars + 2 + 2 * ST;
  uint64_t* empty_v = bars + 2 + 3 * ST;

  const int G = Hq / Hkv;
  const int n_qt = (T_len + kWgBlockQ - 1) / kWgBlockQ;
  const int n_total = B * Hkv * G * n_qt;
  // the key tiles [t_begin, t_begin + n) that q tile qt needs
  auto key_tiles = [&](int qt, int& t_begin) {
    const int q_lo = qt * kWgBlockQ;
    const int q_hi = min(q_lo + kWgBlockQ, T_len) - 1;
    int k_end = S_len;  // exclusive
    if (causal) k_end = min(k_end, q_off + q_hi + 1);
    int k_begin = 0;
    if (has_window) k_begin = max(0, q_off + q_lo - window + 1);
    t_begin = k_begin / BK;
    return max((k_end + BK - 1) / BK - t_begin, 0);
  };

  if (threadIdx.x == 0) {
    sm90::mbar_init(full_q, 1);
    sm90::mbar_init(empty_q, 8);  // lane 0 of each consumer warp
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(full_k + s, 1);
      sm90::mbar_init(full_v + s, 1);
      sm90::mbar_init(empty_k + s, 8);
      sm90::mbar_init(empty_v + s, 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // warpgroup index read from lane 0, so the compiler sees it is
  // warp-uniform and keeps the descriptor arithmetic in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight, across the
    // CTA's q tiles (the K/V ring runs on; Q waits for the consumers'
    // last Q K^T of the previous tile) ------------------------------------
    sm90::regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int kv_it = 0, q_it = 0;
      for (int idx = blockIdx.x; idx < n_total; idx += gridDim.x) {
        const Tile tl = decode_tile(idx, n_qt, B, Hkv, G);
        int t_begin;
        const int n = key_tiles(tl.qt, t_begin);
        if (n == 0) continue;
        sm90::mbar_wait(empty_q, (q_it++ & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full_q, C::kQBytes);
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p)
          load_panel(sQ + p * C::kQPanel, &tm_q, full_q, 64 * p,
                     tl.qt * kWgBlockQ, tl.h, tl.b, q_order);
        for (int i = 0; i < n; ++i, ++kv_it) {
          const int s = kv_it % ST;
          const uint32_t parity = ((kv_it / ST) & 1) ^ 1;
          const int row = (t_begin + i) * BK;
          sm90::mbar_wait(empty_k + s, parity);
          sm90::mbar_arrive_expect_tx(full_k + s, C::kKVBytes);
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p)
            load_panel(sK + s * C::kKVBytes + p * C::kKVPanel, &tm_k,
                       full_k + s, 64 * p, row, tl.hk, tl.b, k_order);
          sm90::mbar_wait(empty_v + s, parity);
          sm90::mbar_arrive_expect_tx(full_v + s, C::kKVBytes);
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p)
            load_panel(sV + s * C::kKVBytes + p * C::kKVPanel, &tm_v,
                       full_v + s, 64 * p, row, tl.hk, tl.b, v_order);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c owns rows 64c .. 64c + 63 of each q tile ---
  sm90::regs_alloc<240>();
  const int c = wg - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tg = lane & 3;
  // descriptors of this warpgroup's 64 Q rows and of stage 0's K and V
  const uint64_t dq =
      sm90::make_desc(sm90::smem_u32(sQ + 64 * c * kPanelBytes), 16, 1024);
  const uint64_t dk0 = sm90::make_desc(sm90::smem_u32(sK), 16, 1024);
  const uint64_t dv0 = sm90::make_desc(sm90::smem_u32(sV), C::kKVPanel, 1024);
  auto dk = [&](int st) { return dk0 + ((st * C::kKVBytes) >> 4); };
  auto dv = [&](int st) { return dv0 + ((st * C::kKVBytes) >> 4); };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(bar);
  };
  // ping-pong: warpgroup c issues its GEMMs between a sync on barrier 1 + c
  // and an arrival at the other's; consumer 1 lets 0 go first, and 0
  // absorbs 1's last arrival at the end, so no phase is left open
  const int bar_mine = 1 + c, bar_other = 2 - c;
  if (c == 1) sm90::named_arrive(1, 256);

  int kv_it = 0, q_it = 0;
  for (int idx = blockIdx.x; idx < n_total; idx += gridDim.x) {
    const Tile tl = decode_tile(idx, n_qt, B, Hkv, G);
    int t_begin;
    const int n = key_tiles(tl.qt, t_begin);
    const int q_lo_c = tl.qt * kWgBlockQ + 64 * c;
    const int qpos[2] = {q_lo_c + 16 * warp + gr,
                         q_lo_c + 16 * warp + gr + 8};
    const int p_lo_c = q_off + q_lo_c;  // the position of its first row
    auto is_edge = [&](int k0) {
      return k0 + BK > S_len || (causal && k0 + BK - 1 > p_lo_c) ||
             (has_window && k0 <= p_lo_c + 63 - window) ||
             !(sm_scale > 0.f);
    };

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {kNegBig, kNegBig};
    float l_part[2] = {0.f, 0.f};  // this thread's columns; quad-summed

    if (n > 0) {
      float s[BK / 2];
      uint32_t p[BK / 16][4];
      float alpha[2];
      sm90::mbar_wait(full_q, q_it++ & 1);
      // key tile 0: S only; P V of tile i - 1 is issued after S of i
      {
        const int st = kv_it % ST;
        sm90::mbar_wait(full_k + st, (kv_it / ST) & 1);
        sm90::named_sync(bar_mine, 256);
        sm90::wgmma_fence();
        issue_qk<T, DH, BK>(s, dq, dk(st));
        sm90::wgmma_commit();
        sm90::named_arrive(bar_other, 256);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        release(empty_k + st);
        if (n == 1) release(empty_q);
        const int k0 = t_begin * BK;
        online_softmax<BK>(s, m_run, l_part, alpha, k0, is_edge(k0), qpos,
                           tg, sm_scale, S_len, causal, has_window, window,
                           q_off);
        to_fragments<T, BK>(s, p);
      }
      for (int i = 1; i < n; ++i) {
        const int it = kv_it + i;
        const int st = it % ST, sp = (it - 1) % ST;
        sm90::mbar_wait(full_k + st, (it / ST) & 1);
        sm90::mbar_wait(full_v + sp, ((it - 1) / ST) & 1);
        sm90::fence_regs(acc);
        sm90::fence_regs(p);
        sm90::named_sync(bar_mine, 256);
        sm90::wgmma_fence();
        issue_qk<T, DH, BK>(s, dq, dk(st));
        sm90::wgmma_commit();
        // O takes the previous tile's max under this tile's Q K^T
        rescale<DH>(acc, alpha);
        sm90::wgmma_fence();
        issue_pv<T, DH, BK>(acc, p, dv(sp));
        sm90::wgmma_commit();
        sm90::named_arrive(bar_other, 256);
        sm90::wgmma_wait<1>();  // S of tile i is in; P V still running
        sm90::fence_regs(s);
        release(empty_k + st);
        if (i == n - 1) release(empty_q);
        const int k0 = (t_begin + i) * BK;
        online_softmax<BK>(s, m_run, l_part, alpha, k0, is_edge(k0), qpos,
                           tg, sm_scale, S_len, causal, has_window, window,
                           q_off);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        release(empty_v + sp);
        to_fragments<T, BK>(s, p);
      }
      const int it = kv_it + n - 1, sl = it % ST;
      sm90::mbar_wait(full_v + sl, (it / ST) & 1);
      rescale<DH>(acc, alpha);
      sm90::fence_regs(acc);
      sm90::fence_regs(p);
      sm90::wgmma_fence();
      issue_pv<T, DH, BK>(acc, p, dv(sl));
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      release(empty_v + sl);
      kv_it += n;
    }

    // ---- epilogue: out = acc / l (0 for a row with no live key), straight
    // from registers; the stores drain under the next tile's work
    T* ob = o + ((int64_t)(tl.b * Hq + tl.h) * T_len) * DH;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_part[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      const int row = qpos[r];
      if (row < T_len) {
        T* orow = ob + (int64_t)row * DH + 2 * tg;
#pragma unroll
        for (int nn = 0; nn < DH / 8; ++nn)
          store2(orow + 8 * nn, acc[4 * nn + 2 * r] * inv,
                 acc[4 * nn + 2 * r + 1] * inv);
      }
    }
  }
  if (c == 0) sm90::named_sync(1, 256);
}

// ---- host: tensor maps and launch of the wgmma variant ---------------------

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so the library links nothing but the runtime
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map (Dh, rows, heads, batch) over [batch, heads, rows, Dh] at the
// given element strides, boxes of 64 columns x box_rows rows, 128-byte
// swizzle, zeros outside. Dims 1..3 are ordered by ascending stride (a
// size-1 dim last), so the [B, T, H, Dh] views the model passes map as
// well as contiguous tensors; *order says where each one went (see
// load_panel). Returns 0 or a CUDA error.
int make_map(CUtensorMap* map, int dtype, const void* ptr, int Dh, int rows,
             int heads, int batch, int64_t st_batch, int64_t st_head,
             int64_t st_row, int box_rows, int* order) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  struct Dim {
    uint64_t size, stride;
    int which;  // 0 row, 1 head, 2 batch
  } d[3] = {{(uint64_t)rows, (uint64_t)st_row, 0},
            {(uint64_t)heads, (uint64_t)st_head, 1},
            {(uint64_t)batch, (uint64_t)st_batch, 2}};
  auto key = [](const Dim& x) {
    return x.size == 1 ? ~0ull : x.stride;
  };
  for (int i = 0; i < 3; ++i)  // three elements: insertion sort
    for (int j = i; j > 0 && key(d[j]) < key(d[j - 1]); --j) {
      Dim t = d[j];
      d[j] = d[j - 1];
      d[j - 1] = t;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)Dh, d[0].size, d[1].size, d[2].size};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  *order = 0;
  uint64_t extent = (uint64_t)Dh * 2;
  for (int i = 0; i < 3; ++i) {
    // a size-1 dim's stride is never stepped: give it a legal one
    gstride[i] = d[i].size == 1 ? extent : d[i].stride * 2;
    extent = gstride[i] * d[i].size;
    if (d[i].which == 0) box[1 + i] = box_rows;
    *order |= (1 + i) << (2 * d[i].which);
  }
  CUresult r = encode(
      map,
      dtype == kBF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
      4, const_cast<void*>(ptr), gdim, gstride, box, estride,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

template <typename T, int DH, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int T_len, int S_len, int dtype,
                 const int64_t* st, float sm_scale, int causal,
                 int has_window, int window, int q_off, cudaStream_t stream) {
  using C = WgCfg<DH, BK>;
  const int64_t tiles =
      (int64_t)B * Hq * ((T_len + kWgBlockQ - 1) / kWgBlockQ);
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (S_len == 0)  // no key at all: every row writes 0
    return cudaMemsetAsync(o, 0, (size_t)B * Hq * T_len * DH * sizeof(T),
                           stream);
  CUtensorMap tq, tk, tv;
  int oq, ok, ov, err;
  if ((err = make_map(&tq, dtype, q, DH, T_len, Hq, B, st[0], st[1], st[2],
                      kWgBlockQ, &oq)) ||
      (err = make_map(&tk, dtype, k, DH, S_len, Hkv, B, st[3], st[4], st[5],
                      BK, &ok)) ||
      (err = make_map(&tv, dtype, v, DH, S_len, Hkv, B, st[6], st[7], st[8],
                      BK, &ov)))
    return err;
  // persistent: one CTA per SM (the shared memory allows one), each walking
  // the q tiles round-robin
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  auto kern = flash_fwd_wgmma_kernel<T, DH, BK>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::kSmem);
  if (e != cudaSuccess) return e;
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  kern<<<grid, kWgThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<T*>(o), B, Hq, Hkv, T_len, S_len, sm_scale,
      causal, has_window, window, q_off, oq, ok, ov);
  return cudaGetLastError();
}

template <typename T>
int launch_wgmma_dh(int Dh, int block_k, const void* q, const void* k,
                    const void* v, void* o, int B, int Hq, int Hkv, int T_len,
                    int S_len, int dtype, const int64_t* st, float sm_scale,
                    int causal, int has_window, int window, int q_off,
                    cudaStream_t s) {
#define FLASH_WG_CASE(DH_, BK_)                                              \
  if (Dh == DH_ && block_k == BK_)                                           \
    return launch_wgmma<T, DH_, BK_>(q, k, v, o, B, Hq, Hkv, T_len, S_len,   \
                                     dtype, st, sm_scale, causal, has_window, \
                                     window, q_off, s);
  FLASH_WG_CASE(64, 64)
  FLASH_WG_CASE(64, 128)
  FLASH_WG_CASE(128, 64)
  FLASH_WG_CASE(128, 128)
  FLASH_WG_CASE(256, 64)  // a 128-key tile leaves room for one K/V stage
#undef FLASH_WG_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: q (batch, head, row), k (batch, head, row), v (batch, head, row),
// in elements; q_off: the position of q's first row (>= 0). Returns the
// CUDA error of the launch (0 on success).
// The mma.sync variant: f32 at Dh 16..256 (3xTF32), bf16/fp16 at Dh 16
// and 32.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int T_len, int S_len, int Dh,
                                   int dtype, const int64_t* strides,
                                   float sm_scale, int causal, int has_window,
                                   int window, int q_off, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_dh<float>(Dh, q, k, v, o, B, Hq, Hkv, T_len, S_len,
                              strides, sm_scale, causal, has_window, window,
                              q_off, s);
    case kF16:
      return launch_dh<__half>(Dh, q, k, v, o, B, Hq, Hkv, T_len, S_len,
                               strides, sm_scale, causal, has_window, window,
                               q_off, s);
    case kBF16:
      return launch_dh<__nv_bfloat16>(Dh, q, k, v, o, B, Hq, Hkv, T_len,
                                      S_len, strides, sm_scale, causal,
                                      has_window, window, q_off, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The wgmma variant: bf16/fp16 at Dh 64 and 128 with key tiles of block_k
// 64 or 128, and at Dh 256 with 64. Same strides and return as
// flash_attention_fwd.
extern "C" int flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int T_len, int S_len, int Dh, int dtype, const int64_t* strides,
    float sm_scale, int causal, int has_window, int window, int q_off,
    int block_k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF16:
      return launch_wgmma_dh<__half>(Dh, block_k, q, k, v, o, B, Hq, Hkv,
                                     T_len, S_len, dtype, strides, sm_scale,
                                     causal, has_window, window, q_off, s);
    case kBF16:
      return launch_wgmma_dh<__nv_bfloat16>(Dh, block_k, q, k, v, o, B, Hq,
                                            Hkv, T_len, S_len, dtype, strides,
                                            sm_scale, causal, has_window,
                                            window, q_off, s);
    default:
      return cudaErrorInvalidValue;
  }
}
