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
//     kpos > qpos - window when a window is given; qpos counts from 0 for
//     the first query row even when T != S;
//   * while a row's running max is <= -5e29 its state stays at the
//     identity (no key seen yet); a row whose sum is 0 writes 0.
//
// Design (a first one that is right and simple; wgmma, TMA and warp
// specialisation are for later):
//   * one CTA of four warps per (b, q head, 64-row q tile); each warp owns
//     16 rows. The grid is ordered so the q heads of one kv group are
//     neighbours (they read the same K/V tiles from L2) and the longest
//     (last) causal q tiles start first;
//   * 64-key K/V tiles are double-buffered in dynamic shared memory with
//     cp.async (rows padded by 16 bytes against bank conflicts); the loop
//     over key tiles starts and ends at the q tile's live range, so tiles
//     wholly above the diagonal or outside the window are never read, and
//     the per-element mask runs only on tiles that cross an edge;
//   * bf16/fp16: S = Q K^T and O += P V with mma.sync.m16n8k16, f32
//     accumulation, Q fragments kept in registers, V fragments through
//     ldmatrix.trans, P rounded to the input type for the second product;
//   * f32: the same loop with plain FMA (exact f32, no TF32), P staged per
//     warp in shared memory.
//
// Bound on the H100 at the smoke's qwen3-14b prefill shape (B = 2, Hq = 40,
// Dh = 128, T = S = 4096, causal, bf16): operations. 4 * B * Hq * Dh *
// T(T+1)/2 = 343.7 GFLOP at 989 TFLOP/s dense bf16 is 0.347 ms; the bytes
// (q, k, v read once, out written once: ~0.2 GB) take 0.06 ms.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPStride = kBlockK + 1;  // f32 path: staged P row, padded
constexpr float kNegBig = -1e30f;
constexpr float kDeadMax = -5e29f;   // _NEG_INF * 0.5

enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2 };

template <typename T, int DH>
struct Cfg {
  static constexpr bool kFloat = std::is_same<T, float>::value;
  static constexpr int kVec = 16 / sizeof(T);       // elements per 16 bytes
  static constexpr int kStride = DH + kVec;         // smem row, padded
  static constexpr int kTile = kBlockQ * kStride;   // elements of one tile
  static constexpr int kChunks = DH / kVec;         // 16-byte chunks a row
  static constexpr size_t kSmem =
      5 * kTile * sizeof(T) +
      (kFloat ? (size_t)kWarps * 16 * kPStride * sizeof(float) : 0);
};

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

// rows [row0, row0 + 64) of a [rows, DH] slab with row stride `stride`
// (elements) into a padded smem tile; rows >= nrows are zero-filled
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t stride, int row0,
                                          int nrows) {
  using C = Cfg<T, DH>;
  for (int i = threadIdx.x; i < kBlockQ * C::kChunks; i += kThreads) {
    const int r = i / C::kChunks, c = i % C::kChunks;
    const int row = row0 + r;
    const bool ok = row < nrows;
    const T* g = src + (ok ? (int64_t)row * stride : 0) + c * C::kVec;
    cp_async16(dst + r * C::kStride + c * C::kVec, g, ok);
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

template <typename T>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (std::is_same<T, float>::value) {
    return expf(x);   // f32 inputs: the accurate exp, for parity at 2e-5
  } else {
    return __expf(x);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// Fragment layout shared by both paths (that of mma.m16n8k16's C):
// lane = 4 * gr + tg; s[j][0..1] are row gr, keys 8j + 2tg + {0, 1};
// s[j][2..3] row gr + 8, the same keys. acc[n][*] likewise over the head
// dim: columns 8n + 2tg + {0, 1}.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Hq,
                     int Hkv, int T_len, int S_len, int64_t qsb, int64_t qsh,
                     int64_t qst, int64_t ksb, int64_t ksh, int64_t kst,
                     int64_t vsb, int64_t vsh, int64_t vst, float sm_scale,
                     int causal, int has_window, int window) {
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

  const int q_lo = qt * kBlockQ;
  const int q_hi = min(q_lo + kBlockQ, T_len) - 1;
  int k_end = S_len;  // exclusive
  if (causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (has_window) k_begin = max(0, q_lo - window + 1);
  const int t_begin = k_begin / kBlockK;
  const int t_end = (k_end + kBlockK - 1) / kBlockK;

  const T* qb = q + b * qsb + h * qsh;
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
  uint32_t qf[C::kFloat ? 1 : DH / 16][4];

  if (t_begin < t_end) {
    load_tile<T, DH>(sQ, qb, qst, q_lo, T_len);
    load_tile<T, DH>(sK, kb, kst, t_begin * kBlockK, S_len);
    load_tile<T, DH>(sV, vb, vst, t_begin * kBlockK, S_len);
    cp_async_commit();
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_tile<T, DH>(sK + (stage ^ 1) * C::kTile, kb, kst,
                       (t + 1) * kBlockK, S_len);
      load_tile<T, DH>(sV + (stage ^ 1) * C::kTile, vb, vst,
                       (t + 1) * kBlockK, S_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* cK = sK + stage * C::kTile;
    const T* cV = sV + stage * C::kTile;
    const int k0 = t * kBlockK;

    // ---- S = Q K^T -------------------------------------------------------
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (C::kFloat) {
      const float* qa = sQ + r0 * C::kStride;
      const float* qc = qa + 8 * C::kStride;
#pragma unroll 2
      for (int d = 0; d < DH; d += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(qa + d);
        const float4 x1 = *reinterpret_cast<const float4*>(qc + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float4 y = *reinterpret_cast<const float4*>(
                cK + (8 * j + 2 * tg + c) * C::kStride + d);
            s[j][c] = fmaf(x0.x, y.x, s[j][c]);
            s[j][c] = fmaf(x0.y, y.y, s[j][c]);
            s[j][c] = fmaf(x0.z, y.z, s[j][c]);
            s[j][c] = fmaf(x0.w, y.w, s[j][c]);
            s[j][2 + c] = fmaf(x1.x, y.x, s[j][2 + c]);
            s[j][2 + c] = fmaf(x1.y, y.y, s[j][2 + c]);
            s[j][2 + c] = fmaf(x1.z, y.z, s[j][2 + c]);
            s[j][2 + c] = fmaf(x1.w, y.w, s[j][2 + c]);
          }
        }
      }
    } else {
      if (t == t_begin) {  // Q fragments, once
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const T* p = sQ + r0 * C::kStride + kk * 16 + 2 * tg;
          qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
          qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * C::kStride);
          qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
          qf[kk][3] =
              *reinterpret_cast<const uint32_t*>(p + 8 * C::kStride + 8);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const T* p = cK + (8 * j + gr) * C::kStride + kk * 16 + 2 * tg;
          mma16816<T>(s[j], qf[kk], *reinterpret_cast<const uint32_t*>(p),
                      *reinterpret_cast<const uint32_t*>(p + 8));
        }
      }
    }

    // ---- scale, mask -----------------------------------------------------
    const bool edge = k0 + kBlockK > S_len ||
                      (causal && k0 + kBlockK - 1 > q_lo) ||
                      (has_window && k0 <= q_hi - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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

    // ---- online softmax (rows gr and gr + 8) -----------------------------
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r], mx);
      const bool dead = m_new <= kDeadMax;
      const float alpha = dead ? 1.f : softmax_exp<T>(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = dead ? 0.f : softmax_exp<T>(s[j][2 * r + c] - m_new);
          s[j][2 * r + c] = p;
          sum += p;
        }
      }
      l_part[r] = l_part[r] * alpha + sum;
      m_run[r] = m_new;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // ---- O += P V ---------------------------------------------------------
    if constexpr (C::kFloat) {
      float* sP = reinterpret_cast<float*>(smem_raw +
                                           5 * C::kTile * sizeof(T)) +
                  warp * 16 * kPStride;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          sP[gr * kPStride + 8 * j + 2 * tg + c] = s[j][c];
          sP[(gr + 8) * kPStride + 8 * j + 2 * tg + c] = s[j][2 + c];
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int key = 0; key < kBlockK; ++key) {
        const float p0 = sP[gr * kPStride + key];
        const float p1 = sP[(gr + 8) * kPStride + key];
        const float* vr = cV + key * C::kStride + 2 * tg;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(vr + 8 * n);
          acc[n][0] = fmaf(p0, y.x, acc[n][0]);
          acc[n][1] = fmaf(p0, y.y, acc[n][1]);
          acc[n][2] = fmaf(p1, y.x, acc[n][2]);
          acc[n][3] = fmaf(p1, y.y, acc[n][3]);
        }
      }
      __syncwarp();
    } else {
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
    }
    __syncthreads();  // this stage is refilled by the next iteration
  }

  // ---- epilogue: out = acc / l (0 for a row with no live key) ------------
  T* ob = o + ((int64_t)(b * Hq + h) * T_len) * DH;
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
      for (int n = 0; n < kN; ++n)
        store2(orow + 8 * n, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int T_len, int S_len, const int64_t* st,
           float sm_scale, int causal, int has_window, int window,
           cudaStream_t stream) {
  using C = Cfg<T, DH>;
  auto kern = flash_fwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t blocks =
      (int64_t)B * Hq * ((T_len + kBlockQ - 1) / kBlockQ);
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, T_len, S_len,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      sm_scale, causal, has_window, window);
  return cudaGetLastError();
}

template <typename T>
int launch_dh(int Dh, const void* q, const void* k, const void* v, void* o,
              int B, int Hq, int Hkv, int T_len, int S_len,
              const int64_t* st, float sm_scale, int causal, int has_window,
              int window, cudaStream_t s) {
  switch (Dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, T_len, S_len, st,
                           sm_scale, causal, has_window, window, s);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, T_len, S_len, st,
                           sm_scale, causal, has_window, window, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, T_len, S_len, st,
                           sm_scale, causal, has_window, window, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, T_len, S_len, st,
                            sm_scale, causal, has_window, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: q (batch, head, row), k (batch, head, row), v (batch, head, row),
// in elements. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int T_len, int S_len, int Dh,
                                   int dtype, const int64_t* strides,
                                   float sm_scale, int causal, int has_window,
                                   int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32:
      return launch_dh<float>(Dh, q, k, v, o, B, Hq, Hkv, T_len, S_len,
                              strides, sm_scale, causal, has_window, window,
                              s);
    case kF16:
      return launch_dh<__half>(Dh, q, k, v, o, B, Hq, Hkv, T_len, S_len,
                               strides, sm_scale, causal, has_window, window,
                               s);
    case kBF16:
      return launch_dh<__nv_bfloat16>(Dh, q, k, v, o, B, Hq, Hkv, T_len,
                                      S_len, strides, sm_scale, causal,
                                      has_window, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}
