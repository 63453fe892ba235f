// Segment combine over dst-sorted messages: out[v, d] = fold of
// vals[e, d] for e in [indptr[v], indptr[v+1]) under sum, min or max.
//
// Replaces the Pallas kernel repro/kernels/segment_reduce.py::
// segment_combine_kernel (one-hot MXU matmul for sum, segmented scan plus
// pick matmul for min/max). On Hopper the dst-sorted order gives every
// vertex a contiguous in-edge range, so no one-hot work and no atomics are
// needed: one warp owns one (vertex, column) pair, its lanes stride over
// the range and a fixed shuffle tree folds the 32 partials. The result is
// deterministic from run to run.
//
// Bound on the H100: bytes. Every message is read once and every output
// written once; the arithmetic is one add or compare per byte or four.
//
// Semantics kept from the Pallas kernel:
//   * accumulation in f32 for f32/f16/bf16 payloads, int32 for int8/int16/
//     int32 (sums wrap in two's complement);
//   * a vertex with no edge gets the identity the caller passes (the
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
__device__ __forceinline__ T from_int_acc(int x) { return static_cast<T>(x); }

template <int OP>
__device__ __forceinline__ float fold(float a, float b) {
  if (OP == kSum) return a + b;
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

template <typename T, typename Acc, int OP>
__global__ void segment_combine_kernel(const T* __restrict__ vals,
                                       const int* __restrict__ indptr,
                                       T* __restrict__ out, int64_t num_rows,
                                       int D, Acc ident) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= num_rows * D) return;  // whole warps leave together
  const int64_t v = warp / D;
  const int d = static_cast<int>(warp - v * D);
  const int lo = indptr[v];
  const int hi = indptr[v + 1];
  Acc acc = ident;
  for (int e = lo + lane; e < hi; e += 32) {
    Acc x = to_acc(vals[static_cast<int64_t>(e) * D + d]);
    if constexpr (std::is_floating_point<Acc>::value && OP != kSum) {
      x = clamp_big(x);  // float min/max only
    }
    acc = fold<OP>(acc, x);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = fold<OP>(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (lane == 0) {
    if constexpr (std::is_floating_point<Acc>::value) {
      out[v * D + d] = from_acc<T>(acc);
    } else {
      out[v * D + d] = from_int_acc<T>(acc);
    }
  }
}

template <typename T, typename Acc>
cudaError_t launch_typed(const void* vals, const int* indptr, void* out,
                         int64_t V, int D, int op, double ident,
                         cudaStream_t stream) {
  constexpr int kThreads = 256;  // 8 warps, one (vertex, column) each
  const int64_t warps = V * D;
  if (warps == 0) return cudaGetLastError();
  const int64_t blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  const Acc id = static_cast<Acc>(ident);
  switch (op) {
    case kSum:
      segment_combine_kernel<T, Acc, kSum>
          <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
              v, indptr, o, V, D, id);
      break;
    case kMin:
      segment_combine_kernel<T, Acc, kMin>
          <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
              v, indptr, o, V, D, id);
      break;
    case kMax:
      segment_combine_kernel<T, Acc, kMax>
          <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
              v, indptr, o, V, D, id);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes. Pointers and the stream are opaque;
// `ident` is the identity as a double (exact for every int32 and for the
// float identities). Returns the cudaError_t of the launch.
extern "C" int segment_combine(const void* vals, const int* indptr,
                               void* out, int64_t num_rows, int D, int dtype,
                               int op, double ident, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_typed<float, float>(vals, indptr, out, num_rows, D, op,
                                        ident, s);
    case kF16:
      return launch_typed<__half, float>(vals, indptr, out, num_rows, D, op,
                                         ident, s);
    case kBF16:
      return launch_typed<__nv_bfloat16, float>(vals, indptr, out, num_rows,
                                                D, op, ident, s);
    case kI8:
      return launch_typed<int8_t, int>(vals, indptr, out, num_rows, D, op,
                                       ident, s);
    case kI16:
      return launch_typed<int16_t, int>(vals, indptr, out, num_rows, D, op,
                                        ident, s);
    case kI32:
      return launch_typed<int32_t, int>(vals, indptr, out, num_rows, D, op,
                                        ident, s);
    default:
      return cudaErrorInvalidValue;
  }
}
