// The block-skip tile bitmap: bitmap[t] = 1 where tile t of the
// combine-ordered edges holds an out-edge of a vertex on the frontier.
//
// Replaces the Pallas `_block_active` of repro/kernels/fused_gather_emit.py
// (a per-block max of the frontier flag gathered at every edge's source)
// with one pass over the frontier, in the src-sorted order: vertex u's
// out-edges are out_indptr[u]:out_indptr[u+1], and out_tile[e] is the
// tile of src-sorted edge e. No prefix sum over the frontier and no
// search per edge: each lane reads 8 flags in one load, and for each of
// its 8 the warp ballots the active ones (a warp with none leaves after
// one load); then
//   * a vertex of fewer than 32 out-edges is walked by its own lane;
//   * a vertex of 32 to HUB out-edges by the whole warp, 32 edges a step;
//   * a hub (more than HUB out-edges) is skipped there: the first CTAs of
//     the grid take the layout's hub pieces (vertex, first edge, end), a
//     table built once per layout, one piece a warp, each walking it only
//     when its vertex is on the frontier.
// Every store writes 1 to a byte, so concurrent stores to one tile need
// no atomics; the bitmap is cleared by one memset before the pass.
//
// Bound on the H100: bytes. The frontier flags and the active vertices'
// row pointers and tile ids are read, the bitmap written; there is no
// arithmetic to speak of.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// frontier flags a lane reads in one 8-byte load: a warp covers 256
// vertices, a CTA 2,048
constexpr int kFlags = 8;

__global__ void __launch_bounds__(kThreads)
    tile_bitmap_kernel(const uint8_t* __restrict__ active,
                       const int* __restrict__ out_indptr,
                       const int* __restrict__ out_tile,
                       const int* __restrict__ hub_pieces, int n_pieces,
                       uint8_t* __restrict__ bitmap, int V, int hub) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int hub_ctas = (n_pieces + kWarps - 1) / kWarps;
  if (static_cast<int>(blockIdx.x) < hub_ctas) {  // one warp a piece
    const int q = blockIdx.x * kWarps + (tid >> 5);
    if (q >= n_pieces) return;
    const int* piece = hub_pieces + 3 * q;
    if (!active[piece[0]]) return;
#pragma unroll 4
    for (int e = piece[1] + lane; e < piece[2]; e += 32) {
      bitmap[out_tile[e]] = 1;
    }
    return;
  }
  // lane l holds the flags of vertices v0 .. v0 + kFlags - 1
  const int64_t v0 =
      (static_cast<int64_t>(blockIdx.x - hub_ctas) * kThreads + tid) *
      kFlags;
  uint64_t flags = 0;
  if (v0 + kFlags <= V) {
    flags = *reinterpret_cast<const uint64_t*>(active + v0);
  } else {
    for (int j = 0; j < kFlags && v0 + j < V; ++j) {
      flags |= static_cast<uint64_t>(active[v0 + j] != 0) << (8 * j);
    }
  }
  if (__ballot_sync(~0u, flags != 0) == 0u) return;  // the whole warp
#pragma unroll 1
  for (int j = 0; j < kFlags; ++j) {
    const bool on = (flags >> (8 * j)) & 0xff;
    if (__ballot_sync(~0u, on) == 0u) continue;
    int lo = 0, hi = 0;
    if (on) {
      lo = out_indptr[v0 + j];
      hi = out_indptr[v0 + j + 1];
    }
    const int deg = hi - lo;
    // own lane: fewer than 32 out-edges
    if (deg < 32) {
#pragma unroll 4
      for (int e = lo; e < hi; ++e) bitmap[out_tile[e]] = 1;
    }
    // whole warp: 32 to `hub` out-edges, one vertex after another
    unsigned mid = __ballot_sync(~0u, deg >= 32 && deg <= hub);
    while (mid) {
      const int src = __ffs(mid) - 1;
      mid &= mid - 1;
      const int a = __shfl_sync(~0u, lo, src);
      const int b = __shfl_sync(~0u, hi, src);
      for (int e = a + lane; e < b; e += 32) bitmap[out_tile[e]] = 1;
    }
  }
}

}  // namespace

// C interface, bound with ctypes: clears the [num_tiles] bitmap and
// launches the pass on `stream`. `active` is the [V] frontier as bytes,
// 8-byte aligned; `hub_pieces` is [n_pieces, 3] int32 (vertex, first
// edge, end) of the vertices of more than `hub` out-edges. Returns the
// cudaError_t of the launch.
extern "C" int tile_bitmap(const uint8_t* active, const int* out_indptr,
                           const int* out_tile, const int* hub_pieces,
                           int n_pieces, uint8_t* bitmap, int num_tiles,
                           int V, int hub, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(bitmap, 0, num_tiles, s);
  if (err != cudaSuccess) return err;
  const int64_t per_cta = static_cast<int64_t>(kThreads) * kFlags;
  const int64_t blocks =
      (n_pieces + kWarps - 1) / kWarps + (V + per_cta - 1) / per_cta;
  if (blocks == 0) return cudaGetLastError();
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  tile_bitmap_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      active, out_indptr, out_tile, hub_pieces, n_pieces, bitmap, V, hub);
  return cudaGetLastError();
}
