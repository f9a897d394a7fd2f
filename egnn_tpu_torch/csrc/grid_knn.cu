// Grid-blocked kNN selection for Hopper (sm_90a). Plain C interface, loaded
// with ctypes (egnn_tpu_torch/ops/cuda/build.py,
// egnn_tpu_torch/ops/cuda/grid_knn.py).
//
// K7 replaces both TPU kernels of egnn_tpu/ops/pallas/grid_knn.py:
//   _grid_knn_kernel          (the candidate table resident in VMEM) and
//   _grid_knn_streamed_kernel (grid (G, 27), candidate blocks streamed),
// which compute one function. The nodes are grouped by the cell of a
// gdim^3 spatial grid (ops/spatial.py); cell_nodes lists them cell by cell
// and cell_start is the CSR over it. Every node among the first 128 of its
// cell ranks the first 128 nodes of each of the 27 cells around it (cells
// out of the grid are empty; self is a candidate), with d = x_i - x_j,
//   r_ij = (d_0^2 + d_1^2) + d_2^2                         (f32, no FMA)
// and keeps the k smallest in (r, node id j) order as vals (f32) and idx,
// written at row i. That is the order of the exact selection (K4,
// csrc/knn_select_large.cu) with the same values bit for bit, so where a
// row's k nearest all lie in its block the row equals K4's. Rows of nodes in
// no cell are left as the caller filled them; a row with fewer than k
// candidates ends in (inf, n).
//
// What is not carried over. The TPU kernels read (cell, slot) tables padded
// to 128 slots a cell, with sentinel coordinates beyond the bounding box in
// the empty slots and the node ids as f32 in a spare sublane row, rank a
// (128, 27 * 128) band in k rounds of min / min-id / evict, and write
// (cell, slot, k) blocks that a gather unsorts; the resident and streamed
// variants differ only in how the band's columns reach VMEM. Here a block
// copies the real candidates of its 27 cells into shared memory once
// (54 KiB at most), empty slots do not exist, ids are integers, and the
// lexicographic order is one 64-bit compare on (bits(r) << 32) | j.
//
// Bound on the H100: at n = 65536, k = 16, gdim = 10 a row of a uniform
// cloud has about 1440 real candidates: 9.4e7 pairs of 12 f32 operations,
// 0.017 ms at 67 TFLOP/s, against 14 MB moved (0.004 ms at 3.35 TB/s): bound
// by operations, but so short that the list insertions (up to
// k * ln(1440 / k) a row in random order, each a few ballots and shuffles by
// the whole warp) outweigh the pairs. So the block's own cell is ranked first
// and the rest by distance of the cell offset, which brings the k-th value
// down early and spares insertions. One warp takes one query at a time and
// each lane ranks one pair a step, as in K4. Measured there: 0.29 ms.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_topk.cuh"

namespace {

using warp_topk::kEmpty;

constexpr int kWarps = 8;      // queries ranked at a time by a block
constexpr int kCap = 128;      // nodes of a cell that take part
constexpr int kMaxCand = 27 * kCap;
constexpr int kMaxK = 128;

// the 27 cell offsets, packed (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1), the
// cell itself first, then its face, edge and corner neighbours
__constant__ int kOrder[27] = {13, 4,  10, 12, 14, 16, 22, 1,  3,  5,  7,  9,  11, 15,
                               17, 19, 21, 23, 25, 0,  2,  6,  8,  18, 20, 24, 26};

template <int kSlots>
__global__ void __launch_bounds__(kWarps * 32) grid_knn_kernel(
    const float* __restrict__ coors,      // (b, n, 3)
    const int* __restrict__ cell_start,   // (b, G + 1)
    const int* __restrict__ cell_nodes,   // (b, n)
    int n, int gdim, int k,
    float* __restrict__ out_vals,         // (b, n, k)
    long long* __restrict__ out_idx) {    // (b, n, k)
  extern __shared__ float4 cand[];        // kMaxCand: x, y, z, node id bits
  __shared__ int part_src[27];            // a cell's first entry in cell_nodes
  __shared__ int part_len[27];            // its nodes that take part
  __shared__ int part_off[28];            // its first slot in cand
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int cell = blockIdx.x;
  const int G = gdim * gdim * gdim;
  const int* cs = cell_start + (size_t)b * (G + 1);
  const int* nodes = cell_nodes + (size_t)b * n;
  const float* cb = coors + (size_t)b * n * 3;

  const int q_begin = cs[cell];
  const int q_count = min(cs[cell + 1] - q_begin, kCap);
  if (q_count <= 0) return;  // whole block: an empty cell has no rows

  if (threadIdx.x < 27) {  // one thread a cell of the block: its loads overlap
    const int ix = cell / (gdim * gdim), iy = (cell / gdim) % gdim, iz = cell % gdim;
    const int o = kOrder[threadIdx.x];
    const int nx = ix + o / 9 - 1, ny = iy + (o / 3) % 3 - 1, nz = iz + o % 3 - 1;
    int src = 0, len = 0;
    if (nx >= 0 && nx < gdim && ny >= 0 && ny < gdim && nz >= 0 && nz < gdim) {
      const int c2 = (nx * gdim + ny) * gdim + nz;
      src = cs[c2];
      len = max(min(cs[c2 + 1] - src, kCap), 0);
    }
    part_src[threadIdx.x] = src;
    part_len[threadIdx.x] = len;
  }
  __syncthreads();
  if (threadIdx.x < 28) {
    int off = 0;
    for (int t = 0; t < (int)threadIdx.x; ++t) off += part_len[t];
    part_off[threadIdx.x] = off;
  }
  __syncthreads();
  const int total = part_off[27];
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int t = 0;
    while (part_off[t + 1] <= e) ++t;
    const int j = nodes[part_src[t] + e - part_off[t]];
    cand[e] = make_float4(cb[(size_t)j * 3], cb[(size_t)j * 3 + 1], cb[(size_t)j * 3 + 2],
                          __int_as_float(j));
  }
  __syncthreads();

  // the block's own cell is part 0: query q is cand[q]
  for (int q = warp; q < q_count; q += kWarps) {
    const float4 me = cand[q];
    warp_topk::List<kSlots> list;
    list.init(k, lane);
    for (int e0 = 0; e0 < total; e0 += 32) {  // the whole warp takes every step
      const int e = e0 + lane;
      unsigned long long p = kEmpty;
      if (e < total) {
        const float4 c = cand[e];
        const float dx = __fsub_rn(me.x, c.x), dy = __fsub_rn(me.y, c.y),
                    dz = __fsub_rn(me.z, c.z);
        const float r =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        // r >= +0: its bit pattern is monotonic
        p = ((unsigned long long)__float_as_uint(r) << 32) |
            (unsigned long long)(unsigned)__float_as_int(c.w);
      }
      list.offer(p);
    }
    const size_t row = (size_t)b * n + (size_t)__float_as_int(me.w);
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = s * 32 + lane;
      if (e < k && list.entry[s] != kEmpty) {  // else the caller's (inf, n)
        out_vals[row * k + e] = __uint_as_float((unsigned)(list.entry[s] >> 32));
        out_idx[row * k + e] = (long long)(list.entry[s] & 0xffffffffull);
      }
    }
  }
}

}  // namespace

extern "C" {

// K7: coors (b, n, 3) f32, cell_start (b, gdim^3 + 1) and cell_nodes (b, n)
// i32; vals f32 and idx i64, (b, n, k), filled with (inf, n) by the caller.
int grid_knn_cells_launch(const void* coors, const void* cell_start, const void* cell_nodes,
                          int b, int n, int gdim, int k, void* vals, void* idx,
                          void* stream) {
  if (b < 1 || n < 1 || gdim < 1 || gdim > 32 || k < 1 || k > kMaxK)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float4) * kMaxCand;
  const dim3 grid(gdim * gdim * gdim, b);
  cudaError_t err = cudaSuccess;
#define LAUNCH_GRID(SLOTS)                                                                \
  err = cudaFuncSetAttribute(grid_knn_kernel<SLOTS>,                                      \
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);     \
  if (err != cudaSuccess) return (int)err;                                                \
  grid_knn_kernel<SLOTS><<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>( \
      static_cast<const float*>(coors), static_cast<const int*>(cell_start),              \
      static_cast<const int*>(cell_nodes), n, gdim, k, static_cast<float*>(vals),         \
      static_cast<long long*>(idx))
  if (k <= 32) { LAUNCH_GRID(1); }
  else if (k <= 64) { LAUNCH_GRID(2); }
  else { LAUNCH_GRID(4); }
#undef LAUNCH_GRID
  return (int)cudaGetLastError();
}

}  // extern "C"
