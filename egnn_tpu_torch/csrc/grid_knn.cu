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
// by operations. The first version (one query a warp, one candidate a lane a
// step, a warp ballot and one insertion of a few shuffles for every value
// below the query's k-th) took 0.275 ms there, 0.157 of it in the insertions
// (PERF.md §6, the stage split). With N = 1440 candidates against k = 16 a
// query inserts often (k (1 + ln(N / k)) in random order), so this design
// cuts what an insertion costs:
//  - One query a warp, kRun = 4 consecutive candidates a lane a step, read
//    as one 16-byte shared load from each of the x, y, z planes. Two and
//    four queries a warp, each with its list in registers, were slower on
//    the H100 (PERF.md §6): their merges unrolled row by row made the
//    kernel up to 15 000 instructions long, and with one merge for all rows
//    (the row picked at run time) the appends cost twice the cycles.
//  - One compare a pair against the query's float threshold, the largest
//    distance that its k-th packed value lets in (ties pass; r >= +0, so the
//    bits of r are its order), and one vote a step: the warp leaves the
//    distance loop only when a lane's pair passed.
//  - Batched insertion. Column by column of the run, the flagged lanes'
//    pairs below the query's k-th are appended to the warp's queue in
//    shared memory, one ballot placing them;
//    once 32 are queued the warp merges them into the list at once
//    (warp_topk.cuh, merge: a bitonic sort and merge, some 42 shuffles for
//    32 values where one insertion took about 6), and the threshold falls.
//    Packed values are distinct, so the list ends the same whatever the
//    batches.
//  - The block's own cell is ranked first and the rest by distance of the
//    cell offset, which brings the k-th value down early.
//  - Staging: the block's 27 parts as planes (x, y, z, id), the coordinates
//    copied by cp.async (4 bytes, gathered by node id), each thread walking
//    the parts in order (no search a candidate). The planes hold +inf past
//    the last candidate to the end of its step.
//  - Three blocks an SM: 54 KiB of planes and 4 KiB of queues a block. A
//    queue of 2-byte plane indices, the values computed again at the
//    merge, fits four blocks an SM and was no faster on the H100.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_topk.cuh"

namespace {

using warp_topk::kEmpty;
using warp_topk::kFull;

constexpr int kWarps = 8;      // warps a block: queries ranked at a time
constexpr int kCap = 128;      // nodes of a cell that take part
constexpr int kMaxCand = 27 * kCap;
constexpr int kMaxK = 128;
constexpr int kRun = 4;        // consecutive candidates a lane ranks a step
constexpr int kStep = 32 * kRun;
constexpr int kBatch = 32;     // queued values a merge takes
constexpr int kQueue = 2 * kBatch;  // a query's queue: under kBatch left, plus one column's
static_assert(kMaxCand % kStep == 0, "the planes end on a whole step");

// the 27 cell offsets, packed (dx + 1) * 9 + (dy + 1) * 3 + (dz + 1), the
// cell itself first, then its face, edge and corner neighbours
#define GRID_KNN_CELL_ORDER \
  13, 4, 10, 12, 14, 16, 22, 1, 3, 5, 7, 9, 11, 15, 17, 19, 21, 23, 25, 0, 2, 6, 8, 18, 20, 24, 26
__constant__ int kOrder[27] = {GRID_KNN_CELL_ORDER};

__device__ __forceinline__ float sq_dist(float x0, float x1, float x2, float y0, float y1,
                                         float y2) {
  const float dx = __fsub_rn(x0, y0), dy = __fsub_rn(x1, y1), dz = __fsub_rn(x2, y2);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

template <int kSlots>
__global__ void __launch_bounds__(kWarps * 32, 3) grid_knn_kernel(
    const float* __restrict__ coors,      // (b, n, 3)
    const int* __restrict__ cell_start,   // (b, G + 1)
    const int* __restrict__ cell_nodes,   // (b, n)
    int n, int gdim, int k,
    float* __restrict__ out_vals,         // (b, n, k)
    long long* __restrict__ out_idx) {    // (b, n, k)
  extern __shared__ __align__(16) float planes[];  // 4 planes of kMaxCand: x, y, z, node id
  // each warp's queue: packed values below its query's k-th
  __shared__ unsigned long long queue[kWarps][kQueue];
  __shared__ int part_src[27];            // a cell's first entry in cell_nodes
  __shared__ int part_len[27];            // its nodes that take part
  __shared__ int part_off[28];            // its first slot in the planes
  const int* ids = reinterpret_cast<const int*>(planes + 3 * kMaxCand);
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
  {
    int t = 0;  // the part of candidate e: e ascends, so t only moves on
#pragma unroll 4
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      while (part_off[t + 1] <= e) ++t;
      const int j = nodes[part_src[t] + e - part_off[t]];
      const float* src = cb + (size_t)j * 3;
#pragma unroll
      for (int cc = 0; cc < 3; ++cc)
        __pipeline_memcpy_async(planes + cc * kMaxCand + e, src + cc, sizeof(float));
      reinterpret_cast<int*>(planes)[3 * kMaxCand + e] = j;
    }
    __pipeline_commit();
    const int end = (total + kStep - 1) / kStep * kStep;
    for (int e = total + threadIdx.x; e < end; e += blockDim.x) {
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) planes[cc * kMaxCand + e] = __uint_as_float(0x7f800000u);
    }
    __pipeline_wait_prior(0);
  }
  __syncthreads();

  // the block's own cell is part 0: query q is candidate q
  for (int q = warp; q < q_count; q += kWarps) {
    const float x0 = planes[q], x1 = planes[kMaxCand + q], x2 = planes[2 * kMaxCand + q];
    warp_topk::List<kSlots> list;
    list.init(k, lane);
    float thr = __uint_as_float(0xffffffffu);  // tau = kEmpty: NaN, every pair passes
    int cnt = 0;                               // values in the queue

    for (int t0 = 0; t0 < total; t0 += kStep) {  // the whole warp takes every step
      const int t = t0 + kRun * lane;            // the lane's first candidate of the step
      float xj[3][kRun];                         // +inf past the last candidate
#pragma unroll
      for (int cc = 0; cc < 3; ++cc) {
        const float4 v = *reinterpret_cast<const float4*>(planes + cc * kMaxCand + t);
        xj[cc][0] = v.x; xj[cc][1] = v.y; xj[cc][2] = v.z; xj[cc][3] = v.w;
      }
      float d[kRun];
      bool pass = false;  // a pair of the lane's may be below the query's k-th
#pragma unroll
      for (int c = 0; c < kRun; ++c) {
        d[c] = sq_dist(x0, x1, x2, xj[0][c], xj[1][c], xj[2][c]);
        pass = pass || !(d[c] > thr);
      }
      if (!__any_sync(kFull, pass)) continue;  // uniform

      const int avail = total - t;  // of the lane's kRun candidates, those that exist
#pragma unroll
      for (int c = 0; c < kRun; ++c) {  // column c of the lanes' runs, lanes in order
        unsigned long long p = kEmpty;
        if (pass && c < avail)  // r >= +0: the bits of r are its order
          p = ((unsigned long long)__float_as_uint(d[c]) << 32) | (unsigned)ids[t + c];
        const bool take = p < list.tau;
        const unsigned ballot = __ballot_sync(kFull, take);
        if (take) queue[warp][cnt + __popc(ballot & ((1u << lane) - 1u))] = p;
        cnt += __popc(ballot);
        if (cnt >= kBatch) {  // uniform: merge the queue's last 32
          cnt -= kBatch;
          __syncwarp();
          const unsigned long long pe = queue[warp][cnt + lane];
          __syncwarp();  // read before the next appends overwrite
          list.merge(pe);
          thr = __uint_as_float((unsigned)(list.tau >> 32));
        }
      }
    }
    if (cnt > 0) {  // what is left
      __syncwarp();
      list.merge(lane < cnt ? queue[warp][lane] : kEmpty);
    }
    const size_t row = (size_t)b * n + (size_t)ids[q];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int e = s * 32 + lane;
      if (e < k && list.entry[s] != kEmpty) {  // else the caller's (inf, n)
        out_vals[row * k + e] = __uint_as_float((unsigned)(list.entry[s] >> 32));
        out_idx[row * k + e] = (long long)(list.entry[s] & 0xffffffffull);
      }
    }
    __syncwarp();  // the queue is read before the next query appends
  }
}

template <int kSlots>
int launch_grid(const float* coors, const int* cell_start, const int* cell_nodes, int b, int n,
                int gdim, int k, float* vals, long long* idx, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * kMaxCand;
  const cudaError_t err = cudaFuncSetAttribute(
      grid_knn_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(gdim * gdim * gdim, b);
  grid_knn_kernel<kSlots><<<grid, kWarps * 32, smem, stream>>>(coors, cell_start, cell_nodes, n,
                                                                gdim, k, vals, idx);
  return (int)cudaGetLastError();
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
  const auto c = static_cast<const float*>(coors);
  const auto s = static_cast<const int*>(cell_start);
  const auto m = static_cast<const int*>(cell_nodes);
  const auto v = static_cast<float*>(vals);
  const auto i = static_cast<long long*>(idx);
  const auto st = static_cast<cudaStream_t>(stream);
  if (k <= 32) return launch_grid<1>(c, s, m, b, n, gdim, k, v, i, st);
  if (k <= 64) return launch_grid<2>(c, s, m, b, n, gdim, k, v, i, st);
  return launch_grid<4>(c, s, m, b, n, gdim, k, v, i, st);
}

// K7's launch plan: candidates a lane a step, the queued values a merge
// takes, and the order of the 27 cells (order[27]).
int grid_knn_plan(int* run, int* batch, int* order) {
  *run = kRun;
  *batch = kBatch;
  constexpr int kCells[27] = {GRID_KNN_CELL_ORDER};
  for (int o = 0; o < 27; ++o) order[o] = kCells[o];
  return 0;
}

}  // extern "C"
