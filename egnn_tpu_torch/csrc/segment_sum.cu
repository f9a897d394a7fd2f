// Deterministic segment sum for Hopper (sm_90a). Plain C interface, loaded
// with ctypes (egnn_tpu_torch/ops/cuda/build.py, egnn_tpu_torch/ops/cuda/segment.py).
//
// Replaces the TPU kernel
//   K2 egnn_tpu/ops/pallas/segment.py:segment_sum_pallas (_seg_kernel)
// which computes, for every graph b of a batch,
//   out[b, s, :] = sum of data[b, e, :] over the edges e with ids[b, e] == s
// for ids in any order; an id < 0 or >= S adds nothing, and an empty
// segment is 0. It is the backward of the kNN gather (K1) and of
// gather_nodes: the gathered rows' cotangents scatter-added into node rows.
//
// Design. The TPU kernel contracts a one-hot (edges x segments) tile with
// the messages on the MXU, in two bf16 passes. Here the sum is exact f32 and
// repeatable bit for bit, in four launches on the caller's stream:
//   1. count:  one thread per edge, an integer atomicAdd into counts[b, id];
//   2. scan:   one block per graph, the exclusive scan of counts into
//              offsets[b, 0..S] (a CSR row pointer);
//   3. place:  one thread per edge writes e into perm[b, offsets[id] + slot],
//              slot from an atomicSub on counts (ends at 0); the order of the
//              edges inside a segment is arbitrary here;
//   4. reduce: one warp per segment ranks its edges (the rank of e is the
//              number of smaller edge ids in the segment), so `sorted` holds
//              them ascending; then each lane sums its columns over the
//              sorted edges from 0.0f with __fadd_rn (no contraction).
// Integer atomics give the same counts and offsets every run, and step 4
// fixes the order of every float add, so the output does not depend on the
// order the atomics of step 3 happened in. The ranking costs deg^2 / 32
// compares a lane: nothing at an in-degree of about k, a few ms for a hub
// segment of 8192 edges.
//
// Bound on the H100: at the train step's shape (b = 1, E = n*k = 8192,
// S = 1024, D = 36) each input read once and the output written once is
// 1.39 MB, 0.42 us at 3.35 TB/s; the 295 K adds are negligible, so it is
// bound by bytes. This first version is not near it: four launches and the
// scratch traffic (counts, offsets, perm, sorted) cost more than the data.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEdgeThreads = 256;   // count and place
constexpr int kScanThreads = 1024;  // one block per graph
constexpr int kReduceWarps = 8;     // segments per reduce block
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;

template <typename Id>
__global__ void count_kernel(const Id* __restrict__ ids, int nb, long long E,
                             long long S, int* __restrict__ counts) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const long long id = (long long)ids[(size_t)b * E + e];
    if (id >= 0 && id < S) atomicAdd(&counts[(size_t)b * S + id], 1);
  }
}

__global__ void scan_kernel(const int* __restrict__ counts, long long S,
                            int* __restrict__ offsets) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* cnt = counts + (size_t)blockIdx.x * S;
  int* off = offsets + (size_t)blockIdx.x * (S + 1);
  int carry = 0;  // the same in every thread: read from shared memory
  for (long long base = 0; base < S; base += blockDim.x) {
    const long long s = base + threadIdx.x;
    const int v = s < S ? cnt[s] : 0;
    int x = v;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += y;
      }
      if (lane < nwarps) warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (s < S) off[s] = before;
    carry += warp_sums[nwarps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  if (threadIdx.x == 0) off[S] = carry;
}

template <typename Id>
__global__ void place_kernel(const Id* __restrict__ ids, int nb, long long E,
                             long long S, const int* __restrict__ offsets,
                             int* __restrict__ counts, int* __restrict__ perm) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const long long id = (long long)ids[(size_t)b * E + e];
    if (id < 0 || id >= S) continue;
    const int slot = atomicSub(&counts[(size_t)b * S + id], 1) - 1;
    perm[(size_t)b * E + offsets[(size_t)b * (S + 1) + id] + slot] = (int)e;
  }
}

__global__ void reduce_kernel(const float* __restrict__ data, int nb, long long E,
                              long long S, int D, const int* __restrict__ offsets,
                              const int* __restrict__ perm, int* __restrict__ sorted,
                              float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (s >= S) return;  // the whole warp: no block barrier follows
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const int* off = offsets + (size_t)b * (S + 1);
    const int beg = off[s];
    const int deg = off[s + 1] - beg;
    const int* p = perm + (size_t)b * E + beg;
    int* q = sorted + (size_t)b * E + beg;
    // edge ids are distinct, so ranks are a permutation of 0..deg-1
    for (int i = lane; i < deg; i += 32) {
      const int x = p[i];
      int r = 0;
      for (int j = 0; j < deg; ++j) r += p[j] < x;
      q[r] = x;
    }
    __syncwarp();
    const float* db = data + (size_t)b * E * D;
    float* o = out + ((size_t)b * S + s) * D;
    for (int col = lane; col < D; col += 32) {
      float acc = 0.f;
      for (int t = 0; t < deg; ++t) acc = __fadd_rn(acc, db[(size_t)q[t] * D + col]);
      o[col] = acc;
    }
    __syncwarp();  // q may be rewritten for the next graph only by this warp
  }
}

template <typename Id>
int launch(const float* data, const Id* ids, int nb, long long E, long long S, int D,
           int* counts, int* offsets, int* perm, int* sorted, float* out,
           cudaStream_t stream) {
  if (nb < 1 || E < 1 || E > INT32_MAX || S < 1 || S > INT32_MAX || D < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned gy = nb < kMaxGridY ? nb : kMaxGridY;
  const dim3 edge_grid((unsigned)((E + kEdgeThreads - 1) / kEdgeThreads), gy);
  count_kernel<Id><<<edge_grid, kEdgeThreads, 0, stream>>>(ids, nb, E, S, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<nb, kScanThreads, 0, stream>>>(counts, S, offsets);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  place_kernel<Id><<<edge_grid, kEdgeThreads, 0, stream>>>(ids, nb, E, S, offsets,
                                                          counts, perm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 seg_grid((unsigned)((S + kReduceWarps - 1) / kReduceWarps), gy);
  reduce_kernel<<<seg_grid, kReduceWarps * 32, 0, stream>>>(data, nb, E, S, D, offsets,
                                                          perm, sorted, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// data (b, E, D) f32, ids (b, E) int64; counts (b, S) int32 zeroed by the
// caller; offsets (b, S + 1), perm and sorted (b, E) int32 scratch; out
// (b, S, D) f32, every element written.
int segment_sum_launch_i64(const void* data, const void* ids, int b, long long E,
                           long long S, int D, void* counts, void* offsets, void* perm,
                           void* sorted, void* out, void* stream) {
  return launch<long long>(static_cast<const float*>(data),
                           static_cast<const long long*>(ids), b, E, S, D,
                           static_cast<int*>(counts), static_cast<int*>(offsets),
                           static_cast<int*>(perm), static_cast<int*>(sorted),
                           static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

// The same with int32 ids.
int segment_sum_launch_i32(const void* data, const void* ids, int b, long long E,
                           long long S, int D, void* counts, void* offsets, void* perm,
                           void* sorted, void* out, void* stream) {
  return launch<int>(static_cast<const float*>(data), static_cast<const int*>(ids), b,
                     E, S, D, static_cast<int*>(counts), static_cast<int*>(offsets),
                     static_cast<int*>(perm), static_cast<int*>(sorted),
                     static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

}  // extern "C"
