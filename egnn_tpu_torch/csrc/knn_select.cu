// Masked kNN selection, with or without the gather of the winners' payload
// rows, for Hopper (sm_90a). Plain C interface, loaded with ctypes
// (egnn_tpu_torch/ops/cuda/build.py, egnn_tpu_torch/ops/cuda/knn.py).
//
// Replaces the TPU kernels
//   K1 egnn_tpu/ops/pallas/knn.py:knn_select_gather_pallas (_knn_gather_kernel)
//   K3 egnn_tpu/ops/pallas/knn.py:knn_select_pallas        (_knn_kernel)
// which compute, for every row i, the ranking
//   r_ij = ((0 + d_0^2) + d_1^2) + ...,  d = x_i - x_j
//   r_ij = 1e5            where !(mask_i && mask_j)      (mask fill first)
//   r_ij = -1             where j == i                   (with an adjacency)
//   r_ij = 0              where adj_ij && j != i         (with an adjacency)
// and keep the k smallest in (value, j) order: the lowest j wins a tie.
// K1 also copies the payload row table[b, j] of every winner.
//
// Design. One warp per query row; a block of WPB warps shares a tile of
// coordinates (and mask bits) staged in shared memory. Each lane takes the
// columns j = tile + lane, tile + lane + 32, ... and keeps its own sorted
// top-k list in shared memory (slot-major, lane-minor: conflict-free).
// Since a lane sees its columns in ascending j, a strict lexicographic
// (value, j) insert keeps the earlier j first. Then k rounds of a warp
// shuffle argmin on (value, j) over the lanes' list heads merge the 32
// lists; each winner's payload row is copied by the lanes as raw floats.
// The ranking is rounded with __fmul_rn / __fadd_rn, so nvcc contracts
// nothing into an FMA and the values equal the plain PyTorch version's
// bitwise. Columns past n are skipped by a bounds check (no padding).
//
// Bound on the H100: at the serving shape (n = 1024, k = 8, tw = 36) the
// work is ~2.4 MB of memory traffic (adjacency rows, table, output rows)
// and ~13 M f32 operations, so it is bound by bytes. The kernel reads each
// adjacency row once, coalesced; coordinates come from shared memory.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;   // columns staged per shared-memory tile
constexpr int kMaxC = 16;    // largest coordinate dimension handled
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool lex_less(float v, int j, float ov, int oj) {
  return v < ov || (v == ov && j < oj);
}

template <bool kPayload>
__global__ void knn_select_kernel(
    const float* __restrict__ coors,        // (b, n, c)
    const unsigned char* __restrict__ mask, // (b, n) or null
    const unsigned char* __restrict__ adj,  // rows of n bytes, or null
    long long adj_bstride,                  // 0 when one (n, n) is shared
    const float* __restrict__ table,        // (b, n, tw) when kPayload
    int n, int c, int k, int tw,
    float* __restrict__ out_vals,           // (b, n, k)
    long long* __restrict__ out_idx,        // (b, n, k)
    float* __restrict__ out_rows) {         // (b, n, k, tw) when kPayload
  extern __shared__ float smem[];
  const int wpb = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i = blockIdx.x * wpb + warp;
  const bool row_ok = i < n;

  float* tile_x = smem;                           // kTile * c
  float* tile_m = tile_x + kTile * c;             // kTile
  float* list_v = tile_m + kTile + warp * k * 32; // k * 32, this warp's
  int* list_j = reinterpret_cast<int*>(tile_m + kTile + wpb * k * 32) + warp * k * 32;

  for (int s = 0; s < k; ++s) {
    list_v[s * 32 + lane] = CUDART_INF_F;
    list_j[s * 32 + lane] = INT32_MAX;
  }

  const float* cb = coors + (size_t)b * n * c;
  float xi[kMaxC];
#pragma unroll
  for (int cc = 0; cc < kMaxC; ++cc) xi[cc] = (row_ok && cc < c) ? cb[(size_t)i * c + cc] : 0.f;
  const bool has_mask = mask != nullptr;
  const bool has_adj = adj != nullptr;
  const bool mask_i = has_mask && row_ok && mask[(size_t)b * n + i] != 0;
  const unsigned char* adj_row =
      has_adj && row_ok ? adj + (size_t)b * adj_bstride + (size_t)i * n : nullptr;

  float worst_v = CUDART_INF_F;  // this lane's k-th entry
  int worst_j = INT32_MAX;

  for (int j0 = 0; j0 < n; j0 += kTile) {
    __syncthreads();
    const int span = min(kTile, n - j0);
    for (int t = threadIdx.x; t < span * c; t += blockDim.x)
      tile_x[t] = cb[(size_t)j0 * c + t];
    if (has_mask)
      for (int t = threadIdx.x; t < span; t += blockDim.x)
        tile_m[t] = mask[(size_t)b * n + j0 + t] != 0 ? 1.f : 0.f;
    __syncthreads();
    if (!row_ok) continue;
    for (int t = lane; t < span; t += 32) {
      const int j = j0 + t;
      float r = 0.f;
#pragma unroll
      for (int cc = 0; cc < kMaxC; ++cc) {
        if (cc < c) {
          const float d = __fsub_rn(xi[cc], tile_x[t * c + cc]);
          r = __fadd_rn(r, __fmul_rn(d, d));
        }
      }
      if (has_mask && !(mask_i && tile_m[t] != 0.f)) r = 1e5f;
      if (has_adj) {
        if (j == i) r = -1.f;
        else if (adj_row[j] != 0) r = 0.f;
      }
      if (lex_less(r, j, worst_v, worst_j)) {
        int s = k - 1;
        while (s > 0) {
          const float pv = list_v[(s - 1) * 32 + lane];
          const int pj = list_j[(s - 1) * 32 + lane];
          if (!lex_less(r, j, pv, pj)) break;
          list_v[s * 32 + lane] = pv;
          list_j[s * 32 + lane] = pj;
          --s;
        }
        list_v[s * 32 + lane] = r;
        list_j[s * 32 + lane] = j;
        worst_v = list_v[(k - 1) * 32 + lane];
        worst_j = list_j[(k - 1) * 32 + lane];
      }
    }
  }
  if (!row_ok) return;  // whole warp: no block barrier follows

  // k rounds of a lexicographic warp argmin over the lanes' list heads
  const size_t row = (size_t)b * n + i;
  int head = 0;
  for (int r = 0; r < k; ++r) {
    const float hv = head < k ? list_v[head * 32 + lane] : CUDART_INF_F;
    const int hj = head < k ? list_j[head * 32 + lane] : INT32_MAX;
    float bv = hv;
    int bj = hj;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      if (lex_less(ov, oj, bv, bj)) {
        bv = ov;
        bj = oj;
      }
    }
    if (hj == bj) ++head;  // columns are disjoint across lanes: one owner
    if (lane == 0) {
      out_vals[row * k + r] = bv;
      out_idx[row * k + r] = bj;
    }
    if (kPayload) {
      // bj == INT32_MAX only when NaN rankings left fewer than k candidates
      const float* src = table + ((size_t)b * n + min(bj, n - 1)) * tw;
      float* dst = out_rows + (row * k + r) * tw;
      for (int t = lane; t < tw; t += 32) dst[t] = bj < n ? src[t] : 0.f;
    }
  }
}

int warps_per_block(int k) {
  // keeps the per-warp lists (k * 32 * 8 bytes each) at <= 32 KB a block
  return k <= 16 ? 8 : k <= 32 ? 4 : k <= 64 ? 2 : 1;
}

template <bool kPayload>
int launch(const float* coors, const unsigned char* mask,
           const unsigned char* adj, long long adj_bstride,
           const float* table, int b, int n, int c, int k, int tw,
           float* vals, long long* idx, float* rows, cudaStream_t stream) {
  if (b < 1 || n < 1 || c < 1 || c > kMaxC || k < 1 || k > 128 || k > n ||
      (kPayload && tw < 1))
    return (int)cudaErrorInvalidValue;
  const int wpb = warps_per_block(k);
  const size_t smem = sizeof(float) * ((size_t)kTile * c + kTile) +
                      (size_t)wpb * k * 32 * (sizeof(float) + sizeof(int));
  const dim3 grid((n + wpb - 1) / wpb, b);
  knn_select_kernel<kPayload><<<grid, wpb * 32, smem, stream>>>(
      coors, mask, adj, adj_bstride, table, n, c, k, tw, vals, idx, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: selection + payload gather. mask and adj may be null.
int knn_select_gather_launch(const void* coors, const void* mask, const void* adj,
                             long long adj_bstride, const void* table, int b, int n,
                             int c, int k, int tw, void* vals, void* idx, void* rows,
                             void* stream) {
  return launch<true>(static_cast<const float*>(coors),
                      static_cast<const unsigned char*>(mask),
                      static_cast<const unsigned char*>(adj), adj_bstride,
                      static_cast<const float*>(table), b, n, c, k, tw,
                      static_cast<float*>(vals), static_cast<long long*>(idx),
                      static_cast<float*>(rows), static_cast<cudaStream_t>(stream));
}

// K3: selection only. mask and adj may be null.
int knn_select_launch(const void* coors, const void* mask, const void* adj,
                      long long adj_bstride, int b, int n, int c, int k, void* vals,
                      void* idx, void* stream) {
  return launch<false>(static_cast<const float*>(coors),
                       static_cast<const unsigned char*>(mask),
                       static_cast<const unsigned char*>(adj), adj_bstride, nullptr,
                       b, n, c, k, 0, static_cast<float*>(vals),
                       static_cast<long long*>(idx), nullptr,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
