// kNN selection at any n for Hopper (sm_90a): the exact j-tiled selection
// and the packed-key candidates. Plain C interface, loaded with ctypes
// (egnn_tpu_torch/ops/cuda/build.py, egnn_tpu_torch/ops/cuda/knn.py).
//
// Replaces the TPU kernels
//   K4 egnn_tpu/ops/pallas/knn.py:knn_select_pallas_tiled (_knn_tiled_kernel)
//   K5 egnn_tpu/ops/pallas/knn.py:knn_candidates_packed_tiled
//      (_knn_packed_tiled_kernel): 20-bit keys, masked pairs at 0x7F800
//   K6 egnn_tpu/ops/pallas/knn.py:knn_candidates_packed
//      (_knn_packed_kernel):       18-bit keys, masked pairs at 0x1FF00
// For every row i and column j, with d = x_i - x_j,
//   r_ij = ((0 + d_0^2) + d_1^2) + ...                       (f32, no FMA)
// K4 ranks by r with the fills of K1 and K3 (csrc/knn_select.cu):
//   r_ij = 1e5 where !(mask_i && mask_j), then with an adjacency
//   r_ij = -1 where j == i and r_ij = 0 where adj_ij && j != i,
// and keeps the k smallest in (r, j) order as vals (f32) and idx.
// K5 and K6 rank by a coarsened key and take no adjacency:
//   key_ij = bits(r_ij) >> kShift   (12 or 14; the bit pattern of a
//                                    non-negative float is monotonic)
//   key_ij = sentinel               where !(mask_i && mask_j)
// and keep the kc smallest in (key, j) order as keys (i32) and cols. Their
// caller re-ranks the candidates exactly and certifies that they cover the
// true top-k (ops/neighbors.py).
//
// What is not carried over. The TPU kernels walk j-tiles as a sequential
// grid axis, park each tile's top-k in an (nj, ti, k) VMEM scratch and merge
// once at the end; K5 and K6 pack a tile-local column beside the key into
// one int32, so that a row minimum is one vector reduction, and restore the
// global order by (tile, slot). Those tile widths and bit budgets (12 + 20,
// 14 + 18, 6 + 5 merge bits) are the vector unit's needs. The order they
// produce is the lexicographic order on (key, global column), which this
// kernel computes directly on one 64-bit integer (key << 32) | j; only the
// key widths are kept, because the keys are part of the result. K4's key is
// the f32 ranking mapped to an order-preserving unsigned integer, so all
// three are one template.
//
// Design. One warp per query row; a block of 8 warps shares a tile of
// coordinates (and mask bits) staged in shared memory; the j-tile grid axis
// is the loop over those tiles. The warp keeps ONE ascending list of its k
// best packed values in registers, entry e in lane e % 32, slot e / 32, and
// the k-th value tau in every lane. Each lane ranks the column tile + lane;
// a ballot finds the lanes whose value beats tau, and each such value is
// inserted by the whole warp: its position is a popcount of a ballot, the
// shift is one shuffle a slot. Packed values are distinct, so any insertion
// order ends in the same list. A row inserts about k * ln(n / k) times in
// all. A list per lane, as K1 and K3 keep at their small n, inserts some 32
// times as often, and at n = 65536 nearly every step has one lane inserting
// while 31 wait: measured on the H100 at n = 65536, kc = 20, 40.2 ms with
// per-lane lists (and a predicated kMaxC-step pair loop) against 6.5 ms.
//
// Bound on the H100: at n = 65536, c = 3 without an adjacency the function
// moves under 20 MB (0.005 ms at 3.35 TB/s) and does n^2 * (3c + 3) = 5.2e10
// f32 operations (0.77 ms at 67 TFLOP/s): bound by operations. With a
// 32768^2 adjacency its 1 GiB of bytes (0.32 ms) is the larger bound. So the
// pair loop is kept short (c = 3 is its own instantiation, without the
// predicated kMaxC-step loop) and a lane's adjacency bytes of a tile are
// loaded together ahead of the loop. Each lane still ranks one pair a step
// and re-reads the coordinate tile from shared memory for every row; nothing
// is held across rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;   // columns staged per shared-memory tile
constexpr int kWarps = 8;    // query rows per block
constexpr int kMaxC = 16;    // largest coordinate dimension handled
constexpr int kMaxK = 128;   // longest list: 4 slots a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;  // above every (key, j)

// f32 bits -> unsigned with the same order (negative values included)
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned b = __float_as_uint(v);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ unsigned float_bits_of_ordered(unsigned u) {
  return u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu);
}

// kShift == 0: K4 (exact ranking, fills, adjacency); 12: K5; 14: K6.
// kSlots: list entries a lane holds, ceil(k / 32).
// kC: the coordinate dimension when it is 3, else 0: any c <= kMaxC through
// a predicated loop, which issues all kMaxC steps for every pair.
template <int kShift, int kSlots, int kC>
__global__ void __launch_bounds__(kWarps * 32) knn_select_large_kernel(
    const float* __restrict__ coors,        // (b, n, c)
    const unsigned char* __restrict__ mask, // (b, n) or null
    const unsigned char* __restrict__ adj,  // rows of n bytes, or null (K4 only)
    long long adj_bstride,                  // 0 when one (n, n) is shared
    int n, int c, int k, unsigned sentinel,
    unsigned* __restrict__ out_hi,          // (b, n, k): vals f32 bits, or keys
    long long* __restrict__ out_idx) {      // (b, n, k)
  extern __shared__ float smem[];
  float* tile_x = smem;               // kTile * c
  float* tile_m = smem + kTile * c;   // kTile
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int i = blockIdx.x * kWarps + warp;
  const bool row_ok = i < n;

  const float* cb = coors + (size_t)b * n * c;
  constexpr int kDims = kC > 0 ? kC : kMaxC;
  float xi[kDims];
#pragma unroll
  for (int cc = 0; cc < kDims; ++cc) xi[cc] = (row_ok && cc < c) ? cb[(size_t)i * c + cc] : 0.f;
  const bool has_mask = mask != nullptr;
  const bool has_adj = kShift == 0 && adj != nullptr;
  const bool mask_i = has_mask && row_ok && mask[(size_t)b * n + i] != 0;
  const unsigned char* adj_row =
      has_adj && row_ok ? adj + (size_t)b * adj_bstride + (size_t)i * n : nullptr;

  unsigned long long entry[kSlots];  // entry[s] is list element s * 32 + lane
#pragma unroll
  for (int s = 0; s < kSlots; ++s) entry[s] = kEmpty;
  unsigned long long tau = kEmpty;   // list element k - 1, the same in every lane
  const int tau_slot = (k - 1) >> 5, tau_lane = (k - 1) & 31;
  const int stride = kC > 0 ? kC : c;  // floats a staged column takes

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
    // this lane's adjacency bytes of the tile, one bit a step, all loaded
    // up front so that their latencies overlap
    unsigned adj_bits = 0;
    if (has_adj) {
#pragma unroll
      for (int step = 0; step < kTile / 32; ++step) {
        const int t = step * 32 + lane;
        if (t < span && adj_row[j0 + t] != 0) adj_bits |= 1u << step;
      }
    }
    for (int t0 = 0; t0 < span; t0 += 32) {  // the whole warp takes every step
      const int t = t0 + lane;
      const int j = j0 + t;
      unsigned long long p = kEmpty;
      if (t < span) {
        float r = 0.f;
#pragma unroll
        for (int cc = 0; cc < kDims; ++cc) {
          if (kC > 0 || cc < c) {
            const float d = __fsub_rn(xi[cc], tile_x[t * stride + cc]);
            r = __fadd_rn(r, __fmul_rn(d, d));
          }
        }
        const bool masked = has_mask && !(mask_i && tile_m[t] != 0.f);
        unsigned hi;
        if (kShift == 0) {
          if (masked) r = 1e5f;
          if (has_adj) {
            if (j == i) r = -1.f;
            else if ((adj_bits >> (t0 >> 5)) & 1u) r = 0.f;
          }
          hi = ordered_bits(r);
        } else {
          hi = masked ? sentinel : (__float_as_uint(r) >> kShift);
        }
        p = ((unsigned long long)hi << 32) | (unsigned long long)(unsigned)j;
      }
      unsigned want = __ballot_sync(kFull, p < tau);
      while (want) {
        const int src = __ffs(want) - 1;
        want &= want - 1;
        const unsigned long long cand = __shfl_sync(kFull, p, src);
        if (cand >= tau) continue;  // tau fell since the ballot; uniform
        int pos = 0;                // list elements below cand
#pragma unroll
        for (int s = 0; s < kSlots; ++s) pos += __popc(__ballot_sync(kFull, entry[s] < cand));
#pragma unroll
        for (int s = kSlots - 1; s >= 0; --s) {
          // element e - 1: the lane below, or lane 31 of the slot below
          unsigned long long below = __shfl_up_sync(kFull, entry[s], 1);
          if (s > 0) {
            const unsigned long long wrap = __shfl_sync(kFull, entry[s - 1], 31);
            if (lane == 0) below = wrap;
          }
          const int e = s * 32 + lane;
          entry[s] = e < pos ? entry[s] : (e == pos ? cand : below);
        }
        unsigned long long last = entry[0];  // entry[tau_slot], kept in registers
#pragma unroll
        for (int s = 1; s < kSlots; ++s)
          if (s == tau_slot) last = entry[s];
        tau = __shfl_sync(kFull, last, tau_lane);
      }
    }
  }
  if (!row_ok) return;  // whole warp: no block barrier follows

  const size_t row = (size_t)b * n + i;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int e = s * 32 + lane;
    if (e < k) {
      const unsigned hi = (unsigned)(entry[s] >> 32);
      out_hi[row * k + e] = kShift == 0 ? float_bits_of_ordered(hi) : hi;
      out_idx[row * k + e] = (long long)(entry[s] & 0xffffffffull);
    }
  }
}

template <int kShift>
int launch(const float* coors, const unsigned char* mask, const unsigned char* adj,
           long long adj_bstride, int b, int n, int c, int k, unsigned sentinel,
           void* out_hi, long long* out_idx, cudaStream_t stream) {
  // k <= n: every list element ends as a real column
  if (b < 1 || n < 1 || c < 1 || c > kMaxC || k < 1 || k > kMaxK || k > n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)kTile * c + kTile);
  const dim3 grid((n + kWarps - 1) / kWarps, b);
  unsigned* hi = static_cast<unsigned*>(out_hi);
#define LAUNCH_LARGE(SLOTS, C)                                                   \
  knn_select_large_kernel<kShift, SLOTS, C><<<grid, kWarps * 32, smem, stream>>>( \
      coors, mask, adj, adj_bstride, n, c, k, sentinel, hi, out_idx)
  if (c == 3) {
    if (k <= 32) LAUNCH_LARGE(1, 3);
    else if (k <= 64) LAUNCH_LARGE(2, 3);
    else LAUNCH_LARGE(4, 3);
  } else {
    if (k <= 32) LAUNCH_LARGE(1, 0);
    else if (k <= 64) LAUNCH_LARGE(2, 0);
    else LAUNCH_LARGE(4, 0);
  }
#undef LAUNCH_LARGE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: exact selection at any n; vals f32 and idx i64. mask and adj may be null.
int knn_select_tiled_launch(const void* coors, const void* mask, const void* adj,
                            long long adj_bstride, int b, int n, int c, int k,
                            void* vals, void* idx, void* stream) {
  return launch<0>(static_cast<const float*>(coors),
                   static_cast<const unsigned char*>(mask),
                   static_cast<const unsigned char*>(adj), adj_bstride, b, n, c, k, 0u,
                   vals, static_cast<long long*>(idx), static_cast<cudaStream_t>(stream));
}

// K5: 20-bit keys (f32 bits >> 12), masked pairs keyed 0x7F800. mask may be null.
int knn_candidates_packed_tiled_launch(const void* coors, const void* mask, int b, int n,
                                       int c, int kc, void* keys, void* cols,
                                       void* stream) {
  return launch<12>(static_cast<const float*>(coors),
                    static_cast<const unsigned char*>(mask), nullptr, 0, b, n, c, kc,
                    0x7F800u, keys, static_cast<long long*>(cols),
                    static_cast<cudaStream_t>(stream));
}

// K6: 18-bit keys (f32 bits >> 14), masked pairs keyed 0x1FF00. mask may be null.
int knn_candidates_packed_launch(const void* coors, const void* mask, int b, int n, int c,
                                 int kc, void* keys, void* cols, void* stream) {
  return launch<14>(static_cast<const float*>(coors),
                    static_cast<const unsigned char*>(mask), nullptr, 0, b, n, c, kc,
                    0x1FF00u, keys, static_cast<long long*>(cols),
                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
