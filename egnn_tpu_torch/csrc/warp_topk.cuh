// A warp's running top-k list in registers, shared by the selection kernels
// (knn_select_large.cu, grid_knn.cu).
//
// The warp keeps ONE ascending list of its k best packed 64-bit values,
// entry e in lane e % 32, slot e / 32, and the k-th value tau in every lane.
// Each lane offers one value a step; a ballot finds the lanes whose value
// beats tau, and each such value is inserted by the whole warp: its position
// is a popcount of a ballot, the shift is one shuffle a slot. Packed values
// are distinct (their low word is a column or a node id), so any insertion
// order ends in the same list. A row of N candidates in random order inserts
// about k * ln(N / k) times in all.
//
// merge and merge_list take many values at once: a batch of one value a
// lane, or a whole sorted list of another warp. The K = 32 * kSlots smallest
// of the list and the batch, element by element min(list[e], batch[K-1-e])
// with the batch ascending and padded with kEmpty, form a bitonic sequence,
// which a bitonic merge sorts (log2 K compare-exchange stages, the first
// log2 kSlots in registers, the last five across lanes). Sorting a batch of
// 32 costs 15 more stages: some 42 shuffles a batch in all at one slot,
// against about 6 a value offered one at a time. Any order of batches ends
// in the same list, for the same reason as offer's.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_topk {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;  // above every packed value

// f32 bits -> unsigned with the same order (negative values included)
__device__ __forceinline__ unsigned ordered_bits(float v) {
  const unsigned b = __float_as_uint(v);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ unsigned float_bits_of_ordered(unsigned u) {
  return u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu);
}

// kSlots: list entries a lane holds, ceil(k / 32). The list starts as
// kEmpty in every entry and in tau.
template <int kSlots>
struct List {
  unsigned long long entry[kSlots];  // entry[s] is list element s * 32 + lane
  unsigned long long tau;            // list element k - 1, the same in every lane
  int tau_slot, tau_lane, lane;

  __device__ __forceinline__ void init(int k, int lane_) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) entry[s] = kEmpty;
    tau = kEmpty;
    tau_slot = (k - 1) >> 5;
    tau_lane = (k - 1) & 31;
    lane = lane_;
  }

  // Every lane of the warp calls this together, each with its own value
  // (kEmpty for none).
  __device__ __forceinline__ void offer(unsigned long long p) {
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

  // Every lane of the warp calls this together, each with one value of the
  // batch (kEmpty for none).
  __device__ __forceinline__ void merge(unsigned long long v) {
    // the batch sorted descending across the lanes (bitonic sort)
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
      for (int d = size >> 1; d > 0; d >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, v, d);
        v = (((lane & d) == 0) == ((lane & size) != 0)) ? umin(v, o) : umax(v, o);
      }
    }
    unsigned long long m[kSlots];  // the batch ascending is element 31 - lane of slot 0
#pragma unroll
    for (int s = 0; s < kSlots; ++s) m[s] = entry[s];
    m[kSlots - 1] = umin(m[kSlots - 1], v);
    settle(m);
  }

  // Every lane calls this together; `other` holds another ascending list of
  // 32 * kSlots values, element e at other[e] (shared memory).
  __device__ __forceinline__ void merge_list(const unsigned long long* other) {
    unsigned long long m[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) m[s] = umin(entry[s], other[(kSlots - s) * 32 - 1 - lane]);
    settle(m);
  }

 private:
  static __device__ __forceinline__ unsigned long long umin(unsigned long long a,
                                                            unsigned long long b) {
    return a < b ? a : b;
  }
  static __device__ __forceinline__ unsigned long long umax(unsigned long long a,
                                                            unsigned long long b) {
    return a < b ? b : a;
  }

  // m, a bitonic sequence of 32 * kSlots values (element s * 32 + lane in
  // m[s]), sorted ascending into the list; then tau.
  __device__ __forceinline__ void settle(unsigned long long (&m)[kSlots]) {
#pragma unroll
    for (int ds = kSlots >> 1; ds > 0; ds >>= 1) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if ((s & ds) == 0) {
          const unsigned long long lo = umin(m[s], m[s + ds]), hi = umax(m[s], m[s + ds]);
          m[s] = lo;
          m[s + ds] = hi;
        }
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const unsigned long long o = __shfl_xor_sync(kFull, m[s], d);
        m[s] = (lane & d) == 0 ? umin(m[s], o) : umax(m[s], o);
      }
    }
    unsigned long long last = m[0];  // m[tau_slot], kept in registers
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      entry[s] = m[s];
      if (s == tau_slot) last = m[s];
    }
    tau = __shfl_sync(kFull, last, tau_lane);
  }
};

}  // namespace warp_topk
