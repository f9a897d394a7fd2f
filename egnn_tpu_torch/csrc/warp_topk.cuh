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
};

}  // namespace warp_topk
