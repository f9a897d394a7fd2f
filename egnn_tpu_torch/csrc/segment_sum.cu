// Order-free segment sum for Hopper (sm_90a). Plain C interface, loaded with
// ctypes (egnn_tpu_torch/ops/cuda/build.py, egnn_tpu_torch/ops/cuda/segment.py).
//
// Replaces the TPU kernel
//   K2 egnn_tpu/ops/pallas/segment.py:segment_sum_pallas (_seg_kernel)
// which computes, for every graph b of a batch,
//   out[b, s, :] = sum of data[b, e, :] over the edges e with ids[b, e] == s
// for ids in any order; an id < 0 or >= S adds nothing, and an empty
// segment is 0. It is the backward of the kNN gather (K1) and of
// gather_nodes, and K11b's j-side sum: pair rows scatter-added into nodes.
//
// Arithmetic: order-free fixed point, bitwise equal to its model
// segment_sum_fixed_point (ops/cuda/segment.py). For each (segment s,
// column c) with deg edges:
//   e_max = the largest biased exponent field of the finite x (a zero or a
//           denormal counts as 1, i.e. as 2^-126), an integer max;
//   H     = 62 - bitlen(deg), u = 2^(e_max - 127 + 1 - H);
//   q_e   = x_e / u rounded half to even to an int64 (x_e / u is exact
//           where it matters: quantize), 0 for a NaN or an infinity;
//   out   = float(double(sum of q_e) * u), each step rounded to nearest.
// |x| < 2^(e_max - 126) = 2^H u, so |q_e| <= 2^H and the sum of deg terms
// stays below 2^62: no int64 overflow. Integer addition is associative, so
// every order and every split of a segment gives the same bits, and nothing
// of the CSR's arbitrary order inside a segment reaches the result. A NaN,
// or both infinities, in (s, c) give NaN; one kind of infinity gives it.
// Error: each q_e is off by at most u / 2 <= 2^-H max|x| (a denormal and a
// segment of one edge are exact), H >= 31 for deg < 2^31, and the two final
// roundings add 2^-24 (1 + 2^-29) of the result: in all at most
// (deg 2^-31 + 2^-24 (1 + 2^-29)) sum|x| <= deg 2^-23 sum|x| for deg >= 1,
// and at most deg 2^-24 sum|x| for deg >= 2, half a sequential f32 sum's
// worst case.
//
// Launches, all on the caller's stream, none reading back to the host:
//   0. memset: the segment counts and the scan's tile status to 0;
//   1. count:  one thread per edge; the lanes of a warp that share an id
//              (__match_any_sync) add their number with one integer atomicAdd,
//              which also gives each edge its slot in the segment (in
//              arbitrary order);
//   2. scan:   a decoupled look-back scan over tiles of 2048 segments, in
//              one pass: offsets[b, 0..S] (a CSR row pointer) and, for each
//              hub (deg > kChunk), its first entry in the work list of hub
//              chunks of kChunk rows; the block zeroes its hubs' scratch;
//   3. place:  one thread per edge writes e into perm[b, offsets[id] + slot];
//              the edge in row c * kChunk of a hub enters chunk c (c >= 1)
//              in the work list;
//   4. hub max: one warp per hub chunk, its rows staged in shared memory
//              (cp.async), lanes over columns: e_max by integer atomicMax,
//              the non-finite flags by atomicOr;
//   5. reduce: one block per kWarps short segments (deg <= kChunk): their
//              rows staged in shared memory, one warp a segment, one lane a
//              column (short_segments); and one warp per hub chunk, staged
//              in shared memory the same way (cp.async), which adds its int64 partials into acc with
//              atomicAdd, the chunk that arrives last (an integer counter,
//              after __threadfence) writing the row.
// Each stage reads its inputs in one round trip to memory: at these sizes
// the kernels wait on latency, not on bandwidth.
// No float atomics; integer atomics give the same counts, offsets, maxima
// and sums on every run.
//
// Bound on the H100: at the train step's shape (b = 1, E = n*k = 8192,
// S = 1024, D = 36) each input read once and the output written once is
// 1.39 MB, 0.42 us at 3.35 TB/s; the adds are negligible, so it is bound by
// bytes. Five launches and a memset cost more than that at this size; at
// path C's (E = 2^20, S = 65536, D = 35) the data read once in the reduce
// dominates, the scratch (counts, offsets, perm) is small beside it.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kEdgeThreads = 256;   // count and place
constexpr int kScanThreads = 256;   // a scan tile: kScanThreads * kScanItems segments
constexpr int kScanItems = 8;
constexpr long long kScanTile = kScanThreads * kScanItems;
constexpr int kWarps = 8;           // warps a block of the hub max and the reduce
constexpr int kChunk = 32;          // rows a warp takes: one a lane
constexpr int kSlab = 40;           // columns staged in shared memory at once (<= 64)
constexpr long long kHubBlocks = 264;   // the hub parts' grid at most: 2 blocks an SM
constexpr int kMaxGridY = 65535;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNaN = 1, kPosInf = 2, kNegInf = 4;
// a scan status word: a flag in bits 62-63 over (hub chunks << 31 | deg);
// both totals stay below 2^31, so neither field carries into the next
constexpr unsigned long long kAggregate = 1ull << 62, kInclusive = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1, kLow31 = (1ull << 31) - 1;

// Scratch, carved from one buffer (segment_sum_scratch_bytes):
//   work     (b, W)    int4    (segment, first row, deg, chunk) of each hub
//                              chunk, W = E/16 + 1
//   acc      (b, S, D) int64   a hub's partial sums
//   status   (b, T)    uint64  the scan's tile status, T tiles    } zeroed by
//   counts   (b, S)    int32   edges a segment                    } the
//   ticket   (b)       int32   the scan's next tile               } memset
//   emax     (b, S, D) int32   a hub's e_max
//   flags    (b, S, D) int32   a hub's non-finite flags
//   arrive   (b, S)    int32   a hub's chunks done
//   offsets  (b, S+1)  int32
//   first    (b, S)    int32   a hub's first chunk in the work list
//   slot     (b, E)    int32   an edge's row in its segment
//   perm     (b, E)    int32
//   nwork    (b)       int32   hub chunks
struct Scratch {
  int4* work;
  unsigned long long *acc, *status;
  int *counts, *ticket, *emax, *flags, *arrive, *offsets, *first, *slot, *perm, *nwork;
};

// A hub has deg >= kChunk + 1 rows in ceil(deg / kChunk) chunks, fewer than
// deg / 32 + deg / 33 < deg / 16 of them.
__host__ __device__ long long work_capacity(long long E) { return E / 16 + 1; }
__host__ __device__ long long scan_tiles(long long S) {
  return (S + kScanTile - 1) / kScanTile;
}

long long scratch_bytes(int nb, long long E, long long S, int D) {
  const long long sd = (long long)nb * S * D;
  return 16 * nb * work_capacity(E) + 8 * (sd + nb * scan_tiles(S)) +
         4 * (2 * sd + 3 * (long long)nb * S + nb * (S + 1) + 2 * nb * E + 2 * nb);
}

Scratch carve(void* base, int nb, long long E, long long S, int D) {
  const size_t sd = (size_t)nb * S * D;
  Scratch t;
  t.work = static_cast<int4*>(base);
  t.acc = reinterpret_cast<unsigned long long*>(t.work + (size_t)nb * work_capacity(E));
  t.status = t.acc + sd;
  int* p = reinterpret_cast<int*>(t.status + (size_t)nb * scan_tiles(S));
  t.counts = p;    p += (size_t)nb * S;
  t.ticket = p;    p += nb;
  t.emax = p;      p += sd;
  t.flags = p;     p += sd;
  t.arrive = p;    p += (size_t)nb * S;
  t.offsets = p;   p += (size_t)nb * (S + 1);
  t.first = p;     p += (size_t)nb * S;
  t.slot = p;      p += (size_t)nb * E;
  t.perm = p;      p += (size_t)nb * E;
  t.nwork = p;
  return t;
}

__device__ __forceinline__ int bit_length(int x) { return 32 - __clz(x); }

__device__ __forceinline__ double pow2(int k) {  // k in [-1022, 1023]
  return __longlong_as_double((long long)(k + 1023) << 52);
}

// The biased exponent field of x with 0 for a zero or a denormal raised to
// 1; a NaN or an infinity sets its flag and leaves `ebits` as it was.
__device__ __forceinline__ void classify(float x, int& ebits, int& fl) {
  const unsigned bits = __float_as_uint(x);
  const int ex = (bits >> 23) & 0xff;
  if (ex == 0xff)
    fl |= (bits & 0x7fffffu) ? kNaN : ((bits >> 31) ? kNegInf : kPosInf);
  else
    ebits = max(ebits, ex);
}

// 1 / u = 2^k with k = h - 1 - (ebits - 127) in [-97, 186], as two float
// factors: 2^min(k, 127) and 2^max(k - 127, 0).
struct Scale {
  float lo, hi;
};

__device__ __forceinline__ float pow2f(int k) {  // k in [-126, 127]
  return __int_as_float((k + 127) << 23);
}

__device__ __forceinline__ Scale inverse_unit(int ebits, int h) {
  const int k = h - 1 - (ebits - 127);
  return {pow2f(min(k, 127)), pow2f(max(k - 127, 0))};
}

// q_e = x / u rounded half to even, 0 for a NaN or an infinity. The float
// products are exact: |x / u| < 2^h, and where x / u falls below 2^-126 it
// rounds to 0 either way; so this is the model's double product and rounding.
__device__ __forceinline__ long long quantize(float x, Scale k) {
  if (((__float_as_uint(x) >> 23) & 0xff) == 0xff) return 0;
  return __float2ll_rn(__fmul_rn(__fmul_rn(x, k.lo), k.hi));
}

__device__ __forceinline__ float finish(long long sum, int ebits, int h, int fl) {
  if (fl) {
    if ((fl & kNaN) || ((fl & kPosInf) && (fl & kNegInf))) return __uint_as_float(0x7fc00000u);
    return (fl & kPosInf) ? __uint_as_float(0x7f800000u) : __uint_as_float(0xff800000u);
  }
  return __double2float_rn(__dmul_rn(__ll2double_rn(sum), pow2(ebits - 127 + 1 - h)));
}

template <typename Id>
__global__ void count_kernel(const Id* __restrict__ ids, int nb, long long E,
                             long long S, Scratch t) {
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const long long id = e < E ? (long long)ids[(size_t)b * E + e] : -1;
    const bool valid = id >= 0 && id < S;
    // a hub's edges come in runs: the lanes of one id add once
    const unsigned peers = __match_any_sync(kFull, valid ? id : -1ll - lane);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (valid && lane == leader) base = atomicAdd(&t.counts[(size_t)b * S + id], __popc(peers));
    base = __shfl_sync(kFull, base, leader);
    if (valid) t.slot[(size_t)b * E + e] = base + __popc(peers & ((1u << lane) - 1u));
  }
}

// Exclusive scan of (hub chunks << 31 | deg) over the graph's segments, one
// tile a block, tiles taken in the order of a ticket so that a block waits
// only on tiles whose blocks already run (decoupled look-back).
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int nb, long long E, long long S, int D, Scratch t) {
  __shared__ unsigned long long warp_sums[kScanThreads / 32];
  __shared__ unsigned long long tile_prefix;
  __shared__ long long tile_sh;
  __shared__ int hubs[kScanTile], nhubs;  // the tile's hubs, for zeroing their scratch
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ntiles = scan_tiles(S);
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    if (threadIdx.x == 0) {
      tile_sh = ntiles == 1 ? 0 : atomicAdd(&t.ticket[b], 1);
      nhubs = 0;
    }
    __syncthreads();
    const long long tile = tile_sh;
    const long long s0 = tile * kScanTile + (long long)threadIdx.x * kScanItems;
    const int* cnt = t.counts + (size_t)b * S;
    unsigned long long v[kScanItems];
    unsigned long long mine = 0;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const long long deg = s0 + i < S ? cnt[s0 + i] : 0;
      const long long chunks = deg > kChunk ? (deg + kChunk - 1) / kChunk : 0;
      v[i] = ((unsigned long long)chunks << 31) | (unsigned long long)deg;
      mine += v[i];
    }
    unsigned long long x = mine;  // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      unsigned long long w = lane < kScanThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, w, d);
        if (lane >= d) w += y;
      }
      if (lane < kScanThreads / 32) warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned long long total = warp_sums[kScanThreads / 32 - 1];
      volatile unsigned long long* status = t.status + (size_t)b * ntiles;
      unsigned long long prefix = 0;
      if (tile > 0) {
        status[tile] = kAggregate | total;
        for (long long p = tile - 1;; --p) {
          unsigned long long st;
          do st = status[p]; while (st == 0);
          prefix += st & kValue;
          if (st & kInclusive) break;
        }
      }
      status[tile] = kInclusive | (prefix + total);
      tile_prefix = prefix;
      if (tile == ntiles - 1) {
        t.offsets[(size_t)b * (S + 1) + S] = (int)((prefix + total) & kLow31);
        t.nwork[b] = (int)((prefix + total) >> 31);
      }
    }
    __syncthreads();
    unsigned long long run = tile_prefix + (warp > 0 ? warp_sums[warp - 1] : 0) + x - mine;
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) {
      const long long s = s0 + i;
      if (s < S) {
        t.offsets[(size_t)b * (S + 1) + s] = (int)(run & kLow31);
        if ((v[i] & kLow31) > (unsigned long long)kChunk) {
          const int f = (int)(run >> 31);
          t.first[(size_t)b * S + s] = f;
          t.work[(size_t)b * work_capacity(E) + f] =
              make_int4((int)s, (int)(run & kLow31), (int)(v[i] & kLow31), 0);
          hubs[atomicAdd(&nhubs, 1)] = (int)s;
        }
      }
      run += v[i];
    }
    __syncthreads();
    for (long long i = threadIdx.x; i < (long long)nhubs * D; i += kScanThreads) {
      const long long s = hubs[i / D];
      const size_t at = ((size_t)b * S + s) * D + i % D;
      t.acc[at] = 0ull;
      t.emax[at] = 0;
      t.flags[at] = 0;
      if (i % D == 0) t.arrive[(size_t)b * S + s] = 0;
    }
    __syncthreads();  // the shared words are rewritten for the next graph
  }
}

template <typename Id>
__global__ void place_kernel(const Id* __restrict__ ids, int nb, long long E, long long S,
                             Scratch t) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const long long id = (long long)ids[(size_t)b * E + e];
    if (id < 0 || id >= S) continue;
    const int slot = t.slot[(size_t)b * E + e];
    const int* off = t.offsets + (size_t)b * (S + 1);
    const int beg = off[id];
    t.perm[(size_t)b * E + beg + slot] = (int)e;
    // the edge in row c * kChunk of a hub enters chunk c; the scan entered c = 0
    if (slot > 0 && slot % kChunk == 0) {
      const int deg = off[id + 1] - beg;
      if (deg > kChunk)
        t.work[(size_t)b * work_capacity(E) + t.first[(size_t)b * S + id] + slot / kChunk] =
            make_int4((int)id, beg, deg, slot / kChunk);
    }
  }
}

// Rows staged in shared memory, kSlab columns at a time: kWarps * kChunk
// rows of a block, or kChunk rows of each warp's hub chunk.
struct Stage {
  float (*rows)[kSlab + 1];  // odd stride: a warp reads a column without conflicts
  int* perm;                 // the edge of each staged row
};

// Columns [c0, c0 + cw) of the staged rows [0, nrows) into `st`, by the
// threads [first, first + count) of the block, in flight all at once.
__device__ __forceinline__ void stage_columns(const Stage& st, const float* __restrict__ db,
                                              int D, int nrows, int c0, int cw, int first,
                                              int count) {
  for (int i = (int)threadIdx.x - first; i < nrows * cw; i += count) {
    const int r = i / cw, c = i - r * cw;
    __pipeline_memcpy_async(&st.rows[r][c], db + (size_t)st.perm[r] * D + c0 + c,
                            sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// kWarps consecutive segments a block, those of at most kChunk rows (a
// hub's rows go to its chunks): the block reads their offsets, then the perm
// entries of their rows, then their rows, all at once into shared memory;
// warp g then takes segment g, lane c column c: e_max, the int64 sum and
// the row from shared memory. Three round trips to memory for kWarps
// segments (and one more for each kSlab columns beyond the first).
__device__ __forceinline__ void short_segments(const Stage& st, const float* __restrict__ db,
                                               int b, long long E, long long S, int D,
                                               long long s0, const Scratch& t,
                                               float* __restrict__ out) {
  __shared__ int tbeg[kWarps], tdeg[kWarps], toff[kWarps + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    const int* off = t.offsets + (size_t)b * (S + 1);
    const int o = lane <= kWarps && s0 + lane <= S ? off[s0 + lane] : 0;
    const int o1 = __shfl_down_sync(kFull, o, 1);
    const int deg = lane < kWarps && s0 + lane < S ? o1 - o : 0;
    const int rows = deg <= kChunk ? deg : 0;
    int x = rows;  // inclusive scan of the rows over lanes 0 .. kWarps - 1
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane < kWarps) {
      tbeg[lane] = o;
      tdeg[lane] = deg;
      toff[lane] = x - rows;
    }
    if (lane == kWarps - 1) toff[kWarps] = x;
  }
  __syncthreads();
  const int nrows = toff[kWarps];
  if ((int)threadIdx.x < nrows) {
    int g = 0;
    while (toff[g + 1] <= (int)threadIdx.x) ++g;
    st.perm[threadIdx.x] = t.perm[(size_t)b * E + tbeg[g] + threadIdx.x - toff[g]];
  }
  __syncthreads();
  const long long s = s0 + warp;
  const int deg = tdeg[warp];
  const bool mine = s < S && deg <= kChunk;
  const int h = 62 - bit_length(max(deg, 1));
  for (int c0 = 0; c0 < D; c0 += kSlab) {
    const int cw = min(kSlab, D - c0);
    stage_columns(st, db, D, nrows, c0, cw, 0, kWarps * 32);
    __syncthreads();
    for (int c = lane; mine && c < cw; c += 32) {
      int ebits = 1, fl = 0;
      for (int r = 0; r < deg; ++r) classify(st.rows[toff[warp] + r][c], ebits, fl);
      const Scale k = inverse_unit(ebits, h);
      long long sum = 0;
      for (int r = 0; r < deg; ++r) sum += quantize(st.rows[toff[warp] + r][c], k);
      out[((size_t)b * S + s) * D + c0 + c] = finish(sum, ebits, h, fl);
    }
    __syncthreads();  // the rows are restaged for the next columns
  }
}

// Hub chunk j of graph b, taken by one warp: its rows' perm entries go into
// the warp's stage.
struct HubChunk {
  long long s;
  int deg, rows;
};

__device__ __forceinline__ HubChunk hub_chunk(const Stage& st, const Scratch& t, int b,
                                              long long E, long long j, int lane) {
  const int4 item = t.work[(size_t)b * work_capacity(E) + j];
  HubChunk c;
  c.s = item.x;
  c.deg = item.z;
  const int r0 = item.w * kChunk;
  c.rows = min(kChunk, c.deg - r0);
  __syncwarp();  // the stage's last use is done
  if (lane < c.rows) st.perm[lane] = t.perm[(size_t)b * E + item.y + r0 + lane];
  __syncwarp();
  return c;
}

__device__ __forceinline__ Stage warp_stage(float (*rows)[kSlab + 1], int* perm) {
  const int warp = threadIdx.x >> 5;
  return {rows + warp * kChunk, perm + warp * kChunk};
}

__global__ void __launch_bounds__(kWarps * 32)
hub_max_kernel(const float* __restrict__ data, int nb, long long E, long long S, int D,
               Scratch t) {
  __shared__ float rows[kWarps * kChunk][kSlab + 1];
  __shared__ int perm[kWarps * kChunk];
  const int lane = threadIdx.x & 31;
  const Stage st = warp_stage(rows, perm);
  const long long w0 = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* db = data + (size_t)b * E * D;
    const int nwork = t.nwork[b];
    for (long long j = w0; j < nwork; j += (long long)gridDim.x * kWarps) {
      const HubChunk c = hub_chunk(st, t, b, E, j, lane);
      const size_t row = ((size_t)b * S + c.s) * D;
      for (int c0 = 0; c0 < D; c0 += kSlab) {
        const int cw = min(kSlab, D - c0);
        stage_columns(st, db, D, c.rows, c0, cw, (threadIdx.x >> 5) * 32, 32);
        __syncwarp();
        for (int col = lane; col < cw; col += 32) {
          int ebits = 1, fl = 0;
          for (int r = 0; r < c.rows; ++r) classify(st.rows[r][col], ebits, fl);
          if (fl) atomicOr(&t.flags[row + c0 + col], fl);
          if (ebits > 1) atomicMax(&t.emax[row + c0 + col], ebits);
        }
        __syncwarp();
      }
    }
  }
}

// five blocks an SM: shared memory allows them, and their loads hide each other's
__global__ void __launch_bounds__(kWarps * 32, 5)
reduce_kernel(const float* __restrict__ data, int nb, long long E, long long S, int D,
              long long seg_blocks, Scratch t, float* __restrict__ out) {
  __shared__ float rows[kWarps * kChunk][kSlab + 1];
  __shared__ int perm[kWarps * kChunk];
  const int lane = threadIdx.x & 31;
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* db = data + (size_t)b * E * D;
    if (blockIdx.x < seg_blocks) {
      short_segments({rows, perm}, db, b, E, S, D, (long long)blockIdx.x * kWarps, t, out);
      continue;
    }
    const Stage st = warp_stage(rows, perm);
    const long long w0 = (blockIdx.x - seg_blocks) * kWarps + (threadIdx.x >> 5);
    const long long stride = (gridDim.x - seg_blocks) * kWarps;
    const int nwork = t.nwork[b];
    for (long long j = w0; j < nwork; j += stride) {  // one hub chunk a warp
      const HubChunk c = hub_chunk(st, t, b, E, j, lane);
      const int h = 62 - bit_length(c.deg);
      const size_t row = ((size_t)b * S + c.s) * D;
      for (int c0 = 0; c0 < D; c0 += kSlab) {
        const int cw = min(kSlab, D - c0);
        int ebits[2];  // read before the rows arrive: kSlab <= 64 columns, two a lane
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ebits[i] = lane + 32 * i < cw ? __ldcg(&t.emax[row + c0 + lane + 32 * i]) : 1;
        stage_columns(st, db, D, c.rows, c0, cw, (threadIdx.x >> 5) * 32, 32);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int col = lane + 32 * i;
          if (col >= cw) continue;
          const Scale k = inverse_unit(max(1, ebits[i]), h);
          long long sum = 0;
          for (int r = 0; r < c.rows; ++r) sum += quantize(st.rows[r][col], k);
          if (sum != 0) atomicAdd(&t.acc[row + c0 + col], (unsigned long long)sum);
        }
        __syncwarp();
      }
      __threadfence();  // this chunk's sums are visible before it counts itself
      int last = 0;
      if (lane == 0)
        last = atomicAdd(&t.arrive[(size_t)b * S + c.s], 1) ==
               (c.deg + kChunk - 1) / kChunk - 1;
      if (!__shfl_sync(kFull, last, 0)) continue;
      __threadfence();
      for (int col = lane; col < D; col += 32)
        out[row + col] = finish((long long)__ldcg(&t.acc[row + col]),
                                max(1, __ldcg(&t.emax[row + col])), h,
                                __ldcg(&t.flags[row + col]));
    }
  }
}

template <typename Id>
int launch(const float* data, const Id* ids, int nb, long long E, long long S, int D,
           void* scratch, float* out, cudaStream_t stream) {
  if (nb < 1 || E < 1 || E > INT32_MAX || S < 1 || S > INT32_MAX || D < 1)
    return (int)cudaErrorInvalidValue;
  const Scratch t = carve(scratch, nb, E, S, D);
  cudaError_t err = cudaMemsetAsync(
      t.status, 0,
      sizeof(unsigned long long) * nb * scan_tiles(S) + sizeof(int) * ((size_t)nb * S + nb),
      stream);
  if (err != cudaSuccess) return (int)err;
  const unsigned gy = nb < kMaxGridY ? nb : kMaxGridY;
  const dim3 edge_grid((unsigned)((E + kEdgeThreads - 1) / kEdgeThreads), gy);
  count_kernel<Id><<<edge_grid, kEdgeThreads, 0, stream>>>(ids, nb, E, S, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_kernel<<<dim3((unsigned)scan_tiles(S), gy), kScanThreads, 0, stream>>>(nb, E, S, D, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  place_kernel<Id><<<edge_grid, kEdgeThreads, 0, stream>>>(ids, nb, E, S, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  long long hub_blocks = (work_capacity(E) + kWarps - 1) / kWarps;
  if (hub_blocks > kHubBlocks) hub_blocks = kHubBlocks;
  hub_max_kernel<<<dim3((unsigned)hub_blocks, gy), kWarps * 32, 0, stream>>>(data, nb, E, S,
                                                                            D, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long seg_blocks = (S + kWarps - 1) / kWarps;
  reduce_kernel<<<dim3((unsigned)(seg_blocks + hub_blocks), gy), kWarps * 32, 0, stream>>>(
      data, nb, E, S, D, seg_blocks, t, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the scratch buffer a launch with these sizes carves (8-byte
// aligned at its start, contents arbitrary).
long long segment_sum_scratch_bytes(int b, long long E, long long S, int D) {
  return scratch_bytes(b, E, S, D);
}

// data (b, E, D) f32, ids (b, E) int64; scratch as above; out (b, S, D) f32,
// every element written.
int segment_sum_launch_i64(const void* data, const void* ids, int b, long long E,
                           long long S, int D, void* scratch, void* out, void* stream) {
  return launch<long long>(static_cast<const float*>(data),
                           static_cast<const long long*>(ids), b, E, S, D, scratch,
                           static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

// The same with int32 ids.
int segment_sum_launch_i32(const void* data, const void* ids, int b, long long E,
                           long long S, int D, void* scratch, void* out, void* stream) {
  return launch<int>(static_cast<const float*>(data), static_cast<const int*>(ids), b, E,
                     S, D, scratch, static_cast<float*>(out),
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
