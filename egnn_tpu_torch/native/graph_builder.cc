// Host-side graph builder of egnn_tpu_torch (the port's own copy).
//
// The host role of the reference's external native dependencies
// (torch-cluster's kNN and radius graph construction, torch-scatter's sorted
// edge layouts; examples/egnn_test.ipynb cell 4): real datasets arrive as
// host arrays, and building the graphs and edge layouts of variable-size
// molecule batches is host work that should overlap the card's steps, not
// run as Python loops. The device side is the port's CUDA kernels
// (egnn_tpu_torch/csrc).
//
// Semantics match the builders of egnn_tpu_torch/ops/graph.py bit for bit
// (squared-distance ranking, egnn_pytorch.py:233, 258): ties go to the lower
// index, invalid pairs rank at BIG, padding rows point at node 0 (at the
// owning graph's first node in the batched layout).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC [-fopenmp] graph_builder.cc
// Loaded through ctypes by egnn_tpu_torch/native/__init__.py (a plain C ABI
// below).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double BIG = 1e10;  // matches ops/graph.py's `big` fill

struct Cand {
  double dist;
  int32_t idx;
  bool operator<(const Cand& o) const {
    return dist != o.dist ? dist < o.dist : idx < o.idx;
  }
};

// k-nearest neighbors of node i within [lo, hi) of the packed coordinate
// array, writing k (sender, valid) pairs. Distance = squared Euclidean;
// self excluded unless `loop`; pairs with an unmasked endpoint rank at BIG
// (still emitted, valid=false, sender clamped to `pad_to`), mirroring
// ops/graph.py:48-66.
void knn_row(const double* coors, int c, int32_t i, int32_t lo, int32_t hi,
             int k, const uint8_t* node_mask, bool loop, int32_t pad_to,
             std::vector<Cand>& scratch, int32_t* senders, uint8_t* valid) {
  scratch.clear();
  const double* ci = coors + static_cast<int64_t>(i) * c;
  const bool mi = node_mask == nullptr || node_mask[i];
  for (int32_t j = lo; j < hi; ++j) {
    double d;
    if ((!loop && j == i) || !mi ||
        (node_mask != nullptr && !node_mask[j])) {
      d = BIG;
    } else {
      const double* cj = coors + static_cast<int64_t>(j) * c;
      d = 0.0;
      for (int t = 0; t < c; ++t) {
        const double r = ci[t] - cj[t];
        d += r * r;
      }
    }
    scratch.push_back({d, j});
  }
  const int kk = std::min<int>(k, static_cast<int>(scratch.size()));
  std::partial_sort(scratch.begin(), scratch.begin() + kk, scratch.end());
  for (int t = 0; t < k; ++t) {
    if (t < kk && scratch[t].dist < BIG) {
      senders[t] = scratch[t].idx;
      valid[t] = 1;
    } else {
      senders[t] = pad_to;
      valid[t] = 0;
    }
  }
}

}  // namespace

extern "C" {

// k-NN graph over one point set. coors: (n, c) f64 row-major. node_mask:
// (n,) u8 or null. Outputs (n*k,) receiver-major: senders, receivers
// (padding rows -> 0), mask. Returns 0 on success.
int egnn_knn_graph(const double* coors, int64_t n, int c, int k,
                   const uint8_t* node_mask, int loop, int32_t* senders,
                   int32_t* receivers, uint8_t* mask) {
  if (n <= 0 || c <= 0 || k <= 0) return 1;
#pragma omp parallel
  {
    std::vector<Cand> scratch;
    scratch.reserve(static_cast<size_t>(n));
#pragma omp for schedule(dynamic, 16)
    for (int64_t i = 0; i < n; ++i) {
      int32_t* s = senders + i * k;
      uint8_t* v = mask + i * k;
      knn_row(coors, c, static_cast<int32_t>(i), 0, static_cast<int32_t>(n),
              k, node_mask, loop != 0, /*pad_to=*/0, scratch, s, v);
      for (int t = 0; t < k; ++t)
        receivers[i * k + t] = v[t] ? static_cast<int32_t>(i) : 0;
    }
  }
  return 0;
}

// Batched kNN for g graphs packed (g*na, c): per-graph kNN with global node
// offsets already applied — the molecule-batch loader hot path
// (examples/molecule_regression.py builds exactly this layout). Outputs are
// (g*na*k,). Padding rows point at the owning graph's base node (g_idx*na)
// so downstream segment ops stay within that graph's id range.
int egnn_batched_knn_graph(const double* coors, int64_t g, int na, int c,
                           int k, const uint8_t* node_mask, int loop,
                           int32_t* senders, int32_t* receivers,
                           uint8_t* mask) {
  if (g <= 0 || na <= 0 || c <= 0 || k <= 0) return 1;
#pragma omp parallel
  {
    std::vector<Cand> scratch;
    scratch.reserve(static_cast<size_t>(na));
#pragma omp for schedule(dynamic, 1)
    for (int64_t gi = 0; gi < g; ++gi) {
      const int32_t lo = static_cast<int32_t>(gi * na);
      const int32_t hi = lo + na;
      for (int32_t i = lo; i < hi; ++i) {
        const int64_t row = static_cast<int64_t>(i) * k;
        knn_row(coors, c, i, lo, hi, k, node_mask, loop != 0, /*pad_to=*/lo,
                scratch, senders + row, mask + row);
        for (int t = 0; t < k; ++t)
          receivers[row + t] = mask[row + t] ? i : lo;
      }
    }
  }
  return 0;
}

// Radius graph with a static edge capacity. Keeps the globally closest
// max_edges pairs when over capacity (ties by flat (i*n+j) index), then
// orders receiver-major — identical to ops/graph.py:69-105. Returns the
// number of valid edges written (<= max_edges), or -1 on error.
int64_t egnn_radius_graph(const double* coors, int64_t n, int c,
                          double radius, int64_t max_edges,
                          const uint8_t* node_mask, int loop,
                          int32_t* senders, int32_t* receivers,
                          uint8_t* mask) {
  if (n <= 0 || c <= 0 || max_edges <= 0) return -1;
  const double r2 = radius * radius;
  struct Pair {
    double dist;
    int64_t flat;
  };
  std::vector<Pair> pairs;
#pragma omp parallel
  {
    std::vector<Pair> local;
#pragma omp for schedule(dynamic, 16) nowait
    for (int64_t i = 0; i < n; ++i) {
      if (node_mask != nullptr && !node_mask[i]) continue;
      const double* ci = coors + i * c;
      for (int64_t j = 0; j < n; ++j) {
        if (!loop && j == i) continue;
        if (node_mask != nullptr && !node_mask[j]) continue;
        const double* cj = coors + j * c;
        double d = 0.0;
        for (int t = 0; t < c; ++t) {
          const double r = ci[t] - cj[t];
          d += r * r;
        }
        if (d <= r2) local.push_back({d, i * n + j});
      }
    }
#pragma omp critical
    pairs.insert(pairs.end(), local.begin(), local.end());
  }
  auto closer = [](const Pair& a, const Pair& b) {
    return a.dist != b.dist ? a.dist < b.dist : a.flat < b.flat;
  };
  if (static_cast<int64_t>(pairs.size()) > max_edges) {
    std::nth_element(pairs.begin(), pairs.begin() + max_edges, pairs.end(),
                     closer);
    pairs.resize(static_cast<size_t>(max_edges));
  }
  std::sort(pairs.begin(), pairs.end(),
            [](const Pair& a, const Pair& b) { return a.flat < b.flat; });
  const int64_t ne = static_cast<int64_t>(pairs.size());
  for (int64_t e = 0; e < max_edges; ++e) {
    if (e < ne) {
      receivers[e] = static_cast<int32_t>(pairs[e].flat / n);
      senders[e] = static_cast<int32_t>(pairs[e].flat % n);
      mask[e] = 1;
    } else {
      receivers[e] = 0;
      senders[e] = 0;
      mask[e] = 0;
    }
  }
  return ne;
}

// Stable counting sort of a COO edge list by receiver, padding (mask=0)
// last: the receiver-major layout of the sparse path's uniform aggregation
// (egnn_tpu_torch/ops/segment.py). Writes a permutation of [0, e) into
// perm; apply it to senders/receivers/edge attributes host-side. Returns 0
// on success.
int egnn_sort_edges_by_receiver(const int32_t* receivers,
                                const uint8_t* mask, int64_t e, int64_t n,
                                int32_t* perm) {
  if (e < 0 || n <= 0) return 1;
  std::vector<int64_t> counts(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    const bool ok = mask == nullptr || mask[i];
    const int64_t key = ok ? receivers[i] : n;  // padding -> last bucket
    if (key < 0 || key > n) return 2;
    ++counts[static_cast<size_t>(key)];
  }
  std::vector<int64_t> offsets(static_cast<size_t>(n) + 1, 0);
  int64_t run = 0;
  for (size_t b = 0; b <= static_cast<size_t>(n); ++b) {
    offsets[b] = run;
    run += counts[b];
  }
  for (int64_t i = 0; i < e; ++i) {
    const bool ok = mask == nullptr || mask[i];
    const int64_t key = ok ? receivers[i] : n;
    perm[offsets[static_cast<size_t>(key)]++] = static_cast<int32_t>(i);
  }
  return 0;
}

// Batch packing for variable-size graphs: per-graph node counts ->
// (g*na,) graph-id vector and node validity mask (the PyG `batch` vector,
// egnn_pytorch_geometric.py:189, in static-capacity form). Returns 0 on
// success, 1 if any size exceeds the capacity.
int egnn_pack_batch(const int32_t* sizes, int64_t g, int na,
                    int32_t* batch_ids, uint8_t* node_mask) {
  int bad = 0;
  for (int64_t gi = 0; gi < g; ++gi) {
    if (sizes[gi] > na || sizes[gi] < 0) bad = 1;
    for (int a = 0; a < na; ++a) {
      batch_ids[gi * na + a] = static_cast<int32_t>(gi);
      node_mask[gi * na + a] = a < sizes[gi] ? 1 : 0;
    }
  }
  return bad;
}

int egnn_native_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
