// Native topology core: plane (ring) discovery + one-hop adjacency.
//
// The port's own copy of the JAX package's csrc/topo.cc, the same
// algorithm: two devices are linked along an axis when they agree on
// every OTHER coordinate and on the core index; union-find over those
// links yields per-axis connected sets, the rings, exactly the sets
// tpu_patterns_torch/topo/topology.py's Python path builds by
// hash-grouping.  The two must agree bit for bit
// (tests/test_torch_topo.py drives both on the same topologies).
//
// Plain C++ (no framework headers), built with g++ at first use by
// tpu_patterns_torch/topo/native.py and called over ctypes: host-side
// launcher logic, not device code.

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(int32_t n) : parent(n) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) { parent[find(a)] = find(b); }
};

// Per-axis extent = number of DISTINCT coordinate values (the Python
// torus_shape), not max+1 — synthetic/sparse coords must agree.
static void extents(const int32_t* coords, int32_t n, int32_t ndim,
                    std::vector<int32_t>* out) {
  out->assign(ndim, 0);
  std::vector<int32_t> vals;
  for (int32_t ax = 0; ax < ndim; ++ax) {
    vals.clear();
    for (int32_t i = 0; i < n; ++i) vals.push_back(coords[i * ndim + ax]);
    std::sort(vals.begin(), vals.end());
    (*out)[ax] = static_cast<int32_t>(
        std::unique(vals.begin(), vals.end()) - vals.begin());
  }
}

// Linked along `ax`: same core, same every-other-coordinate.
static bool linked(const int32_t* coords, const int32_t* cores,
                   int32_t ndim, int32_t ax, int32_t i, int32_t j) {
  if (cores[i] != cores[j]) return false;
  for (int32_t d = 0; d < ndim; ++d) {
    if (d == ax) continue;
    if (coords[i * ndim + d] != coords[j * ndim + d]) return false;
  }
  return true;
}

}  // namespace

// Rings of the torus, flattened: ring r spans
// out_members[out_offsets[r] .. out_offsets[r+1]).  Returns the ring
// count, or -1 on bad args / buffer overflow (callers size generously:
// total membership <= n * ndim + n).
extern "C" int32_t tp_topo_planes(const int32_t* coords,
                                  const int32_t* cores, int32_t n,
                                  int32_t ndim, int32_t* out_members,
                                  int32_t* out_offsets,
                                  int32_t cap_members, int32_t cap_rings) {
  if (n <= 0 || ndim <= 0 || !coords || !cores || !out_members ||
      !out_offsets)
    return -1;
  std::vector<int32_t> ext;
  extents(coords, n, ndim, &ext);
  int32_t n_rings = 0, n_members = 0;
  auto emit = [&](const std::vector<int32_t>& ring) -> bool {
    if (n_rings + 1 > cap_rings ||
        n_members + static_cast<int32_t>(ring.size()) > cap_members)
      return false;
    out_offsets[n_rings] = n_members;
    for (int32_t idx : ring) out_members[n_members++] = idx;
    out_offsets[++n_rings] = n_members;
    return true;
  };
  for (int32_t ax = 0; ax < ndim; ++ax) {
    // degenerate axis on a multi-axis torus contributes no rings (the
    // 1-extent axis of an 8x1 mesh); a 1-D "torus" keeps its chain
    if (ext[ax] <= 1 && ndim > 1) continue;
    UnionFind uf(n);
    for (int32_t i = 0; i < n; ++i)
      for (int32_t j = i + 1; j < n; ++j)
        if (linked(coords, cores, ndim, ax, i, j)) uf.unite(i, j);
    // components in first-seen order; members in device order, then
    // stably sorted along the ring axis — byte-compatible with the
    // Python hash-group + stable sort
    std::vector<int32_t> root_order;
    std::vector<std::vector<int32_t>> comps(n);
    for (int32_t i = 0; i < n; ++i) {
      int32_t r = uf.find(i);
      if (comps[r].empty()) root_order.push_back(r);
      comps[r].push_back(i);
    }
    for (int32_t r : root_order) {
      std::vector<int32_t>& m = comps[r];
      if (static_cast<int32_t>(m.size()) < 2 && n > 1) continue;
      std::stable_sort(m.begin(), m.end(), [&](int32_t a, int32_t b) {
        return coords[a * ndim + ax] < coords[b * ndim + ax];
      });
      if (!emit(m)) return -1;
    }
  }
  if (n_rings == 0) {
    // single device / fully degenerate: one plane of everything
    std::vector<int32_t> all(n);
    for (int32_t i = 0; i < n; ++i) all[i] = i;
    if (!emit(all)) return -1;
  }
  return n_rings;
}

// Devices one hop from `index`: same core, torus-wrapped coordinate
// distance summing to exactly 1.  Returns the neighbor count written to
// out (sorted ascending), or -1 on bad args / overflow.
extern "C" int32_t tp_topo_neighbors(const int32_t* coords,
                                     const int32_t* cores, int32_t n,
                                     int32_t ndim, int32_t index,
                                     int32_t* out, int32_t cap) {
  if (n <= 0 || ndim <= 0 || index < 0 || index >= n || !coords ||
      !cores || !out)
    return -1;
  std::vector<int32_t> ext;
  extents(coords, n, ndim, &ext);
  int32_t count = 0;
  for (int32_t j = 0; j < n; ++j) {
    if (j == index || cores[j] != cores[index]) continue;
    int64_t dist = 0;
    for (int32_t ax = 0; ax < ndim; ++ax) {
      int32_t a = coords[index * ndim + ax], b = coords[j * ndim + ax];
      int32_t d = a > b ? a - b : b - a;
      if (ext[ax] > 1) d = std::min(d, ext[ax] - d);  // wrap
      dist += d;
    }
    if (dist == 1) {
      if (count >= cap) return -1;
      out[count++] = j;  // j ascends, so the output is already sorted
    }
  }
  return count;
}
