// Native preprocessing kernels for the host-side (dynamic-shape) stages of
// the perception pipeline. The reference leaned on Open3D's C++ backend for
// these (point_collect/collect.py); here they are self-contained, built with
// g++ -O3 and loaded via ctypes (see pipeline/native_dbscan.py).
//
// dbscan(): grid-hashed DBSCAN with Open3D cluster_dbscan semantics
//   (collect.py:42): a point is core iff |N_eps(p)| >= min_points, where the
//   neighborhood INCLUDES the point itself; clusters grow from core points
//   through core connectivity; border points join the first cluster that
//   reaches them; noise stays -1.
// radius_counts(): #neighbors within radius per point (excl. self), the
//   kernel behind remove_radius_outlier (collect.py:92-102).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
  int64_t x, y, z;
  bool operator==(const CellKey& o) const { return x == o.x && y == o.y && z == o.z; }
};

struct CellHash {
  size_t operator()(const CellKey& k) const {
    // 3-way FNV-style mix; cell coords are small after eps scaling
    uint64_t h = 1469598103934665603ULL;
    for (int64_t v : {k.x, k.y, k.z}) {
      h ^= static_cast<uint64_t>(v) + 0x9e3779b97f4a7c15ULL;
      h *= 1099511628211ULL;
    }
    return static_cast<size_t>(h);
  }
};

using Grid = std::unordered_map<CellKey, std::vector<int32_t>, CellHash>;

Grid build_grid(const double* pts, int32_t n, double eps) {
  Grid grid;
  grid.reserve(static_cast<size_t>(n) / 4 + 1);
  for (int32_t i = 0; i < n; ++i) {
    CellKey k{static_cast<int64_t>(std::floor(pts[3 * i] / eps)),
              static_cast<int64_t>(std::floor(pts[3 * i + 1] / eps)),
              static_cast<int64_t>(std::floor(pts[3 * i + 2] / eps))};
    grid[k].push_back(i);
  }
  return grid;
}

inline void neighbors_of(const double* pts, const Grid& grid, double eps,
                         int32_t i, std::vector<int32_t>& out) {
  out.clear();
  const double eps2 = eps * eps;
  const double px = pts[3 * i], py = pts[3 * i + 1], pz = pts[3 * i + 2];
  const int64_t cx = static_cast<int64_t>(std::floor(px / eps));
  const int64_t cy = static_cast<int64_t>(std::floor(py / eps));
  const int64_t cz = static_cast<int64_t>(std::floor(pz / eps));
  for (int64_t dx = -1; dx <= 1; ++dx)
    for (int64_t dy = -1; dy <= 1; ++dy)
      for (int64_t dz = -1; dz <= 1; ++dz) {
        auto it = grid.find(CellKey{cx + dx, cy + dy, cz + dz});
        if (it == grid.end()) continue;
        for (int32_t j : it->second) {
          const double ddx = pts[3 * j] - px;
          const double ddy = pts[3 * j + 1] - py;
          const double ddz = pts[3 * j + 2] - pz;
          if (ddx * ddx + ddy * ddy + ddz * ddz <= eps2) out.push_back(j);
        }
      }
}

int n_workers() {
  unsigned hc = std::thread::hardware_concurrency();
  int nt = hc ? static_cast<int>(hc) : 1;
  return nt > 16 ? 16 : nt;
}

// Runs fn(i) for i in [0, n) across a small thread pool, handing out
// contiguous chunks through an atomic cursor (same pattern as the CSV pool).
template <typename Fn>
void parallel_for(int32_t n, Fn fn) {
  const int32_t CHUNK = 256;
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int32_t lo = next.fetch_add(CHUNK);
      if (lo >= n) return;
      int32_t hi = lo + CHUNK < n ? lo + CHUNK : n;
      for (int32_t i = lo; i < hi; ++i) fn(i);
    }
  };
  int nt = n_workers();
  std::vector<std::thread> pool;
  for (int t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// labels_out: int64[n], filled with cluster ids or -1. Returns #clusters.
//
// Two-phase: (1) a thread-parallel pass computes each point's eps-neighbor
// list once and caches it (the lists double as the core test: a point is
// core iff its list, which includes itself, has >= min_points entries);
// (2) the sequential BFS expansion then reads the cached lists instead of
// re-scanning the grid — with min_points=500-dense clusters the second scan
// used to cost as much as the first. Cached entries are capped at ~1 GB;
// past the budget a point's list is left empty (unambiguous: every real
// list contains the point itself) and the BFS recomputes it on the fly.
int32_t pc_dbscan(const double* pts, int32_t n, double eps, int32_t min_points,
                  int64_t* labels_out) {
  Grid grid = build_grid(pts, n, eps);
  std::vector<uint8_t> core(n, 0);
  std::vector<std::vector<int32_t>> nbrs(n);
  const int64_t budget_entries = (1ll << 30) / sizeof(int32_t);
  std::atomic<int64_t> cached(0);
  parallel_for(n, [&](int32_t i) {
    thread_local std::vector<int32_t> scratch;
    neighbors_of(pts, grid, eps, i, scratch);
    core[i] = scratch.size() >= static_cast<size_t>(min_points);
    int64_t sz = static_cast<int64_t>(scratch.size());
    if (cached.fetch_add(sz) + sz <= budget_entries) nbrs[i] = scratch;
  });
  std::memset(labels_out, 0xff, sizeof(int64_t) * n);  // all -1
  int32_t cluster = 0;
  std::vector<int32_t> stack, scratch;
  for (int32_t i = 0; i < n; ++i) {
    if (labels_out[i] != -1 || !core[i]) continue;
    labels_out[i] = cluster;
    stack.assign(1, i);
    while (!stack.empty()) {
      int32_t j = stack.back();
      stack.pop_back();
      const std::vector<int32_t>* nb = &nbrs[j];
      if (nb->empty()) {
        neighbors_of(pts, grid, eps, j, scratch);
        nb = &scratch;
      }
      for (int32_t q : *nb) {
        if (labels_out[q] == -1) {
          labels_out[q] = cluster;
          if (core[q]) stack.push_back(q);
        }
      }
    }
    ++cluster;
  }
  return cluster;
}

// counts_out: int32[n] = #points within radius of each point (excl. self).
void pc_radius_counts(const double* pts, int32_t n, double radius,
                      int32_t* counts_out) {
  Grid grid = build_grid(pts, n, radius);
  parallel_for(n, [&](int32_t i) {
    thread_local std::vector<int32_t> scratch;
    neighbors_of(pts, grid, radius, i, scratch);
    counts_out[i] = static_cast<int32_t>(scratch.size()) - 1;
  });
}

// pc_load_csv_files: threaded bulk reader for the reference's on-disk sample
// layout (data/<cat>/<cat>_NNNN.txt, comma-separated floats one point per
// line — data_build/Cube.py:90-100). The torch pipeline covered this cost
// with DataLoader(num_workers=10) (train_classification.py:195-196); here a
// worker pool parses straight into the caller's float32 buffer.
//
//   paths:    null-separated path strings, n_files of them
//   out:      float32[n_files, max_rows, cols]
//   rows_out: int32[n_files] = parsed row count, or -1 on open/parse failure
//
// Returns the number of failed files. Rows beyond max_rows are skipped;
// short rows are zero-padded.
int32_t pc_load_csv_files(const char* paths, int32_t n_files, int32_t max_rows,
                          int32_t cols, float* out, int32_t* rows_out,
                          int32_t n_threads) {
  std::vector<const char*> starts;
  starts.reserve(n_files);
  const char* p = paths;
  for (int32_t i = 0; i < n_files; ++i) {
    starts.push_back(p);
    p += std::strlen(p) + 1;
  }
  std::atomic<int32_t> next(0), failed(0);
  auto worker = [&]() {
    std::string buf;
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n_files) return;
      FILE* f = std::fopen(starts[i], "rb");
      if (!f) { rows_out[i] = -1; ++failed; continue; }
      std::fseek(f, 0, SEEK_END);
      long sz = std::ftell(f);
      std::fseek(f, 0, SEEK_SET);
      buf.resize(static_cast<size_t>(sz));
      size_t got = sz ? std::fread(&buf[0], 1, static_cast<size_t>(sz), f) : 0;
      std::fclose(f);
      buf.resize(got);
      float* row = out + static_cast<int64_t>(i) * max_rows * cols;
      std::memset(row, 0, sizeof(float) * max_rows * cols);
      int32_t r = 0, c = 0;
      const char* s = buf.c_str();
      const char* end = s + buf.size();
      while (s < end && r < max_rows) {
        char* after = nullptr;
        float v = std::strtof(s, &after);
        if (after == s) { ++s; continue; }  // skip separators/garbage
        row[static_cast<int64_t>(r) * cols + c] = v;
        if (++c == cols) { c = 0; ++r; }
        s = after;
      }
      rows_out[i] = r;
    }
  };
  int32_t nt = n_threads > 0 ? n_threads : 1;
  std::vector<std::thread> pool;
  for (int32_t t = 1; t < nt; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
  return failed.load();
}

}  // extern "C"
