// Cell-list neighbor engine (native runtime component).
//
// Role: O(N) radius queries on the host side — the stand-in for the
// reference stack's native neighbor machinery (Biopython NeighborSearch
// KD-tree C extension, and fairchem's radius-graph builders). Built by
// pdb2reaction_tpu_torch/native with g++ on first use.
//
// C ABI (ctypes):
//   n_pairs = cell_list_pairs(coords, n, cutoff, pairs_out, max_pairs)
//     coords: double[n*3]; pairs_out: int32[max_pairs*2]
//     returns number of (i<j) pairs with |ri-rj| <= cutoff, or -1 if the
//     buffer was too small.
//   n_hits = radius_query(coords, n, centers, m, cutoff, hits_out, max_hits)
//     all (atom, center) pairs within cutoff; hits_out int32[max_hits*2].

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

struct CellKey {
    int64_t x, y, z;
    bool operator==(const CellKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};

struct CellKeyHash {
    size_t operator()(const CellKey& k) const {
        // 3D spatial hash with large odd primes
        return static_cast<size_t>(k.x * 73856093LL ^ k.y * 19349663LL ^
                                   k.z * 83492791LL);
    }
};

using CellMap = std::unordered_map<CellKey, std::vector<int32_t>, CellKeyHash>;

CellMap build_cells(const double* coords, int32_t n, double cell) {
    CellMap cells;
    cells.reserve(static_cast<size_t>(n));
    for (int32_t i = 0; i < n; ++i) {
        CellKey k{static_cast<int64_t>(std::floor(coords[3 * i] / cell)),
                  static_cast<int64_t>(std::floor(coords[3 * i + 1] / cell)),
                  static_cast<int64_t>(std::floor(coords[3 * i + 2] / cell))};
        cells[k].push_back(i);
    }
    return cells;
}

inline double dist2(const double* a, const double* b) {
    const double dx = a[0] - b[0], dy = a[1] - b[1], dz = a[2] - b[2];
    return dx * dx + dy * dy + dz * dz;
}

}  // namespace

extern "C" {

int64_t cell_list_pairs(const double* coords, int32_t n, double cutoff,
                        int32_t* pairs_out, int64_t max_pairs) {
    if (n <= 0 || cutoff <= 0) return 0;
    const double c2 = cutoff * cutoff;
    CellMap cells = build_cells(coords, n, cutoff);
    int64_t count = 0;
    for (const auto& kv : cells) {
        const CellKey& k = kv.first;
        for (int64_t dx = -1; dx <= 1; ++dx)
        for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
            CellKey nk{k.x + dx, k.y + dy, k.z + dz};
            auto it = cells.find(nk);
            if (it == cells.end()) continue;
            for (int32_t i : kv.second) {
                for (int32_t j : it->second) {
                    if (j <= i) continue;
                    if (dist2(coords + 3 * i, coords + 3 * j) <= c2) {
                        if (count < max_pairs) {
                            pairs_out[2 * count] = i;
                            pairs_out[2 * count + 1] = j;
                        }
                        ++count;
                    }
                }
            }
        }
    }
    return count <= max_pairs ? count : -1;
}

int64_t radius_query(const double* coords, int32_t n, const double* centers,
                     int32_t m, double cutoff, int32_t* hits_out,
                     int64_t max_hits) {
    if (n <= 0 || m <= 0 || cutoff <= 0) return 0;
    const double c2 = cutoff * cutoff;
    CellMap cells = build_cells(coords, n, cutoff);
    int64_t count = 0;
    for (int32_t q = 0; q < m; ++q) {
        const double* ctr = centers + 3 * q;
        const int64_t cx = static_cast<int64_t>(std::floor(ctr[0] / cutoff));
        const int64_t cy = static_cast<int64_t>(std::floor(ctr[1] / cutoff));
        const int64_t cz = static_cast<int64_t>(std::floor(ctr[2] / cutoff));
        for (int64_t dx = -1; dx <= 1; ++dx)
        for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
            CellKey nk{cx + dx, cy + dy, cz + dz};
            auto it = cells.find(nk);
            if (it == cells.end()) continue;
            for (int32_t i : it->second) {
                if (dist2(coords + 3 * i, ctr) <= c2) {
                    if (count < max_hits) {
                        hits_out[2 * count] = i;
                        hits_out[2 * count + 1] = q;
                    }
                    ++count;
                }
            }
        }
    }
    return count <= max_hits ? count : -1;
}

}  // extern "C"
