// Native host-side kernels for dune_hdd_tpu_torch (dune_hdd_tpu_torch/native.py).
//
// The host-side index builders that sit between grid construction and the
// first kernel: mesh face connectivity and sparsity-pattern deduplication.
// A copy of the JAX package's native/hdd_native.cpp, built by the port at
// first use into dune_hdd_tpu_torch/_build/ and bound with ctypes.
//
// Build:  g++ -O3 -shared -fPIC -o libhdd_native.so hdd_native.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<int64_t, int64_t>& p) const {
    return std::hash<int64_t>()(p.first * 0x9e3779b97f4a7c15LL ^ p.second);
  }
};

}  // namespace

extern "C" {

// Build face connectivity for a homogeneous 2d mesh.
//   cells:       [nc * nvc] vertex ids
//   local faces: (i, (i+1) % nvc)
// Outputs (preallocated by caller to the maximal size nc * nvc):
//   faces      [max_nf * 2]   vertex pairs, inside-cell orientation
//   cell_faces [nc * nvc]
//   face_cells [max_nf * 2]   (inside, outside | -1)
//   face_local [max_nf * 2]
// Returns the actual number of faces.
int64_t build_connectivity(const int32_t* cells, int64_t nc, int32_t nvc,
                           int32_t* faces, int32_t* cell_faces,
                           int32_t* face_cells, int32_t* face_local) {
  std::unordered_map<std::pair<int64_t, int64_t>, int64_t, PairHash> lookup;
  lookup.reserve(static_cast<size_t>(nc) * nvc);
  int64_t nf = 0;
  for (int64_t c = 0; c < nc; ++c) {
    for (int32_t k = 0; k < nvc; ++k) {
      const int64_t a = cells[c * nvc + k];
      const int64_t b = cells[c * nvc + (k + 1) % nvc];
      const auto key = std::minmax(a, b);
      auto it = lookup.find(key);
      if (it == lookup.end()) {
        const int64_t f = nf++;
        lookup.emplace(key, f);
        faces[f * 2] = static_cast<int32_t>(a);
        faces[f * 2 + 1] = static_cast<int32_t>(b);
        face_cells[f * 2] = static_cast<int32_t>(c);
        face_cells[f * 2 + 1] = -1;
        face_local[f * 2] = k;
        face_local[f * 2 + 1] = -1;
        cell_faces[c * nvc + k] = static_cast<int32_t>(f);
      } else {
        const int64_t f = it->second;
        face_cells[f * 2 + 1] = static_cast<int32_t>(c);
        face_local[f * 2 + 1] = k;
        cell_faces[c * nvc + k] = static_cast<int32_t>(f);
      }
    }
  }
  return nf;
}

// Deduplicate COO entries into sorted unique slots.
//   keys [e] = row * num_cols + col  (caller-computed)
// Outputs: perm [e] (argsort of keys), seg_ids [e], slot_keys [<= e].
// Returns nnz.
int64_t dedup_pattern(const int64_t* keys, int64_t e, int64_t* perm,
                      int32_t* seg_ids, int64_t* slot_keys) {
  std::vector<int64_t> idx(e);
  for (int64_t i = 0; i < e; ++i) idx[i] = i;
  std::stable_sort(idx.begin(), idx.end(),
                   [keys](int64_t a, int64_t b) { return keys[a] < keys[b]; });
  int64_t nnz = 0;
  int64_t prev = 0;
  for (int64_t i = 0; i < e; ++i) {
    perm[i] = idx[i];
    const int64_t k = keys[idx[i]];
    if (i == 0 || k != prev) {
      slot_keys[nnz++] = k;
      prev = k;
    }
    seg_ids[i] = static_cast<int32_t>(nnz - 1);
  }
  return nnz;
}

}  // extern "C"
