// Native host-side runtime for hpddm_tpu.
//
// The reference is a header-only C++ library whose host-side machinery
// (CSR parsing/assembly, neighbor resolution, format conversion) runs as
// compiled code; this file provides the same for this framework's
// setup path, exposed through a C ABI consumed via ctypes
// (hpddm_tpu/native/__init__.py). The JAX/XLA device path is unaffected —
// these are the O(nnz) host loops that are too slow in pure Python:
//
//  * ell_pack        — CSR -> padded ELL (cf. Wrapper<K> conversions,
//                      include/HPDDM_wrapper.hpp:151-221)
//  * dia_pack        — CSR -> DIA with a fixed offset table
//  * parse_coo       — text parser for the HPDDM dump / MatrixMarket
//                      coordinate format (cf. MatrixCSR(std::ifstream&),
//                      include/HPDDM_matrix.hpp:173-245)
//  * uf_resolve      — union-find over pairwise interface correspondences
//                      (the globalMapping analogue,
//                      include/HPDDM_subdomain.hpp:471-544)
//  * overlap_grow    — indicator growth by |A| powers
//                      (examples/generateFromFile.cpp:63-141)
//
// Build: make -C hpddm_tpu/native   (g++ -O3 -shared -fPIC)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// CSR -> ELL. values/cols must be zero-initialized (n_rows x width).
void ell_pack(const int64_t n_rows, const int64_t *indptr,
              const int32_t *indices, const double *data,
              const int64_t width, double *values, int32_t *cols) {
  for (int64_t i = 0; i < n_rows; ++i) {
    const int64_t lo = indptr[i], hi = indptr[i + 1];
    double *vrow = values + i * width;
    int32_t *crow = cols + i * width;
    for (int64_t k = lo; k < hi; ++k) {
      vrow[k - lo] = data[k];
      crow[k - lo] = indices[k];
    }
  }
}

// CSR -> DIA. offsets maps diagonal offset -> slot; values is
// (n_diag x n_rows) zero-initialized. offset_of is a lookup table of size
// (2*n_rows - 1) mapping (col - row + n_rows - 1) -> slot or -1.
void dia_pack(const int64_t n_rows, const int64_t *indptr,
              const int32_t *indices, const double *data,
              const int32_t *offset_of, double *values) {
  for (int64_t i = 0; i < n_rows; ++i) {
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      const int32_t slot = offset_of[indices[k] - i + n_rows - 1];
      if (slot >= 0) values[(int64_t)slot * n_rows + i] = data[k];
    }
  }
}

// Union-find with path halving over pairwise correspondences.
// pairs_a/pairs_b are flattened global slot ids; parent must be iota(n).
void uf_resolve(const int64_t n, int64_t *parent, const int64_t n_pairs,
                const int64_t *pairs_a, const int64_t *pairs_b) {
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int64_t k = 0; k < n_pairs; ++k) {
    int64_t ra = find(pairs_a[k]), rb = find(pairs_b[k]);
    if (ra != rb) parent[ra > rb ? ra : rb] = ra > rb ? rb : ra;
  }
  for (int64_t i = 0; i < n; ++i) parent[i] = find(i);
}

// Indicator growth: joined[i] = round at which dof i entered the subdomain
// (0 = owned, -1 = never). CSR adjacency, `rounds` growth sweeps.
void overlap_grow(const int64_t n, const int64_t *indptr,
                  const int32_t *indices, int32_t *joined,
                  const int32_t rounds) {
  std::vector<int64_t> frontier, next;
  for (int64_t i = 0; i < n; ++i)
    if (joined[i] == 0) frontier.push_back(i);
  for (int32_t r = 1; r <= rounds; ++r) {
    next.clear();
    for (int64_t f : frontier) {
      for (int64_t k = indptr[f]; k < indptr[f + 1]; ++k) {
        const int32_t j = indices[k];
        if (joined[j] < 0) {
          joined[j] = r;
          next.push_back(j);
        }
      }
    }
    frontier.swap(next);
  }
}

// Text COO parser: reads `max_nnz` "i j v" triplets (1-based) from `path`
// starting after `skip_lines` lines. Returns number parsed, or -1 on error.
int64_t parse_coo(const char *path, const int64_t skip_lines,
                  const int64_t max_nnz, int64_t *rows, int64_t *cols,
                  double *vals) {
  FILE *f = std::fopen(path, "r");
  if (!f) return -1;
  char buf[512];
  int64_t line = 0, k = 0;
  while (line < skip_lines && std::fgets(buf, sizeof buf, f)) ++line;
  while (k < max_nnz && std::fgets(buf, sizeof buf, f)) {
    if (buf[0] == '#' || buf[0] == '%' || buf[0] == '\n') continue;
    long long i, j;
    double v;
    if (std::sscanf(buf, "%lld %lld %lf", &i, &j, &v) == 3) {
      rows[k] = i - 1;
      cols[k] = j - 1;
      vals[k] = v;
      ++k;
    }
  }
  std::fclose(f);
  return k;
}

}  // extern "C"
