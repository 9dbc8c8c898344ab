// Host-side symbolic engine for the hierarchical block-sparse library.
//
// Role (SURVEY.md section 8.2): the reference's quadtree walk is host C++;
// in this design the device executes batched leaf GEMMs over static-shape
// arrays, and the host's job shrinks to *exact symbolic planning* — sizing
// pair/output capacities before tracing so the compiled program wastes no
// FLOPs on padding.  These routines are the hot host path for large plans
// (millions of block pairs); `runtime/native.py` loads this via ctypes with
// a numpy fallback.
//
// Everything operates on the canonical representation: int32 block ids
// (row-major: id = brow * nb_cols + bcol), sorted ascending, padded with
// INT32_MAX sentinels.
//
// Build: `make -C csrc` (g++ -O3 -shared -fPIC).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t kSentinel = INT32_MAX;

// Strip sentinel padding (sorted => padding is a suffix).
inline int64_t valid_count(const int32_t* ids, int64_t n) {
  // Binary search for first sentinel.
  const int32_t* p = std::lower_bound(ids, ids + n, kSentinel);
  return p - ids;
}

}  // namespace

extern "C" {

// Exact SpGEMM plan: out[0] = number of contributing block pairs
// (leaf GEMMs == the reference's no_of_block_multiplies counter),
// out[1] = number of distinct output blocks.
void hbsm_plan_spgemm(const int32_t* a_ids, int64_t na, const int32_t* b_ids,
                      int64_t nb, int32_t a_nbc, int32_t b_nbr, int32_t b_nbc,
                      int64_t* out) {
  (void)b_nbr;
  na = valid_count(a_ids, na);
  nb = valid_count(b_ids, nb);

  // Start offset of each block-row of B (B sorted row-major => each block
  // row is a contiguous run).
  // b_row_start[r] = first index in b_ids with row >= r.
  std::vector<int64_t> row_start;
  {
    int32_t max_row = nb ? (b_ids[nb - 1] / b_nbc) : -1;
    row_start.assign((size_t)max_row + 2, nb);
    int64_t i = 0;
    for (int32_t r = 0; r <= max_row; ++r) {
      while (i < nb && b_ids[i] / b_nbc < r) ++i;
      row_start[(size_t)r] = i;
    }
    row_start[(size_t)max_row + 1] = nb;
  }
  const int32_t b_rows_present = (int32_t)row_start.size() - 1;

  int64_t n_pairs = 0;
  std::vector<int64_t> c_ids;
  for (int64_t i = 0; i < na; ++i) {
    const int32_t k = a_ids[i] % a_nbc;   // A block column = B block row
    if (k >= b_rows_present) continue;
    const int64_t lo = row_start[(size_t)k];
    const int64_t hi = row_start[(size_t)k + 1];
    if (hi <= lo) continue;
    const int64_t arow = a_ids[i] / a_nbc;
    n_pairs += hi - lo;
    for (int64_t j = lo; j < hi; ++j) {
      c_ids.push_back(arow * (int64_t)b_nbc + b_ids[j] % b_nbc);
    }
  }
  std::sort(c_ids.begin(), c_ids.end());
  int64_t n_out = 0;
  for (size_t i = 0; i < c_ids.size(); ++i) {
    if (i == 0 || c_ids[i] != c_ids[i - 1]) ++n_out;
  }
  out[0] = n_pairs;
  out[1] = n_out;
}

// Norm-filtered (SpAMM-style) plan: pairs with
// ||A_ik||_F * ||B_kj||_F > tau survive.  a_norms/b_norms are Frobenius
// norms aligned with the (padded) id arrays.  The reference lineage's
// error-controlled sparse approximate multiply (SURVEY.md section 1,
// Artemov's purification work) — skipping products a priori by norm bound.
void hbsm_plan_spamm(const int32_t* a_ids, const float* a_norms, int64_t na,
                     const int32_t* b_ids, const float* b_norms, int64_t nb,
                     int32_t a_nbc, int32_t b_nbr, int32_t b_nbc, double tau,
                     int64_t* out) {
  (void)b_nbr;
  na = valid_count(a_ids, na);
  nb = valid_count(b_ids, nb);
  std::vector<int64_t> row_start;
  {
    int32_t max_row = nb ? (b_ids[nb - 1] / b_nbc) : -1;
    row_start.assign((size_t)max_row + 2, nb);
    int64_t i = 0;
    for (int32_t r = 0; r <= max_row; ++r) {
      while (i < nb && b_ids[i] / b_nbc < r) ++i;
      row_start[(size_t)r] = i;
    }
    row_start[(size_t)max_row + 1] = nb;
  }
  const int32_t b_rows_present = (int32_t)row_start.size() - 1;

  int64_t n_pairs = 0;
  std::vector<int64_t> c_ids;
  for (int64_t i = 0; i < na; ++i) {
    const int32_t k = a_ids[i] % a_nbc;
    if (k >= b_rows_present) continue;
    const int64_t lo = row_start[(size_t)k];
    const int64_t hi = row_start[(size_t)k + 1];
    const int64_t arow = a_ids[i] / a_nbc;
    const double an = a_norms[i];
    for (int64_t j = lo; j < hi; ++j) {
      if (an * (double)b_norms[j] > tau) {
        ++n_pairs;
        c_ids.push_back(arow * (int64_t)b_nbc + b_ids[j] % b_nbc);
      }
    }
  }
  std::sort(c_ids.begin(), c_ids.end());
  int64_t n_out = 0;
  for (size_t i = 0; i < c_ids.size(); ++i) {
    if (i == 0 || c_ids[i] != c_ids[i - 1]) ++n_out;
  }
  out[0] = n_pairs;
  out[1] = n_out;
}

// Extended SpGEMM plan for the row-panel kernel: out[0] = pairs,
// out[1] = distinct output blocks, out[2] = max blocks in any B block-row,
// out[3] = max distinct output blocks in any C block-row (the static
// panel capacities of the row-panel Pallas kernel).
void hbsm_plan_spgemm_ex(const int32_t* a_ids, int64_t na,
                         const int32_t* b_ids, int64_t nb, int32_t a_nbc,
                         int32_t b_nbr, int32_t b_nbc, int64_t* out) {
  (void)b_nbr;
  na = valid_count(a_ids, na);
  nb = valid_count(b_ids, nb);
  std::vector<int64_t> row_start;
  {
    int32_t max_row = nb ? (b_ids[nb - 1] / b_nbc) : -1;
    row_start.assign((size_t)max_row + 2, nb);
    int64_t i = 0;
    for (int32_t r = 0; r <= max_row; ++r) {
      while (i < nb && b_ids[i] / b_nbc < r) ++i;
      row_start[(size_t)r] = i;
    }
    row_start[(size_t)max_row + 1] = nb;
  }
  const int32_t b_rows_present = (int32_t)row_start.size() - 1;
  int64_t max_b_row = 0;
  for (int32_t r = 0; r < b_rows_present; ++r) {
    max_b_row = std::max(max_b_row, row_start[(size_t)r + 1] - row_start[(size_t)r]);
  }

  int64_t n_pairs = 0;
  std::vector<int64_t> c_ids;
  for (int64_t i = 0; i < na; ++i) {
    const int32_t k = a_ids[i] % a_nbc;
    if (k >= b_rows_present) continue;
    const int64_t lo = row_start[(size_t)k];
    const int64_t hi = row_start[(size_t)k + 1];
    if (hi <= lo) continue;
    const int64_t arow = a_ids[i] / a_nbc;
    n_pairs += hi - lo;
    for (int64_t j = lo; j < hi; ++j) {
      c_ids.push_back(arow * (int64_t)b_nbc + b_ids[j] % b_nbc);
    }
  }
  std::sort(c_ids.begin(), c_ids.end());
  int64_t n_out = 0, max_c_row = 0, row_cnt = 0;
  int64_t prev_row = -1;
  for (size_t i = 0; i < c_ids.size(); ++i) {
    if (i > 0 && c_ids[i] == c_ids[i - 1]) continue;
    ++n_out;
    const int64_t row = c_ids[i] / b_nbc;
    if (row != prev_row) {
      max_c_row = std::max(max_c_row, row_cnt);
      row_cnt = 0;
      prev_row = row;
    }
    ++row_cnt;
  }
  max_c_row = std::max(max_c_row, row_cnt);
  out[0] = n_pairs;
  out[1] = n_out;
  out[2] = max_b_row;
  out[3] = max_c_row;
}

// Union cardinality of two sorted, sentinel-padded id lists (exact output
// capacity of add; the reference's structural-union walk, SURVEY.md C6).
int64_t hbsm_plan_add(const int32_t* a_ids, int64_t na, const int32_t* b_ids,
                      int64_t nb) {
  na = valid_count(a_ids, na);
  nb = valid_count(b_ids, nb);
  int64_t i = 0, j = 0, n = 0;
  while (i < na && j < nb) {
    const int32_t a = a_ids[i], b = b_ids[j];
    i += (a <= b);
    j += (b <= a);
    ++n;
  }
  n += (na - i) + (nb - j);
  return n;
}

// Number of distinct blocks touched by COO triplets (exact capacity for
// from_coo; the reference's assign_from_vectors sizing, SURVEY.md C3).
int64_t hbsm_count_coo_blocks(const int32_t* rows, const int32_t* cols,
                              int64_t n, int32_t block_size, int32_t nb_cols) {
  std::vector<int64_t> ids((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    ids[(size_t)i] =
        (int64_t)(rows[i] / block_size) * nb_cols + cols[i] / block_size;
  }
  std::sort(ids.begin(), ids.end());
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (i == 0 || ids[(size_t)i] != ids[(size_t)i - 1]) ++count;
  }
  return count;
}

// Full symbolic SpGEMM: materialize (a_idx, b_idx, c_id) sorted by c_id.
// Caller allocates pair_cap-sized outputs; returns the true pair count
// (entries past min(true, pair_cap) untouched).  Host fast path for plan
// construction when the caller wants the pair lists computed off-device.
int64_t hbsm_symbolic_spgemm(const int32_t* a_ids, int64_t na,
                             const int32_t* b_ids, int64_t nb, int32_t a_nbc,
                             int32_t b_nbc, int64_t pair_cap, int32_t* a_idx,
                             int32_t* b_idx, int32_t* c_id) {
  na = valid_count(a_ids, na);
  nb = valid_count(b_ids, nb);
  std::vector<int64_t> row_start;
  {
    int32_t max_row = nb ? (b_ids[nb - 1] / b_nbc) : -1;
    row_start.assign((size_t)max_row + 2, nb);
    int64_t i = 0;
    for (int32_t r = 0; r <= max_row; ++r) {
      while (i < nb && b_ids[i] / b_nbc < r) ++i;
      row_start[(size_t)r] = i;
    }
    row_start[(size_t)max_row + 1] = nb;
  }
  const int32_t b_rows_present = (int32_t)row_start.size() - 1;

  struct Rec {
    int32_t c, a, b;
  };
  std::vector<Rec> recs;
  for (int64_t i = 0; i < na; ++i) {
    const int32_t k = a_ids[i] % a_nbc;
    if (k >= b_rows_present) continue;
    const int64_t lo = row_start[(size_t)k];
    const int64_t hi = row_start[(size_t)k + 1];
    const int32_t arow = a_ids[i] / a_nbc;
    for (int64_t j = lo; j < hi; ++j) {
      recs.push_back({arow * b_nbc + b_ids[j] % b_nbc, (int32_t)i, (int32_t)j});
    }
  }
  std::stable_sort(recs.begin(), recs.end(),
                   [](const Rec& x, const Rec& y) { return x.c < y.c; });
  const int64_t n = std::min<int64_t>((int64_t)recs.size(), pair_cap);
  for (int64_t i = 0; i < n; ++i) {
    a_idx[i] = recs[(size_t)i].a;
    b_idx[i] = recs[(size_t)i].b;
    c_id[i] = recs[(size_t)i].c;
  }
  return (int64_t)recs.size();
}

}  // extern "C"
