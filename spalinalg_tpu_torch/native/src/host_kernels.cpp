// Native host-side symbolic kernels of spalinalg_tpu_torch.
//
// Plain C++ with a C interface and no tie to any framework, compiled at
// first use by spalinalg_tpu_torch/native/lib.py and bound with ctypes.
// The functions are copied from the JAX package's
// spalinalg_tpu/native/src/host_kernels.cpp, each with its first caller in
// the port, so both packages compute the same plans.
//
// Index type: int64 throughout (host side; device uses int32).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// SpGEMM symbolic phase: expand product terms of C = A·B (both CSR),
// sort by output coordinate, group into unique slots. Two-call protocol:
// first call with out_* null pointers returns the term count; second call
// fills a_idx/b_idx/gid (size n_terms) + out_rowptr (nrows_a+1) +
// out_colind (>= n_out) and returns n_out.
// ---------------------------------------------------------------------
int64_t spal_spgemm_symbolic(
    const int64_t* aptr, const int64_t* acol, int64_t nrows_a,
    const int64_t* bptr, const int64_t* bcol, int64_t ncols_b,
    int64_t* a_idx, int64_t* b_idx, int64_t* gid,
    int64_t* out_rowptr, int64_t* out_colind) {
  // term count
  int64_t total = 0;
  for (int64_t e = 0; e < aptr[nrows_a]; ++e) {
    int64_t k = acol[e];
    total += bptr[k + 1] - bptr[k];
  }
  if (a_idx == nullptr) return total;

  struct Term {
    int64_t row, col, ai, bi;
  };
  std::vector<Term> terms;
  terms.reserve(total);
  for (int64_t i = 0; i < nrows_a; ++i)
    for (int64_t e = aptr[i]; e < aptr[i + 1]; ++e) {
      int64_t k = acol[e];
      for (int64_t f = bptr[k]; f < bptr[k + 1]; ++f)
        terms.push_back({i, bcol[f], e, f});
    }
  std::stable_sort(terms.begin(), terms.end(),
                   [](const Term& a, const Term& b) {
                     if (a.row != b.row) return a.row < b.row;
                     return a.col < b.col;
                   });
  int64_t n_out = 0;
  std::memset(out_rowptr, 0, sizeof(int64_t) * (nrows_a + 1));
  for (int64_t t = 0; t < total; ++t) {
    if (t == 0 || terms[t].row != terms[t - 1].row ||
        terms[t].col != terms[t - 1].col) {
      out_colind[n_out] = terms[t].col;
      out_rowptr[terms[t].row + 1]++;
      ++n_out;
    }
    a_idx[t] = terms[t].ai;
    b_idx[t] = terms[t].bi;
    gid[t] = n_out - 1;
  }
  for (int64_t i = 0; i < nrows_a; ++i) out_rowptr[i + 1] += out_rowptr[i];
  (void)ncols_b;
  return n_out;
}

}  // extern "C"
