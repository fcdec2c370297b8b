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
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// compress: sort COO triplets by (major, minor), optionally merging
// duplicates (summing values) and dropping exact zeros. Mirrors
// convert/engine.compress_host. Returns the output nnz; fills ptr
// (n_major+1), out_minor, out_values (caller-allocated, size nnz_in).
// ---------------------------------------------------------------------
int64_t spal_compress(
    const int64_t* major, const int64_t* minor, const double* values,
    int64_t nnz, int64_t n_major,
    int32_t dedup, int32_t drop_zeros,
    int64_t* ptr, int64_t* out_minor, double* out_values) {
  std::vector<int64_t> order(nnz);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [major, minor](int64_t a, int64_t b) {
                     if (major[a] != major[b]) return major[a] < major[b];
                     return minor[a] < minor[b];
                   });

  // Pass 1: write sorted triplets; pass 2 merges/drops in place.
  int64_t out = nnz;
  std::vector<int64_t> maj(nnz);
  for (int64_t k = 0; k < nnz; ++k) {
    int64_t e = order[k];
    maj[k] = major[e];
    out_minor[k] = minor[e];
    out_values[k] = values[e];
  }

  int64_t w = 0;
  for (int64_t k = 0; k < out;) {
    int64_t m = maj[k], c = out_minor[k];
    double v = out_values[k];
    int64_t j = k + 1;
    if (dedup) {
      while (j < out && maj[j] == m && out_minor[j] == c) {
        v += out_values[j];
        ++j;
      }
    }
    if (!(drop_zeros && v == 0.0)) {
      maj[w] = m;
      out_minor[w] = c;
      out_values[w] = v;
      ++w;
    }
    k = j;
  }

  std::memset(ptr, 0, sizeof(int64_t) * (n_major + 1));
  for (int64_t k = 0; k < w; ++k) ptr[maj[k] + 1]++;
  for (int64_t i = 0; i < n_major; ++i) ptr[i + 1] += ptr[i];
  return w;
}

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

// ---------------------------------------------------------------------
// RCM ordering. adjacency = CSR structure (assumed structurally
// symmetric). Writes perm (n). Matches linalg/ordering.rcm_ordering.
// ---------------------------------------------------------------------
void spal_rcm(const int64_t* ptr, const int64_t* ind, int64_t n,
              int64_t* perm) {
  std::vector<int64_t> deg(n);
  for (int64_t i = 0; i < n; ++i) deg[i] = ptr[i + 1] - ptr[i];
  std::vector<uint8_t> visited(n, 0);
  std::vector<int64_t> order;
  order.reserve(n);
  std::vector<int64_t> nbrs;

  auto bfs = [&](int64_t start, std::vector<int64_t>& out) {
    out.clear();
    visited[start] = 1;
    std::queue<int64_t> q;
    q.push(start);
    while (!q.empty()) {
      int64_t u = q.front();
      q.pop();
      out.push_back(u);
      nbrs.clear();
      for (int64_t k = ptr[u]; k < ptr[u + 1]; ++k) {
        int64_t v = ind[k];
        if (!visited[v]) nbrs.push_back(v);
      }
      std::stable_sort(nbrs.begin(), nbrs.end(),
                       [&](int64_t a, int64_t b) { return deg[a] < deg[b]; });
      for (int64_t v : nbrs)
        if (!visited[v]) {
          visited[v] = 1;
          q.push(v);
        }
    }
  };

  std::vector<int64_t> comp;
  for (int64_t s = 0; s < n; ++s) {
    if (visited[s]) continue;
    bfs(s, comp);                       // first sweep
    for (int64_t u : comp) visited[u] = 0;
    bfs(comp.back(), comp);             // restart from pseudo-periphery
    order.insert(order.end(), comp.begin(), comp.end());
  }
  for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

// ---------------------------------------------------------------------
// Level schedule for triangular solves. Writes lev (n); returns n_levels.
// ---------------------------------------------------------------------
int64_t spal_level_schedule(const int64_t* ptr, const int64_t* ind,
                            int64_t n, int32_t lower, int64_t* lev) {
  int64_t max_lev = -1;
  if (lower) {
    for (int64_t i = 0; i < n; ++i) {
      int64_t l = 0;
      for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k)
        if (ind[k] < i && lev[ind[k]] + 1 > l) l = lev[ind[k]] + 1;
      lev[i] = l;
      if (l > max_lev) max_lev = l;
    }
  } else {
    for (int64_t i = n - 1; i >= 0; --i) {
      int64_t l = 0;
      for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k)
        if (ind[k] > i && lev[ind[k]] + 1 > l) l = lev[ind[k]] + 1;
      lev[i] = l;
      if (l > max_lev) max_lev = l;
    }
  }
  return max_lev + 1;
}

// ---------------------------------------------------------------------
// Elimination tree of a (structurally symmetric) matrix given its full
// CSR structure. parent[j] = -1 for roots. Classic Liu algorithm with
// path compression. Matches linalg/symbolic.etree.
// ---------------------------------------------------------------------
void spal_etree(const int64_t* ptr, const int64_t* ind, int64_t n,
                int64_t* parent) {
  std::vector<int64_t> anc(n, -1);
  for (int64_t i = 0; i < n; ++i) parent[i] = -1;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = ptr[i]; p < ptr[i + 1]; ++p) {
      int64_t j = ind[p];
      while (j != -1 && j < i) {
        int64_t next = anc[j];
        anc[j] = i;
        if (next == -1) {
          parent[j] = i;
          break;
        }
        j = (next == i) ? -1 : next;
      }
    }
  }
}

// ---------------------------------------------------------------------
// Supernodal Cholesky symbolic phase. Input: full symmetric CSR
// structure, POSTORDERED (children column indices < parent). Computes
// the etree, per-column L structures bottom-up (merging child
// structures), fundamental supernodes (parent[j-1]==j and
// count[j]==count[j-1]-1), and per-supernode row structures
// (struct(first column) = supernode columns + strictly-below rows).
//
// Two-call protocol: with rows_idx == null returns the total structure
// length and fills parent (n), nsn_out (1), snode_ptr (first nsn+1
// slots of an (n+1) buffer), rows_ptr (first nsn+1 slots); the second
// call also fills rows_idx.
// ---------------------------------------------------------------------
int64_t spal_chol_symbolic(const int64_t* ptr, const int64_t* ind,
                           int64_t n, int64_t* parent, int64_t* nsn_out,
                           int64_t* snode_ptr, int64_t* rows_ptr,
                           int64_t* rows_idx) {
  spal_etree(ptr, ind, n, parent);

  // children lists (counting sort by parent)
  std::vector<int64_t> child_ptr(n + 2, 0), child(n);
  for (int64_t j = 0; j < n; ++j)
    if (parent[j] >= 0) child_ptr[parent[j] + 2]++;
  for (int64_t i = 2; i <= n + 1; ++i) child_ptr[i] += child_ptr[i - 1];
  for (int64_t j = 0; j < n; ++j)
    if (parent[j] >= 0) child[child_ptr[parent[j] + 1]++] = j;

  std::vector<std::vector<int64_t>> st(n);  // freed after parent merge
  std::vector<int64_t> mark(n, -1);
  std::vector<int64_t> count(n, 0);

  int64_t nsn = 0;
  int64_t total = 0;
  snode_ptr[0] = 0;
  rows_ptr[0] = 0;
  std::vector<int64_t> snode_first;  // first column of each snode
  snode_first.reserve(64);

  for (int64_t j = 0; j < n; ++j) {
    auto& s = st[j];
    mark[j] = j;
    s.push_back(j);
    for (int64_t p = ptr[j]; p < ptr[j + 1]; ++p) {
      int64_t i = ind[p];
      if (i > j && mark[i] != j) {
        mark[i] = j;
        s.push_back(i);
      }
    }
    for (int64_t cp = child_ptr[j]; cp < child_ptr[j + 1]; ++cp) {
      auto& cs = st[child[cp]];
      for (int64_t i : cs) {
        if (i > j && mark[i] != j) {
          mark[i] = j;
          s.push_back(i);
        }
      }
      std::vector<int64_t>().swap(cs);  // free child structure
    }
    count[j] = (int64_t)s.size();

    bool fresh = (j == 0) || !(parent[j - 1] == j &&
                               count[j] == count[j - 1] - 1);
    if (fresh) {
      snode_first.push_back(j);
      ++nsn;
      snode_ptr[nsn] = j + 1;
      total += count[j];
      rows_ptr[nsn] = total;
      if (rows_idx) {
        std::vector<int64_t> sorted(s);
        std::sort(sorted.begin(), sorted.end());
        std::copy(sorted.begin(), sorted.end(),
                  rows_idx + rows_ptr[nsn - 1]);
      }
    } else {
      snode_ptr[nsn] = j + 1;
    }
  }
  *nsn_out = nsn;
  return total;
}

// ---------------------------------------------------------------------
// Approximate minimum-degree ordering (AMD-style quotient graph with
// element absorption and AMD's degree bound; no supervariable
// detection). Input: full symmetric CSR structure WITHOUT the diagonal
// being required. Writes perm (n): perm[k] = the k-th pivot.
// ---------------------------------------------------------------------
void spal_amd(const int64_t* ptr, const int64_t* ind, int64_t n,
              int64_t* perm) {
  // adjacency storage: per node, a list of variable neighbours and a
  // list of element ids.
  std::vector<std::vector<int64_t>> vadj(n), eadj(n);
  std::vector<int64_t> deg(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = ptr[i]; p < ptr[i + 1]; ++p) {
      int64_t j = ind[p];
      if (j != i) vadj[i].push_back(j);
    }
    deg[i] = (int64_t)vadj[i].size();
  }
  // elements: boundary lists (index space separate from variables)
  std::vector<std::vector<int64_t>> ebnd;
  std::vector<uint8_t> edead;
  std::vector<int64_t> ew, esee;  // per-element |Le \ Lp| + visit stamp
  std::vector<uint8_t> eliminated(n, 0);
  std::vector<int64_t> mark(n, -1);
  int64_t stamp = 0;

  // bucket queue on degree
  std::vector<std::vector<int64_t>> bucket(n + 1);
  std::vector<int64_t> bpos(n, 0);
  for (int64_t i = 0; i < n; ++i) bucket[deg[i]].push_back(i);
  int64_t cur = 0;

  std::vector<int64_t> Lp;
  for (int64_t k = 0; k < n; ++k) {
    // pop the minimum-degree live variable
    int64_t v = -1;
    while (true) {
      while (cur <= n && bucket[cur].empty()) ++cur;
      v = bucket[cur].back();
      bucket[cur].pop_back();
      // stale slots are dropped: every degree update pushed a fresh
      // entry at bucket[deg[v]], so a live one exists there.
      if (!eliminated[v] && deg[v] == cur) break;
    }
    perm[k] = v;
    eliminated[v] = 1;

    // Lp = live variable neighbours of v  U  boundaries of v's elements
    ++stamp;
    Lp.clear();
    mark[v] = stamp;
    for (int64_t u : vadj[v])
      if (!eliminated[u] && mark[u] != stamp) {
        mark[u] = stamp;
        Lp.push_back(u);
      }
    for (int64_t e : eadj[v]) {
      if (edead[e]) continue;
      for (int64_t u : ebnd[e])
        if (!eliminated[u] && mark[u] != stamp) {
          mark[u] = stamp;
          Lp.push_back(u);
        }
      edead[e] = 1;  // absorbed into the new element
    }
    int64_t enew = (int64_t)ebnd.size();
    ebnd.push_back(Lp);
    edead.push_back(0);
    ew.resize(ebnd.size(), 0);
    esee.resize(ebnd.size(), -1);

    // pass 1: for every live element touching Lp, prune its boundary
    // (drop eliminated) and compute w(e) = |Le \ Lp| exactly — Lp
    // members carry mark[.] == stamp.
    for (int64_t u : Lp) {
      for (int64_t e : eadj[u]) {
        if (edead[e] || esee[e] == stamp) continue;
        esee[e] = stamp;
        auto& be = ebnd[e];
        int64_t w = 0, outside = 0;
        for (int64_t x : be)
          if (!eliminated[x]) {
            be[w++] = x;
            if (mark[x] != stamp) ++outside;
          }
        be.resize(w);
        ew[e] = outside;
      }
    }

    // pass 2: per neighbour, prune adjacency, attach enew, and set the
    // AMD degree d_u = |A_u \ Lp| + |Lp \ u| + sum w(e) over u's other
    // live elements (clipped at n-k-1).
    for (int64_t u : Lp) {
      auto& ea = eadj[u];
      int64_t w = 0;
      for (int64_t e : ea)
        if (!edead[e]) ea[w++] = e;
      ea.resize(w);
      auto& va = vadj[u];
      w = 0;
      int64_t a_out = 0;
      for (int64_t x : va)
        if (!eliminated[x]) {
          va[w++] = x;
          if (mark[x] != stamp) ++a_out;
        }
      va.resize(w);
      int64_t d = a_out + (int64_t)Lp.size() - 1;
      for (int64_t e : ea) d += ew[e];
      ea.push_back(enew);
      d = std::min(d, n - k - 1);
      if (d < 0) d = 0;
      deg[u] = d;
      bucket[d].push_back(u);
      if (d < cur) cur = d;
    }
  }
}

// ---------------------------------------------------------------------
// ILU(0): incomplete LU restricted to the pattern, in-place on `val`
// (CSR with sorted column indices). IKJ sweep (Saad Alg. 10.4) with a
// per-row column->slot map. Returns -1 on success, else the row of the
// first zero pivot / missing diagonal.
// ---------------------------------------------------------------------
int64_t spal_ilu0(const int64_t* ptr, const int64_t* ind, double* val,
                  int64_t n) {
  std::vector<int64_t> diag(n, -1), pos(n, -1);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t k = ptr[i]; k < ptr[i + 1]; ++k)
      if (ind[k] == i) diag[i] = k;
  for (int64_t i = 0; i < n; ++i)
    if (diag[i] < 0) return i;

  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = ptr[i], hi = ptr[i + 1];
    for (int64_t k = lo; k < hi; ++k) pos[ind[k]] = k;
    for (int64_t kk = lo; kk < hi; ++kk) {
      const int64_t k = ind[kk];
      if (k >= i) break;  // columns sorted
      const double piv = val[diag[k]];
      if (piv == 0.0) { for (int64_t q = lo; q < hi; ++q) pos[ind[q]] = -1;
                        return k; }
      const double lik = val[kk] / piv;
      val[kk] = lik;
      for (int64_t jj = diag[k] + 1; jj < ptr[k + 1]; ++jj) {
        const int64_t p = pos[ind[jj]];
        if (p >= 0) val[p] -= lik * val[jj];
      }
    }
    for (int64_t k = lo; k < hi; ++k) pos[ind[k]] = -1;
    if (val[diag[i]] == 0.0) return i;
  }
  return -1;
}

// ---------------------------------------------------------------------
// IC(0): incomplete Cholesky on the LOWER pattern (lptr/lind/lval CSR of
// the lower triangle incl. diagonal, columns sorted so the diagonal is
// each row's last entry). In-place on lval. Returns -1 on success, else
// the row whose pivot went non-positive (not SPD under zero fill) or
// whose diagonal is missing.
// ---------------------------------------------------------------------
int64_t spal_ic0(const int64_t* lptr, const int64_t* lind, double* lval,
                 int64_t n) {
  std::vector<int64_t> pos(n, -1), dpos(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    if (lptr[i + 1] <= lptr[i] || lind[lptr[i + 1] - 1] != i) return i;
    dpos[i] = lptr[i + 1] - 1;
  }
  for (int64_t i = 0; i < n; ++i) {
    const int64_t lo = lptr[i], hi = lptr[i + 1];
    for (int64_t k = lo; k < hi; ++k) pos[lind[k]] = k;
    for (int64_t kk = lo; kk < hi; ++kk) {
      const int64_t j = lind[kk];
      double s = lval[kk];
      // s -= sum over shared columns col < j of L[i,col] * L[j,col]
      for (int64_t jj = lptr[j]; jj < dpos[j]; ++jj) {
        const int64_t p = pos[lind[jj]];
        if (p >= 0 && lind[jj] < j) s -= lval[p] * lval[jj];
      }
      if (j < i) {
        lval[kk] = s / lval[dpos[j]];
      } else {  // diagonal (last entry)
        if (s <= 0.0) { for (int64_t q = lo; q < hi; ++q) pos[lind[q]] = -1;
                        return i; }
        lval[kk] = std::sqrt(s);
      }
    }
    for (int64_t k = lo; k < hi; ++k) pos[lind[k]] = -1;
  }
  return -1;
}

}  // extern "C"
