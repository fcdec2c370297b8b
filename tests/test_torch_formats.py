"""Formats and conversions of the PyTorch port against the JAX package.

Replays the JAX package's own case tables (``test_coo.py``, ``test_dok.py``,
``test_csr.py``, ``test_convert.py`` and the COO/DOK/CSR/CSC rows of
``test_raises_parity.py``) through both packages: each case is a function
of the package, and both must give the same value or raise an error of the
same class (the port's own). Then all 12 conversion edges run on random
matrices with duplicates and explicit zeros: structure must match exactly
and values bit for bit, since both packages use the NumPy host engine and
the same stable orderings.
"""

import numpy as np
import pytest
import torch

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.convert import conversions as jconv
from spalinalg_tpu_torch.convert import conversions as tconv


def host(a):
    """A package's array (JAX array, torch tensor, NumPy) as NumPy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def hl(a):
    return host(a).tolist()


def dtname(d):
    return str(d).removeprefix("torch.")


def outcome(case, pkg):
    """``("ok", value)`` or ``("raises", error class name)``; an error from
    the port must be one of the port's own classes."""
    try:
        return ("ok", case(pkg))
    except pkg.SpalinalgError as e:
        return ("raises", type(e).__name__)


def replay(case):
    got = outcome(case, tsp)
    assert got == outcome(case, jsp)
    return got


# ---------------------------------------------------------------- COO


def _coo_push_pop_clear(m):
    a = m.CooMatrix(3, 3)
    a.push(1, 2, 4.0)
    a.push(0, 0, 1.0)
    out = [a.length, a.pop(), a.length]
    a.clear()
    return out + [a.length, a.pop()]


def _coo_set_value(m):
    a = m.CooMatrix.with_entries(2, 3, [(0, 1, 5.0)])
    a.set_value(0, 7.0)
    return a.get(0)


def _coo_extend_oob(m):
    a = m.CooMatrix(2, 2)
    try:
        a.extend([(0, 0, 1.0), (5, 0, 2.0)])
    except m.IndexError_:
        return ("raised", a.length)
    return ("appended", a.length)


def _coo_map_values(m):
    a = m.CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (1, 1, 2.0)])
    return list(a.map_values(lambda v: v * 10)), list(a)


def _coo_extend(m):
    a = m.CooMatrix(2, 3)
    a.extend([(0, 0, 1.0), (1, 1, 2.0)])
    return list(a)


def _coo_extend_from_coo(m):
    src = m.CooMatrix.with_entries(2, 3, [(0, 0, 1.0), (1, 2, 5.0)])
    a = m.CooMatrix(2, 3)
    a.extend(src)
    return list(a)


COO_CASES = [
    ("new", lambda m: (m.CooMatrix(2, 3).shape, m.CooMatrix(2, 3).length)),
    ("new_zero_rows", lambda m: m.CooMatrix(0, 3)),
    ("new_zero_cols", lambda m: m.CooMatrix(2, 0)),
    ("eye", lambda m: list(m.CooMatrix.eye(3))),
    ("with_capacity", lambda m: (m.CooMatrix.with_capacity(2, 3, 10).capacity
                                 >= 10, m.CooMatrix.with_capacity(2, 3, 10)
                                 .length)),
    ("with_capacity_zero_dims", lambda m: m.CooMatrix.with_capacity(0, 3, 10)),
    ("with_entries", lambda m: list(m.CooMatrix.with_entries(
        2, 3, [(0, 0, 1.0), (1, 2, 2.0)]))),
    ("with_entries_row_oob",
     lambda m: m.CooMatrix.with_entries(2, 3, [(2, 0, 1.0)])),
    ("with_entries_col_oob",
     lambda m: m.CooMatrix.with_entries(2, 3, [(0, 3, 1.0)])),
    ("with_triplets", lambda m: list(m.CooMatrix.with_triplets(
        2, 3, [0, 1], [0, 2], [1.0, 2.0]))),
    ("with_triplets_length_mismatch",
     lambda m: m.CooMatrix.with_triplets(2, 3, [0, 1], [0], [1.0, 2.0])),
    ("with_triplets_oob",
     lambda m: m.CooMatrix.with_triplets(2, 3, [5], [0], [1.0])),
    ("shape_accessors", lambda m: (m.CooMatrix(2, 3).nrows,
                                   m.CooMatrix(2, 3).ncols)),
    ("get", lambda m: [m.CooMatrix.with_entries(2, 3, [(0, 1, 5.0)]).get(i)
                       for i in (0, 1)]),
    ("set_value", _coo_set_value),
    ("set_value_oob", lambda m: m.CooMatrix.with_entries(
        2, 3, [(0, 1, 5.0)]).set_value(3, 1.0)),
    ("push_pop_clear", _coo_push_pop_clear),
    ("push_row_oob", lambda m: m.CooMatrix(2, 3).push(2, 0, 1.0)),
    ("push_col_oob", lambda m: m.CooMatrix(2, 3).push(0, 3, 1.0)),
    ("duplicates_allowed", lambda m: m.CooMatrix.with_entries(
        2, 2, [(0, 0, 1.0), (0, 0, 2.0)]).length),
    ("extend", _coo_extend),
    ("transpose", lambda m: (m.CooMatrix.with_entries(
        2, 3, [(0, 2, 1.0), (1, 0, 2.0)]).transpose().shape, list(
        m.CooMatrix.with_entries(2, 3, [(0, 2, 1.0), (1, 0, 2.0)]).T))),
    ("map_values", _coo_map_values),
    ("add_concatenates", lambda m: list(
        m.CooMatrix.with_entries(2, 2, [(0, 0, 1.0)])
        + m.CooMatrix.with_entries(2, 2, [(0, 0, 2.0), (1, 1, 3.0)]))),
    ("add_shape_mismatch", lambda m: m.CooMatrix(2, 2) + m.CooMatrix(2, 3)),
    ("sub_concatenates_negated", lambda m: list(
        m.CooMatrix.with_entries(2, 2, [(0, 0, 1.0)])
        - m.CooMatrix.with_entries(2, 2, [(1, 1, 3.0)]))),
    ("neg", lambda m: list(-m.CooMatrix.with_entries(
        2, 2, [(0, 0, 1.0), (1, 0, -2.0)]))),
    ("to_dense_sums_duplicates", lambda m: m.CooMatrix.with_entries(
        2, 2, [(0, 0, 1.0), (0, 0, 2.0)]).to_dense().tolist()),
    ("extend_from_coo", _coo_extend_from_coo),
    ("extend_oob_appends_nothing", _coo_extend_oob),
    ("float32_dtype", lambda m: m.CooMatrix(2, 2, dtype=np.float32)
     .dtype.name),
]


@pytest.mark.parametrize("case", [c[1] for c in COO_CASES],
                         ids=[c[0] for c in COO_CASES])
def test_coo_cases(case):
    replay(case)


# ---------------------------------------------------------------- DOK


def _dok_insert(m):
    a = m.DokMatrix(2, 2)
    return [a.insert(0, 0, 1.0), a.insert(0, 0, 2.0), a.get(0, 0), a.length]


def _dok_remove(m):
    a = m.DokMatrix.with_entries(2, 2, [(0, 1, 3.0)])
    return [a.remove(0, 1), a.remove(0, 1), a.length]


def _dok_clear(m):
    a = m.DokMatrix.eye(3)
    a.clear()
    return a.length


def _dok_contains(m):
    a = m.DokMatrix.with_entries(2, 2, [(0, 1, 3.0)])
    return [a.contains(0, 1), a.contains(1, 0)]


def _dok_merge(m, sign):
    a = m.DokMatrix.with_entries(2, 2, [(0, 0, 1.0), (1, 1, 2.0)])
    b = m.DokMatrix.with_entries(2, 2, [(0, 0, 10.0), (1, 0, -1.0)])
    c = a + b if sign > 0 else a - b
    return sorted(c.iter())


DOK_CASES = [
    ("new", lambda m: (m.DokMatrix(2, 3).shape, m.DokMatrix(2, 3).length)),
    ("new_zero_rows", lambda m: m.DokMatrix(0, 3)),
    ("new_zero_cols", lambda m: m.DokMatrix(2, 0)),
    ("eye", lambda m: (m.DokMatrix.eye(3).length, m.DokMatrix.eye(3).get(1, 1),
                       m.DokMatrix.eye(3).get(0, 1))),
    ("with_entries_overwrites", lambda m: sorted(m.DokMatrix.with_entries(
        2, 2, [(0, 0, 1.0), (0, 0, 9.0)]).iter())),
    ("with_triplets_length_mismatch",
     lambda m: m.DokMatrix.with_triplets(2, 2, [0], [0, 1], [1.0])),
    ("insert_returns_old", _dok_insert),
    ("insert_row_oob", lambda m: m.DokMatrix(2, 2).insert(2, 0, 1.0)),
    ("insert_col_oob", lambda m: m.DokMatrix(2, 2).insert(0, 5, 1.0)),
    ("contains", _dok_contains),
    ("contains_oob", lambda m: m.DokMatrix(2, 2).contains(5, 0)),
    ("get_oob", lambda m: m.DokMatrix(2, 2).get(2, 0)),
    ("remove", _dok_remove),
    ("clear", _dok_clear),
    ("transpose", lambda m: (m.DokMatrix.with_entries(
        2, 3, [(0, 2, 1.0), (1, 0, 2.0)]).transpose().shape, sorted(
        m.DokMatrix.with_entries(2, 3, [(0, 2, 1.0), (1, 0, 2.0)]).T.iter()))),
    ("add_merges_by_key", lambda m: _dok_merge(m, +1)),
    ("sub", lambda m: _dok_merge(m, -1)),
    ("add_keeps_cancelled_zero", lambda m: sorted(
        (m.DokMatrix.with_entries(2, 2, [(0, 0, 1.0)])
         + m.DokMatrix.with_entries(2, 2, [(0, 0, -1.0)])).iter())),
    ("add_shape_mismatch", lambda m: m.DokMatrix(2, 2) + m.DokMatrix(3, 2)),
    ("neg", lambda m: (-m.DokMatrix.with_entries(2, 2, [(0, 0, 1.0)]))
     .get(0, 0)),
    ("to_dense", lambda m: m.DokMatrix.with_entries(
        2, 2, [(0, 1, 2.0), (1, 0, 3.0)]).to_dense().tolist()),
]


@pytest.mark.parametrize("case", [c[1] for c in DOK_CASES],
                         ids=[c[0] for c in DOK_CASES])
def test_dok_cases(case):
    replay(case)


# ---------------------------------------------------------------- CSR/CSC

REF_ROWPTR = [0, 2, 3, 5, 6]
REF_COLIND = [0, 2, 1, 2, 3, 3]
REF_VALUES = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
CSC_PTR, CSC_IND = [0, 1, 2, 4, 6], [0, 1, 0, 2, 2, 3]
CSC_VALUES = [1.0, 3.0, 2.0, 4.0, 5.0, 6.0]


def ref_csr(m):
    return m.CsrMatrix(4, 4, REF_ROWPTR, REF_COLIND, REF_VALUES)


def ref_csc(m):
    return m.CscMatrix(4, 4, CSC_PTR, CSC_IND, CSC_VALUES)


def _sorted_structure(m):
    t = m.CsrMatrix(2, 3, [0, 2, 3], [0, 2, 1], [1.0, 2.0, 3.0]).transpose()
    return t.shape, hl(t.rowptr), hl(t.colind), hl(t.values)


CSR_CASES = [
    ("valid_construction", lambda m: (ref_csr(m).shape, ref_csr(m).nnz)),
    ("zero_dims", lambda m: m.CsrMatrix(0, 4, [0], [], [])),
    ("bad_ptr_length",
     lambda m: m.CsrMatrix(4, 4, [0, 2, 3], REF_COLIND, REF_VALUES)),
    ("ptr_not_zero",
     lambda m: m.CsrMatrix(4, 4, [1, 2, 3, 5, 6], REF_COLIND, REF_VALUES)),
    ("ind_length_mismatch",
     lambda m: m.CsrMatrix(4, 4, REF_ROWPTR, [0, 2, 1], REF_VALUES)),
    ("values_length_mismatch",
     lambda m: m.CsrMatrix(4, 4, REF_ROWPTR, REF_COLIND, [1.0, 2.0])),
    ("non_monotone_ptr",
     lambda m: m.CsrMatrix(4, 4, [0, 3, 2, 5, 6], REF_COLIND, REF_VALUES)),
    ("index_out_of_range",
     lambda m: m.CsrMatrix(4, 4, REF_ROWPTR, [0, 9, 1, 2, 3, 3], REF_VALUES)),
    ("unsorted_indices",
     lambda m: m.CsrMatrix(4, 4, REF_ROWPTR, [2, 0, 1, 2, 3, 3], REF_VALUES)),
    ("duplicate_indices",
     lambda m: m.CsrMatrix(4, 4, REF_ROWPTR, [0, 0, 1, 2, 3, 3], REF_VALUES)),
    ("arrays", lambda m: (hl(ref_csr(m).rowptr), hl(ref_csr(m).colind),
                          hl(ref_csr(m).values))),
    ("eye", lambda m: (hl(m.CsrMatrix.eye(3).to_dense()),
                       m.CsrMatrix.eye(3).nnz)),
    ("iter_row_major", lambda m: list(ref_csr(m))),
    ("with_values", lambda m: hl(ref_csr(m).with_values(
        host(ref_csr(m).values) * 2).values)),
    ("with_values_wrong_length",
     lambda m: ref_csr(m).with_values(np.ones(3))),
    ("map_values_nrows", lambda m: hl(m.CsrMatrix(
        2, 5, [0, 1, 2], [0, 4], [1.0, 2.0]).map_values(lambda v: v * 10)
        .values)),
    ("to_dense", lambda m: hl(ref_csr(m).to_dense())),
    ("transpose_values", lambda m: hl(ref_csr(m).transpose().to_dense())),
    ("transpose_sorted_structure", _sorted_structure),
    ("double_transpose", lambda m: hl(ref_csr(m).T.T.to_dense())),
    ("csc_valid_construction", lambda m: (hl(ref_csc(m).to_dense()),
                                          ref_csc(m).nnz)),
    ("csc_bad_ptr_length", lambda m: m.CscMatrix(4, 4, [0, 1], [0], [1.0])),
    ("csc_unsorted_in_column",
     lambda m: m.CscMatrix(2, 2, [0, 2, 2], [1, 0], [1.0, 2.0])),
    ("csc_iter_column_major", lambda m: list(ref_csc(m))),
    ("csc_transpose", lambda m: (
        m.CscMatrix(2, 3, [0, 1, 2, 3], [0, 1, 0], [1.0, 2.0, 3.0]).T.shape,
        hl(m.CscMatrix(2, 3, [0, 1, 2, 3], [0, 1, 0], [1.0, 2.0, 3.0])
           .transpose().to_dense()))),
    ("astype_float32", lambda m: (dtname(m.CsrMatrix.eye(3).astype(
        "float32").dtype), hl(m.CsrMatrix.eye(3).astype("float32")
                              .to_dense()))),
    ("astype_bfloat16", lambda m: dtname(
        m.CsrMatrix.eye(3).astype("float32").astype("bfloat16").dtype)),
    ("astype_int32", lambda m: m.CsrMatrix.eye(3).astype("int32")),
    ("astype_float16", lambda m: m.CsrMatrix.eye(3).astype("float16")),
    ("float32_values_kept", lambda m: dtname(m.CsrMatrix(
        2, 2, [0, 1, 2], [0, 1], np.ones(2, np.float32)).dtype)),
    ("integer_values_become_float64", lambda m: dtname(m.CsrMatrix(
        2, 2, [0, 1, 2], [0, 1], [1, 2]).dtype)),
]


@pytest.mark.parametrize("case", [c[1] for c in CSR_CASES],
                         ids=[c[0] for c in CSR_CASES])
def test_csr_cases(case):
    replay(case)


# ---------------------------------------------------- golden conversions

GOLDEN_ENTRIES = [(2, 2, 4.0), (0, 0, 1.0), (0, 0, 2.0), (1, 1, 0.0),
                  (3, 3, 5.0), (3, 3, -5.0), (0, 2, 7.0)]


def _compressed_arrays(mat):
    return hl(mat._ptr), hl(mat._minor), hl(mat.values)


def _sample_csr(m):
    return m.CsrMatrix(3, 4, [0, 2, 2, 4], [0, 3, 1, 2], [1.0, 2.0, 3.0, 4.0])


def _sample_csc(m):
    return m.CscMatrix(3, 3, [0, 1, 2, 3], [2, 0, 1], [1.0, 2.0, 3.0])


def _roundtrip_dense(m):
    rng = np.random.default_rng(1234)
    n = 37
    coo = m.CooMatrix(n, n)
    for _ in range(150):
        coo.push(int(rng.integers(n)), int(rng.integers(n)),
                 float(rng.normal()))
    return hl(m.CsrMatrix.from_coo(coo).to_dense())


CONVERT_CASES = [
    ("coo_to_csr_dedup_and_zero_drop", lambda m: _compressed_arrays(
        m.CsrMatrix.from_coo(m.CooMatrix.with_entries(4, 4, GOLDEN_ENTRIES)))),
    ("coo_to_csc_mirror", lambda m: _compressed_arrays(
        m.CscMatrix.from_coo(m.CooMatrix.with_entries(4, 4, GOLDEN_ENTRIES)))),
    ("roundtrip_dense_equality", _roundtrip_dense),
    ("dok_keeps_explicit_zeros", lambda m: _compressed_arrays(
        m.CsrMatrix.from_dok(m.DokMatrix.with_entries(
            3, 3, [(0, 0, 0.0), (1, 2, 5.0)])))),
    ("dok_to_csc", lambda m: _compressed_arrays(m.CscMatrix.from_dok(
        m.DokMatrix.with_entries(3, 3, [(2, 0, 1.0), (0, 1, 2.0)])))),
    ("csr_to_csc_same_matrix", lambda m: (
        type(_sample_csr(m).to_csc()).__name__,
        _compressed_arrays(_sample_csr(m).to_csc()))),
    ("csc_to_csr_same_matrix",
     lambda m: _compressed_arrays(_sample_csc(m).to_csr())),
    ("csr_csc_keeps_explicit_zero", lambda m: m.CsrMatrix(
        2, 2, [0, 1, 2], [0, 1], [0.0, 5.0]).to_csc().nnz),
    ("csr_to_coo_order", lambda m: list(_sample_csr(m).to_coo())),
    ("csc_to_coo_order", lambda m: list(_sample_csc(m).to_coo())),
    ("csr_to_dok", lambda m: sorted(_sample_csr(m).to_dok().iter())),
    ("coo_to_dok_sums_duplicates", lambda m: sorted(
        (jconv if m is jsp else tconv).coo_to_dok(m.CooMatrix.with_entries(
            2, 2, [(0, 0, 1.0), (0, 0, 2.0)])).iter())),
    ("dok_to_coo", lambda m: list((jconv if m is jsp else tconv).dok_to_coo(
        m.DokMatrix.with_entries(2, 2, [(0, 1, 2.0), (1, 0, 3.0)])))),
]


@pytest.mark.parametrize("case", [c[1] for c in CONVERT_CASES],
                         ids=[c[0] for c in CONVERT_CASES])
def test_golden_conversions(case):
    replay(case)


# ------------------------------------------------------- raises parity

# (name in test_raises_parity.py, thunk of the package)
RAISES = [
    ("coo_new_invalid_nrows", lambda m: m.CooMatrix(0, 1)),
    ("coo_new_invalid_ncols", lambda m: m.CooMatrix(1, 0)),
    ("coo_with_capacity_invalid_nrows",
     lambda m: m.CooMatrix.with_capacity(0, 1, 1)),
    ("coo_with_capacity_invalid_ncols",
     lambda m: m.CooMatrix.with_capacity(1, 0, 1)),
    ("coo_with_entries_invalid_nrows",
     lambda m: m.CooMatrix.with_entries(0, 1, [(0, 0, 1.0)])),
    ("coo_with_entries_invalid_ncols",
     lambda m: m.CooMatrix.with_entries(1, 0, [(0, 0, 1.0)])),
    ("coo_with_entries_invalid_row",
     lambda m: m.CooMatrix.with_entries(1, 2, [(1, 0, 1.0)])),
    ("coo_with_entries_invalid_col",
     lambda m: m.CooMatrix.with_entries(2, 1, [(0, 1, 1.0)])),
    ("coo_with_triplets_invalid_nrows",
     lambda m: m.CooMatrix.with_triplets(0, 1, [0], [0], [1.0])),
    ("coo_with_triplets_invalid_ncols",
     lambda m: m.CooMatrix.with_triplets(1, 0, [0], [0], [1.0])),
    ("coo_with_triplets_invalid_triplets_rowind_length",
     lambda m: m.CooMatrix.with_triplets(2, 2, [0, 1, 0], [0, 1], [1.0, 2.0])),
    ("coo_with_triplets_invalid_triplets_colind_length",
     lambda m: m.CooMatrix.with_triplets(2, 2, [0, 1], [0, 1, 0], [1.0, 2.0])),
    ("coo_with_triplets_invalid_triplets_values_length",
     lambda m: m.CooMatrix.with_triplets(2, 2, [0, 1], [0, 1],
                                         [1.0, 2.0, 3.0])),
    ("coo_with_triplets_invalid_row",
     lambda m: m.CooMatrix.with_triplets(1, 2, [1], [0], [1.0])),
    ("coo_with_triplets_invalid_col",
     lambda m: m.CooMatrix.with_triplets(2, 1, [0], [1], [1.0])),
    ("coo_push_invalid_row", lambda m: m.CooMatrix(1, 2).push(1, 0, 1.0)),
    ("coo_push_invalid_col", lambda m: m.CooMatrix(2, 1).push(0, 1, 1.0)),
    ("csr_new_invalid_nrows",
     lambda m: m.CsrMatrix(0, 1, [0, 1, 1], [0], [1.0])),
    ("csr_new_invalid_ncols",
     lambda m: m.CsrMatrix(2, 0, [0, 1, 1], [0], [1.0])),
    ("csr_new_invalid_colptr_first_not_zero",
     lambda m: m.CsrMatrix(2, 1, [1, 1, 1], [0], [1.0])),
    ("csr_new_invalid_colptr_invalid_length",
     lambda m: m.CsrMatrix(2, 1, [0, 1], [0], [1.0])),
    ("csr_new_invalid_rowind",
     lambda m: m.CsrMatrix(2, 1, [0, 1, 1], [1], [1.0])),
    ("csr_new_unsorted_colind",
     lambda m: m.CsrMatrix(2, 2, [0, 2, 2], [1, 0], [1.0, 2.0])),
    ("csr_new_invalid_rowind_values",
     lambda m: m.CsrMatrix(2, 1, [0, 1, 1], [0], [1.0, 2.0])),
    ("csc_new_invalid_nrows",
     lambda m: m.CscMatrix(0, 1, [0, 1], [0], [1.0])),
    ("csc_new_invalid_ncols", lambda m: m.CscMatrix(2, 0, [0], [0], [1.0])),
    ("csc_new_invalid_colptr_first_not_zero",
     lambda m: m.CscMatrix(1, 2, [1, 1, 1], [0], [1.0])),
    ("csc_new_invalid_colptr_invalid_length",
     lambda m: m.CscMatrix(1, 2, [0, 1], [0], [1.0])),
    ("csc_new_invalid_rowind",
     lambda m: m.CscMatrix(1, 2, [0, 1, 1], [1], [1.0])),
    ("csc_new_unsorted_rowind",
     lambda m: m.CscMatrix(2, 2, [0, 2, 2], [1, 0], [1.0, 2.0])),
    ("csc_new_invalid_rowind_values",
     lambda m: m.CscMatrix(1, 2, [0, 1, 1], [0], [1.0, 2.0])),
    ("dok_new_invalid_nrows", lambda m: m.DokMatrix(0, 1)),
    ("dok_new_invalid_ncols", lambda m: m.DokMatrix(1, 0)),
    ("dok_with_capacity_invalid_nrows",
     lambda m: m.DokMatrix.with_capacity(0, 1, 1)),
    ("dok_with_capacity_invalid_ncols",
     lambda m: m.DokMatrix.with_capacity(1, 0, 1)),
    ("dok_with_entries_invalid_nrows",
     lambda m: m.DokMatrix.with_entries(0, 1, [(0, 0, 1.0)])),
    ("dok_with_entries_invalid_ncols",
     lambda m: m.DokMatrix.with_entries(1, 0, [(0, 0, 1.0)])),
    ("dok_with_entries_invalid_row",
     lambda m: m.DokMatrix.with_entries(1, 2, [(1, 0, 1.0)])),
    ("dok_with_entries_invalid_col",
     lambda m: m.DokMatrix.with_entries(2, 1, [(0, 1, 1.0)])),
    ("dok_with_triplets_invalid_nrows",
     lambda m: m.DokMatrix.with_triplets(0, 1, [0], [0], [1.0])),
    ("dok_with_triplets_invalid_ncols",
     lambda m: m.DokMatrix.with_triplets(1, 0, [0], [0], [1.0])),
    ("dok_with_triplets_invalid_triplets_rowind_length",
     lambda m: m.DokMatrix.with_triplets(2, 2, [0, 1, 0], [0, 1], [1.0, 2.0])),
    ("dok_with_triplets_invalid_triplets_colind_length",
     lambda m: m.DokMatrix.with_triplets(2, 2, [0, 1], [0, 1, 0], [1.0, 2.0])),
    ("dok_with_triplets_invalid_triplets_values_length",
     lambda m: m.DokMatrix.with_triplets(2, 2, [0, 1], [0, 1], [1.0])),
    ("dok_with_triplets_invalid_row",
     lambda m: m.DokMatrix.with_triplets(1, 2, [1], [0], [1.0])),
    ("dok_with_triplets_invalid_col",
     lambda m: m.DokMatrix.with_triplets(2, 1, [0], [1], [1.0])),
    ("dok_contains_invalid_row", lambda m: m.DokMatrix(1, 2).contains(1, 0)),
    ("dok_contains_invalid_col", lambda m: m.DokMatrix(2, 1).contains(0, 1)),
    ("dok_get_invalid_row", lambda m: m.DokMatrix(1, 2).get(1, 0)),
    ("dok_get_invalid_col", lambda m: m.DokMatrix(2, 1).get(0, 1)),
    ("dok_get_mut_invalid_row", lambda m: m.DokMatrix(1, 2).remove(1, 0)),
    ("dok_get_mut_invalid_col", lambda m: m.DokMatrix(2, 1).remove(0, 1)),
    ("dok_insert_invalid_row", lambda m: m.DokMatrix(1, 2).insert(1, 0, 1.0)),
    ("dok_insert_invalid_col", lambda m: m.DokMatrix(2, 1).insert(0, 1, 1.0)),
]

assert len(RAISES) == 54


@pytest.mark.parametrize("thunk", [c[1] for c in RAISES],
                         ids=[c[0] for c in RAISES])
def test_raises_parity(thunk):
    kind, name = replay(thunk)
    assert kind == "raises"
    assert issubclass(getattr(tsp, name), tsp.SpalinalgError)


# ------------------------------------------- all 12 edges, random input


def _triplets(dtype):
    """40 x 50 triplets with duplicates and explicit zeros."""
    rng = np.random.default_rng(7)
    k = 600
    rows = rng.integers(0, 40, size=k)
    cols = rng.integers(0, 50, size=k)
    vals = rng.normal(size=k).astype(dtype)
    vals[rng.random(k) < 0.1] = 0
    rows = np.concatenate([rows, rows[:50]])
    cols = np.concatenate([cols, cols[:50]])
    vals = np.concatenate([vals, -vals[:25], rng.normal(size=25).astype(dtype)])
    return rows, cols, vals


def _host_formats(m, dtype):
    rows, cols, vals = _triplets(dtype)
    coo = m.CooMatrix.with_triplets(40, 50, rows, cols, vals)
    dok = m.DokMatrix.with_triplets(40, 50, rows, cols, vals)
    return coo, dok


def _exact(mat):
    """A conversion result as exactly comparable host data."""
    if isinstance(mat, (jsp.CsrMatrix, jsp.CscMatrix, tsp.CsrMatrix,
                        tsp.CscMatrix)):
        return (type(mat).__name__, mat.shape, host(mat._ptr).tolist(),
                host(mat._minor).tolist(), host(mat.values).tobytes())
    if isinstance(mat, (jsp.CooMatrix, tsp.CooMatrix)):
        r, c, v = mat.to_arrays()
        return ("coo", mat.shape, r.tolist(), c.tolist(), v.tobytes())
    return ("dok", mat.shape, sorted(mat._map.items()))


EDGES = {
    "coo_to_csr": lambda conv, coo, dok: conv.coo_to_csr(coo),
    "coo_to_csc": lambda conv, coo, dok: conv.coo_to_csc(coo),
    "coo_to_dok": lambda conv, coo, dok: conv.coo_to_dok(coo),
    "dok_to_csr": lambda conv, coo, dok: conv.dok_to_csr(dok),
    "dok_to_csc": lambda conv, coo, dok: conv.dok_to_csc(dok),
    "dok_to_coo": lambda conv, coo, dok: conv.dok_to_coo(dok),
    "csr_to_csc": lambda conv, coo, dok: conv.csr_to_csc(conv.dok_to_csr(dok)),
    "csc_to_csr": lambda conv, coo, dok: conv.csc_to_csr(conv.dok_to_csc(dok)),
    "csr_to_coo": lambda conv, coo, dok: conv.csr_to_coo(conv.coo_to_csr(coo)),
    "csc_to_coo": lambda conv, coo, dok: conv.csc_to_coo(conv.coo_to_csc(coo)),
    "csr_to_dok": lambda conv, coo, dok: conv.csr_to_dok(conv.coo_to_csr(coo)),
    "csc_to_dok": lambda conv, coo, dok: conv.csc_to_dok(conv.coo_to_csc(coo)),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_conversion_edge_matches_jax(edge, dtype):
    got = _exact(EDGES[edge](tconv, *_host_formats(tsp, dtype)))
    want = _exact(EDGES[edge](jconv, *_host_formats(jsp, dtype)))
    assert got == want


def test_coo_to_csr_lands_on_named_device():
    coo, _ = _host_formats(tsp, np.float64)
    csr = tsp.CsrMatrix.from_coo(coo, device="cpu")
    assert csr.device == torch.device("cpu")
    assert csr.rowptr.dtype == torch.int32 and csr.colind.dtype == torch.int32
    assert csr.nse == csr.nnz == tsp.CsrMatrix.from_coo(coo).nnz


def test_nse_past_int32_raises():
    from spalinalg_tpu_torch.dtypes import check_nse

    check_nse(2**31 - 1)
    with pytest.raises(tsp.StructureError):
        check_nse(2**31)
