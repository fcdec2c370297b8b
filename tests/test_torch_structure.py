"""Structure builders of the PyTorch port against the JAX package.

``kron``, ``vstack``, ``hstack``, ``block_diag``, ``bmat``, ``tril``,
``triu``, ``diags`` and ``sprandom`` on the cases of ``test_structure.py``
(and more): each case is a function of the package, and both packages must
give the same CSR arrays exactly (both run the NumPy host engine) or raise
an error of the same class. ``sprandom`` draws from NumPy's generator, so
one seed gives both packages the same matrix.
"""

import numpy as np
import pytest
import torch

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.ops import structure as tstructure


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


def hl(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().tolist()
    return np.asarray(a).tolist()


def arrays(mat):
    return (mat.shape, hl(mat.rowptr), hl(mat.colind), hl(mat.values),
            str(mat.dtype).removeprefix("torch."))


def _rand(m, seed, n, k, density=0.3, fmt="csr"):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((n, k)) < density, rng.normal(size=(n, k)), 0)
    rows, cols = np.nonzero(d)
    coo = m.CooMatrix.with_triplets(n, k, rows, cols, d[rows, cols])
    return {"coo": coo, "csr": m.CsrMatrix.from_coo(coo),
            "csc": m.CscMatrix.from_coo(coo),
            "dok": m.CsrMatrix.from_coo(coo).to_dok()}[fmt]


def _coo_dups(m):
    return m.CooMatrix.with_entries(2, 2, [(0, 0, 1.0), (0, 0, 2.0),
                                           (1, 0, -1.0), (1, 0, 1.0)])


def _dia(m):
    return m.DiaMatrix.from_diagonals([1.0, 2.0], [0, 1], 3)


CASES = [
    ("kron_3x4_2x5", lambda m: arrays(m.kron(_rand(m, 1, 3, 4),
                                             _rand(m, 2, 2, 5)))),
    ("kron_1x1_4x3", lambda m: arrays(m.kron(_rand(m, 3, 1, 1, 1.0),
                                             _rand(m, 4, 4, 3)))),
    ("kron_coo_duplicates", lambda m: arrays(m.kron(
        _coo_dups(m), m.CsrMatrix.eye(2)))),
    ("kron_csc_dok", lambda m: arrays(m.kron(_rand(m, 5, 3, 3, fmt="csc"),
                                             _rand(m, 6, 2, 4, fmt="dok")))),
    ("kron_laplacian", lambda m: arrays(m.kron(
        m.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(4, 4)),
        m.diags([1.0], [0], shape=(3, 3))))),
    ("vstack", lambda m: arrays(m.vstack([_rand(m, 7, 3, 4),
                                          _rand(m, 8, 2, 4)]))),
    ("hstack", lambda m: arrays(m.hstack([_rand(m, 9, 3, 4),
                                          _rand(m, 10, 3, 2)]))),
    ("block_diag", lambda m: arrays(m.block_diag([_rand(m, 11, 3, 4),
                                                  _rand(m, 12, 2, 2)]))),
    ("bmat_none", lambda m: arrays(m.bmat([[_rand(m, 13, 3, 4),
                                            _rand(m, 14, 3, 2)],
                                           [_rand(m, 15, 2, 4), None]]))),
    ("mixed_formats", lambda m: arrays(m.vstack(
        [_rand(m, 16, 4, 4), _rand(m, 16, 4, 4, fmt="csc"),
         _rand(m, 16, 4, 4, fmt="coo"), _rand(m, 16, 4, 4, fmt="dok"),
         _rand(m, 16, 4, 4).to_bsr(2)]))),
    ("vstack_column_mismatch", lambda m: m.vstack([_rand(m, 1, 3, 4),
                                                   _rand(m, 2, 3, 5)])),
    ("hstack_row_mismatch", lambda m: m.hstack([_rand(m, 1, 3, 4),
                                                _rand(m, 2, 2, 4)])),
    ("vstack_empty", lambda m: m.vstack([])),
    ("hstack_empty", lambda m: m.hstack([])),
    ("block_diag_empty", lambda m: m.block_diag([])),
    ("bmat_all_none", lambda m: m.bmat([[None, None]])),
    ("bmat_width_mismatch", lambda m: m.bmat(
        [[_rand(m, 1, 3, 4), _rand(m, 1, 3, 4)],
         [_rand(m, 1, 3, 4), _rand(m, 2, 3, 5)]])),
    ("bmat_ragged", lambda m: m.bmat([[_rand(m, 1, 3, 4)],
                                      [_rand(m, 1, 3, 4), None]])),
    ("bmat_empty", lambda m: m.bmat([])),
    ("dia_operand", lambda m: m.kron(_dia(m), _rand(m, 1, 2, 2))),
    ("dia_in_vstack", lambda m: m.vstack([_rand(m, 1, 3, 3), _dia(m)])),
    ("diags_matches", lambda m: arrays(m.diags(
        [np.arange(1.0, 6.0), np.arange(6.0, 12.0), np.arange(3.0)],
        offsets=[-1, 0, 2], shape=(6, 6)))),
    ("diags_scalar_broadcast", lambda m: arrays(m.diags(
        [-1.0, 2.0, -1.0], offsets=[-1, 0, 1], shape=(5, 5)))),
    ("diags_rectangular", lambda m: arrays(m.diags(
        [1.0, 2.0], offsets=[0, 1], shape=(3, 5)))),
    ("diags_single", lambda m: arrays(m.diags(np.array([1.0, 2.0, 3.0])))),
    ("diags_scalar_offset", lambda m: arrays(m.diags(
        np.array([4.0, 5.0]), 1))),
    ("diags_float32", lambda m: arrays(m.diags(
        [1.0, -2.0], [0, -2], shape=(4, 6), dtype=np.float32))),
    ("diags_offset_outside", lambda m: m.diags([1.0], offsets=[9],
                                               shape=(3, 3))),
    ("diags_count", lambda m: m.diags([[1.0], [2.0]], offsets=[0])),
    ("diags_short", lambda m: m.diags([np.ones(2)], offsets=[0],
                                      shape=(4, 4))),
    ("diags_zero_shape", lambda m: m.diags([1.0], shape=(0, 3))),
    ("sprandom_seed", lambda m: arrays(m.sprandom(50, 60, density=0.1,
                                                  seed=3))),
    ("sprandom_uniform_f32", lambda m: arrays(m.sprandom(
        20, 30, density=0.2, seed=5, values="uniform", dtype=np.float32))),
    ("sprandom_rng", lambda m: arrays(m.sprandom(
        30, 10, density=0.5, rng=np.random.default_rng(9)))),
    ("sprandom_nnz", lambda m: m.sprandom(50, 60, density=0.1, seed=3).nnz),
    ("sprandom_zero_dims", lambda m: m.sprandom(0, 4)),
    ("sprandom_density", lambda m: m.sprandom(4, 4, density=1.5)),
    ("tril", lambda m: arrays(m.tril(_rand(m, 17, 6, 6, 0.6)))),
    ("tril_k_minus_1", lambda m: arrays(m.tril(_rand(m, 17, 6, 6, 0.6),
                                               k=-1))),
    ("tril_k_2_rectangular", lambda m: arrays(m.tril(
        _rand(m, 18, 5, 8, 0.6), k=2))),
    ("triu", lambda m: arrays(m.triu(_rand(m, 17, 6, 6, 0.6)))),
    ("triu_k_1", lambda m: arrays(m.triu(_rand(m, 17, 6, 6, 0.6), k=1))),
    ("triu_coo_duplicates", lambda m: arrays(m.triu(_coo_dups(m), k=-1))),
    ("tril_dense", lambda m: hl(m.tril(_rand(m, 19, 4, 4, 0.9))
                                .to_dense())),
]


def outcome(case, pkg):
    try:
        return ("ok", case(pkg))
    except pkg.SpalinalgError as e:
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("case", [c for _, c in CASES],
                         ids=[n for n, _ in CASES])
def test_structure_matches_jax(case):
    got = outcome(case, tsp)
    assert got == outcome(case, jsp)


def test_results_land_on_the_operands_device():
    """The result goes to the device of the first operand that has one;
    host builders have none, and then the default device holds it."""
    class OnMeta:
        device = torch.device("meta")

    coo = _coo_dups(tsp)
    assert tstructure._device_of([coo, OnMeta(), coo]) == torch.device(
        "meta")
    dok = _rand(tsp, 1, 3, 2, fmt="dok")
    assert tstructure._device_of([coo, dok]) is None
    assert tsp.kron(coo, coo).device == torch.device("cpu")
    csr = _rand(tsp, 1, 3, 2)
    assert tsp.vstack([coo, dok, csr]).device == csr.device
