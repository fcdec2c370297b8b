"""DeviceCoo and the device-side compress of the PyTorch port against the
JAX package.

``compress_device`` and ``DeviceCoo.to_csr_device`` give the JAX arrays
array for array, padding included, for all four ``dedup`` / ``drop_zeros``
combinations, on triplets with duplicates, cancelling duplicates,
explicit zeros and sentinel padding rows. Structure must match exactly;
values bit for bit where nothing is summed and within 1e-12 (f64) /
1e-6 (f32) of the summed magnitudes where duplicates are merged. Then
``DeviceCoo @ x``, ``to_host``, ``nnz_device``, ``CooMatrix.to_device``
and the carrying of a ``DeviceCoo`` as NumPy arrays.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.convert.engine import compress_device as jax_compress_device
from spalinalg_tpu_torch.convert.engine import compress_device, ptr_from_major
from spalinalg_tpu_torch.io import device_coo_from_arrays, to_arrays


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


TOL = {np.float32: 1e-6, np.float64: 1e-12}
FLAGS = [(True, True), (True, False), (False, True), (False, False)]


def host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _triplets(n, m, k, dtype, seed, pad=0):
    """Triplets with duplicates (some cancelling), explicit zeros and
    ``pad`` sentinel padding slots (row == n, value 0) mixed in."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=k)
    cols = rng.integers(0, m, size=k)
    vals = rng.normal(size=k).astype(dtype)
    vals[rng.random(k) < 0.05] = 0
    rows = np.concatenate([rows, rows[:k // 5], np.full(pad, n)])
    cols = np.concatenate([cols, cols[:k // 5],
                           rng.integers(0, m, size=pad)])
    vals = np.concatenate([vals, -vals[:k // 10],
                           rng.normal(size=k // 5 - k // 10).astype(dtype),
                           np.zeros(pad, dtype)])
    perm = rng.permutation(rows.size)
    return rows[perm], cols[perm], vals[perm]


def _scale(rows, cols, vals):
    """Per-slot magnitude of a merged sum, looked up by (row, col)."""
    acc = {}
    for r, c, v in zip(rows.tolist(), cols.tolist(), np.abs(vals).tolist()):
        acc[r, c] = acc.get((r, c), 0.0) + v
    return acc


@pytest.mark.parametrize("dedup, drop_zeros", FLAGS)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape, k, pad", [((40, 30), 300, 0),
                                           ((40, 30), 300, 17),
                                           ((1, 7), 20, 3),
                                           ((500, 2), 400, 0)])
def test_compress_device_matches_jax(shape, k, pad, dtype, dedup,
                                     drop_zeros):
    n, m = shape
    rows, cols, vals = _triplets(n, m, k, dtype, seed=k + pad, pad=pad)
    want = jax_compress_device(jnp.asarray(rows, jnp.int32),
                               jnp.asarray(cols, jnp.int32),
                               jnp.asarray(vals), n_major=n, n_minor=m,
                               dedup=dedup, drop_zeros=drop_zeros)
    got = compress_device(torch.from_numpy(rows.astype(np.int32)),
                          torch.from_numpy(cols.astype(np.int32)),
                          torch.from_numpy(vals), n_major=n, n_minor=m,
                          dedup=dedup, drop_zeros=drop_zeros)
    ptr, minor, values = (host(a) for a in got)
    jptr, jminor, jvalues = (np.asarray(a) for a in want)
    assert ptr.dtype == np.int32 and minor.dtype == np.int32
    assert values.dtype == jvalues.dtype
    np.testing.assert_array_equal(ptr, jptr)
    np.testing.assert_array_equal(minor, jminor)
    if not dedup:
        np.testing.assert_array_equal(values, jvalues)
        return
    major = np.repeat(np.arange(n), np.diff(ptr))
    sums = _scale(rows, cols, vals)
    scale = np.array([sums.get((r, c), 0.0) for r, c in
                      zip(major, minor[:ptr[-1]])]
                     + [0.0] * (rows.size - ptr[-1]))
    assert np.all(np.abs(values.astype(np.float64)
                         - jvalues.astype(np.float64))
                  <= TOL[dtype] * scale + 1e-300)


def test_compress_device_empty_and_ptr():
    ptr, minor, values = compress_device(
        torch.zeros(0, dtype=torch.int32), torch.zeros(0, dtype=torch.int32),
        torch.zeros(0), n_major=4, n_minor=3, dedup=True, drop_zeros=True)
    assert ptr.tolist() == [0] * 5 and minor.numel() == 0
    assert values.numel() == 0
    majors = torch.tensor([0, 0, 2, 3, 3, 3, 4, 4], dtype=torch.int32)
    assert ptr_from_major(majors, 4).tolist() == [0, 2, 2, 3, 6]


@pytest.mark.parametrize("dedup, drop_zeros", FLAGS)
def test_to_csr_device_matches_jax(dedup, drop_zeros):
    rows, cols, vals = _triplets(60, 45, 500, np.float64, seed=2)
    j = jsp.CooMatrix.with_triplets(60, 45, rows, cols, vals).to_device()
    t = tsp.CooMatrix.with_triplets(60, 45, rows, cols, vals).to_device()
    assert isinstance(t, tsp.DeviceCoo)
    assert t.device == torch.device("cpu") and t.nse == j.nse
    jc = j.to_csr_device(dedup=dedup, drop_zeros=drop_zeros)
    tc = t.to_csr_device(dedup=dedup, drop_zeros=drop_zeros)
    assert isinstance(tc, tsp.CsrMatrix) and tc.nse == jc.nse == rows.size
    np.testing.assert_array_equal(host(tc.rowptr), np.asarray(jc.rowptr))
    np.testing.assert_array_equal(host(tc.colind), np.asarray(jc.colind))
    np.testing.assert_allclose(host(tc.values), np.asarray(jc.values),
                               rtol=0, atol=1e-12 * np.abs(vals).sum())


def test_to_csr_device_equals_from_coo():
    """With the defaults, the padded result holds ``from_coo``'s structure
    and values, and its products match."""
    rows, cols, vals = _triplets(80, 70, 900, np.float64, seed=3)
    coo = tsp.CooMatrix.with_triplets(80, 70, rows, cols, vals)
    host_csr = tsp.CsrMatrix.from_coo(coo)
    dev_csr = coo.to_device().to_csr_device()
    nnz = host_csr.nnz
    assert dev_csr.nnz == nnz and dev_csr.nse == rows.size
    assert torch.equal(dev_csr.rowptr, host_csr.rowptr)
    assert torch.equal(dev_csr.colind[:nnz], host_csr.colind)
    torch.testing.assert_close(dev_csr.values[:nnz], host_csr.values,
                               rtol=0, atol=1e-12)
    assert not dev_csr.values[nnz:].any()
    x = torch.from_numpy(np.random.default_rng(4).normal(size=70))
    torch.testing.assert_close(dev_csr @ x, host_csr @ x, rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("rhs_shape", [(45,), (45, 3)])
def test_matmul_matches_jax(rhs_shape):
    rows, cols, vals = _triplets(60, 45, 500, np.float64, seed=5, pad=9)
    j = jsp.DeviceCoo(60, 45, rows, cols, vals)
    t = tsp.DeviceCoo(60, 45, rows, cols, vals)
    x = np.random.default_rng(6).normal(size=rhs_shape)
    got = t @ torch.from_numpy(x)
    want = np.asarray(j @ jnp.asarray(x))
    scale = np.zeros(want.shape)
    live = rows < 60
    np.add.at(scale, rows[live], np.abs(vals[live])[(slice(None),)
              + (None,) * (x.ndim - 1)] * np.abs(x[cols[live]]))
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert np.all(np.abs(host(got) - want) <= 1e-12 * scale + 1e-300)


def test_to_host_and_nnz_device():
    rows, cols, vals = _triplets(30, 20, 100, np.float64, seed=7, pad=6)
    j = jsp.DeviceCoo(30, 20, rows, cols, vals)
    t = tsp.DeviceCoo(30, 20, rows, cols, vals)
    assert int(t.nnz_device()) == int(j.nnz_device()) == rows.size - 6
    assert t.nnz_device().dtype == torch.int32
    th, jh = t.to_host(), j.to_host()
    for a, b in zip(th.to_arrays(), jh.to_arrays()):
        np.testing.assert_array_equal(a, b)
    assert th.shape == jh.shape


@pytest.mark.parametrize("pkg_case", [
    lambda m: m.DeviceCoo(0, 3, [0], [0], [1.0]),
    lambda m: m.DeviceCoo(3, -1, [0], [0], [1.0]),
    lambda m: (m.DeviceCoo(3, 4, [0, 1], [2, 3], [1.0, 2.0]).shape,
               m.DeviceCoo(3, 4, [0, 1], [2, 3], [1.0, 2.0]).nse),
], ids=["zero_rows", "negative_cols", "shape_nse"])
def test_errors_match_jax(pkg_case):
    def outcome(pkg):
        try:
            return ("ok", pkg_case(pkg))
        except pkg.SpalinalgError as e:
            return ("raises", type(e).__name__)

    assert outcome(tsp) == outcome(jsp)


def test_operand_length_is_checked():
    """The port refuses an operand whose length is not ``ncols``; the JAX
    package's ``DeviceCoo @ x`` gathers from it unchecked (ROADMAP queue
    C)."""
    with pytest.raises(tsp.ShapeError):
        tsp.DeviceCoo(3, 4, [0], [0], [1.0]) @ np.ones(5)
    with pytest.raises(tsp.ShapeError):
        tsp.DeviceCoo(3, 4, [0], [0], [1.0]) @ np.ones((3, 2))


def test_arrays_carry_both_ways():
    rows, cols, vals = _triplets(30, 20, 100, np.float32, seed=8, pad=4)
    j = jsp.DeviceCoo(30, 20, rows, cols, vals)
    t = device_coo_from_arrays(j.nrows, j.ncols, np.asarray(j.rows),
                               np.asarray(j.cols), np.asarray(j.values))
    assert t.device == torch.device("cpu") and t.values.dtype == torch.float32
    back = jsp.DeviceCoo(*to_arrays(t))
    for a, b in ((back.rows, j.rows), (back.cols, j.cols),
                 (back.values, j.values)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
