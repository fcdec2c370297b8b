"""The port's IO tier against the JAX package's, on the same NumPy inputs.

- Matrix Market: every field (real, integer, pattern) and symmetry
  (general, symmetric, skew-symmetric), plain and ``.gz``, read by both
  packages to equal triplets; files written by both from the same matrix
  byte for byte equal, and each package reads the other's; the same
  errors, with the same messages.
- npz checkpoints: COO, DOK, CSR, CSC and BSR (float32 and float64) saved
  by each package load in the other to equal arrays; DIA, a bfloat16 BSR
  and a padded ``DeviceCoo`` CSR round-trip through the port (saved
  trimmed); factors are refused. (A ``DistCsr``, shard by shard, runs in
  the 4-rank gang of ``tests/test_torch_parallel.py``.)
- scipy: ``from_scipy`` / ``to_scipy`` give the JAX package's arrays.
- ``torch.sparse``: ``to_sparse_coo`` against ``to_bcoo``, ``to_sparse_csr``
  against ``to_bcsr``, ``from_sparse_coo`` against ``from_bcoo`` (with
  duplicates and explicit zeros), on equal arrays.

Every comparison is exact: these are copies or the same operations in the
same order.
"""

import gzip

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp
from jax.experimental import sparse as jsparse

import spalinalg_tpu as jsp
import spalinalg_tpu.io as jio
import spalinalg_tpu_torch as tsp
import spalinalg_tpu_torch.io as tio
from spalinalg_tpu.errors import SpalinalgError as JaxSpalinalgError
from spalinalg_tpu_torch.errors import ShapeError, SpalinalgError


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


def _t(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def triplets(dtype=np.float64, n=12, m=10, k=50, seed=3):
    """Random triplets with duplicates and an explicit zero."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, size=k)
    cols = rng.integers(0, m, size=k)
    vals = rng.normal(size=k).astype(dtype)
    vals[7] = 0
    rows[-5:], cols[-5:] = rows[:5], cols[:5]
    return n, m, rows, cols, vals


def both(kind, dtype=np.float64):
    """The same matrix of ``kind`` in both packages."""
    n, m, rows, cols, vals = triplets(dtype)
    out = []
    for pkg in (jsp, tsp):
        coo = pkg.CooMatrix.with_triplets(n, m, rows, cols, vals, dtype=dtype)
        out.append({
            "coo": lambda: coo,
            "dok": lambda: pkg.DokMatrix.with_triplets(n, m, rows, cols,
                                                       vals, dtype=dtype),
            "csr": lambda: pkg.CsrMatrix.from_coo(coo),
            "csc": lambda: pkg.CscMatrix.from_coo(coo),
            "bsr": lambda: pkg.CsrMatrix.from_coo(
                pkg.CooMatrix.with_triplets(12, 12, rows, cols % 12, vals,
                                            dtype=dtype)).to_bsr(4),
        }[kind]())
    return out


def coo_triplets(coo):
    rows, cols, vals = coo.to_arrays()
    return rows, cols, vals


# ---------------------------------------------------------------------------
# Matrix Market
# ---------------------------------------------------------------------------

ENTRIES = {
    "real": ["1 1 2.5", "3 1 -1.25", "2 2 4", "4 3 0.5", "4 4 1e-300"],
    "integer": ["1 1 2", "3 1 -7", "2 2 4", "4 3 11", "4 4 -3"],
    "pattern": ["1 1", "3 1", "2 2", "4 3", "4 4"],
}


def mm_text(field, symmetry):
    lines = [f"%%MatrixMarket matrix coordinate {field} {symmetry}",
             "% a comment line", "4 4 5"] + ENTRIES[field]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("symmetry", ["general", "symmetric",
                                      "skew-symmetric"])
@pytest.mark.parametrize("field", ["real", "integer", "pattern"])
def test_read_matches_jax(field, symmetry, gz, tmp_path):
    path = tmp_path / ("m.mtx.gz" if gz else "m.mtx")
    text = mm_text(field, symmetry)
    if gz:
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    got, want = tio.read_matrix_market(path), jio.read_matrix_market(path)
    assert got.shape == want.shape == (4, 4)
    for g, w in zip(coo_triplets(got), coo_triplets(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if symmetry != "general":
        assert got.nnz == 7         # the two off-diagonal entries mirrored


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("kind", ["coo", "csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_written_files_are_identical(kind, dtype, gz, tmp_path):
    """Both packages write the same bytes for the same matrix, and each
    reads the other's file to the same triplets."""
    jm, tm = both(kind, dtype)
    name = "m.mtx.gz" if gz else "m.mtx"
    jpath, tpath = tmp_path / f"jax_{name}", tmp_path / f"torch_{name}"
    jio.write_matrix_market(jpath, jm)
    tio.write_matrix_market(tpath, tm)
    opener = gzip.open if gz else open
    with opener(jpath, "rb") as f:
        jbytes = f.read()
    with opener(tpath, "rb") as f:
        tbytes = f.read()
    assert tbytes == jbytes and len(tbytes) > 100
    for g, w in zip(coo_triplets(tio.read_matrix_market(jpath)),
                    coo_triplets(jio.read_matrix_market(tpath))):
        np.testing.assert_array_equal(g, w)


def test_write_bsr_and_dia(tmp_path):
    """BSR and DIA (no ``to_coo``) are written through their CSR."""
    _, bsr = both("bsr")
    tio.write_matrix_market(tmp_path / "b.mtx", bsr)
    back = tio.read_matrix_market(tmp_path / "b.mtx")
    np.testing.assert_array_equal(back.to_dense(), bsr.to_dense().numpy())
    dia = tsp.DiaMatrix.from_diagonals([1.0, -2.0], [0, 2], 6)
    tio.write_matrix_market(tmp_path / "d.mtx", dia)
    back = tio.read_matrix_market(tmp_path / "d.mtx")
    np.testing.assert_array_equal(back.to_dense(), dia.to_dense().numpy())


@pytest.mark.parametrize("text", [
    "nope\n",
    "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n",
    "%%MatrixMarket matrix coordinate real hermitian\n1 1 1\n1 1 1\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1\n2 2 2\n",
], ids=["bad_header", "array", "complex", "hermitian", "short"])
def test_errors_match_jax(text, tmp_path):
    path = tmp_path / "bad.mtx"
    path.write_text(text)
    with pytest.raises(JaxSpalinalgError) as jerr:
        jio.read_matrix_market(path)
    with pytest.raises(SpalinalgError) as terr:
        tio.read_matrix_market(path)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(SpalinalgError, match="cannot write"):
        tio.write_matrix_market(tmp_path / "x.mtx", object())


def test_dok_is_refused_alike(tmp_path):
    """A DOK has no ``to_coo`` in either package: neither writes it to
    Matrix Market nor converts it to scipy, with the same message."""
    jm, tm = both("dok")
    for jfn, tfn in ((lambda m: jio.write_matrix_market(tmp_path / "j", m),
                      lambda m: tio.write_matrix_market(tmp_path / "t", m)),
                     (jio.to_scipy, tio.to_scipy)):
        with pytest.raises(JaxSpalinalgError) as jerr:
            jfn(jm)
        with pytest.raises(SpalinalgError) as terr:
            tfn(tm)
        assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# npz checkpoints
# ---------------------------------------------------------------------------

def arrays_of(mat):
    """Every array a checkpoint holds, by its key, as NumPy."""
    if hasattr(mat, "to_arrays"):
        return dict(zip(("rows", "cols", "values"), mat.to_arrays()))
    if hasattr(mat, "blocksize"):
        return {"indptr": _t(mat.indptr), "indices": _t(mat.indices),
                "data": _t(mat.data), "blocksize": np.asarray(mat.blocksize)}
    return {"ptr": _t(mat._ptr), "minor": _t(mat._minor),
            "values": _t(mat._values)}


def assert_same(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got.shape == want.shape
    ga, wa = arrays_of(got), arrays_of(want)
    assert ga.keys() == wa.keys()
    for key in ga:
        assert ga[key].dtype == wa[key].dtype, key
        np.testing.assert_array_equal(ga[key], wa[key])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["coo", "dok", "csr", "csc", "bsr"])
def test_npz_loads_across_packages(kind, dtype, tmp_path):
    jm, tm = both(kind, dtype)
    assert_same(tm, jm)                       # the same matrix to start
    tio.save_npz(tmp_path / "torch.npz", tm)
    jio.save_npz(tmp_path / "jax.npz", jm)
    assert_same(jio.load_npz(tmp_path / "torch.npz"), jm)
    back = tio.load_npz(tmp_path / "jax.npz")
    assert_same(back, jm)
    assert_same(tio.load_npz(tmp_path / "torch.npz"), tm)
    if kind in ("csr", "csc", "bsr"):
        assert back.device == torch.device("cpu")


def test_npz_places_on_the_named_device(tmp_path):
    _, csr = both("csr")
    tio.save_npz(tmp_path / "m.npz", csr)
    assert tio.load_npz(tmp_path / "m.npz", device="meta").device.type \
        == "meta"
    with tsp.default_device("meta"):
        assert tio.load_npz(tmp_path / "m.npz").device.type == "meta"


def test_npz_dia_round_trip(tmp_path):
    rng = np.random.default_rng(8)
    for dtype in (torch.float64, torch.float32):
        dia = tsp.DiaMatrix(30, 40, [-3, 0, 5, 39],
                            torch.from_numpy(rng.normal(size=(4, 30))).to(
                                dtype))
        tio.save_npz(tmp_path / "d.npz", dia)
        back = tio.load_npz(tmp_path / "d.npz")
        assert isinstance(back, tsp.DiaMatrix) and back.shape == (30, 40)
        np.testing.assert_array_equal(back.offsets, dia.offsets)
        assert back.dtype == dtype
        assert torch.equal(back.data, dia.data)


def test_npz_bfloat16_bsr_round_trip(tmp_path):
    _, bsr = both("bsr")
    b16 = bsr.astype(torch.bfloat16)
    tio.save_npz(tmp_path / "b.npz", b16)
    back = tio.load_npz(tmp_path / "b.npz")
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.data, b16.data)
    assert torch.equal(back.indices, b16.indices)


def test_npz_padded_csr_is_saved_trimmed(tmp_path):
    """``DeviceCoo.to_csr_device`` pads past ``ptr[-1]``; the file holds
    ``nnz`` entries, and the loaded matrix equals the padded one."""
    n, m, rows, cols, vals = triplets()
    padded = tsp.CooMatrix.with_triplets(n, m, rows, cols,
                                         vals).to_device().to_csr_device()
    assert padded.nse > padded.nnz
    tio.save_npz(tmp_path / "p.npz", padded)
    with np.load(tmp_path / "p.npz") as z:
        assert z["minor"].size == z["values"].size == padded.nnz
    back = tio.load_npz(tmp_path / "p.npz")
    assert back.nse == back.nnz == padded.nnz
    assert torch.equal(back.to_dense(), padded.to_dense())
    exact = tsp.CsrMatrix.from_coo(tsp.CooMatrix.with_triplets(n, m, rows,
                                                               cols, vals))
    assert_same(back, exact)
    # a padded file (as the JAX package writes one) loads too
    np.savez_compressed(tmp_path / "jp.npz", kind="csr",
                        shape=np.asarray(padded.shape),
                        ptr=_t(padded.rowptr), minor=_t(padded.colind),
                        values=_t(padded.values))
    again = tio.load_npz(tmp_path / "jp.npz")
    assert again.nse == padded.nse
    assert torch.equal(again.to_dense(), padded.to_dense())


def test_npz_refuses_factors_and_unknown_kinds(tmp_path):
    A = tsp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(6, 6))
    fac = tsp.linalg.cholesky(A)
    with pytest.raises(SpalinalgError, match="cannot checkpoint"):
        tio.save_npz(tmp_path / "f.npz", fac)
    with pytest.raises(JaxSpalinalgError, match="cannot checkpoint"):
        jio.save_npz(tmp_path / "f.npz", jsp.linalg.cholesky(
            jsp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(6, 6))))
    np.savez_compressed(tmp_path / "u.npz", kind="ell", shape=np.asarray(
        (2, 2)))
    with pytest.raises(SpalinalgError, match="unknown checkpoint kind"):
        tio.load_npz(tmp_path / "u.npz")
    np.savez_compressed(tmp_path / "s.rank0.npz", kind="distcsr",
                        shape=np.asarray((2, 2)))
    with pytest.raises(SpalinalgError, match="mesh="):
        tio.load_npz(tmp_path / "s.rank0.npz")


# ---------------------------------------------------------------------------
# scipy
# ---------------------------------------------------------------------------

def scipy_inputs():
    rng = np.random.default_rng(9)
    d = np.where(rng.random((9, 7)) < 0.4, rng.normal(size=(9, 7)), 0)
    unsorted = sps.csr_matrix((np.array([1.0, 2.0, 3.0]),
                               np.array([2, 0, 1]), np.array([0, 2, 3])),
                              shape=(2, 3))
    return {"csr": sps.csr_matrix(d), "csc": sps.csc_matrix(d),
            "coo": sps.coo_matrix(d), "lil": sps.lil_matrix(d),
            "csr_unsorted": unsorted,
            "csr_f32": sps.csr_matrix(d.astype(np.float32))}


@pytest.mark.parametrize("name", list(scipy_inputs()))
def test_from_scipy_matches_jax(name):
    s = scipy_inputs()[name]
    got, want = tio.from_scipy(s), jio.from_scipy(s)
    assert_same(got, want)
    if hasattr(got, "device"):
        assert got.device == torch.device("cpu")
    sc = tio.to_scipy(got)
    ref = jio.to_scipy(want)
    assert sc.format == ref.format
    np.testing.assert_array_equal(sc.toarray(), ref.toarray())
    if sc.format in ("csr", "csc"):
        for key in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(sc, key), getattr(ref, key))


def test_to_scipy_of_every_format():
    """COO, CSR and CSC as in the JAX package; BSR (which the JAX package
    refuses) through its CSR; a padded CSR trimmed to ``nnz``."""
    for kind in ("coo", "csr", "csc", "bsr"):
        jm, tm = both(kind)
        if kind == "bsr":
            jm = jm.to_csr()
        np.testing.assert_array_equal(tio.to_scipy(tm).toarray(),
                                      jio.to_scipy(jm).toarray())
    padded = tsp.CooMatrix.with_triplets(*triplets()).to_device() \
        .to_csr_device()
    s = tio.to_scipy(padded)
    assert s.nnz == padded.nnz and s.indices.size == padded.nnz
    np.testing.assert_array_equal(s.toarray(), padded.to_dense().numpy())
    with tsp.default_device("meta"):
        assert tio.from_scipy(scipy_inputs()["csr"]).device.type == "meta"
    with pytest.raises(SpalinalgError, match="not a scipy sparse"):
        tio.from_scipy(np.eye(2))


# ---------------------------------------------------------------------------
# torch.sparse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["coo", "dok", "csr", "csc", "bsr"])
def test_to_sparse_coo_matches_to_bcoo(kind):
    jm, tm = both(kind)
    t = tio.to_sparse_coo(tm)
    b = jio.to_bcoo(jm)
    assert t.layout == torch.sparse_coo and tuple(t.shape) == b.shape
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(b.todense()))
    if kind == "coo":                 # exported as it stands
        assert not t.is_coalesced() and t._nnz() == int(b.nse) == 50
        np.testing.assert_array_equal(t._indices().numpy().T,
                                      np.asarray(b.indices))
    else:
        assert t.is_coalesced()
    if kind == "csr":
        np.testing.assert_array_equal(t.indices().numpy().T,
                                      np.asarray(b.indices))
        np.testing.assert_array_equal(t.values().numpy(),
                                      np.asarray(b.data))


def test_to_sparse_csr_matches_to_bcsr():
    jm, tm = both("csr")
    t = tio.to_sparse_csr(tm)
    b = jio.to_bcsr(jm)
    assert t.layout == torch.sparse_csr
    assert t.crow_indices().data_ptr() == tm.rowptr.data_ptr()
    assert t.col_indices().data_ptr() == tm.colind.data_ptr()
    np.testing.assert_array_equal(t.crow_indices().numpy(),
                                  np.asarray(b.indptr))
    np.testing.assert_array_equal(t.col_indices().numpy(),
                                  np.asarray(b.indices))
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(b.todense()))
    with pytest.raises(ShapeError, match="takes a CsrMatrix"):
        tio.to_sparse_csr(tm.to_csc())
    padded = tsp.CooMatrix.with_triplets(*triplets()).to_device() \
        .to_csr_device()
    tp = tio.to_sparse_csr(padded)
    assert tp.col_indices().numel() == padded.nnz
    assert torch.equal(tp.to_dense(), padded.to_dense())


@pytest.mark.parametrize("dedup", [True, False])
def test_from_sparse_coo_matches_from_bcoo(dedup):
    """Duplicates (summed with ``dedup``) and explicit zeros (kept): the
    same padded arrays as the JAX package's device compress."""
    n, m, rows, cols, vals = triplets()
    idx = np.stack([rows, cols])
    t = torch.sparse_coo_tensor(torch.from_numpy(idx), torch.from_numpy(vals),
                                (n, m))
    b = jsparse.BCOO((jnp.asarray(vals), jnp.asarray(idx.T)), shape=(n, m))
    got, want = tio.from_sparse_coo(t, dedup=dedup), jio.from_bcoo(
        b, dedup=dedup)
    assert isinstance(got, tsp.CsrMatrix) and got.device == t.device
    assert_same(got, want)
    assert got.nnz == want.nnz
    assert (got.values[:got.nnz] == 0).any()          # the explicit zero


def test_from_sparse_coo_rejects_other_layouts():
    with pytest.raises(ShapeError):
        tio.from_sparse_coo(torch.eye(3))
    with pytest.raises(ShapeError):
        tio.from_sparse_coo(torch.eye(3).to_sparse_csr())
    with pytest.raises(ShapeError):
        tio.from_sparse_coo(torch.ones(2, 3, 4).to_sparse(2))   # hybrid
    with pytest.raises(ShapeError):
        tio.from_sparse_coo(torch.ones(2, 3, 4).to_sparse())    # 3-D
    with pytest.raises(ShapeError, match="cannot export"):
        tio.to_sparse_coo(object())
