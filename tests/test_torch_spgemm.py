"""SpGEMM and add/sub/neg of the PyTorch port against the JAX package.

The port runs its plain torch version here (CPU tensors); the SpGEMM
kernel itself is held against it on the GPU by ``chip_smoke.py``. Inputs
are made with NumPy from a seed and handed to both packages.

- plans: ``a_idx``, ``b_idx``, ``gid``, ``rowptr`` and ``colind`` equal to
  ``spalinalg_tpu.spgemm_plan``'s, on both sides of the 4096-entry native
  threshold;
- values against ``spgemm_apply`` (scaled error ``<= tol·Σ|a||b|``, 1e-12
  f64, 1e-5 f32), also on rows with repeated and unsorted columns, and
  against the TPU kernel's own function,
  ``pair_route_apply(..., interpret=True)`` (f32, at the tolerance of
  ``tests/test_pair_route.py``);
- gradients against ``jax.grad`` through ``spgemm_apply``;
- whole products (``a * b``, ``a @ b``, CSC×CSC, ``a ** k``) with the same
  structure exactly, cancellation zeros included;
- ``+``/``-``/unary ``-``: the same structure and values bit for bit, and
  ``ShapeError`` where the JAX package raises it;
- the native host library: built from the port's own copy of the source into
  ``build/native/``, and a failed build raises.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import spalinalg_tpu as jsp
import spalinalg_tpu_torch as tsp
from spalinalg_tpu.ops.kernels.pair_route import (build_pair_route_plan,
                                                  pair_route_apply)
from spalinalg_tpu_torch.io import csr_from_arrays
from spalinalg_tpu_torch.native import lib as native
from spalinalg_tpu_torch.ops import spgemm as tsg
from spalinalg_tpu_torch.ops.kernels.spgemm_numeric import spgemm_numeric


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _arrays(n, m, deg_fn, seed, dtype=np.float64):
    """Host CSR arrays with sorted, unique columns per row."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(deg_fn(rng, n), m)
    cols = [np.sort(rng.choice(m, size=k, replace=False)) for k in deg]
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    colind = np.concatenate(cols) if cols else np.zeros(0, np.int64)
    values = rng.normal(size=colind.size).astype(dtype)
    return n, m, rowptr, colind, values


def _both(n, m, rowptr, colind, values, fmt="csr"):
    cls_j = jsp.CsrMatrix if fmt == "csr" else jsp.CscMatrix
    cls_t = tsp.CsrMatrix if fmt == "csr" else tsp.CscMatrix
    return (cls_j(n, m, rowptr, colind, values),
            cls_t(n, m, rowptr, colind, values))


def _power_law(n, seed, dtype=np.float64):
    return _arrays(n, n, lambda r, n: np.minimum(r.zipf(1.9, size=n), 64),
                   seed, dtype)


def _uniform(n, lo, hi, seed, dtype=np.float64):
    return _arrays(n, n, lambda r, n: r.integers(lo, hi, size=n), seed, dtype)


def _term_scale(plan, av, bv):
    """``Σ_{t in slot} |a[a_idx[t]]|·|b[b_idx[t]]|`` per output slot."""
    out = np.zeros(plan.n_out)
    np.add.at(out, np.asarray(plan.gid),
              np.abs(np.asarray(av, np.float64)[np.asarray(plan.a_idx)])
              * np.abs(np.asarray(bv, np.float64)[np.asarray(plan.b_idx)]))
    return out


def _within(got, want, scale, tol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= tol * scale), (err / np.maximum(scale, 1e-300)).max()


# ------------------------------------------------------------------ plans


@pytest.mark.parametrize("case,path", [
    ("small_uniform", "numpy"),        # nnz_a <= 4096: NumPy on both sides
    ("small_power_law", "numpy"),
    ("large_power_law", "native"),     # nnz_a > 4096: native on both sides
    ("large_rectangular", "native"),
])
def test_plan_equals_jax(case, path):
    from spalinalg_tpu_torch.utils import metrics

    if case == "small_uniform":
        a_args = b_args = _uniform(120, 1, 6, 40)
    elif case == "small_power_law":
        a_args, b_args = _power_law(150, 41), _uniform(150, 0, 5, 42)
    elif case == "large_power_law":
        a_args = b_args = _power_law(1500, 43)
    else:
        a_args = _arrays(900, 700, lambda r, n: r.integers(2, 12, size=n), 44)
        b_args = _arrays(700, 400, lambda r, n: r.integers(0, 7, size=n), 45)
    ja, ta = _both(*a_args)
    jb, tb = _both(*b_args)
    assert (ta.nnz > tsg.NATIVE_MIN_NNZ) == (path == "native")
    jplan = jsp.spgemm_plan(ja, jb)
    rec = metrics.enable()
    try:
        rec.records.clear()
        tplan = tsp.spgemm_plan(ta, tb)
        assert [r.path for r in rec.records] == [f"spgemm_symbolic:{path}"]
    finally:
        metrics.disable()
        rec.records.clear()
    assert (tplan.nrows, tplan.ncols, tplan.n_out) == (
        jplan.nrows, jplan.ncols, jplan.n_out)
    for field in ("a_idx", "b_idx", "gid", "rowptr", "colind"):
        got = getattr(tplan, field)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(jplan, field)))
    # the slot pointers: each slot's first term
    tptr = np.searchsorted(tplan.gid.numpy(), np.arange(tplan.n_out + 1))
    np.testing.assert_array_equal(tplan.tptr.numpy(), tptr)


def test_native_and_numpy_symbolic_agree():
    n, m, rowptr, colind, _ = _power_law(600, 46)
    args = (rowptr.astype(np.int64), colind.astype(np.int64), n,
            rowptr.astype(np.int64), colind.astype(np.int64), m)
    for x, y in zip(native.spgemm_symbolic(*args), tsg._symbolic_numpy(*args)):
        assert x.dtype == y.dtype == np.int64
        np.testing.assert_array_equal(x, y)


def test_empty_product_plan():
    """No product terms: n_out == 0, an empty output, nothing launched."""
    a = tsp.CsrMatrix(3, 4, [0, 1, 1, 2], [0, 2], [1.0, 2.0])
    b = tsp.CsrMatrix(4, 2, [0, 0, 1, 1, 1], [1], [5.0])   # rows 0, 2 empty
    ja = jsp.CsrMatrix(3, 4, [0, 1, 1, 2], [0, 2], [1.0, 2.0])
    jb = jsp.CsrMatrix(4, 2, [0, 0, 1, 1, 1], [1], [5.0])
    c = a * b
    assert c.nnz == 0 and c.values.shape == (0,) and c.shape == (3, 2)
    assert (ja * jb).nnz == 0
    np.testing.assert_array_equal(c.rowptr.numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(c.to_dense().numpy(), np.zeros((3, 2)))


# ----------------------------------------------------------------- values


def _unsorted(n, ncols, cap, seed, dtype):
    """Host CSR arrays with zipf row lengths (every 11th row empty) and
    uniform columns, unsorted and repeating within a row."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.8, size=n), cap)
    deg[::11] = 0
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    colind = rng.integers(0, ncols, size=int(rowptr[-1]))
    values = rng.normal(size=colind.size).astype(dtype)
    return n, ncols, rowptr, colind, values


def _trusted(n, m, rowptr, colind, values):
    """Both packages' CSR through their trusted constructors: repeated and
    unsorted columns stay as they are."""
    return (jsp.CsrMatrix._from_parts(
                n, m, jnp.asarray(rowptr, jnp.int32),
                jnp.asarray(colind, jnp.int32), jnp.asarray(values)),
            tsp.CsrMatrix._from_parts(
                n, m, torch.from_numpy(rowptr.astype(np.int32)),
                torch.from_numpy(colind.astype(np.int32)),
                torch.from_numpy(values)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["power_law", "large_native", "unsorted"])
def test_values_match_spgemm_apply(dtype, case):
    if case == "unsorted":
        a_args = _unsorted(300, 300, 64, 78, dtype)
        b_args = _unsorted(300, 250, 200, 79, dtype)
        (ja, ta), (jb, tb) = _trusted(*a_args), _trusted(*b_args)
    else:
        n = 200 if case == "power_law" else 1200
        a_args = _power_law(n, 47, dtype)
        b_args = _uniform(n, 0, 6, 48, dtype)
        ja, ta = _both(*a_args)
        jb, tb = _both(*b_args)
    jplan, tplan = jsp.spgemm_plan(ja, jb), tsp.spgemm_plan(ta, tb)
    want = np.asarray(jsp.spgemm_apply(jplan, ja.values, jb.values))
    got = tsp.spgemm_apply(tplan, ta.values, tb.values)
    assert got.dtype == ta.values.dtype and want.dtype == dtype
    _within(got.numpy(), want, _term_scale(tplan, a_args[4], b_args[4]),
            TOL[dtype])


@pytest.mark.parametrize("case", ["uniform", "power_law", "hub_slot"])
def test_values_match_pair_route_interpret_f32(case):
    """The TPU kernel run as ``tests/test_pair_route.py`` runs it."""
    if case == "uniform":
        a_args = b_args = _uniform(150, 1, 9, 49, np.float32)
    elif case == "power_law":
        a_args = _power_law(200, 50, np.float32)
        b_args = _uniform(200, 1, 6, 51, np.float32)
    else:
        # one dense column: output slot (0, 0) sums n terms
        n = 96
        vals = np.random.default_rng(52).normal(size=n).astype(np.float32)
        a_args = (n, n, np.concatenate([[0], np.full(n, n)]), np.arange(n),
                  vals)
        b_args = (n, n, np.arange(n + 1), np.zeros(n, np.int64), vals)
    ja, ta = _both(*a_args)
    jb, tb = _both(*b_args)
    jplan, tplan = jsp.spgemm_plan(ja, jb), tsp.spgemm_plan(ta, tb)
    pr = build_pair_route_plan(
        np.asarray(jplan.gid, np.int64), np.asarray(jplan.a_idx, np.int64),
        np.asarray(jplan.b_idx, np.int64), max(jplan.n_out, 1),
        max(ja.nnz, 1), max(jb.nnz, 1))
    want = np.asarray(pair_route_apply(pr, jnp.asarray(a_args[4]),
                                       jnp.asarray(b_args[4]),
                                       interpret=True))[:jplan.n_out]
    got = tsp.spgemm_apply(tplan, ta.values, tb.values).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grad_matches_jax(dtype):
    a_args = _power_law(60, 53, dtype)
    b_args = _uniform(60, 0, 5, 54, dtype)
    ja, ta = _both(*a_args)
    jb, tb = _both(*b_args)
    jplan, tplan = jsp.spgemm_plan(ja, jb), tsp.spgemm_plan(ta, tb)
    w = np.random.default_rng(55).normal(size=tplan.n_out).astype(dtype)

    def f(av, bv):
        return jnp.sum(jnp.asarray(w) * jsp.spgemm_apply(jplan, av, bv))

    jda, jdb = jax.grad(f, argnums=(0, 1))(ja.values, jb.values)
    av = ta.values.clone().requires_grad_(True)
    bv = tb.values.clone().requires_grad_(True)
    tsp.spgemm_apply(tplan, av, bv).backward(torch.from_numpy(w))
    a_abs, b_abs, w_abs = (np.abs(x).astype(np.float64)
                           for x in (a_args[4], b_args[4], w))
    gid, ai, bi = (getattr(tplan, f).numpy() for f in ("gid", "a_idx", "b_idx"))
    scale_a = np.zeros(ta.nnz)
    np.add.at(scale_a, ai, w_abs[gid] * b_abs[bi])
    scale_b = np.zeros(tb.nnz)
    np.add.at(scale_b, bi, w_abs[gid] * a_abs[ai])
    _within(av.grad.numpy(), np.asarray(jda), scale_a, TOL[dtype])
    _within(bv.grad.numpy(), np.asarray(jdb), scale_b, TOL[dtype])


def test_padding_slots_get_no_gradient():
    n, m, rowptr, colind, values = _uniform(40, 1, 5, 56)
    pad = 7
    ind = np.concatenate([colind, np.zeros(pad, np.int64)])
    val = np.concatenate([values, np.full(pad, 3.0)])
    a = csr_from_arrays(n, m, rowptr, ind, val)
    exact = tsp.CsrMatrix(n, m, rowptr, colind, values)
    av = a.values.clone().requires_grad_(True)
    c = a.with_values(av) * exact
    np.testing.assert_array_equal(c.values.detach().numpy(),
                                  (exact * exact).values.numpy())
    c.values.sum().backward()
    assert np.all(av.grad.numpy()[-pad:] == 0)


def test_numeric_wrapper_checks():
    import dataclasses

    v = torch.ones(3, dtype=torch.float64)
    # no product terms: n_out == 0
    a = tsp.CsrMatrix(1, 2, [0, 1], [0], [1.0])
    b = tsp.CsrMatrix(2, 1, [0, 0, 1], [0], [1.0])
    empty = tsp.spgemm_plan(a, b)
    out = spgemm_numeric(empty, v, v)
    assert empty.n_out == 0 and out.shape == (0,) and out.dtype == torch.float64
    with pytest.raises(tsp.ShapeError):   # rowptr for another row count
        spgemm_numeric(dataclasses.replace(
            empty, rowptr=torch.zeros(3, dtype=torch.int32)), v, v)
    with pytest.raises(tsp.DTypeError):   # an int64 term list
        spgemm_numeric(dataclasses.replace(empty, gid=empty.gid.long()),
                       v, v)
    one = tsp.spgemm_plan(*(tsp.CsrMatrix(1, 1, [0, 1], [0], [1.0]),) * 2)
    half = spgemm_numeric(one, v.bfloat16(), v.float())
    assert half.dtype == torch.float32 and half.tolist() == [1.0]
    with pytest.raises(tsp.ShapeError):   # values shorter than the operand
        spgemm_numeric(one, v[:0], v)


# ------------------------------------------------------- whole products


def _cancelling_pair():
    """C = A·B with entry (0, 0) = 1·1 + 1·(-1): stored, exactly 0."""
    a = (2, 2, [0, 2, 3], [0, 1, 1], [1.0, 1.0, 2.0])
    b = (2, 2, [0, 1, 3], [0, 0, 1], [1.0, -1.0, 4.0])
    return a, b


def _product_cases():
    rng_a = _power_law(120, 57)
    rng_b = _uniform(120, 0, 6, 58)
    return {"random": (rng_a, rng_b), "cancelling": _cancelling_pair()}


@pytest.mark.parametrize("case", ["random", "cancelling"])
@pytest.mark.parametrize("op", ["mul", "matmul", "csc_mul", "csc_matmul",
                                "pow2", "pow3", "pow5"])
def test_products_match_jax(op, case):
    a_args, b_args = _product_cases()[case]
    fmt = "csc" if op.startswith("csc") else "csr"
    ja, ta = _both(*a_args, fmt=fmt)
    jb, tb = _both(*b_args, fmt=fmt)
    if op.startswith("pow"):
        k = int(op[3:])
        jc, tc = ja ** k, ta ** k
    elif op.endswith("matmul"):
        jc, tc = ja @ jb, ta @ tb
    else:
        jc, tc = ja * jb, ta * tb
    assert type(tc).__name__ == type(jc).__name__ and tc.shape == jc.shape
    np.testing.assert_array_equal(tc._ptr.numpy(), np.asarray(jc._ptr))
    np.testing.assert_array_equal(tc._minor.numpy(), np.asarray(jc._minor))
    np.testing.assert_allclose(tc.values.numpy(), np.asarray(jc.values),
                               rtol=1e-12, atol=1e-12)
    if case == "cancelling" and op in ("mul", "matmul"):
        assert tc.nnz == 4 and 0.0 in tc.values.tolist()


def test_power_edge_cases():
    t = tsp.CsrMatrix(2, 2, [0, 1, 2], [1, 0], [2.0, 3.0]).astype("float32")
    eye = t ** 0
    assert eye.dtype == torch.float32 and eye.device == t.device
    np.testing.assert_array_equal(eye.to_dense().numpy(), np.eye(2))
    assert (t ** 1) is t
    with pytest.raises(ValueError):
        t ** -1
    with pytest.raises(TypeError):
        t ** 1.5
    rect_j = jsp.CsrMatrix(2, 3, [0, 1, 1], [2], [1.0])
    rect_t = tsp.CsrMatrix(2, 3, [0, 1, 1], [2], [1.0])
    with pytest.raises(jsp.ShapeError):
        rect_j ** 2
    with pytest.raises(tsp.ShapeError):
        rect_t ** 2


def test_product_shape_errors_match_jax():
    for fmt in ("csr", "csc"):
        ja, ta = _both(2, 3, [0, 1, 1], [2], [1.0], fmt=fmt) if fmt == "csr" \
            else _both(2, 3, [0, 1, 1, 1], [0], [1.0], fmt=fmt)
        for op in (lambda x: x * x, lambda x: x @ x):
            with pytest.raises(jsp.ShapeError):
                op(ja)
            with pytest.raises(tsp.ShapeError):
                op(ta)


def test_scalar_scaling_matches_jax():
    ja, ta = _both(*_uniform(30, 1, 4, 59))
    for s in (2.5, -3, np.float64(0.5), np.asarray(4.0)):
        np.testing.assert_array_equal((ta * s).values.numpy(),
                                      np.asarray((ja * s).values))
    for s in (2.5, -3):
        np.testing.assert_array_equal((s * ta).values.numpy(),
                                      np.asarray((s * ja).values))
    np.testing.assert_array_equal(
        (ta * torch.tensor(2.0, dtype=torch.float64)).values.numpy(),
        np.asarray((ja * 2.0).values))


def test_plan_cache_reuses_and_frees(monkeypatch):
    import gc

    gc.collect()
    builds = []
    build = tsg.spgemm_plan
    monkeypatch.setattr(tsg, "spgemm_plan",
                        lambda a, b: builds.append(1) or build(a, b))
    n_before = len(tsg._PLAN_CACHE)
    _, ta = _both(*_uniform(50, 1, 5, 60))
    for scale in (1.0, 2.0):
        ta.with_values(ta.values * scale) * ta
    assert len(builds) == 1 and len(tsg._PLAN_CACHE) == n_before + 1
    # Same arrays, other shape: its own plan (keys carry the shapes).
    wide = tsp.CsrMatrix._from_parts(50, 60, ta.rowptr, ta.colind, ta.values)
    tall = tsp.CsrMatrix._from_parts(60, 50, torch.cat(
        [ta.rowptr, ta.rowptr[-1:].repeat(10)]), ta.colind, ta.values)
    wide * tall
    assert len(builds) == 2
    del ta, wide, tall
    gc.collect()
    assert len(tsg._PLAN_CACHE) == n_before


# ---------------------------------------------------- add / sub / neg


@pytest.mark.parametrize("fmt", ["csr", "csc"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("op", ["add", "sub", "neg", "self_sub"])
def test_elementwise_matches_jax_bitwise(op, dtype, fmt):
    n, m = 40, 30
    a_args = _arrays(n, m, lambda r, n: r.integers(0, 8, size=n), 61, dtype)
    b_args = _arrays(n, m, lambda r, n: r.integers(0, 8, size=n), 62, dtype)
    if fmt == "csc":   # the same arrays read as CSC of an m x n matrix
        a_args, b_args = ((m, n) + a_args[2:], (m, n) + b_args[2:])
    ja, ta = _both(*a_args, fmt=fmt)
    jb, tb = _both(*b_args, fmt=fmt)
    jc, tc = {"add": lambda: (ja + jb, ta + tb),
              "sub": lambda: (ja - jb, ta - tb),
              "neg": lambda: (-ja, -ta),
              "self_sub": lambda: (ja - ja, ta - ta)}[op]()
    assert type(tc).__name__ == type(jc).__name__
    assert tc.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    np.testing.assert_array_equal(tc._ptr.numpy(), np.asarray(jc._ptr))
    np.testing.assert_array_equal(tc._minor.numpy(), np.asarray(jc._minor))
    np.testing.assert_array_equal(tc.values.numpy(), np.asarray(jc.values))
    if op == "self_sub":   # cancelled sums stay as stored zeros
        assert tc.nnz == ta.nnz and np.all(tc.values.numpy() == 0)


def test_add_keeps_cancellation_zeros_and_promotes():
    a = tsp.CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0]).astype("float32")
    b = tsp.CsrMatrix(2, 2, [0, 2, 2], [0, 1], [-1.0, 5.0])
    ja = jsp.CsrMatrix(2, 2, [0, 1, 2], [0, 1], [1.0, 2.0]).astype("float32")
    jb = jsp.CsrMatrix(2, 2, [0, 2, 2], [0, 1], [-1.0, 5.0])
    c, jc = a + b, ja + jb
    assert c.dtype == torch.float64 and np.asarray(jc.values).dtype == np.float64
    np.testing.assert_array_equal(c.values.numpy(), np.asarray(jc.values))
    assert c.values.tolist() == [0.0, 5.0, 2.0]


def test_add_shape_error_matches_jax():
    for fmt in ("csr", "csc"):
        ja, ta = _both(2, 2, [0, 1, 1], [0], [1.0], fmt=fmt)
        jb, tb = _both(2, 3, [0, 1, 1], [2], [1.0], fmt=fmt) if fmt == "csr" \
            else _both(2, 3, [0, 1, 1, 1], [0], [1.0], fmt=fmt)
        for op in (lambda x, y: x + y, lambda x, y: x - y):
            with pytest.raises(jsp.ShapeError):
                op(ja, jb)
            with pytest.raises(tsp.ShapeError):
                op(ta, tb)


def test_mixed_formats_are_not_added():
    a = tsp.CsrMatrix.eye(3)
    with pytest.raises(TypeError):
        a + a.to_csc()
    with pytest.raises(TypeError):
        a * a.to_csc()


# ------------------------------------------------- native host library


def test_native_library_builds_into_build_dir(tmp_path, monkeypatch):
    """The port's own source is compiled where it lies, into the build
    directory; nothing is written beside the source."""
    src_dir = native.SOURCE.parent
    assert native.library_path().parent.parts[-2:] == ("build", "native")
    assert native.SOURCE.parts[-4:] == ("spalinalg_tpu_torch", "native",
                                        "src", "host_kernels.cpp")
    before = sorted(p.name for p in src_dir.iterdir())
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out = tmp_path / "libspal_host_test.so"
    native._build(out)
    assert [p.name for p in tmp_path.iterdir()] == [out.name]
    assert sorted(p.name for p in src_dir.iterdir()) == before


def test_native_source_is_the_ports_own():
    """The port builds its own copy of the C++ source, under
    ``spalinalg_tpu_torch/``, never a file of the JAX package; the copy
    holds the bound entry point and not the unported route colouring."""
    root = pathlib.Path(tsp.__file__).resolve().parent
    assert native.SOURCE.resolve().is_relative_to(root)
    text = native.SOURCE.read_text()
    assert "spal_spgemm_symbolic" in text and "spal_route_color" not in text


def test_native_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+"):
        native._build(tmp_path / "lib.so")
    monkeypatch.setattr(native, "SOURCE", tmp_path / "missing.cpp")
    with pytest.raises(native.NativeBuildError, match="not found"):
        native.library_path()


def test_large_plan_does_not_drop_to_numpy(monkeypatch):
    """Above the threshold the native library is required: its failure
    raises instead of running the NumPy expansion."""
    def broken():
        raise native.NativeBuildError("no compiler")

    monkeypatch.setattr(native, "load_library", broken)
    monkeypatch.setattr(tsg, "_symbolic_numpy", None)
    _, ta = _both(*_power_law(1500, 63))
    assert ta.nnz > tsg.NATIVE_MIN_NNZ
    with pytest.raises(native.NativeBuildError):
        tsp.spgemm_plan(ta, ta)
