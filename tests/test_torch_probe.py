"""The wide-gather probe of the PyTorch port against the JAX package's tool.

``spalinalg_tpu_torch.tools.probe_widegather.wide_gather_mac_plain`` is
held against the tool's own Pallas kernel (``tools/probe_widegather.py``
``_kernel``, loaded by path; the tool is not a package) run through
``pl.pallas_call(..., interpret=True)`` at the tool's shapes, with
in-range indices as the tool draws them and with out-of-range ones, which
the kernel's ``FILL_OR_DROP`` gather reads as 0. The tolerance, 1e-5 of
``Σ_k |xt|·|val|`` per entry, covers summation in float32 (the
interpreted kernel's multiply-adds may be fused). The tool's NumPy
reference (``:75-77``) is a second oracle.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import spalinalg_tpu_torch as tsp
from spalinalg_tpu_torch.tools import probe_widegather as probe


@pytest.fixture(autouse=True)
def _cpu_scope():
    """The port's entry points place data on the card unless told
    otherwise; these tests run on the CPU."""
    with tsp.default_device("cpu"):
        yield


TOOL = Path(__file__).resolve().parents[1] / "tools" / "probe_widegather.py"


def _tool():
    spec = importlib.util.spec_from_file_location("probe_widegather_tool",
                                                  TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, out_of_range):
    xt, idx, val = (a.numpy() for a in probe.inputs("cpu", seed))
    if out_of_range:
        rng = np.random.default_rng(seed + 100)
        hit = rng.random(idx.shape) < 0.05
        idx = np.where(hit, rng.choice([-1, -7, probe.N, probe.N + 3],
                                       size=idx.shape), idx).astype(np.int32)
    return xt, idx, val


def _scale(xt, idx, val):
    ok = (idx >= 0) & (idx < xt.shape[1])
    safe = np.where(ok, idx, 0)
    return sum(np.abs(xt[:, safe[k]]) * ok[k] * np.abs(val[k])
               for k in range(idx.shape[0]))


def test_shapes_match_the_tool():
    tool = _tool()
    assert (probe.N, probe.NCOL, probe.TAKES) == (tool.N, tool.NCOL,
                                                  tool.TAKES)
    rng = np.random.default_rng(0)
    xt, idx, val = probe.inputs("cpu", 0)
    np.testing.assert_array_equal(
        xt.numpy(), rng.normal(size=(tool.NCOL, tool.N)).astype(np.float32))
    np.testing.assert_array_equal(
        idx.numpy(), rng.integers(0, tool.N, size=(tool.TAKES, 128))
        .astype(np.int32))
    np.testing.assert_array_equal(
        val.numpy(), rng.normal(size=(tool.TAKES, 128)).astype(np.float32))


@pytest.mark.parametrize("out_of_range", [False, True],
                         ids=["tool_inputs", "out_of_range"])
def test_plain_matches_tool_kernel_interpret(out_of_range):
    tool = _tool()
    xt, idx, val = _inputs(0, out_of_range)
    fn = pl.pallas_call(
        tool._kernel, interpret=True,
        out_shape=jax.ShapeDtypeStruct((tool.NCOL, 128), jnp.float32))
    want = np.asarray(fn(jnp.asarray(xt), jnp.asarray(idx),
                         jnp.asarray(val)))
    got = probe.wide_gather_mac(*(torch.from_numpy(a)
                                  for a in (xt, idx, val))).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * _scale(xt, idx, val) + 1e-30)


def test_split_matches_kernel_source():
    """``probe.SPLIT`` is the kernel's own K split."""
    src = (Path(probe.__file__).resolve().parents[1] / "csrc"
           / "wide_gather.cu").read_text()
    assert re.search(r"constexpr int kSplit = (\d+);", src).group(1) \
        == str(probe.SPLIT)


@pytest.mark.parametrize("out_of_range", [False, True],
                         ids=["tool_inputs", "out_of_range"])
def test_split_order_matches_tool_kernel_interpret(out_of_range):
    """The kernel's order of summation, emulated in float32 (SPLIT runs of
    consecutive takes, each summed in order, then the runs' sums in order),
    is within the tolerance of the tool's kernel: the redesign may change
    the last bits, not the function."""
    tool = _tool()
    xt, idx, val = _inputs(3, out_of_range)
    fn = pl.pallas_call(
        tool._kernel, interpret=True,
        out_shape=jax.ShapeDtypeStruct((tool.NCOL, 128), jnp.float32))
    want = np.asarray(fn(jnp.asarray(xt), jnp.asarray(idx),
                         jnp.asarray(val)))
    ok = (idx >= 0) & (idx < xt.shape[1])
    safe = np.where(ok, idx, 0)
    run = -(-probe.TAKES // probe.SPLIT)
    got = np.zeros_like(want)
    for r in range(probe.SPLIT):
        part = np.zeros_like(want)
        for k in range(r * run, min(probe.TAKES, (r + 1) * run)):
            part += np.where(ok[k], xt[:, safe[k]], np.float32(0)) * val[k]
        got += part
    assert got.dtype == np.float32
    assert np.all(np.abs(got - want) <= 1e-5 * _scale(xt, idx, val) + 1e-30)


def test_plain_matches_tool_numpy_reference():
    xt, idx, val = _inputs(1, False)
    ref = np.zeros((probe.NCOL, 128), np.float32)
    for k in range(probe.TAKES):
        ref += xt[:, idx[k]] * val[k]
    got = probe.wide_gather_mac_plain(*(torch.from_numpy(a)
                                        for a in (xt, idx, val))).numpy()
    assert np.all(np.abs(got - ref) <= 1e-5 * _scale(xt, idx, val) + 1e-30)


def test_wrapper_checks_and_counts():
    xt, idx, val = probe.inputs("cpu", 2)
    before = dict(probe.LAUNCHES)
    probe.wide_gather_mac(xt[:, :100], idx % 100, val)
    assert probe.LAUNCHES == before          # plain versions count nothing
    with pytest.raises(tsp.DTypeError):
        probe.wide_gather_mac(xt.double(), idx, val)
    with pytest.raises(tsp.DTypeError):
        probe.wide_gather_mac(xt, idx.long(), val)
    with pytest.raises(tsp.ShapeError):
        probe.wide_gather_mac(xt, idx, val[:, :5])
    with pytest.raises(ValueError, match="no wide_gather kernel"):
        probe.wide_gather_mac(xt.to("meta"), idx.to("meta"), val.to("meta"))
    with pytest.raises(ValueError, match="not on cpu"):
        probe.run("cpu")


def test_launch_floor_needs_a_card():
    with pytest.raises(ValueError, match="not on cpu"):
        probe.launch_floor_us("cpu")


def test_main_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present; main() would time it")
    assert probe.main() == 1
    assert "no CUDA device" in capsys.readouterr().err
