"""The port's config against the JAX package's: the kept fields and their
defaults, ``with_``, the ``use()`` stack, and the TPU knobs the port drops
(``use_pallas``, ``bsr_stream_group``, ``max_bucket_width``,
``min_bucket_width``), which raise ``TypeError``."""

import dataclasses

import numpy as np
import pytest

import spalinalg_tpu.config as jcfg
import spalinalg_tpu_torch.config as tcfg

KEPT = ("default_dtype", "rtol_f32", "rtol_f64", "partition_axis")
DROPPED = ("use_pallas", "bsr_stream_group", "max_bucket_width",
           "min_bucket_width")


def test_fields_are_the_kept_ones():
    names = tuple(f.name for f in dataclasses.fields(tcfg.Config))
    jnames = {f.name for f in dataclasses.fields(jcfg.Config)}
    assert names == KEPT
    assert set(KEPT) | set(DROPPED) == jnames


@pytest.mark.parametrize("field", KEPT)
def test_defaults_match_jax(field):
    assert getattr(tcfg.default_config(), field) == getattr(
        jcfg.default_config(), field)


@pytest.mark.parametrize("knob", DROPPED)
def test_dropped_knobs_raise(knob):
    value = getattr(jcfg.default_config(), knob)
    with pytest.raises(TypeError):
        tcfg.Config(**{knob: value})
    with pytest.raises(TypeError):
        tcfg.default_config().with_(**{knob: value})


def test_frozen_and_hashable():
    cfg = tcfg.Config()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.partition_axis = "x"
    assert hash(cfg) == hash(tcfg.Config())
    assert cfg.np_default_dtype == np.dtype(np.float64)
    assert cfg.np_default_dtype == jcfg.Config().np_default_dtype


def test_use_stack():
    base = tcfg.current_config()
    assert base is tcfg.default_config()
    outer = base.with_(partition_axis="outer")
    inner = outer.with_(rtol_f64=1e-10)
    with tcfg.use(outer) as got:
        assert got is outer and tcfg.current_config() is outer
        with tcfg.use(inner):
            assert tcfg.current_config().partition_axis == "outer"
            assert tcfg.current_config().rtol_f64 == 1e-10
        assert tcfg.current_config() is outer
    assert tcfg.current_config() is base


def test_use_pops_on_error():
    with pytest.raises(RuntimeError):
        with tcfg.use(tcfg.Config(default_dtype="float32")):
            raise RuntimeError("boom")
    assert tcfg.current_config() is tcfg.default_config()


def test_partition_axis_names_the_mesh():
    """``make_row_mesh`` names its axis after the current config's
    ``partition_axis``."""
    import torch.distributed as dist

    from spalinalg_tpu_torch.parallel import make_row_mesh

    assert not dist.is_initialized()
    try:
        with tcfg.use(tcfg.Config(partition_axis="shards")):
            assert make_row_mesh(device="cpu").mesh_dim_names == ("shards",)
        assert make_row_mesh(device="cpu").mesh_dim_names == ("rows",)
        assert make_row_mesh(axis="z", device="cpu").mesh_dim_names == ("z",)
    finally:
        dist.destroy_process_group()
