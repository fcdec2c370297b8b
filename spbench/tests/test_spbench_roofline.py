"""The frozen work counts against hand counts."""

import pytest

from spbench import roofline


def test_spmv_bytes_by_hand():
    # 3 x 4, 5 entries, float64: values and colind 5·(8 + 4), x 4·8,
    # y 3·8, rowptr 4·4
    nbytes, flops = roofline.csr_spmv_work(3, 4, 5, 8)
    assert nbytes == 60 + 32 + 24 + 16
    assert flops == 10


def test_spmm_bytes_by_hand():
    # the same structure, float32, k = 2: X 4·2·4, Y 3·2·4
    nbytes, flops = roofline.csr_spmm_work(3, 4, 5, 2, 4)
    assert nbytes == 5 * 8 + 32 + 24 + 16
    assert flops == 2 * 5 * 2


def test_hpcg_spmv_bound():
    """The f64 SpMV at 256^3: 5.73 GB, 1.71 ms at 3.35 TB/s."""
    n, nnz = 256 ** 3, 449_455_096
    nbytes, flops = roofline.csr_spmv_work(n, n, nnz, 8)
    assert nbytes == 12 * nnz + 16 * n + 4 * (n + 1)
    assert roofline.bound_s(nbytes, flops, 8) == pytest.approx(
        nbytes / 3.35e12)
    assert 1.70e-3 < roofline.bound_s(nbytes, flops, 8) < 1.72e-3


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(0, 67e12, 4) == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 1, 8) == pytest.approx(1.0)


def test_brackets_share():
    work = roofline.csr_spmv_work(10, 10, 30, 4)
    bound = roofline.bound_s(*work, 4)
    share = roofline.brackets_share([(2 * bound, (*work, 4)),
                                     (2 * bound, (*work, 4))])
    assert share == pytest.approx(50.0)
    assert roofline.brackets_share([]) is None
