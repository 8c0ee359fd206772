"""work.py's count of an operator's bytes and flops, against hand counts."""

from math import comb

import numpy as np
import pytest

from eigbench import work
from eigbench.reference import heisenberg_chain


def test_symmetric_tridiagonal_by_hand():
    # 3 x 3 tridiagonal: 7 nonzeros, of which 5 on or above the diagonal
    rows = np.array([0, 0, 1, 1, 1, 2, 2])
    cols = np.array([0, 1, 0, 1, 2, 1, 2])
    assert work.spmv_work(rows, cols, 3, 3, "bfloat16", True) == (5 * (2 + 4) + 6 * 4, 14)
    assert work.spmv_work(rows, cols, 3, 3, "float32", False) == (7 * (4 + 4) + 6 * 4, 14)
    assert work.spmv_work(rows, cols, 3, 3, "float64", False) == (7 * (8 + 4) + 6 * 4, 14)


def test_rectangular_counts_both_vectors():
    rows, cols = np.array([0, 1]), np.array([4, 2])
    assert work.spmv_work(rows, cols, 2, 5, "float32", False) == (2 * 8 + (2 + 5) * 4, 4)


@pytest.mark.parametrize("L", [8, 12])
def test_heisenberg_sector_matches_closed_count(L):
    """Open chain, S_z = 0: each of the L - 1 bonds flips 2 C(L - 2, L/2 - 1)
    states; the diagonal is dense.  The count at L = 24 that the same
    formula gives is pinned below."""
    crow, col, _, dim = heisenberg_chain.csr_arrays(L, L // 2, 1.0, 1.0, False)
    rows = np.repeat(np.arange(dim), np.diff(crow))
    off = (L - 1) * 2 * comb(L - 2, L // 2 - 1)
    assert dim == comb(L, L // 2) and col.size == dim + off
    assert work.spmv_work(rows, col, dim, dim, "bfloat16", True) == (
        (dim + off // 2) * 6 + 2 * dim * 4, 2 * (dim + off))


def test_published_sizes_pinned():
    # heisenberg_l24: dim C(24, 12), 23 bonds x 2 C(22, 11) flips; stored: diagonal + upper
    dim, off = comb(24, 12), 23 * 2 * comb(22, 11)
    assert (dim, dim + off) == (2_704_156, 35_154_028)
    nbytes = (dim + off // 2) * 6 + 2 * dim * 4
    assert nbytes == 135_207_800
    assert work.roofline_ms(nbytes, 2 * (dim + off), "bfloat16", "NVIDIA H100 80GB HBM3") == \
        pytest.approx(nbytes / 3.35e12 * 1e3)
    # convdiff_316: the diagonal plus 4 nx (nx - 1) neighbours, general float32
    from eigbench.tests._tiny import core

    cd = core.load_module(core.ROOT / "eigbench" / "configs" / "convdiff_316.py", "config")
    r, c, _, shape = cd.operand(cd.PARAMS)
    assert work.spmv_work(r, c, *shape, "float32", False) == (498_016 * 8 + 2 * 99_856 * 4, 2 * 498_016)


def test_peaks_pick_the_specific_part_first():
    assert work.peaks_for("NVIDIA H100 PCIe")[0] == 2.0e12
    assert work.peaks_for("NVIDIA H100 80GB HBM3")[0] == 3.35e12
    assert work.peaks_for("some other card") is None
    assert work.roofline_ms(1, 1, "float32", "some other card") is None
