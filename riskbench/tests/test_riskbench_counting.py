"""The path kernel's work and bound, counted by hand at small shapes."""

import numpy as np
import pytest

from riskbench import counting
from riskbench.counting import Block, Launch

BS_MULTI = (Block("bs_multi", "exact", 4),)
NORTH_STAR = (Block("vasicek", "euler"), Block("bs", "euler"), Block("cirpp", "euler"))


def corr4():
    c = np.full((4, 4), 0.35)
    np.fill_diagonal(c, 1.0)
    return np.linalg.cholesky(c)


def test_bs_multi_by_hand():
    launch = Launch(BS_MULTI, corr4(), (0.5, 1.0), 1, 1000)
    # one Philox call, 4 uniforms, 2 Box-Muller pairs, 10 products and 6
    # sums of the factor, 4 exact GBM updates of 8; one exp per asset a date
    per_substep = 98 + 4 * 5 + 2 * 8 + 10 + 6 + 4 * 8
    assert counting.path_ops(launch) == 1000 * (2 * per_substep + 2 * 4)
    assert counting.path_bytes(launch) == 2 * 1000 * 4 * 4


def test_north_star_blocks_by_hand():
    chol = np.eye(3)
    launch = Launch(NORTH_STAR, chol, (0.25, 0.25, 0.5), 2, 10)
    # 3 factors: one Philox call, 4 uniforms, a pair and a cosine half, 3
    # diagonal products, no sums; updates 9 + 7 + 14; the repeated date
    # does not move
    per_substep = 98 + 4 * 5 + 8 + 6 + 3 + 0 + 9 + 7 + 14
    assert counting.live_substeps(launch.timeline, 2) == 4
    assert counting.path_ops(launch) == 10 * 4 * per_substep
    assert counting.state_dim(NORTH_STAR) == 5
    assert counting.path_bytes(launch) == 3 * 10 * 5 * 4


def test_bound_takes_the_larger():
    t, by = counting.bound(3.35e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "bytes")
    t, by = counting.bound(1.0, 67e12 * 2)
    assert (t, by) == (pytest.approx(2.0), "operations")


@pytest.mark.parametrize("blocks, chol, points, paths, bound_ms", [
    # the bring-up table's bounds (PERF.md): north star [57, 1e6, 5], BS-multi [10, 2^20, 4]
    (NORTH_STAR, np.eye(3), 57, 1_000_000, 0.340),
    (BS_MULTI, corr4(), 10, 1 << 20, 0.0501),
])
def test_bounds_of_the_bring_up_table(blocks, chol, points, paths, bound_ms):
    launch = Launch(blocks, chol, tuple(0.1 * (i + 1) for i in range(points)), 1, paths)
    t, by = counting.least_seconds(launch)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(bound_ms, rel=2e-3)
