"""Inputs from the seed: the same seed gives the same arrivals, widths,
right-hand sides and values; two seeds give different ones, and every seed
the same work."""

import collections

import numpy as np
import pytest

from perfbench import matrices
from perfbench.common import SCALES, RhsStream, rhs_pool, seed_rng
from perfbench.loops.serve import schedule
from perfbench.sweep import holds

BIG = 2**31 + 12345  # seeds may pass 32 signed bits


def test_schedule_repeats_for_a_seed_and_differs_across_seeds():
    a1, w1 = schedule(250.0, 10.0, [1, 2, 3, 4], BIG)
    a2, w2 = schedule(250.0, 10.0, [1, 2, 3, 4], BIG)
    a3, w3 = schedule(250.0, 10.0, [1, 2, 3, 4], BIG + 1)
    np.testing.assert_array_equal(a1, a2)
    np.testing.assert_array_equal(w1, w2)
    assert not np.array_equal(a1, a3) and not np.array_equal(w1, w3)


def test_every_seed_gets_the_same_work():
    a1, w1 = schedule(250.0, 10.0, [1, 2, 3, 4], 1)
    a3, w3 = schedule(250.0, 10.0, [1, 2, 3, 4], 99)
    assert len(a1) == len(a3) == 2500
    np.testing.assert_allclose(np.sort(np.diff(a1, append=10.0)),
                               np.sort(np.diff(a3, append=10.0)))
    assert collections.Counter(w1.tolist()) == collections.Counter(
        w3.tolist()) == {1: 625, 2: 625, 3: 625, 4: 625}
    assert a1[0] == 0.0 and np.all(np.diff(a1) > 0) and a1[-1] < 10.0


def test_gaps_are_a_poisson_streams():
    a, _ = schedule(400.0, 25.0, [1], 5)
    gaps = np.diff(a)
    assert gaps.mean() == pytest.approx(1 / 400, rel=0.01)
    # exponential gaps: the standard deviation equals the mean
    assert gaps.std() == pytest.approx(gaps.mean(), rel=0.05)


def test_rhs_pool_from_the_seed():
    p1 = rhs_pool(64, 8, BIG, "cpu")
    p2 = rhs_pool(64, 8, BIG, "cpu")
    p3 = rhs_pool(64, 8, BIG + 1, "cpu")
    assert p1.shape == (8, 64) and p1.dtype == np.float32
    np.testing.assert_array_equal(p1, p2)
    assert not np.array_equal(p1, p3)
    assert len({row.tobytes() for row in p1}) == 8


def test_every_request_gets_new_numbers():
    s1 = RhsStream(64, 8, BIG, "cpu")
    s2 = RhsStream(64, 8, BIG, "cpu")
    buf = np.empty((1, 64), dtype=np.float32)
    seen = set()
    for i in range(3 * 8 * 5):
        s1.fill(i, i % 8, 1, buf)
        # one address, other numbers at every call; the same from the seed
        assert buf.tobytes() not in seen
        seen.add(buf.tobytes())
        np.testing.assert_array_equal(buf, s2.make(i, i % 8, 1))
    assert len(set(s1.scales.tolist())) == SCALES
    assert np.all((np.abs(s1.scales) >= 0.5) & (np.abs(s1.scales) <= 2.0))
    assert not np.array_equal(s1.scales, RhsStream(64, 8, BIG + 1, "cpu").scales)
    wide = s1.make(7, 2, 4)
    assert wide.shape == (4, 64)
    np.testing.assert_array_equal(wide, s1.pool[2:6] * s1.scales[7])


def test_values_from_the_seed_pattern_from_the_configuration():
    v1, d1 = matrices.values(100, 300, BIG)
    v2, d2 = matrices.values(100, 300, BIG)
    v3, d3 = matrices.values(100, 300, BIG + 1)
    np.testing.assert_array_equal(v1, v2)
    np.testing.assert_array_equal(d1, d2)
    assert not np.array_equal(v1, v3) and not np.array_equal(d1, d3)
    assert np.all(np.abs(v1) <= 0.5)
    assert np.all((np.abs(d1) >= 1.0) & (np.abs(d1) <= 2.0))


def test_seed_streams_are_independent():
    assert seed_rng(BIG, 1).random() != seed_rng(BIG, 2).random()
    assert seed_rng(BIG, 1).random() == seed_rng(BIG, 1).random()


def _row(rate, p50, p95, backlog=(2.0, 3.0), ratio=1.0):
    return {"offered_cols_s": rate * 2.5, "completed_cols_s": rate * 2.5 * ratio,
            "backlog_first": backlog[0], "backlog_last": backlog[1],
            "p50_ms": p50, "p95_ms": p95}


@pytest.mark.parametrize("row, held", [
    # the ckt_add20_32k sweep on the card: 250 requests/s kept up
    (_row(250, 5.2323, 10.7154, (3.385, 4.535)), True),
    # 280: a queue built up early and never drained, the backlog flat
    (_row(280, 296.7922, 435.0459, (157.51, 173.44), 0.9918), False),
    # 280: no backlog to speak of, but the tail swung out
    (_row(280, 7.8828, 98.7987, (13.905, 7.97), 0.9977), False),
    # completed columns fell behind the offered ones
    (_row(300, 5.0, 9.0, (2.0, 3.0), 0.97), False),
])
def test_the_sweep_marks_the_knee(row, held):
    assert holds(row, max_batch=16) is held
