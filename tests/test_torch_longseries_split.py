"""The port's long-series split geometry against the JAX package's, on
the CPU: ``stats.segment_plan`` / ``SegmentPlan`` and
``longseries.split`` (``difference``, ``tail_ring``, ``segment_panel``)
on a parametrised grid of lengths, orders, ``seg_len`` and overlaps,
their errors included.  Host numpy on both sides, so every result must
be equal, not close."""

import numpy as np
import pytest

from spark_timeseries_tpu import stats as jstats
from spark_timeseries_tpu.longseries import split as jsplit
from spark_timeseries_tpu_torch import stats
from spark_timeseries_tpu_torch.longseries import split

pytestmark = pytest.mark.long


@pytest.mark.parametrize("n_obs,p,q,kw", [
    (1_000_000, 2, 2, {}),
    (1_000_000, 1, 1, {}),
    (100_000_000, 1, 1, {}),
    (131_072, 1, 1, {"seg_len": 8192}),
    (4_096, 1, 1, {"seg_len": 256}),
    (5_000, 0, 3, {"overlap": 16}),
    (1_000, 1, 0, {"seg_len": 128, "overlap": 16, "min_seg_len": 128}),
    (3_000_000, 5, 5, {"max_segments": 64}),
    (777, 2, 1, {"min_seg_len": 100, "overlap": 7}),
])
def test_segment_plan_and_panel_match_jax(n_obs, p, q, kw):
    plan = stats.segment_plan(n_obs, p, q, **kw)
    want = jstats.segment_plan(n_obs, p, q, **kw)
    assert tuple(plan) == tuple(want)
    assert plan._fields == want._fields
    assert isinstance(plan, stats.SegmentPlan)
    assert plan.head_drop + plan.n_used == n_obs
    if n_obs <= 131_072:
        y = np.random.default_rng(n_obs).normal(size=n_obs)
        got = split.segment_panel(y, plan)
        np.testing.assert_array_equal(got, jsplit.segment_panel(y, want))
        assert got.flags.c_contiguous
        # the last window ends at the series' tail
        assert got[-1, -1] == y[-1]


@pytest.mark.parametrize("d", [0, 1, 2, 3])
def test_difference_and_tail_ring_match_jax(d):
    y = np.cumsum(np.random.default_rng(d).normal(size=300))
    np.testing.assert_array_equal(split.difference(y, d),
                                  jsplit.difference(y, d))
    ring = split.tail_ring(y, d)
    np.testing.assert_array_equal(ring, jsplit.tail_ring(y, d))
    assert ring.shape == (d,)
    for j in range(d):
        assert ring[j] == np.diff(y, n=j)[-1]


@pytest.mark.parametrize("call,match", [
    (lambda m: m.segment_plan(100, 2, 2), "too short to segment"),
    (lambda m: m.segment_plan(100_000, 2, 2, seg_len=8),
     "reliability floor"),
    (lambda m: m.segment_plan(1_000, 1, 1, seg_len=600), "segment"),
])
def test_segment_plan_raises_like_jax(call, match):
    with pytest.raises(ValueError, match=match) as got:
        call(stats)
    with pytest.raises(ValueError) as want:
        call(jstats)
    assert str(got.value) == str(want.value)


def test_segment_panel_raises_like_jax():
    plan = stats.segment_plan(1_000, 1, 1, seg_len=128)
    for bad, match in ((np.zeros((2, 1000)), "one series"),
                       (np.zeros(500), "plan covers")):
        with pytest.raises(ValueError, match=match) as got:
            split.segment_panel(bad, plan)
        with pytest.raises(ValueError) as want:
            jsplit.segment_panel(bad, plan)
        assert str(got.value) == str(want.value)
