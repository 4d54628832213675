"""The port's DARIMA combiner (``longseries.combine``) against the JAX
package's, on the CPU in float64: ``combine_segments`` on dense,
poisoned, all-dead and overlapping segment panels, with and without an
intercept, in one chunk and in several, and on the heterogeneous-order
layout of the auto path; the one device→host copy's byte count.

Tolerance: 1e-10 relative on the coefficients and σ².  Both sides sum
the same float64 gram products (``einsum``) in other orders, then solve
the same 13 × 13 ridge-guarded system in float64 on the host; the
counters must be equal."""

import numpy as np
import pytest
import torch

from spark_timeseries_tpu.longseries import combine as jcombine
from spark_timeseries_tpu_torch.longseries import combine
from spark_timeseries_tpu_torch.utils import metrics

pytestmark = pytest.mark.long

K, L = 12, 300


def _segments(seed, k=K, n=L):
    """ARMA(1,1) windows, each with its own mean."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(k, n + 1))
    y = np.zeros((k, n))
    for t in range(n):
        y[:, t] = 0.5 * (y[:, t - 1] if t else 0.0) + e[:, t + 1] \
            + 0.3 * e[:, t]
    return y + rng.normal(size=(k, 1))


def _coefs(seed, k, p, q, icpt):
    rng = np.random.default_rng(seed + 100)
    c = rng.normal(size=(k, icpt))
    phi = rng.uniform(-0.6, 0.6, size=(k, p)) / max(p, 1)
    theta = rng.uniform(-0.5, 0.5, size=(k, q)) / max(q, 1)
    return np.concatenate([c, phi, theta], axis=1)


def _layout(case):
    """(segs, coefs, converged, kwargs) of one combiner case."""
    segs = _segments(3)
    conv = np.random.default_rng(4).random(K) > 0.2
    kw = dict(p=1, q=1, include_intercept=True, n_ar=12)
    if case == "no_intercept":
        kw["include_intercept"] = False
        return segs, _coefs(1, K, 1, 1, 0), conv, kw
    coefs = _coefs(1, K, 1, 1, 1)
    if case == "poisoned":
        coefs[2] = np.nan
        segs[5, 40] = np.inf
        coefs[7, 1] = np.inf
    elif case == "all_dead":
        coefs[:] = np.nan
    elif case == "dead_windows":
        # finite estimates, no weightable segment: the mean of the
        # finite estimates
        segs[:] = np.nan
    elif case == "overlap":
        kw["overlap"] = 20
    elif case == "chunked":
        kw["chunk_segments"] = 5
    elif case == "heterogeneous":
        # the auto path's padded (max_p, max_q) = (3, 2) layout, each
        # segment's unused slots zero
        coefs = _coefs(2, K, 3, 2, 1)
        rng = np.random.default_rng(5)
        for i in range(K):
            pc, qc = rng.integers(0, 4), rng.integers(0, 3)
            coefs[i, 1 + pc:4] = 0.0
            coefs[i, 4 + qc:] = 0.0
        kw.update(p=3, q=2, n_ar=5)
    return segs, coefs, conv, kw


CASES = ["dense", "no_intercept", "poisoned", "all_dead", "dead_windows",
         "overlap", "chunked", "heterogeneous"]


@pytest.mark.parametrize("case", CASES)
def test_combine_segments_matches_jax(case):
    segs, coefs, conv, kw = _layout(case)
    got = combine.combine_segments(segs, coefs, conv, device="cpu", **kw)
    want = jcombine.combine_segments(segs, coefs, conv, **kw)
    assert got._fields == want._fields
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=1e-10, atol=1e-12)
    assert got.coefficients.dtype == np.float64
    np.testing.assert_allclose(got.sigma2, want.sigma2, rtol=1e-10)
    for f in ("n_segments", "n_finite", "n_weighted", "n_converged",
              "used_wls"):
        assert getattr(got, f) == getattr(want, f), f
    if case in ("all_dead", "dead_windows"):
        assert not got.used_wls
    # tensors in, and float32, combine the same way
    got_t = combine.combine_segments(torch.from_numpy(segs),
                                     torch.from_numpy(coefs),
                                     torch.from_numpy(conv), device="cpu",
                                     **kw)
    np.testing.assert_array_equal(got_t.coefficients, got.coefficients)


def test_one_copy_to_the_host_of_the_expected_bytes():
    """The accumulators cross in one packed copy of exactly
    ``expected_combine_acc_bytes``, in float32 and float64, and the
    counters move as the JAX package's."""
    for dtype in (np.float32, np.float64):
        acc = combine._zero_acc(13, torch.from_numpy(
            np.zeros(0, dtype)).dtype, torch.device("cpu"))
        acc[0][1, 2] = 3.5
        acc[2].fill_(7)
        host, nbytes = combine._acc_to_host(acc)
        assert nbytes == combine.expected_combine_acc_bytes(12, True, dtype)
        assert nbytes == jcombine.expected_combine_acc_bytes(12, True, dtype)
        assert host[0][1, 2] == 3.5 and int(host[2]) == 7
        assert [h.shape for h in host] == [tuple(a.shape) for a in acc]
    assert combine.expected_combine_acc_bytes(3, False) \
        == jcombine.expected_combine_acc_bytes(3, False)
    segs, coefs, conv, kw = _layout("poisoned")
    reg = metrics.get_registry()
    before = reg.snapshot()["counters"]
    res = combine.combine_segments(segs, coefs, conv, device="cpu", **kw)
    after = reg.snapshot()["counters"]
    assert after["longseries.segments_combined"] \
        - before.get("longseries.segments_combined", 0) == res.n_weighted
    assert after["longseries.segments_dropped"] \
        - before.get("longseries.segments_dropped", 0) \
        == K - res.n_weighted


def test_combine_raises_like_jax():
    segs, coefs, conv, kw = _layout("dense")
    for bad_segs, bad_coefs, match in (
            (segs[:, :20], coefs, "too short"),
            (segs, coefs[:5], "coefficient rows")):
        with pytest.raises(ValueError, match=match):
            combine.combine_segments(bad_segs, bad_coefs, device="cpu",
                                     **kw)
        with pytest.raises(ValueError, match=match):
            jcombine.combine_segments(bad_segs, bad_coefs, **kw)
    with pytest.raises(ValueError, match="too short"):
        combine.fused_fit_combine(segs[:, :20], p=1, q=1, n_ar=12,
                                  device="cpu")
