"""Obs-axis segmentation: one ultra-long series → a segment panel
(counterpart of ``spark_timeseries_tpu/longseries/split.py``; host
numpy, a copy of the JAX package's).

The whole trick of the DARIMA tier (PAPERS.md "Distributed ARIMA Models
for Ultra-long Time Series") is a change of axis: a series too long to
fit — the CSS MA recursion is sequential in t, and 10⁶–10⁸ observations
will not sit in one optimizer dispatch — is reshaped so that **time
blocks become the batch axis**.  The resulting ``(n_segments, window)``
panel is exactly the shape every existing engine path eats:
``engine.stream_fit`` chunks it and pads its tail chunk with no new
machinery, which is why this module is host-side numpy and ~nothing
else.

Geometry (:func:`spark_timeseries_tpu_torch.stats.segment_plan` chooses it):
windows tile the *tail* of the (already differenced) series — the most
recent data always participates, the ``head_drop`` leading observations
are excluded, mirroring ``arima.fit_long``.  With ``overlap = o > 0``
every window extends ``o`` observations left of its own ``seg_len``
stride, giving each segment fit real left context instead of a zero
burn-in; the combiner then weights each observation **once** by skipping
the first ``max(n_ar, o)`` design rows per window
(``longseries.combine``).
"""

from __future__ import annotations

import numpy as np

from ..stats import SegmentPlan, segment_plan

__all__ = ["segment_panel", "difference", "tail_ring", "SegmentPlan",
           "segment_plan"]


def difference(ts: np.ndarray, d: int) -> np.ndarray:
    """Order-``d`` differencing on host (``np.diff`` — the global
    differencing pass the split runs once, so segments fit a pure ARMA
    with a **common** d instead of per-segment differencing that would
    put segment estimates in incompatible spaces)."""
    ts = np.asarray(ts)
    return np.diff(ts, n=int(d)) if d else ts


def tail_ring(ts: np.ndarray, d: int) -> np.ndarray:
    """The last raw differences ``ring[j] = (Δʲ ts)[-1]`` for
    ``j < d`` — the ``FilterState.ring`` seed that lets the state-space
    forecast integrate back from the differenced filter scale to raw
    observations (``statespace.kalman.forecast_mean``)."""
    ts = np.asarray(ts)
    ring = np.zeros((int(d),), ts.dtype)
    cur = ts
    for j in range(int(d)):
        ring[j] = cur[-1]
        cur = np.diff(cur)
    return ring


def segment_panel(diffed: np.ndarray, plan: SegmentPlan) -> np.ndarray:
    """Reshape a 1-D (differenced) series into the ``(n_segments,
    window)`` panel its :class:`~spark_timeseries_tpu_torch.stats.SegmentPlan`
    describes.

    Window ``k`` holds ``diffed[head_drop + k·seg_len : head_drop +
    k·seg_len + window]``; consecutive windows share their trailing/
    leading ``overlap`` observations.  Returns a contiguous host array
    (the copy is ``n_used + (n_segments-1)·overlap`` floats — a few MB
    at 10⁶ obs — and what ``stream_fit`` slices chunks from)."""
    diffed = np.asarray(diffed)
    if diffed.ndim != 1:
        raise ValueError(
            f"segment_panel splits one series; got shape {diffed.shape} "
            f"(fit ultra-long panels one series at a time)")
    if diffed.size < plan.head_drop + plan.n_used:
        raise ValueError(
            f"plan covers {plan.head_drop + plan.n_used} obs but the "
            f"series has {diffed.size}")
    starts = plan.head_drop + np.arange(plan.n_segments) * plan.seg_len
    idx = starts[:, None] + np.arange(plan.window)[None, :]
    return np.ascontiguousarray(diffed[idx])
