"""Window resampling with pandas-style closed/stamp semantics
(counterpart of ``spark_timeseries_tpu/ops/resample.py``).

Bucket assignment is one ``searchsorted`` over int64 nanos on the host;
the aggregation is a segment reduction along the last axis of a
``(..., n)`` tensor on its own device (``index_add_`` /
``scatter_reduce``), so one call resamples a whole panel.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

from ..time.index import DateTimeIndex


def bucket_assignments(source_nanos: np.ndarray, target_nanos: np.ndarray,
                       closed_right: bool, stamp_right: bool) -> np.ndarray:
    """Bucket index for each source instant; -1 where the observation falls
    in no window.

    Window semantics (m = len(target)):
      - ``stamp_right``: stamp i labels the window *ending* at target[i];
        bucket 0 is unbounded below, observations after the last stamp drop.
      - ``not stamp_right``: stamp i labels the window *starting* at
        target[i]; observations before the first stamp drop, the last
        window is unbounded above.
      - ``closed_right``: windows are (lo, hi] instead of [lo, hi).
    """
    side = "left" if closed_right else "right"
    pos = np.searchsorted(target_nanos, source_nanos, side=side)
    bucket = pos if stamp_right else pos - 1
    m = target_nanos.size
    return np.where((bucket >= 0) & (bucket < m), bucket, -1).astype(np.int64)


def _seg_reduce(values: torch.Tensor, bucket: torch.Tensor, m: int,
                how: str) -> torch.Tensor:
    """Segment reduction of ``values (..., n)`` over ``bucket (n,)`` into
    ``(..., m)``; observations in no bucket go to a spill bucket ``m``
    that is dropped.  Empty buckets give NaN; a NaN inside a bucket makes
    its ``min`` / ``max`` / ``sum`` / ``mean`` NaN (the JAX segment ops
    propagate it too)."""
    n = values.shape[-1]
    flat = values.reshape(-1, n)
    seg = torch.where(bucket < 0, m, bucket)
    count = torch.zeros(m + 1, dtype=values.dtype, device=values.device)
    count.index_add_(0, seg, torch.ones(n, dtype=values.dtype,
                                        device=values.device))
    out = flat.new_zeros((flat.shape[0], m + 1))
    if how in ("mean", "sum"):
        out.index_add_(1, seg, flat)
        if how == "mean":
            out = out / count
    elif how in ("min", "max"):
        out.scatter_reduce_(1, seg.expand(flat.shape), flat, "a" + how,
                            include_self=False)
    elif how in ("first", "last"):
        iota = torch.arange(n, device=values.device)
        pos = torch.full((m + 1,), n if how == "first" else -1,
                         dtype=iota.dtype, device=values.device)
        pos.scatter_reduce_(0, seg, iota, "amin" if how == "first"
                            else "amax")
        out = flat[:, pos.clamp(0, n - 1)]
    elif how == "count":
        out = count.expand(flat.shape[0], m + 1)
    else:
        raise ValueError(f"unknown aggregator {how!r}")
    out = torch.where(count > 0, out, flat.new_tensor(float("nan")))[:, :m]
    return out.reshape(*values.shape[:-1], m)


def resample(values, source_index: DateTimeIndex, target_index: DateTimeIndex,
             aggr: Union[str, Callable] = "mean",
             closed_right: bool = False, stamp_right: bool = False):
    """Resample ``(..., n)`` values from ``source_index`` onto
    ``target_index``.

    ``aggr`` is one of ``mean|sum|min|max|first|last|count`` (a segment
    reduction on the tensor's device), or a Python callable ``(np.ndarray,
    start, end) -> float`` applied per bucket on the host, which returns a
    numpy array as the JAX function's host path does.
    """
    src = source_index.to_nanos_array()
    tgt = target_index.to_nanos_array()
    bucket = bucket_assignments(src, tgt, closed_right, stamp_right)

    if callable(aggr):
        arr = values.cpu().numpy() if isinstance(values, torch.Tensor) \
            else np.asarray(values)
        m = tgt.size
        out_dtype = arr.dtype if np.issubdtype(arr.dtype, np.floating) \
            else np.float64
        out = np.full((*arr.shape[:-1], m), np.nan, dtype=out_dtype)
        flat = arr.reshape(-1, arr.shape[-1])
        out_flat = out.reshape(-1, m)
        valid = bucket >= 0
        for b in range(m):
            locs = np.flatnonzero(valid & (bucket == b))
            if locs.size:
                start, end = int(locs[0]), int(locs[-1]) + 1
                out_flat[:, b] = [aggr(row, start, end) for row in flat]
        return out

    values = torch.as_tensor(values)
    return _seg_reduce(values, torch.from_numpy(bucket).to(values.device),
                       tgt.size, aggr)
