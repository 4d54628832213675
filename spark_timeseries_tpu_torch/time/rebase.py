"""Rebasing: move series from a source index onto a target index.

Capability parity with the reference's ``TimeSeriesUtils.scala``
(``src/main/scala/com/cloudera/sparkts/TimeSeriesUtils.scala:107-221``).
The reference builds per-target-location scalar lookups (with fast paths for
uniform->uniform and irregular->uniform); here every case reduces to one
vectorized **index mapping**: an int64 array ``m`` with ``m[i] = j`` meaning
"target location i takes source location j", and ``m[i] = -1`` meaning "no
source observation; fill with the default".

Applying a rebase is then a gather — `vals[..., m]` masked by `m < 0` — which
is jit/vmap friendly and applies to a whole (n_series, n_obs) panel at once
instead of per-series.
"""

from __future__ import annotations

import numpy as np

from .index import DateTimeIndex, UniformDateTimeIndex


class Rebaser:
    """A reusable source-index -> target-index alignment (gather spec)."""

    def __init__(self, index_mapping: np.ndarray, default_value: float = np.nan):
        self.index_mapping = np.asarray(index_mapping, dtype=np.int64)
        self.default_value = default_value
        self._safe = np.clip(self.index_mapping, 0, None)
        self._missing = self.index_mapping < 0
        self.is_identity = bool(np.array_equal(
            self.index_mapping, np.arange(self.index_mapping.size, dtype=np.int64)))

    def __call__(self, values: np.ndarray) -> np.ndarray:
        """Apply along the last (time) axis; works on 1-D series and 2-D panels."""
        values = np.asarray(values)
        if self.is_identity and values.shape[-1] == self.index_mapping.size:
            return values
        safe = np.minimum(self._safe, values.shape[-1] - 1)
        gathered = values[..., safe]
        missing = self._missing | (self.index_mapping >= values.shape[-1])
        return np.where(missing, self.default_value, gathered)


def rebaser(source_index: DateTimeIndex, target_index: DateTimeIndex,
            default_value: float = np.nan) -> Rebaser:
    """Build the alignment from ``source_index`` to ``target_index``.

    Equivalent of ref ``TimeSeriesUtils.rebaser`` (``TimeSeriesUtils.scala:78-102``);
    all source/target type combinations collapse to the vectorized mapping.
    """
    if isinstance(source_index, UniformDateTimeIndex) \
            and isinstance(target_index, UniformDateTimeIndex) \
            and source_index.frequency == target_index.frequency:
        freq = source_index.frequency
        start = freq.difference(source_index.first_nanos, target_index.first_nanos,
                                source_index.zone)
        # O(1) arithmetic fast path (ref TimeSeriesUtils.scala:107-128), valid
        # only when the target grid is in phase with the source grid
        if freq.advance(source_index.first_nanos, start, source_index.zone) \
                == target_index.first_nanos:
            mapping = start + np.arange(target_index.size, dtype=np.int64)
            mapping[(mapping < 0) | (mapping >= source_index.size)] = -1
            return Rebaser(mapping, default_value)
    target_nanos = target_index.to_nanos_array()
    mapping = source_index.locs_at(target_nanos)
    return Rebaser(mapping, default_value)


def rebase(source_index: DateTimeIndex, target_index: DateTimeIndex,
           values: np.ndarray, default_value: float = np.nan) -> np.ndarray:
    """One-shot rebase (ref ``TimeSeriesUtils.scala:62-68``)."""
    return rebaser(source_index, target_index, default_value)(values)
