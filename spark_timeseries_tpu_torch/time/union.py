"""Index union & simplify.

Capability parity with the reference's ``DateTimeIndexUtils.scala``
(``src/main/scala/com/cloudera/sparkts/DateTimeIndexUtils.scala:22-154``):
unions a collection of date-time indices into one hybrid index via a priority
queue with overlap trimming/splitting, then simplifies adjacent
irregular/size-1 sub-indices into single irregular blocks.

Host-side only; never enters jitted code.
"""

from __future__ import annotations

import heapq
from typing import List, Sequence

import numpy as np

from .index import (
    DateTimeIndex,
    HybridDateTimeIndex,
    IrregularDateTimeIndex,
)


def _sort_key(ix: DateTimeIndex) -> tuple[int, int]:
    # order by first instant, ties by size (ref DateTimeIndexUtils.scala:23-28)
    return (ix.first_nanos, ix.size)


def simplify(indices: Sequence[DateTimeIndex]) -> List[DateTimeIndex]:
    """Merge runs of adjacent irregular or size-1 indices into one irregular index
    (ref ``DateTimeIndexUtils.scala:40-78``)."""
    simplified: List[DateTimeIndex] = []
    buffer: List[DateTimeIndex] = []
    last_i = len(indices) - 1

    for i, current in enumerate(indices):
        mergeable = current.size == 1 or isinstance(current, IrregularDateTimeIndex)
        if mergeable:
            buffer.append(current)
        if not mergeable or i == last_i:
            if len(buffer) > 1:
                simplified.append(IrregularDateTimeIndex(
                    np.concatenate([b.to_nanos_array() for b in buffer]),
                    buffer[0].zone))
                buffer.clear()
            elif len(buffer) == 1:
                simplified.append(buffer[0])
                buffer.clear()
            if not mergeable:
                simplified.append(current)
    return simplified


def union(indices: Sequence[DateTimeIndex], zone=None) -> DateTimeIndex:
    """Union indices into a single hybrid index (ref ``DateTimeIndexUtils.scala:114-153``).

    Duplicated instants are represented once; overlapping indices are trimmed or
    split so the resulting sub-indices are sorted and disjoint.
    """
    if zone is None:
        zone = indices[0].zone
    heap: List[tuple[tuple[int, int], int, DateTimeIndex]] = []
    counter = 0
    for ix in indices:
        heapq.heappush(heap, (_sort_key(ix), counter, ix))
        counter += 1

    union_list: List[DateTimeIndex] = [heapq.heappop(heap)[2]]

    while heap:
        a = union_list.pop()
        b = heapq.heappop(heap)[2]

        b_trimmed = False
        while b.size > 0 and a.loc_at_datetime(b.first_nanos) > -1:
            b = b.islice(1, b.size)
            b_trimmed = True

        if b_trimmed and b.size > 0:
            union_list.append(a)
            heapq.heappush(heap, (_sort_key(b), counter, b))
            counter += 1
        elif b.size == 0:
            union_list.append(a)
        else:
            split_loc = a.insertion_loc(b.first_nanos)
            if split_loc < a.size:
                a_lower = a.islice(0, split_loc)
                a_upper = a.islice(split_loc, a.size)
                union_list.append(a_lower)
                union_list.append(b)
                heapq.heappush(heap, (_sort_key(a_upper), counter, a_upper))
                counter += 1
            else:
                union_list.append(a)
                union_list.append(b)

    simplified = simplify(union_list)
    return HybridDateTimeIndex(simplified).at_zone(zone)
