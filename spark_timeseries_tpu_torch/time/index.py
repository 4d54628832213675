"""Date-time indices: uniform, irregular, hybrid.

Capability parity with the reference's ``DateTimeIndex.scala``
(``src/main/scala/com/cloudera/sparkts/DateTimeIndex.scala:40-914``):
a bi-directional map between instants and integer locations, with slicing by time
(inclusive) and by position (exclusive end), ``loc_at_*`` lookups, iteration, and
a string round-trip (``to_string``/``from_string``) used as the sidecar format by
save/load.

TPU-first design: indices are host-side objects backed by int64 epoch-nanos numpy
arrays.  Only resolved integer locations ever enter jitted code; calendar logic
(zones, business days) never touches the device.  All lookups have vectorized
array variants (``locs_at``, ``insertion_locs``) used by the ingestion and
rebase paths, replacing the reference's per-observation scalar lookups
(ref ``TimeSeriesRDD.scala:727``).
"""

from __future__ import annotations

import datetime as _dt
import re
from abc import ABC, abstractmethod
from typing import Iterable, List, Sequence, Union

import numpy as np

from .frequency import (
    NANOS_PER_MICRO,
    NANOS_PER_SECOND,
    DurationFrequency,
    Frequency,
    datetime_to_nanos,
    frequency_from_string,
    nanos_to_datetime,
    rebase_day_of_week,
    zone_of,
)

DateTimeLike = Union[int, np.int64, _dt.datetime, str]


def to_nanos(dt: DateTimeLike) -> int:
    """Coerce an instant-like value (epoch-nanos int, datetime, ISO string) to nanos."""
    if isinstance(dt, (int, np.integer)):
        return int(dt)
    if isinstance(dt, _dt.datetime):
        return datetime_to_nanos(dt)
    if isinstance(dt, str):
        nanos, _ = parse_zoned_datetime(dt)
        return nanos
    raise TypeError(f"cannot interpret {type(dt)} as an instant")


# ---------------------------------------------------------------------------
# Java-compatible ZonedDateTime formatting (sidecar string contract)
# ---------------------------------------------------------------------------

_ZDT_RE = re.compile(
    r"^(\d{4,})-(\d{2})-(\d{2})T(\d{2}):(\d{2})"
    r"(?::(\d{2})(?:\.(\d{1,9}))?)?"
    r"(Z|[+-]\d{2}:\d{2}(?::\d{2})?)"
    r"(?:\[([^\]]+)\])?$"
)


def parse_zoned_datetime(s: str) -> tuple[int, str]:
    """Parse java.time ``ZonedDateTime.toString`` output.

    Returns (epoch_nanos, zone_id).  Zone falls back to the offset when no
    ``[Zone]`` suffix is present.  Keeps full nanosecond precision.
    """
    m = _ZDT_RE.match(s.strip())
    if not m:
        raise ValueError(f"cannot parse zoned date-time: {s!r}")
    year, month, day, hour, minute = (int(m.group(i)) for i in range(1, 6))
    second = int(m.group(6) or 0)
    frac = (m.group(7) or "").ljust(9, "0")
    nanos_frac = int(frac) if frac else 0
    offset_s = m.group(8)
    zone = m.group(9)
    offset = _parse_offset(offset_s)
    local = _dt.datetime(year, month, day, hour, minute, second,
                         tzinfo=_dt.timezone(offset))
    nanos = datetime_to_nanos(local) + nanos_frac
    if zone is None:
        total = int(offset.total_seconds())
        if total == 0:
            zone = "Z"
        else:
            sign_c = "+" if total >= 0 else "-"
            total = abs(total)
            zone = f"{sign_c}{total // 3600:02d}:{(total % 3600) // 60:02d}"
    return nanos, zone


def format_zoned_datetime(nanos: int, zone) -> str:
    """Format epoch-nanos as java.time ``ZonedDateTime.toString`` would.

    Trailing zero components are omitted (``T00:00`` not ``T00:00:00``);
    fractions print in 3/6/9 digit groups; offset 0 prints ``Z``; a named zone
    is appended as ``[Zone]``.
    """
    zone_str = str(zone)
    zi = zone_of(zone) if not _is_offset_zone(zone_str) else None
    if zi is not None:
        aware = nanos_to_datetime(nanos - (nanos % NANOS_PER_MICRO), zi)
        offset = aware.utcoffset()
    else:
        offset = _parse_offset(zone_str)
    off_total = int(offset.total_seconds())
    wall_nanos = nanos + off_total * NANOS_PER_SECOND
    days, day_nanos = divmod(wall_nanos, 86_400 * NANOS_PER_SECOND)
    date = _dt.date(1970, 1, 1) + _dt.timedelta(days=int(days))
    hour, rem = divmod(int(day_nanos), 3_600 * NANOS_PER_SECOND)
    minute, rem = divmod(rem, 60 * NANOS_PER_SECOND)
    second, nanos_frac = divmod(rem, NANOS_PER_SECOND)

    out = f"{date.year:04d}-{date.month:02d}-{date.day:02d}T{hour:02d}:{minute:02d}"
    if second or nanos_frac:
        out += f":{second:02d}"
        if nanos_frac:
            frac = f"{nanos_frac:09d}"
            for width in (3, 6, 9):
                if int(frac[width:] or 0) == 0:
                    out += "." + frac[:width]
                    break
    if off_total == 0:
        out += "Z"
    else:
        sign = "+" if off_total >= 0 else "-"
        a = abs(off_total)
        out += f"{sign}{a // 3600:02d}:{(a % 3600) // 60:02d}"
        if a % 60:
            out += f":{a % 60:02d}"
    if zi is not None and zone_str not in ("Z",):
        out += f"[{zone_str}]"
    return out


def _is_offset_zone(zone_str: str) -> bool:
    return zone_str == "Z" or bool(re.match(r"^[+-]\d{2}:\d{2}", zone_str))


def _parse_offset(zone_str: str) -> _dt.timedelta:
    if zone_str == "Z":
        return _dt.timedelta(0)
    sign = 1 if zone_str[0] == "+" else -1
    parts = zone_str[1:].split(":")
    return sign * _dt.timedelta(hours=int(parts[0]), minutes=int(parts[1]),
                                seconds=int(parts[2]) if len(parts) > 2 else 0)


# ---------------------------------------------------------------------------
# DateTimeIndex
# ---------------------------------------------------------------------------

class DateTimeIndex(ABC):
    """Bi-directional time <-> location map (ref ``DateTimeIndex.scala:40-156``)."""

    zone: str

    # -- size / bounds ------------------------------------------------------
    @property
    @abstractmethod
    def size(self) -> int: ...

    def __len__(self) -> int:
        return self.size

    @property
    @abstractmethod
    def first_nanos(self) -> int: ...

    @property
    @abstractmethod
    def last_nanos(self) -> int: ...

    @property
    def first(self) -> _dt.datetime:
        return nanos_to_datetime(self.first_nanos, self.zone)

    @property
    def last(self) -> _dt.datetime:
        return nanos_to_datetime(self.last_nanos, self.zone)

    # -- slicing ------------------------------------------------------------
    @abstractmethod
    def islice(self, start: int, end: int) -> "DateTimeIndex":
        """Position slice; exclusive end (ref ``DateTimeIndex.scala:61-69``)."""

    @abstractmethod
    def slice(self, start: DateTimeLike, end: DateTimeLike) -> "DateTimeIndex":
        """Time slice; inclusive both ends (ref ``DateTimeIndex.scala:45-55``)."""

    # -- lookups ------------------------------------------------------------
    @abstractmethod
    def datetime_at_loc(self, loc: int) -> _dt.datetime: ...

    @abstractmethod
    def nanos_at_loc(self, loc: int) -> int: ...

    @abstractmethod
    def loc_at_datetime(self, dt: DateTimeLike) -> int:
        """Location of the instant; -1 if absent (ref ``DateTimeIndex.scala:98-110``)."""

    @abstractmethod
    def loc_at_or_before(self, dt: DateTimeLike) -> int: ...

    @abstractmethod
    def loc_at_or_after(self, dt: DateTimeLike) -> int: ...

    @abstractmethod
    def insertion_loc(self, dt: DateTimeLike) -> int:
        """Location of the first instant strictly greater than ``dt``
        (ref ``DateTimeIndex.scala:124-139``)."""

    # -- vectorized lookups (TPU ingestion path) ----------------------------
    def locs_at(self, nanos: np.ndarray) -> np.ndarray:
        """Vectorized ``loc_at_datetime`` over an int64 nanos array; -1 where absent."""
        arr = self.to_nanos_array()
        pos = np.searchsorted(arr, nanos, side="left")
        pos_c = np.clip(pos, 0, arr.size - 1)
        return np.where((pos < arr.size) & (arr[pos_c] == nanos), pos, -1).astype(np.int64)

    def locs_at_or_before(self, nanos: np.ndarray) -> np.ndarray:
        """Vectorized location of the last instant ``<=`` each value; -1
        where every instant is later (unlike the scalar
        ``loc_at_or_before``'s clamped edge returns, callers see the
        out-of-range case explicitly)."""
        arr = self.to_nanos_array()
        return (np.searchsorted(arr, np.asarray(nanos, dtype=np.int64),
                                side="right") - 1).astype(np.int64)

    # -- materialization ----------------------------------------------------
    @abstractmethod
    def to_nanos_array(self) -> np.ndarray:
        """All instants as an int64 epoch-nanos array."""

    def to_datetime_array(self) -> List[_dt.datetime]:
        return [nanos_to_datetime(int(n), self.zone) for n in self.to_nanos_array()]

    def nanos_iterator(self) -> Iterable[int]:
        return iter(int(x) for x in self.to_nanos_array())

    # -- zone ---------------------------------------------------------------
    @abstractmethod
    def at_zone(self, zone) -> "DateTimeIndex": ...

    # -- serialization ------------------------------------------------------
    @abstractmethod
    def to_string(self) -> str:
        """Sidecar serialization (ref ``DateTimeIndex.scala:886-913`` contract)."""

    def __str__(self) -> str:
        return self.to_string()


class UniformDateTimeIndex(DateTimeIndex):
    """Start + periods + frequency; O(1) lookups via frequency arithmetic
    (ref ``DateTimeIndex.scala:162-306``)."""

    def __init__(self, start: DateTimeLike, periods: int, frequency: Frequency,
                 zone: Union[str, None] = None):
        self.start_nanos = to_nanos(start)
        self.periods = int(periods)
        if self.periods < 0:
            # otherwise the first touch is an obscure "__len__() should
            # return >= 0" far from the construction site
            raise ValueError(f"periods must be >= 0, got {self.periods}")
        self.frequency = frequency
        if zone is None and isinstance(start, _dt.datetime) and start.tzinfo is not None \
                and hasattr(start.tzinfo, "key"):
            zone = start.tzinfo.key  # type: ignore[attr-defined]
        self.zone = str(zone) if zone is not None else "Z"
        self._nanos_cache: np.ndarray | None = None

    # -- size / bounds ------------------------------------------------------
    @property
    def size(self) -> int:
        return self.periods

    @property
    def first_nanos(self) -> int:
        return self.start_nanos

    @property
    def last_nanos(self) -> int:
        return self.frequency.advance(self.start_nanos, self.periods - 1, self.zone)

    # -- slicing ------------------------------------------------------------
    def islice(self, start: int, end: int) -> "UniformDateTimeIndex":
        return UniformDateTimeIndex(
            self.frequency.advance(self.start_nanos, start, self.zone),
            end - start, self.frequency, self.zone)

    def slice(self, start: DateTimeLike, end: DateTimeLike) -> "UniformDateTimeIndex":
        s, e = to_nanos(start), to_nanos(end)
        periods = self.frequency.difference(s, e, self.zone) + 1
        return UniformDateTimeIndex(s, periods, self.frequency, self.zone)

    # -- lookups ------------------------------------------------------------
    def nanos_at_loc(self, loc: int) -> int:
        return self.frequency.advance(self.start_nanos, loc, self.zone)

    def datetime_at_loc(self, loc: int) -> _dt.datetime:
        return nanos_to_datetime(self.nanos_at_loc(loc), self.zone)

    def loc_at_datetime(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        loc = self.frequency.difference(self.start_nanos, nanos, self.zone)
        if 0 <= loc < self.size and self.nanos_at_loc(loc) == nanos:
            return loc
        return -1

    def loc_at_or_before(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        loc = self.frequency.difference(self.start_nanos, nanos, self.zone)
        if 0 <= loc < self.size:
            return loc - 1 if self.nanos_at_loc(loc) > nanos else loc
        return 0 if loc < 0 else self.size

    def loc_at_or_after(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        loc = self.frequency.difference(self.start_nanos, nanos, self.zone)
        if 0 <= loc < self.size:
            return loc + 1 if self.nanos_at_loc(loc) < nanos else loc
        return 0 if loc < 0 else self.size

    def insertion_loc(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        loc = self.frequency.difference(self.start_nanos, nanos, self.zone)
        if 0 <= loc < self.size:
            return loc + 1 if self.nanos_at_loc(loc) <= nanos else loc
        return 0 if loc < 0 else self.size

    def locs_at(self, nanos: np.ndarray) -> np.ndarray:
        nanos = np.asarray(nanos, dtype=np.int64)
        if isinstance(self.frequency, DurationFrequency):
            step = self.frequency.duration_nanos
            rel = nanos - np.int64(self.start_nanos)
            loc = rel // step
            ok = (rel % step == 0) & (loc >= 0) & (loc < self.size)
            return np.where(ok, loc, -1).astype(np.int64)
        return super().locs_at(nanos)

    # -- materialization ----------------------------------------------------
    def to_nanos_array(self) -> np.ndarray:
        if self._nanos_cache is None:
            if isinstance(self.frequency, DurationFrequency):
                self._nanos_cache = (
                    np.int64(self.start_nanos)
                    + np.arange(self.periods, dtype=np.int64)
                    * np.int64(self.frequency.duration_nanos))
            else:
                self._nanos_cache = self.frequency.advance_array(
                    self.start_nanos, np.arange(self.periods), self.zone)
        return self._nanos_cache

    # -- zone / serialization ----------------------------------------------
    def at_zone(self, zone) -> "UniformDateTimeIndex":
        return UniformDateTimeIndex(self.start_nanos, self.periods, self.frequency, str(zone))

    def to_string(self) -> str:
        return ",".join([
            "uniform", self.zone,
            format_zoned_datetime(self.start_nanos, self.zone),
            str(self.periods), str(self.frequency)])

    def __eq__(self, other):
        return isinstance(other, UniformDateTimeIndex) \
            and other.start_nanos == self.start_nanos \
            and other.periods == self.periods and other.frequency == self.frequency

    def __hash__(self):
        return hash((self.start_nanos, self.periods, self.frequency))

    def __repr__(self):
        return f"UniformDateTimeIndex({self.to_string()})"


class IrregularDateTimeIndex(DateTimeIndex):
    """Arbitrary sorted instants; O(log n) lookups by binary search
    (ref ``DateTimeIndex.scala:312-432``)."""

    def __init__(self, instants, zone: Union[str, None] = None):
        if isinstance(instants, np.ndarray) and instants.dtype == np.int64:
            self.instants = instants
        else:
            vals = [to_nanos(x) for x in instants]
            self.instants = np.asarray(vals, dtype=np.int64)
        if self.instants.size > 1 and np.any(np.diff(self.instants) < 0):
            # every lookup is a binary search (ref DateTimeIndex.scala:352-360)
            # — unsorted instants would return silently wrong locations
            raise ValueError(
                "irregular index instants must be in non-decreasing order")
        self.zone = str(zone) if zone is not None else "Z"

    @property
    def size(self) -> int:
        return int(self.instants.size)

    @property
    def first_nanos(self) -> int:
        return int(self.instants[0])

    @property
    def last_nanos(self) -> int:
        return int(self.instants[-1])

    def islice(self, start: int, end: int) -> "IrregularDateTimeIndex":
        return IrregularDateTimeIndex(self.instants[start:end], self.zone)

    def slice(self, start: DateTimeLike, end: DateTimeLike) -> "IrregularDateTimeIndex":
        s, e = to_nanos(start), to_nanos(end)
        lo = int(np.searchsorted(self.instants, s, side="left"))
        hi = int(np.searchsorted(self.instants, e, side="right"))
        return IrregularDateTimeIndex(self.instants[lo:hi], self.zone)

    def nanos_at_loc(self, loc: int) -> int:
        return int(self.instants[loc])

    def datetime_at_loc(self, loc: int) -> _dt.datetime:
        return nanos_to_datetime(self.nanos_at_loc(loc), self.zone)

    def loc_at_datetime(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        loc = int(np.searchsorted(self.instants, nanos, side="left"))
        if loc < self.size and self.instants[loc] == nanos:
            return loc
        return -1

    def loc_at_or_before(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        return int(np.searchsorted(self.instants, nanos, side="right")) - 1

    def loc_at_or_after(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        return int(np.searchsorted(self.instants, nanos, side="left"))

    def insertion_loc(self, dt: DateTimeLike) -> int:
        return int(np.searchsorted(self.instants, to_nanos(dt), side="right"))

    def to_nanos_array(self) -> np.ndarray:
        return self.instants

    def at_zone(self, zone) -> "IrregularDateTimeIndex":
        return IrregularDateTimeIndex(self.instants, str(zone))

    def to_string(self) -> str:
        stamps = ",".join(format_zoned_datetime(int(n), self.zone) for n in self.instants)
        return f"irregular,{self.zone},{stamps}"

    def __eq__(self, other):
        return isinstance(other, IrregularDateTimeIndex) \
            and np.array_equal(other.instants, self.instants)

    def __hash__(self):
        return hash(self.instants.tobytes())

    def __repr__(self):
        return f"IrregularDateTimeIndex(n={self.size}, zone={self.zone})"


class HybridDateTimeIndex(DateTimeIndex):
    """Sorted disjoint sub-indices with prefix-sum offsets
    (ref ``DateTimeIndex.scala:442-677``)."""

    def __init__(self, indices: Sequence[DateTimeIndex], zone: Union[str, None] = None):
        if not indices:
            raise ValueError("hybrid index needs at least one sub-index")
        self.indices = list(indices)
        self.size_on_left = np.concatenate(
            [[0], np.cumsum([ix.size for ix in self.indices])[:-1]]).astype(np.int64)
        self.zone = str(zone) if zone is not None else self.indices[0].zone
        self._firsts = np.asarray([ix.first_nanos for ix in self.indices], dtype=np.int64)
        self._lasts = np.asarray([ix.last_nanos for ix in self.indices], dtype=np.int64)

    @property
    def size(self) -> int:
        return int(self.size_on_left[-1] + self.indices[-1].size)

    @property
    def first_nanos(self) -> int:
        return self.indices[0].first_nanos

    @property
    def last_nanos(self) -> int:
        return self.indices[-1].last_nanos

    # -- sub-index location -------------------------------------------------
    def _sub_for_loc(self, loc: int) -> tuple[int, int]:
        i = int(np.searchsorted(self.size_on_left, loc, side="right")) - 1
        return i, loc - int(self.size_on_left[i])

    def _sub_for_time(self, nanos: int) -> int:
        """Index of the sub-index whose [first, last] may contain ``nanos``.

        Returns the last sub-index with first <= nanos (clipped to 0).
        """
        i = int(np.searchsorted(self._firsts, nanos, side="right")) - 1
        return max(i, 0)

    def islice(self, start: int, end: int) -> DateTimeIndex:
        si, soff = self._sub_for_loc(start)
        ei, eoff = self._sub_for_loc(end - 1)
        if si == ei:
            return self.indices[si].islice(soff, eoff + 1)
        parts: List[DateTimeIndex] = [self.indices[si].islice(soff, self.indices[si].size)]
        parts.extend(self.indices[si + 1:ei])
        parts.append(self.indices[ei].islice(0, eoff + 1))
        return HybridDateTimeIndex(parts, self.zone)

    def slice(self, start: DateTimeLike, end: DateTimeLike) -> DateTimeIndex:
        lo = self.loc_at_or_after(start)
        hi = self.loc_at_or_before(end)
        return self.islice(lo, hi + 1)

    def nanos_at_loc(self, loc: int) -> int:
        i, off = self._sub_for_loc(loc)
        return self.indices[i].nanos_at_loc(off)

    def datetime_at_loc(self, loc: int) -> _dt.datetime:
        return nanos_to_datetime(self.nanos_at_loc(loc), self.zone)

    def loc_at_datetime(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        i = self._sub_for_time(nanos)
        loc = self.indices[i].loc_at_datetime(nanos)
        return int(self.size_on_left[i]) + loc if loc >= 0 else -1

    def loc_at_or_before(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        i = self._sub_for_time(nanos)
        if nanos < self.indices[i].first_nanos:
            return -1
        if nanos > self.indices[i].last_nanos:
            return int(self.size_on_left[i]) + self.indices[i].size - 1
        return int(self.size_on_left[i]) + self.indices[i].loc_at_or_before(nanos)

    def loc_at_or_after(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        i = self._sub_for_time(nanos)
        if nanos > self.indices[i].last_nanos:
            if i + 1 < len(self.indices):
                return int(self.size_on_left[i + 1])
            return self.size
        if nanos < self.indices[i].first_nanos:
            return int(self.size_on_left[i])
        return int(self.size_on_left[i]) + self.indices[i].loc_at_or_after(nanos)

    def insertion_loc(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        i = self._sub_for_time(nanos)
        if nanos > self.indices[i].last_nanos:
            return int(self.size_on_left[i]) + self.indices[i].size
        if nanos < self.indices[i].first_nanos:
            return int(self.size_on_left[i])
        return int(self.size_on_left[i]) + self.indices[i].insertion_loc(nanos)

    def to_nanos_array(self) -> np.ndarray:
        return np.concatenate([ix.to_nanos_array() for ix in self.indices])

    def at_zone(self, zone) -> "HybridDateTimeIndex":
        return HybridDateTimeIndex([ix.at_zone(zone) for ix in self.indices], str(zone))

    def to_string(self) -> str:
        return f"hybrid,{self.zone}," + ";".join(ix.to_string() for ix in self.indices)

    def __eq__(self, other):
        return isinstance(other, HybridDateTimeIndex) and other.indices == self.indices

    def __hash__(self):
        return hash(tuple(self.indices))

    def __repr__(self):
        return f"HybridDateTimeIndex(n_sub={len(self.indices)}, size={self.size})"


# ---------------------------------------------------------------------------
# Factories (ref ``DateTimeIndex.scala:679-913``)
# ---------------------------------------------------------------------------

def uniform(start: DateTimeLike, periods: int, frequency: Frequency,
            zone: Union[str, None] = None) -> UniformDateTimeIndex:
    return UniformDateTimeIndex(start, periods, frequency, zone)


def uniform_from_interval(start: DateTimeLike, end: DateTimeLike, frequency: Frequency,
                          zone: Union[str, None] = None) -> UniformDateTimeIndex:
    z = zone if zone is not None else "Z"
    periods = frequency.difference(to_nanos(start), to_nanos(end), z) + 1
    return UniformDateTimeIndex(start, periods, frequency, zone)


def irregular(instants, zone: Union[str, None] = None) -> IrregularDateTimeIndex:
    return IrregularDateTimeIndex(instants, zone)


def hybrid(indices: Sequence[DateTimeIndex],
           zone: Union[str, None] = None) -> HybridDateTimeIndex:
    z = zone if zone is not None else indices[0].zone
    if any(ix.zone != z for ix in indices):
        raise ValueError("All indices should have the same zone")
    return HybridDateTimeIndex(indices, z)


def next_business_day(nanos: int, zone=None, first_day_of_week: int = 1) -> int:
    """First business day at or after the instant (ref ``DateTimeIndex.scala:858-869``)."""
    local = nanos_to_datetime(nanos, zone_of(zone))
    aligned = rebase_day_of_week(local.isoweekday(), first_day_of_week)
    if aligned == 6:
        shift = 2
    elif aligned == 7:
        shift = 1
    else:
        shift = 0
    wall = (local + _dt.timedelta(days=shift)).replace(tzinfo=None)
    return datetime_to_nanos(wall.replace(tzinfo=zone_of(zone)))


def from_string(s: str) -> DateTimeIndex:
    """Parse ``to_string`` output (sidecar contract, ref ``DateTimeIndex.scala:886-913``)."""
    kind, rest = s.split(",", 1)
    if kind == "uniform":
        zone, start_s, periods_s, freq_s = rest.split(",")
        start_nanos, _ = parse_zoned_datetime(start_s)
        return UniformDateTimeIndex(start_nanos, int(periods_s),
                                    frequency_from_string(freq_s), zone)
    if kind == "irregular":
        parts = rest.split(",")
        zone, stamps = parts[0], parts[1:]
        instants = [parse_zoned_datetime(t)[0] for t in stamps]
        return IrregularDateTimeIndex(instants, zone)
    if kind == "hybrid":
        zone, subs = rest.split(",", 1)
        indices = [from_string(sub) for sub in subs.split(";")]
        return HybridDateTimeIndex(indices, zone)
    raise ValueError(f"DateTimeIndex type {kind!r} not recognized")
