"""Frequency hierarchy for uniform date-time indices.

Capability parity with the reference's ``Frequency.scala`` (see
``src/main/scala/com/cloudera/sparkts/Frequency.scala:29-189``):
a frequency knows how to ``advance`` an instant n steps and how to count the
number of whole steps between two instants (``difference``).

Design notes (TPU-first): all calendar logic is host-side and never enters a
jitted computation.  Instants are int64 epoch-nanoseconds (UTC).  Duration
frequencies (ms/us/s/min/h) are pure nanosecond arithmetic and vectorize over
numpy arrays; calendar frequencies (day/month/year/business-day) operate on
zone-local wall-clock fields via ``zoneinfo``, matching java.time semantics
(DST-aware calendar-day addition, day-of-month clamping for months/years,
weekday-skipping for business days).
"""

from __future__ import annotations

import datetime as _dt
from abc import ABC, abstractmethod
from typing import Union
from zoneinfo import ZoneInfo

import numpy as np

NANOS_PER_SECOND = 1_000_000_000
NANOS_PER_MICRO = 1_000
NANOS_PER_MILLI = 1_000_000
NANOS_PER_MINUTE = 60 * NANOS_PER_SECOND
NANOS_PER_HOUR = 60 * NANOS_PER_MINUTE
NANOS_PER_DAY = 24 * NANOS_PER_HOUR

Nanos = Union[int, np.int64]


def zone_of(zone: Union[str, ZoneInfo, None]) -> ZoneInfo:
    if zone is None or zone == "Z":
        return ZoneInfo("UTC")
    if isinstance(zone, ZoneInfo):
        return zone
    return ZoneInfo(zone)


def nanos_to_datetime(nanos: Nanos, zone: Union[str, ZoneInfo, None] = None) -> _dt.datetime:
    """Epoch-nanos (UTC) -> zone-aware datetime (microsecond precision floor)."""
    zi = zone_of(zone)
    secs, rem = divmod(int(nanos), NANOS_PER_SECOND)
    base = _dt.datetime.fromtimestamp(secs, tz=_dt.timezone.utc).astimezone(zi)
    return base + _dt.timedelta(microseconds=rem // NANOS_PER_MICRO)


def datetime_to_nanos(dt: _dt.datetime) -> int:
    """Zone-aware datetime -> epoch nanos. Naive datetimes are treated as UTC."""
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=_dt.timezone.utc)
    whole = dt.replace(microsecond=0)
    return int(whole.timestamp()) * NANOS_PER_SECOND + dt.microsecond * NANOS_PER_MICRO


def _local_wall(dt_nanos: int, zi: ZoneInfo) -> _dt.datetime:
    return nanos_to_datetime(dt_nanos, zi)


def _wall_to_nanos(local: _dt.datetime) -> int:
    """Interpret a zone-aware wall-clock datetime as an instant (fold=0 on gaps)."""
    return datetime_to_nanos(local)


def _is_utc(zi: ZoneInfo) -> bool:
    return getattr(zi, "key", None) in ("UTC", "Etc/UTC", "Z")


def _offsets_at_instants(ns: np.ndarray, zi: ZoneInfo) -> np.ndarray:
    """UTC offset (nanos) of zone ``zi`` at each *instant*, vectorized by
    resolving one offset per unique UTC hour (offsets are piecewise-constant
    with transitions on hour boundaries in practice; zones with sub-hour
    transition instants mis-resolve only inside that single hour)."""
    ns = np.asarray(ns, dtype=np.int64)
    if _is_utc(zi):
        return np.zeros(ns.shape, np.int64)
    hours, inverse = np.unique(ns // NANOS_PER_HOUR, return_inverse=True)
    offs = np.empty(hours.shape, np.int64)
    for i, h in enumerate(hours):
        dt = _dt.datetime.fromtimestamp(int(h) * 3600,
                                        tz=_dt.timezone.utc).astimezone(zi)
        offs[i] = int(dt.utcoffset().total_seconds()) * NANOS_PER_SECOND
    return offs[inverse].reshape(ns.shape)


def _offsets_at_walls(wall_ns: np.ndarray, zi: ZoneInfo) -> np.ndarray:
    """UTC offset (nanos) of zone ``zi`` at each *wall-clock* time (fold=0 on
    ambiguity/gaps, matching the scalar path), one lookup per unique hour."""
    wall_ns = np.asarray(wall_ns, dtype=np.int64)
    if _is_utc(zi):
        return np.zeros(wall_ns.shape, np.int64)
    hours, inverse = np.unique(wall_ns // NANOS_PER_HOUR, return_inverse=True)
    offs = np.empty(hours.shape, np.int64)
    for i, h in enumerate(hours):
        naive = _dt.datetime.fromtimestamp(int(h) * 3600,
                                           tz=_dt.timezone.utc)
        local = naive.replace(tzinfo=zi)
        offs[i] = int(local.utcoffset().total_seconds()) * NANOS_PER_SECOND
    return offs[inverse].reshape(wall_ns.shape)


class Frequency(ABC):
    """Abstract step used by uniform indices (ref ``Frequency.scala:29-39``)."""

    @abstractmethod
    def advance(self, nanos: Nanos, n: int, zone=None) -> int:
        """Advance instant ``nanos`` by this frequency ``n`` times."""

    @abstractmethod
    def difference(self, nanos1: Nanos, nanos2: Nanos, zone=None) -> int:
        """Whole number of steps from ``nanos1`` to ``nanos2``, rounded toward zero."""

    def advance_each(self, nanos: np.ndarray, steps, zone=None) -> np.ndarray:
        """Element-wise advance: instant ``nanos[i]`` moved ``steps[i]``
        (broadcastable) whole frequencies.  Subclasses override with numpy
        field-decomposition implementations; this fallback loops on host."""
        nanos = np.asarray(nanos, dtype=np.int64)
        steps_b = np.broadcast_to(np.asarray(steps, dtype=np.int64),
                                  nanos.shape)
        return np.asarray(
            [self.advance(int(t), int(k), zone)
             for t, k in zip(nanos.ravel(), steps_b.ravel())],
            dtype=np.int64).reshape(nanos.shape)

    def advance_array(self, nanos: Nanos, steps: np.ndarray, zone=None) -> np.ndarray:
        """Vectorized advance of one base instant over an int array of step
        counts (host-side)."""
        steps = np.asarray(steps, dtype=np.int64)
        return self.advance_each(
            np.broadcast_to(np.int64(nanos), steps.shape), steps, zone)

    # subclasses override __str__ to produce the save/load token (e.g. "days 1")


class DurationFrequency(Frequency):
    """Fixed-duration step: pure nanosecond arithmetic (ref ``Frequency.scala:41-62``)."""

    def __init__(self, duration_nanos: int):
        if duration_nanos <= 0:
            raise ValueError("duration must be positive")
        self.duration_nanos = int(duration_nanos)

    def advance(self, nanos, n, zone=None) -> int:
        return int(nanos) + self.duration_nanos * int(n)

    def difference(self, nanos1, nanos2, zone=None) -> int:
        return int((int(nanos2) - int(nanos1)) // self.duration_nanos) \
            if int(nanos2) >= int(nanos1) \
            else -int((int(nanos1) - int(nanos2)) // self.duration_nanos)

    def advance_array(self, nanos, steps, zone=None) -> np.ndarray:
        return np.int64(nanos) + np.asarray(steps, dtype=np.int64) * np.int64(self.duration_nanos)

    def advance_each(self, nanos, steps, zone=None) -> np.ndarray:
        return np.asarray(nanos, dtype=np.int64) \
            + np.asarray(steps, dtype=np.int64) * np.int64(self.duration_nanos)

    def __eq__(self, other):
        return isinstance(other, DurationFrequency) \
            and other.duration_nanos == self.duration_nanos

    def __hash__(self):
        return hash(self.duration_nanos)


class NanosecondFrequency(DurationFrequency):
    def __init__(self, ns: int):
        super().__init__(ns)
        self.ns = ns

    def __str__(self):
        return f"nanoseconds {self.ns}"


class MicrosecondFrequency(DurationFrequency):
    def __init__(self, us: int):
        super().__init__(us * NANOS_PER_MICRO)
        self.us = us

    def __str__(self):
        return f"microseconds {self.us}"


class MillisecondFrequency(DurationFrequency):
    def __init__(self, ms: int):
        super().__init__(ms * NANOS_PER_MILLI)
        self.ms = ms

    def __str__(self):
        return f"milliseconds {self.ms}"


class SecondFrequency(DurationFrequency):
    def __init__(self, seconds: int):
        super().__init__(seconds * NANOS_PER_SECOND)
        self.seconds = seconds

    def __str__(self):
        return f"seconds {self.seconds}"


class MinuteFrequency(DurationFrequency):
    def __init__(self, minutes: int):
        super().__init__(minutes * NANOS_PER_MINUTE)
        self.minutes = minutes

    def __str__(self):
        return f"minutes {self.minutes}"


class HourFrequency(DurationFrequency):
    def __init__(self, hours: int):
        super().__init__(hours * NANOS_PER_HOUR)
        self.hours = hours

    def __str__(self):
        return f"hours {self.hours}"


class PeriodFrequency(Frequency):
    """Calendar-period step, zone-local wall-clock arithmetic
    (ref ``Frequency.scala:64-123``)."""

    def __eq__(self, other):
        return type(other) is type(self) and other.__dict__ == self.__dict__

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(self.__dict__.items()))))


class DayFrequency(PeriodFrequency):
    """Calendar days: adding a day preserves local wall-clock time across DST."""

    def __init__(self, days: int):
        if days <= 0:
            raise ValueError("days must be positive")
        self.days = int(days)

    def advance(self, nanos, n, zone=None) -> int:
        zi = zone_of(zone)
        local = _local_wall(int(nanos), zi)
        shifted = local + _dt.timedelta(days=self.days * int(n))
        # re-resolve the zone offset at the new local date (calendar addition)
        wall = shifted.replace(tzinfo=None)
        return _wall_to_nanos(wall.replace(tzinfo=zi))

    def difference(self, nanos1, nanos2, zone=None) -> int:
        if int(nanos2) < int(nanos1):
            return -self.difference(nanos2, nanos1, zone)
        zi = zone_of(zone)
        d1, d2 = _local_wall(int(nanos1), zi), _local_wall(int(nanos2), zi)
        days = (d2.date() - d1.date()).days
        if d2.time() < d1.time():
            days -= 1
        return days // self.days

    def advance_each(self, nanos, steps, zone=None) -> np.ndarray:
        """Vectorized: calendar-day addition is uniform in *wall-clock*
        space, so shift into the zone's wall frame, add whole days, and
        re-resolve the offset at each landing wall time (preserves full
        nanosecond precision, like java.time)."""
        zi = zone_of(zone)
        nanos = np.asarray(nanos, dtype=np.int64)
        steps = np.asarray(steps, dtype=np.int64)
        wall = nanos + _offsets_at_instants(nanos, zi) \
            + steps * np.int64(self.days * NANOS_PER_DAY)
        return wall - _offsets_at_walls(wall, zi)

    def __str__(self):
        return f"days {self.days}"


class MonthFrequency(PeriodFrequency):
    """Calendar months with day-of-month clamping (java.time ``plusMonths``)."""

    def __init__(self, months: int):
        if months <= 0:
            raise ValueError("months must be positive")
        self.months = int(months)

    @staticmethod
    def _add_months(local: _dt.datetime, months: int) -> _dt.datetime:
        y = local.year + (local.month - 1 + months) // 12
        m = (local.month - 1 + months) % 12 + 1
        # clamp day to the last valid day of the target month
        if m == 12:
            last = 31
        else:
            last = (_dt.date(y, m + 1, 1) - _dt.timedelta(days=1)).day
        d = min(local.day, last)
        return local.replace(year=y, month=m, day=d)

    def advance(self, nanos, n, zone=None) -> int:
        zi = zone_of(zone)
        local = _local_wall(int(nanos), zi)
        shifted = self._add_months(local.replace(tzinfo=None), self.months * int(n))
        return _wall_to_nanos(shifted.replace(tzinfo=zi))

    def difference(self, nanos1, nanos2, zone=None) -> int:
        zi = zone_of(zone)
        d1, d2 = _local_wall(int(nanos1), zi), _local_wall(int(nanos2), zi)
        months = (d2.year - d1.year) * 12 + (d2.month - d1.month)
        # ChronoUnit.MONTHS on LocalDate: partial months don't count
        if months > 0 and d2.day < d1.day:
            months -= 1
        elif months < 0 and d2.day > d1.day:
            months += 1
        return int(months // self.months) if months >= 0 else -int((-months) // self.months)

    def advance_each(self, nanos, steps, zone=None) -> np.ndarray:
        """Vectorized month addition via numpy datetime64 field
        decomposition: split each wall time into (month index, day-of-month,
        time-of-day), add months, clamp the day to the target month's length
        (java.time ``plusMonths`` semantics), reassemble, re-resolve zone
        offsets."""
        zi = zone_of(zone)
        nanos = np.asarray(nanos, dtype=np.int64)
        steps = np.asarray(steps, dtype=np.int64)
        wall = nanos + _offsets_at_instants(nanos, zi)

        w64 = wall.astype("datetime64[ns]")
        m0 = w64.astype("datetime64[M]")
        day0 = (w64.astype("datetime64[D]") - m0.astype("datetime64[D]")
                ).astype(np.int64)                       # day-of-month - 1
        tod = wall - w64.astype("datetime64[D]").astype(
            "datetime64[ns]").astype(np.int64)
        m2 = m0 + (steps * np.int64(self.months)).astype("timedelta64[M]")
        mstart = m2.astype("datetime64[D]")
        dim = ((m2 + np.timedelta64(1, "M")).astype("datetime64[D]")
               - mstart).astype(np.int64)                # days in month
        day2 = np.minimum(day0, dim - 1)
        wall2 = mstart.astype("datetime64[ns]").astype(np.int64) \
            + day2 * np.int64(NANOS_PER_DAY) + tod
        return wall2 - _offsets_at_walls(wall2, zi)

    def __str__(self):
        return f"months {self.months}"


class YearFrequency(PeriodFrequency):
    def __init__(self, years: int):
        if years <= 0:
            raise ValueError("years must be positive")
        self.years = int(years)

    def advance(self, nanos, n, zone=None) -> int:
        return MonthFrequency(12).advance(nanos, self.years * int(n), zone)

    def difference(self, nanos1, nanos2, zone=None) -> int:
        months = MonthFrequency(1).difference(nanos1, nanos2, zone)
        years = months // 12 if months >= 0 else -((-months) // 12)
        return years // self.years if years >= 0 else -((-years) // self.years)

    def advance_each(self, nanos, steps, zone=None) -> np.ndarray:
        return MonthFrequency(12).advance_each(
            nanos, np.asarray(steps, dtype=np.int64) * self.years, zone)

    def __str__(self):
        return f"years {self.years}"


def rebase_day_of_week(iso_day_of_week: int, first_day_of_week: int = 1) -> int:
    """Re-index an ISO day-of-week (Mon=1..Sun=7) so ``first_day_of_week`` is 1.

    Semantics of ref ``DateTimeIndex.scala:848-853``.
    """
    return (iso_day_of_week - first_day_of_week + 7) % 7 + 1


class BusinessDayFrequency(Frequency):
    """Weekday-skipping day arithmetic (ref ``Frequency.scala:143-189``).

    ``first_day_of_week`` is an ISO weekday (Mon=1); the 6th and 7th days of the
    rebased week are the weekend.
    """

    def __init__(self, days: int, first_day_of_week: int = 1):
        if days <= 0:
            raise ValueError("days must be positive")
        self.days = int(days)
        self.first_day_of_week = int(first_day_of_week)

    def _aligned_dow(self, local: _dt.datetime) -> int:
        return rebase_day_of_week(local.isoweekday(), self.first_day_of_week)

    def advance(self, nanos, n, zone=None) -> int:
        zi = zone_of(zone)
        local = _local_wall(int(nanos), zi)
        aligned = self._aligned_dow(local)
        if aligned > 5:
            raise ValueError(f"{local} is not a business day")
        total_days = int(n) * self.days
        if total_days >= 0:
            weekend_days = (total_days // 5) * 2
            remaining = total_days % 5
            extra = 2 if aligned + remaining > 5 else 0
            shift = total_days + weekend_days + extra
        else:
            back = -total_days
            weekend_days = (back // 5) * 2
            remaining = back % 5
            extra = 2 if aligned - remaining < 1 else 0
            shift = -(back + weekend_days + extra)
        wall = (local + _dt.timedelta(days=shift)).replace(tzinfo=None)
        return _wall_to_nanos(wall.replace(tzinfo=zi))

    def difference(self, nanos1, nanos2, zone=None) -> int:
        if int(nanos2) < int(nanos1):
            return -self.difference(nanos2, nanos1, zone)
        zi = zone_of(zone)
        d1, d2 = _local_wall(int(nanos1), zi), _local_wall(int(nanos2), zi)
        days_between = (d2.date() - d1.date()).days
        if d2.time() < d1.time():
            days_between -= 1
        aligned1 = self._aligned_dow(d1)
        if aligned1 > 5:
            raise ValueError(f"{d1} is not a business day")
        weekend_days = (days_between // 7) * 2
        remaining = days_between % 7
        extra = 2 if aligned1 + remaining > 5 else 0
        return (days_between - weekend_days - extra) // self.days

    def advance_each(self, nanos, steps, zone=None) -> np.ndarray:
        """Vectorized weekday-skipping arithmetic: day-of-week comes from the
        wall day number (epoch day 0 = Thursday), the weekend-skip count is
        the same closed form as the scalar path, and zone offsets are
        re-resolved at the landing wall times."""
        zi = zone_of(zone)
        nanos = np.asarray(nanos, dtype=np.int64)
        steps = np.asarray(steps, dtype=np.int64)
        wall = nanos + _offsets_at_instants(nanos, zi)
        day = np.floor_divide(wall, NANOS_PER_DAY)
        iso = (day + 3) % 7 + 1                          # 1970-01-01 = Thu(4)
        aligned = (iso - self.first_day_of_week + 7) % 7 + 1
        if np.any(aligned > 5):
            bad = nanos[np.argmax(aligned > 5)]
            raise ValueError(
                f"{nanos_to_datetime(int(bad), zi)} is not a business day")
        total = steps * np.int64(self.days)
        mag = np.abs(total)
        weekend = (mag // 5) * 2
        remaining = mag % 5
        extra_f = np.where(aligned + remaining > 5, 2, 0)
        extra_b = np.where(aligned - remaining < 1, 2, 0)
        shift = np.where(total >= 0, total + weekend + extra_f,
                         -(mag + weekend + extra_b))
        wall2 = wall + shift * np.int64(NANOS_PER_DAY)
        return wall2 - _offsets_at_walls(wall2, zi)

    def __eq__(self, other):
        return isinstance(other, BusinessDayFrequency) and other.days == self.days \
            and other.first_day_of_week == self.first_day_of_week

    def __hash__(self):
        return hash((self.days, self.first_day_of_week))

    def __str__(self):
        return f"businessDays {self.days} firstDayOfWeek {self.first_day_of_week}"


_FREQ_PARSERS = {
    "nanoseconds": lambda t: NanosecondFrequency(int(t[1])),
    "microseconds": lambda t: MicrosecondFrequency(int(t[1])),
    "milliseconds": lambda t: MillisecondFrequency(int(t[1])),
    "seconds": lambda t: SecondFrequency(int(t[1])),
    "minutes": lambda t: MinuteFrequency(int(t[1])),
    "hours": lambda t: HourFrequency(int(t[1])),
    "days": lambda t: DayFrequency(int(t[1])),
    "months": lambda t: MonthFrequency(int(t[1])),
    "years": lambda t: YearFrequency(int(t[1])),
    "businessDays": lambda t: BusinessDayFrequency(
        int(t[1]), int(t[3]) if len(t) >= 4 else 1),
}


def frequency_from_string(s: str) -> Frequency:
    """Parse the token emitted by ``str(freq)`` (save/load sidecar contract,
    ref ``DateTimeIndex.scala:886-913``)."""
    tokens = s.strip().split(" ")
    try:
        return _FREQ_PARSERS[tokens[0]](tokens)
    except KeyError:
        raise ValueError(f"Frequency {tokens[0]!r} not recognized") from None
