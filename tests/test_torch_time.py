"""The port's copy of the time core against the JAX package's ``time/``.

Both are numpy and ``zoneinfo`` code; the copy must compute the same
int64 instants and emit the same sidecar strings, so every comparison is
exact: ``advance`` / ``difference`` / ``advance_each`` for every
frequency in UTC and in named zones across DST changes,
``to_string()`` / ``from_string()`` across the packages in both
directions, ``rebase`` and ``union``.
"""

import datetime as dt
from zoneinfo import ZoneInfo

import numpy as np
import pytest

from spark_timeseries_tpu import time as jtime
from spark_timeseries_tpu_torch import time as ttime

ZONES = ("Z", "America/New_York", "Europe/London", "Asia/Kolkata")

# (class name, constructor arguments)
FREQUENCIES = [
    ("NanosecondFrequency", (7,)), ("MicrosecondFrequency", (3,)),
    ("MillisecondFrequency", (250,)), ("SecondFrequency", (45,)),
    ("MinuteFrequency", (15,)), ("HourFrequency", (1,)),
    ("HourFrequency", (5,)), ("DayFrequency", (1,)), ("DayFrequency", (3,)),
    ("MonthFrequency", (1,)), ("MonthFrequency", (5,)),
    ("YearFrequency", (1,)), ("BusinessDayFrequency", (1,)),
    ("BusinessDayFrequency", (3, 3)),
]


def _instants(zone):
    """Instants around the 2021 DST changes of the US and UK, month ends
    and a leap day, at local midnight and at 01:30 (inside the spring
    gap / the autumn fold), plus seeded random instants."""
    zi = dt.timezone.utc if zone == "Z" else ZoneInfo(zone)
    walls = [(2021, 3, 14, 1, 30), (2021, 3, 14, 3, 0), (2021, 3, 28, 1, 30),
             (2021, 11, 7, 1, 30), (2021, 10, 31, 1, 30), (2020, 1, 31, 0, 0),
             (2020, 2, 29, 12, 0), (2019, 12, 31, 23, 59), (2021, 3, 13, 0, 0)]
    out = [jtime.datetime_to_nanos(dt.datetime(*w, tzinfo=zi))
           for w in walls]
    rng = np.random.default_rng(3)
    base = jtime.datetime_to_nanos(dt.datetime(2020, 1, 1, tzinfo=zi))
    out += [int(v) for v in base + rng.integers(0, 2 * 365 * 86400,
                                                 size=12) * 10 ** 9]
    return np.asarray(out, dtype=np.int64)


@pytest.mark.parametrize("zone", ZONES)
@pytest.mark.parametrize("name,args", FREQUENCIES)
def test_frequency_arithmetic_matches_jax(name, args, zone):
    jf = getattr(jtime, name)(*args)
    tf = getattr(ttime, name)(*args)
    assert str(tf) == str(jf)
    assert str(ttime.frequency_from_string(str(jf))) == str(jf)
    nanos = _instants(zone)
    if name == "BusinessDayFrequency":
        # a business-day step starts on a business day: both refuse others
        for f in (jf, tf):
            with pytest.raises(ValueError, match="not a business day"):
                f.advance_each(nanos, 1, zone)
        nanos = np.array([jtime.next_business_day(int(t), zone, *args[1:])
                          for t in nanos], dtype=np.int64)
    steps = np.array([-3, -1, 0, 1, 2, 7, 13] * 3)[:nanos.size]
    np.testing.assert_array_equal(tf.advance_each(nanos, steps, zone),
                                  jf.advance_each(nanos, steps, zone))
    np.testing.assert_array_equal(tf.advance_array(nanos[0], steps, zone),
                                  jf.advance_array(nanos[0], steps, zone))
    for a in nanos[:8]:
        for k in (-2, 1, 5):
            assert tf.advance(int(a), k, zone) == jf.advance(int(a), k, zone)
        for b in nanos[8:16]:
            assert tf.difference(int(a), int(b), zone) \
                == jf.difference(int(a), int(b), zone)


def _index_pairs():
    """The same indices built by both packages."""
    out = []
    stamps = np.sort(_instants("Z"))
    for pkg in (jtime, ttime):
        u = pkg.uniform("2021-03-10T00:00-05:00[America/New_York]", 12,
                        pkg.DayFrequency(1), "America/New_York")
        b = pkg.uniform("2020-01-01T00:00Z", 30, pkg.BusinessDayFrequency(1))
        m = pkg.uniform("2020-01-31T00:00Z", 14, pkg.MonthFrequency(1))
        h = pkg.uniform("2021-10-30T22:00+01:00[Europe/London]", 10,
                        pkg.HourFrequency(1), "Europe/London")
        irr = pkg.irregular(stamps[:9], "Z")
        hyb = pkg.hybrid([pkg.uniform("2020-01-01T00:00Z", 5,
                                      pkg.DayFrequency(1)),
                          pkg.irregular(stamps[12:17], "Z")])
        out.append([u, b, m, h, irr, hyb])
    return list(zip(*out))


@pytest.mark.parametrize("case", range(6))
def test_index_strings_interchange(case):
    jix, tix = _index_pairs()[case]
    s = jix.to_string()
    assert tix.to_string() == s
    np.testing.assert_array_equal(tix.to_nanos_array(), jix.to_nanos_array())
    # a JAX sidecar read by the port, and the port's read by the JAX package
    back_t = ttime.from_string(s)
    back_j = jtime.from_string(tix.to_string())
    assert type(back_t).__name__ == type(jix).__name__
    assert back_t.to_string() == s == back_j.to_string()
    np.testing.assert_array_equal(back_t.to_nanos_array(),
                                  jix.to_nanos_array())
    probe = jix.to_nanos_array()[::2] + 1
    np.testing.assert_array_equal(tix.locs_at(probe), jix.locs_at(probe))
    np.testing.assert_array_equal(tix.locs_at_or_before(probe),
                                  jix.locs_at_or_before(probe))
    assert tix.islice(1, 4).to_string() == jix.islice(1, 4).to_string()


def test_rebase_and_union_match_jax():
    rng = np.random.default_rng(5)
    pairs = _index_pairs()
    for (js, ts), (jt, tt) in [(pairs[1], pairs[4]), (pairs[0], pairs[0]),
                               (pairs[4], pairs[5]), (pairs[2], pairs[1])]:
        vals = rng.normal(size=(3, len(js)))
        np.testing.assert_array_equal(
            ttime.rebase(ts, tt, vals, -1.0),
            jtime.rebase(js, jt, vals, -1.0))
        np.testing.assert_array_equal(ttime.rebaser(ts, tt).index_mapping,
                                      jtime.rebaser(js, jt).index_mapping)
    # an in-phase uniform pair (the O(1) mapping) and a shifted one
    for start in ("2020-01-03T00:00Z", "2020-01-03T12:00Z"):
        src = [pkg.uniform("2020-01-01T00:00Z", 20, pkg.DayFrequency(1))
               for pkg in (jtime, ttime)]
        dst = [pkg.uniform(start, 25, pkg.DayFrequency(1))
               for pkg in (jtime, ttime)]
        vals = rng.normal(size=20)
        np.testing.assert_array_equal(
            ttime.rebase(src[1], dst[1], vals),
            jtime.rebase(src[0], dst[0], vals))
    for group in ([0, 0], [1, 4], [4, 5, 1], [2, 1, 4]):
        j = jtime.union([pairs[i][0] for i in group], "Z")
        t = ttime.union([pairs[i][1] for i in group], "Z")
        assert t.to_string() == j.to_string()
        np.testing.assert_array_equal(t.to_nanos_array(), j.to_nanos_array())
    j = jtime.simplify([pairs[i][0] for i in (4, 5, 1)])
    t = ttime.simplify([pairs[i][1] for i in (4, 5, 1)])
    assert [x.to_string() for x in t] == [x.to_string() for x in j]
