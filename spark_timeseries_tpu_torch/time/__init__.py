"""Time & index core (L0): frequencies, date-time indices, union, rebase.

Host-side calendar logic; only resolved integer locations enter jitted code.
"""

from .frequency import (
    BusinessDayFrequency,
    DayFrequency,
    DurationFrequency,
    Frequency,
    HourFrequency,
    MicrosecondFrequency,
    MillisecondFrequency,
    MinuteFrequency,
    MonthFrequency,
    NanosecondFrequency,
    PeriodFrequency,
    SecondFrequency,
    YearFrequency,
    datetime_to_nanos,
    frequency_from_string,
    nanos_to_datetime,
    rebase_day_of_week,
)
from .index import (
    DateTimeIndex,
    HybridDateTimeIndex,
    IrregularDateTimeIndex,
    UniformDateTimeIndex,
    format_zoned_datetime,
    from_string,
    hybrid,
    irregular,
    next_business_day,
    parse_zoned_datetime,
    to_nanos,
    uniform,
    uniform_from_interval,
)
from .rebase import Rebaser, rebase, rebaser
from .union import simplify, union

__all__ = [
    "BusinessDayFrequency", "DayFrequency", "DurationFrequency", "Frequency",
    "HourFrequency", "MicrosecondFrequency", "MillisecondFrequency",
    "MinuteFrequency", "MonthFrequency", "NanosecondFrequency",
    "PeriodFrequency", "SecondFrequency", "YearFrequency",
    "datetime_to_nanos", "frequency_from_string", "nanos_to_datetime",
    "rebase_day_of_week",
    "DateTimeIndex", "HybridDateTimeIndex", "IrregularDateTimeIndex",
    "UniformDateTimeIndex", "format_zoned_datetime", "from_string", "hybrid",
    "irregular", "next_business_day", "parse_zoned_datetime", "to_nanos",
    "uniform", "uniform_from_interval",
    "Rebaser", "rebase", "rebaser", "simplify", "union",
]
