"""Calendar / model-time arithmetic.

Port of isca_tpu/utils/time_manager.py, unchanged: plain Python.

Reference: src/shared/time_manager/time_manager.F90 (exact integer (days,
seconds) time type; THIRTY_DAY_MONTHS, JULIAN, NOLEAP, GREGORIAN, NO_CALENDAR
calendars). Implemented as exact integer-second arithmetic on plain ints
(host side only; device code receives seconds as a float).
"""

from __future__ import annotations

import dataclasses

_DAYS_PER_MONTH_NOLEAP = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


@dataclasses.dataclass(frozen=True)
class ModelTime:
    """Exact model time: integer seconds since the calendar epoch (year 1)."""

    seconds: int
    calendar: str = "thirty_day_months"   # | noleap | julian | no_calendar

    # -- calendar helpers ------------------------------------------------
    @property
    def days(self) -> int:
        return self.seconds // 86400

    @property
    def seconds_of_day(self) -> int:
        return self.seconds % 86400

    def year_length_seconds(self) -> int:
        if self.calendar == "thirty_day_months":
            return 360 * 86400
        if self.calendar == "noleap":
            return 365 * 86400
        if self.calendar == "julian":
            return int(365.25 * 86400)
        return 360 * 86400  # no_calendar: nominal

    def __add__(self, dt_seconds: int) -> "ModelTime":
        return ModelTime(self.seconds + int(dt_seconds), self.calendar)

    def __sub__(self, other) -> int:
        if isinstance(other, ModelTime):
            return self.seconds - other.seconds
        return NotImplemented

    def date(self) -> tuple[int, int, int, int, int, int]:
        """(year, month, day, hour, minute, second), 1-based like the reference."""
        d = self.days
        sod = self.seconds_of_day
        hh, rem = divmod(sod, 3600)
        mm, ss = divmod(rem, 60)
        if self.calendar in ("thirty_day_months", "no_calendar"):
            year, rem_d = divmod(d, 360)
            month, day = divmod(rem_d, 30)
            return (year + 1, month + 1, day + 1, hh, mm, ss)
        if self.calendar == "noleap":
            year, rem_d = divmod(d, 365)
            month = 0
            while rem_d >= _DAYS_PER_MONTH_NOLEAP[month]:
                rem_d -= _DAYS_PER_MONTH_NOLEAP[month]
                month += 1
            return (year + 1, month + 1, rem_d + 1, hh, mm, ss)
        # julian: treat as noleap with a Feb 29 every 4th year
        year = 0
        while True:
            ylen = 366 if (year + 1) % 4 == 0 else 365
            if d < ylen:
                break
            d -= ylen
            year += 1
        months = list(_DAYS_PER_MONTH_NOLEAP)
        if (year + 1) % 4 == 0:
            months[1] = 29
        month = 0
        while d >= months[month]:
            d -= months[month]
            month += 1
        return (year + 1, month + 1, d + 1, hh, mm, ss)

    @staticmethod
    def from_date(year=1, month=1, day=1, hour=0, minute=0, second=0,
                  calendar="thirty_day_months") -> "ModelTime":
        if calendar in ("thirty_day_months", "no_calendar"):
            d = (year - 1) * 360 + (month - 1) * 30 + (day - 1)
        elif calendar == "noleap":
            d = (year - 1) * 365 + sum(_DAYS_PER_MONTH_NOLEAP[: month - 1]) + (day - 1)
        elif calendar == "julian":
            d = 0
            for y in range(1, year):
                d += 366 if y % 4 == 0 else 365
            months = list(_DAYS_PER_MONTH_NOLEAP)
            if year % 4 == 0:
                months[1] = 29
            d += sum(months[: month - 1]) + (day - 1)
        else:
            raise ValueError(calendar)
        return ModelTime(d * 86400 + hour * 3600 + minute * 60 + second, calendar)

    def fraction_of_year(self) -> float:
        return (self.seconds % self.year_length_seconds()) / self.year_length_seconds()

    def fraction_of_day(self) -> float:
        return self.seconds_of_day / 86400.0
