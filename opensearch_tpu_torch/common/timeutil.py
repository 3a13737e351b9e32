"""Time-value parsing (the reference's TimeValue.parseTimeValue analog,
libs/core/src/main/java/org/opensearch/core/common/unit/TimeValue.java)
plus the injectable clock every sim-run module must read time through.

Production code calls :func:`epoch_millis` / :func:`monotonic_millis`
instead of ``time.time()`` / ``time.monotonic()`` directly; the
deterministic simulation (testing/sim.py) installs a virtual-time clock
via :func:`set_clock` / :func:`clock_scope` so replayable scenarios
control every timestamp. tpulint rule TPU004 enforces this in cluster/,
transport/, and index/recovery.py.
"""

from __future__ import annotations

import contextlib
import re
import time as _time
from typing import Any, Iterator

from opensearch_tpu_torch.common.errors import IllegalArgumentException


class Clock:
    """Time source. The default reads the host clocks; the sim swaps in a
    virtual-time implementation (DeterministicTaskQueue.clock())."""

    def epoch_millis(self) -> int:
        """Wall-clock epoch milliseconds (timestamps in API responses)."""
        return int(_time.time() * 1000)

    def monotonic_millis(self) -> int:
        """Monotonic milliseconds (durations, timeouts, "took" timers)."""
        return int(_time.monotonic() * 1000)


_SYSTEM_CLOCK = Clock()
_clock: Clock = _SYSTEM_CLOCK


def get_clock() -> Clock:
    return _clock


def set_clock(clock: Clock | None) -> Clock:
    """Install `clock` (None restores the system clock); returns the
    previously active clock so callers can restore it."""
    global _clock
    previous = _clock
    _clock = clock if clock is not None else _SYSTEM_CLOCK
    return previous


@contextlib.contextmanager
def clock_scope(clock: Clock) -> Iterator[Clock]:
    """``with clock_scope(queue.clock()):`` — virtual time for a block."""
    previous = set_clock(clock)
    try:
        yield clock
    finally:
        set_clock(previous)


def epoch_millis() -> int:
    return _clock.epoch_millis()


def monotonic_millis() -> int:
    return _clock.monotonic_millis()

_UNITS_MS = {
    "nanos": 1e-6, "micros": 1e-3, "ms": 1, "s": 1000, "m": 60_000,
    "h": 3_600_000, "d": 86_400_000, "w": 604_800_000,
}


def parse_time_value_millis(
    value: Any, name: str = "time", positive: bool = False
) -> int:
    """'30s' / '1m' / '100ms' / bare int (millis) -> milliseconds."""
    if isinstance(value, (int, float)):
        out = int(value)
    else:
        s = str(value).strip()
        m = re.fullmatch(r"(-?\d+(?:\.\d+)?)\s*(nanos|micros|ms|s|m|h|d|w)", s)
        if not m:
            raise IllegalArgumentException(
                f"failed to parse setting [{name}] with value [{value}] as a time value"
            )
        out = int(float(m.group(1)) * _UNITS_MS[m.group(2)])
    if positive and out <= 0:
        raise IllegalArgumentException(
            f"[{name}] must be positive, got [{value}]"
        )
    return out


def now_millis() -> int:
    return _clock.monotonic_millis()


# --------------------------------------------------------------------------
# Date math ("now-1d/d", "2024-01-01||+1M/d") — the analog of the
# reference's JavaDateMathParser (server/.../common/time/DateMathParser).
# --------------------------------------------------------------------------

_MATH_TOKEN = re.compile(r"([+\-/])(\d*)([yMwdhHms])?")


def _apply_unit(dt, n: int, unit: str):
    import datetime as _dt

    if unit == "y":
        import calendar

        year = dt.year + n
        day = min(dt.day, calendar.monthrange(year, dt.month)[1])
        return dt.replace(year=year, day=day)
    if unit == "M":
        month0 = dt.month - 1 + n
        year = dt.year + month0 // 12
        month = month0 % 12 + 1
        import calendar

        day = min(dt.day, calendar.monthrange(year, month)[1])
        return dt.replace(year=year, month=month, day=day)
    secs = {"w": 604800, "d": 86400, "h": 3600, "H": 3600, "m": 60, "s": 1}[unit]
    return dt + _dt.timedelta(seconds=n * secs)


def _round_down(dt, unit: str):
    if unit == "y":
        return dt.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "M":
        return dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if unit == "w":
        import datetime as _dt

        start = dt - _dt.timedelta(days=dt.weekday())
        return start.replace(hour=0, minute=0, second=0, microsecond=0)
    if unit == "d":
        return dt.replace(hour=0, minute=0, second=0, microsecond=0)
    if unit in ("h", "H"):
        return dt.replace(minute=0, second=0, microsecond=0)
    if unit == "m":
        return dt.replace(second=0, microsecond=0)
    return dt.replace(microsecond=0)


def parse_date_math(expr: Any, now_ms: int | None = None, round_up: bool = False) -> int:
    """Resolve a date-math expression to epoch millis.

    Anchors: ``now`` or ``<date>||``; ops: ``+N<unit>``, ``-N<unit>``,
    ``/<unit>`` (round down; round *up* to the last millisecond of the unit
    when `round_up` — the reference uses round_up for range upper bounds).
    """
    import datetime as _dt

    if isinstance(expr, (int, float)) and not isinstance(expr, bool):
        return int(expr)
    s = str(expr).strip()
    if s.startswith("now"):
        base_ms = epoch_millis() if now_ms is None else now_ms
        math = s[3:]
    elif "||" in s:
        anchor, _, math = s.partition("||")
        from opensearch_tpu_torch.index.mapper import parse_date_millis

        base_ms = parse_date_millis(anchor)
    else:
        from opensearch_tpu_torch.index.mapper import parse_date_millis

        return parse_date_millis(s)
    dt = _dt.datetime.fromtimestamp(base_ms / 1000, _dt.timezone.utc)
    pos = 0
    while pos < len(math):
        m = _MATH_TOKEN.match(math, pos)
        if not m:
            raise IllegalArgumentException(f"invalid date math [{expr}]")
        op, num, unit = m.group(1), m.group(2), m.group(3)
        if op == "/":
            if unit is None:
                raise IllegalArgumentException(f"invalid date math [{expr}]")
            dt = _round_down(dt, unit)
            if round_up:
                dt = _apply_unit(dt, 1, unit) - _dt.timedelta(milliseconds=1)
        else:
            if unit is None:
                raise IllegalArgumentException(f"invalid date math [{expr}]")
            n = int(num) if num else 1
            dt = _apply_unit(dt, n if op == "+" else -n, unit)
        pos = m.end()
    return int(dt.timestamp() * 1000)
