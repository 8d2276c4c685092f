"""Minimal 5-field cron matcher (minute hour dom month dow).

The port's own copy of ``karmada_tpu/utils/cron.py``.

Supports: ``*``, lists (``1,2,3``), ranges (``1-5``), steps (``*/15``,
``2-10/2``). Enough for the CronFederatedHPA rules the reference drives with
gocron.
"""

from __future__ import annotations

import time


def _parse_field(field: str, lo: int, hi: int) -> set[int]:
    out: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        else:
            start = end = int(part)
        out.update(range(start, end + 1, step))
    return out


def cron_matches(schedule: str, ts: float) -> bool:
    fields = schedule.split()
    if len(fields) != 5:
        raise ValueError(f"invalid cron schedule {schedule!r}")
    t = time.gmtime(ts)
    minute, hour, dom, month, dow = fields
    checks = (
        (minute, t.tm_min, 0, 59),
        (hour, t.tm_hour, 0, 23),
        (dom, t.tm_mday, 1, 31),
        (month, t.tm_mon, 1, 12),
        (dow, t.tm_wday + 1 if t.tm_wday < 6 else 0, 0, 6),  # 0=Sunday
    )
    for field, value, lo, hi in checks:
        if value not in _parse_field(field, lo, hi):
            return False
    return True
