"""Temporal kernels: date_part extraction (arrow-arith/src/temporal.rs:44,146).

The reference leans on chrono per element; here extraction is branch-free
civil-calendar arithmetic on the VPU (Howard Hinnant's days-from-civil
inverse algorithm, the standard O(1) date decomposition), so year/month/day
run at elementwise bandwidth on device — no host round trip.

Timezone-aware extraction (arrow-array/src/timezone.rs role): fixed
offsets parse directly; IANA zones load their TZif transition tables
from the host tzdata once (cached), upload as two small tensors, and the
per-element UTC offset is one device searchsorted — extraction stays
branch-free over DST transitions.
"""

from __future__ import annotations

import functools
import struct as _struct

import jax
import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..core.column import PrimitiveColumn
from ..errors import ArrowTypeError

__all__ = ["date_part", "year", "month", "day", "hour", "minute", "second",
           "millisecond", "microsecond", "nanosecond", "day_of_week",
           "day_of_year", "quarter", "week", "iso_week", "iso_year",
           "add_interval", "sub_interval"]

_UNIT_NS = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}


# ---- timezone support --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tzif_table(name: str):
    """Parse the TZif file for an IANA zone -> (transition seconds i64,
    utc offsets seconds i64), both numpy.  Uses the v2+ 64-bit block."""
    import os
    base = "/usr/share/zoneinfo"
    path = os.path.join(base, *name.split("/"))
    if not os.path.realpath(path).startswith(os.path.realpath(base)):
        raise ArrowTypeError(f"bad timezone name {name!r}")
    with open(path, "rb") as f:
        data = f.read()

    def parse_block(off, wide):
        if data[off:off + 4] != b"TZif":
            raise ArrowTypeError(f"{name}: not a TZif file")
        version = data[off + 4:off + 5]
        (isutcnt, isstdcnt, leapcnt, timecnt, typecnt,
         charcnt) = _struct.unpack_from(">6I", data, off + 20)
        p = off + 44
        tsize = 8 if wide else 4
        fmt = ">%d%s" % (timecnt, "q" if wide else "i")
        times = np.array(_struct.unpack_from(fmt, data, p), np.int64)
        p += timecnt * tsize
        idxs = np.frombuffer(data, np.uint8, timecnt, p)
        p += timecnt
        offs = np.zeros(typecnt, np.int64)
        for t in range(typecnt):
            utoff = _struct.unpack_from(">i", data, p + 6 * t)[0]
            offs[t] = utoff
        p += 6 * typecnt + charcnt
        p += leapcnt * (tsize + 4) + isstdcnt + isutcnt
        return version, times, idxs, offs, p

    version, times, idxs, offs, end = parse_block(0, wide=False)
    footer_end = end
    if version >= b"2":
        version, times, idxs, offs, footer_end = parse_block(end,
                                                             wide=True)
    # v2+ footer POSIX TZ rule: governs instants past the last stored
    # transition (slim tzdata ships few transitions; fat ends ~2037)
    tzstr = ""
    if footer_end < len(data) and data[footer_end:footer_end + 1] == b"\n":
        nl = data.find(b"\n", footer_end + 1)
        tzstr = data[footer_end + 1:nl if nl > 0 else len(data)] \
            .decode("ascii", "ignore")
    if len(times) == 0:
        return (np.array([-(1 << 62)], np.int64),
                np.array([offs[0] if len(offs) else 0], np.int64))
    # offset BEFORE the first transition: the first non-DST type (or 0)
    trans_offs = offs[idxs]
    first = offs[0]
    ft, fo = _posix_rule_transitions(tzstr, int(times[-1]))
    if ft:
        times = np.concatenate([times, np.asarray(ft, np.int64)])
        trans_offs = np.concatenate([trans_offs,
                                     np.asarray(fo, np.int64)])
    return (np.concatenate([[-(1 << 62)], times]).astype(np.int64),
            np.concatenate([[first], trans_offs]).astype(np.int64))


def _posix_rule_transitions(tz: str, after: int):
    """Expand a POSIX TZ footer rule ('EST5EDT,M3.2.0,M11.1.0') into
    explicit (utc_second, offset) transitions for years after `after`,
    through 2120 (the chrono-tz role for post-table instants)."""
    import datetime
    import re
    name = r"(?:<[^>]+>|[A-Za-z]+)"
    off = r"[+-]?\d+(?::\d+(?::\d+)?)?"
    m = re.match(rf"^({name})({off})(({name})({off})?)?(?:,(.+),(.+))?$",
                 tz)
    if not m or not m.group(3) or not m.group(6):
        return [], []                 # constant offset: table suffices

    def secs(s):
        sign = -1 if s.startswith("-") else 1
        parts = [int(x) for x in s.lstrip("+-").split(":")]
        while len(parts) < 3:
            parts.append(0)
        return sign * (parts[0] * 3600 + parts[1] * 60 + parts[2])

    std_off = -secs(m.group(2))       # POSIX offsets are west-positive
    dst_off = -secs(m.group(5)) if m.group(5) else std_off + 3600

    def parse_rule(s):
        t = 2 * 3600
        if "/" in s:
            s, tp = s.split("/", 1)
            t = secs(tp)
        mo, wk, wd = (int(x) for x in s[1:].split("."))
        if not s.startswith("M"):
            raise ArrowNotImplementedError(f"TZ rule {s!r}")
        return mo, wk, wd, t

    try:
        r_start = parse_rule(m.group(6))
        r_end = parse_rule(m.group(7))
    except (ValueError, ArrowNotImplementedError):
        return [], []                 # Jn/n rules: rare, skip footer

    def m_date(year, mo, wk, wd):
        if wk == 5:                   # last wd of the month
            nxt = datetime.date(year + (mo == 12), mo % 12 + 1, 1)
            d = nxt - datetime.timedelta(days=1)
            return d - datetime.timedelta(
                days=((d.weekday() + 1) % 7 - wd) % 7)
        d = datetime.date(year, mo, 1)
        dow = (d.weekday() + 1) % 7   # 0=Sunday per POSIX
        d += datetime.timedelta(days=(wd - dow) % 7 + 7 * (wk - 1))
        return d

    epoch = datetime.date(1970, 1, 1)
    y0 = (datetime.date(1970, 1, 1)
          + datetime.timedelta(seconds=after // 86400 * 86400)).year
    out_t, out_o = [], []
    for y in range(max(y0, 1971), 2121):
        mo, wk, wd, t = r_start     # DST begins (time is in std time)
        st = (m_date(y, mo, wk, wd) - epoch).days * 86400 + t - std_off
        mo, wk, wd, t = r_end       # DST ends (time is in dst time)
        en = (m_date(y, mo, wk, wd) - epoch).days * 86400 + t - dst_off
        for sec, o in sorted([(st, dst_off), (en, std_off)]):
            if sec > after:
                out_t.append(sec)
                out_o.append(o)
    return out_t, out_o


def _parse_fixed_offset(tz: str):
    """'+HH:MM' / '-HH:MM' / 'UTC' / 'GMT' -> offset seconds or None."""
    if tz in ("UTC", "GMT", "utc", "Z", "+00:00", "-00:00"):
        return 0
    if len(tz) >= 3 and tz[0] in "+-" and tz[1:3].isdigit():
        sign = 1 if tz[0] == "+" else -1
        hh = int(tz[1:3])
        mm = int(tz[4:6]) if len(tz) >= 6 else 0
        return sign * (hh * 3600 + mm * 60)
    return None


def _tz_tables(tz: str):
    """-> (transitions i64 tensor, offsets i64 tensor) for any tz spec
    (fixed offsets become a single-entry table)."""
    fixed = _parse_fixed_offset(tz)
    if fixed is not None:
        import numpy as _np
        return (jnp.asarray(_np.array([-(1 << 62)], _np.int64)),
                jnp.asarray(_np.array([fixed], _np.int64)))
    trans, offs = _tzif_table(tz)
    return jnp.asarray(trans), jnp.asarray(offs)


def _epoch_days_and_time_ns_traced(v, trans, offs, dname, unit):
    """(days since epoch, intra-day nanoseconds) from raw int64 values —
    floor semantics for pre-epoch instants.  Traced (jit-safe); tz
    transition tables arrive as tensors."""
    if dname == "date32":
        return v, jnp.zeros_like(v)
    if dname == "date64":
        days = jnp.floor_divide(v, 86_400_000)
        rem = v - days * 86_400_000
        return days, rem * 1_000_000
    if dname == "timestamp":
        scale = _UNIT_NS[unit]
        ns = v * scale
        if trans is not None:
            # local wall-clock = instant + utc_offset(instant)
            secs = jnp.floor_divide(ns, 1_000_000_000)
            idx = jnp.clip(jnp.searchsorted(trans, secs, side="right")
                           - 1, 0, offs.shape[0] - 1)
            ns = ns + offs[idx] * 1_000_000_000
        days = jnp.floor_divide(ns, 86_400 * 1_000_000_000)
        rem = ns - days * 86_400 * 1_000_000_000
        return days, rem
    if dname in ("time32", "time64"):
        scale = _UNIT_NS[unit]
        return jnp.zeros_like(v), v * scale
    raise ArrowTypeError(f"date_part of {dname}")


def _civil_from_days(z: jnp.ndarray):
    """days-since-epoch -> (year, month, day), proleptic Gregorian."""
    z = z + 719_468
    era = jnp.floor_divide(z, 146_097)
    doe = z - era * 146_097                                   # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)           # [0, 365]
    mp = (5 * doy + 2) // 153                                 # [0, 11]
    day = doy - (153 * mp + 2) // 5 + 1                       # [1, 31]
    month = jnp.where(mp < 10, mp + 3, mp - 9)                # [1, 12]
    year = jnp.where(month <= 2, y + 1, y)
    return year, month, day


def _iso_year_week(days: jnp.ndarray):
    """(iso_year, iso_week) per ISO 8601, branch-free (temporal.rs
    YearISO/WeekISO semantics)."""
    yy, mm, dd = _civil_from_days(days)
    dow1 = jnp.mod(days + 3, 7) + 1          # Monday=1..Sunday=7
    jan1 = _days_from_civil(yy, jnp.ones_like(mm), jnp.ones_like(dd))
    doy = days - jan1 + 1                    # 1..366
    w = (doy - dow1 + 10) // 7

    def weeks_in(y):
        # 52 + (jan1 is Thursday, or leap year and jan1 is Wednesday)
        j = _days_from_civil(y, jnp.ones_like(y), jnp.ones_like(y))
        jd = jnp.mod(j + 3, 7) + 1           # Monday=1
        leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
        return 52 + ((jd == 4) | (leap & (jd == 3))).astype(days.dtype)

    week = jnp.where(w < 1, weeks_in(yy - 1), w)
    week = jnp.where((w > 52) & (w > weeks_in(yy)),
                     jnp.ones_like(w), week)
    iso_year = jnp.where(w < 1, yy - 1,
                         jnp.where((w > 52) & (w > weeks_in(yy)),
                                   yy + 1, yy))
    return iso_year, week


@functools.partial(jax.jit,
                   static_argnames=("dname", "unit", "part", "has_tz"))
def _date_part_stage(v, trans, offs, dname, unit, part, has_tz):
    """Whole extraction as ONE XLA program (one dispatch instead of
    one per array op)."""
    days, t_ns = _epoch_days_and_time_ns_traced(
        v, trans if has_tz else None, offs if has_tz else None,
        dname, unit)
    if part in ("week", "week_iso", "year_iso"):
        iso_year, week = _iso_year_week(days)
        out = iso_year if part == "year_iso" else week
    elif part in ("year", "month", "day", "quarter", "doy"):
        yy, mm, dd = _civil_from_days(days)
        out = {"year": yy, "month": mm, "day": dd,
               "quarter": (mm - 1) // 3 + 1,
               "doy": None}[part]
        if part == "doy":
            jan1 = _days_from_civil(yy, jnp.ones_like(mm),
                                    jnp.ones_like(dd))
            out = days - jan1 + 1
    elif part == "dow":
        # arrow DatePart::DayOfWeekMonday0: Monday=0..Sunday=6
        out = jnp.mod(days + 3, 7)
    elif part == "dow_sunday0":
        # DatePart::DayOfWeekSunday0: Sunday=0..Saturday=6
        out = jnp.mod(days + 4, 7)
    elif part == "hour":
        out = t_ns // (3_600 * 1_000_000_000)
    elif part == "minute":
        out = (t_ns // (60 * 1_000_000_000)) % 60
    elif part == "second":
        out = (t_ns // 1_000_000_000) % 60
    elif part == "millisecond":
        out = (t_ns // 1_000_000) % 1_000
    elif part == "microsecond":
        out = (t_ns // 1_000) % 1_000_000
    elif part == "nanosecond":
        out = t_ns % 1_000_000_000
    else:
        raise ArrowTypeError(f"unknown date part {part}")
    return out.astype(jnp.int32)


_I32_LO, _I32_HI = -2 ** 31, 2 ** 31 - 1


@functools.partial(jax.jit, static_argnames=("unit", "part"))
def _duration_part_stage(v, unit, part):
    """Duration date_part (temporal.rs:527-650): truncating unit
    conversion; the fits-i32 mask rides along (unary_opt -> null)."""
    tps = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}[unit]
    part_sec_num, part_sec_den = {
        "week": (604_800, 1), "day": (86_400, 1), "hour": (3_600, 1),
        "minute": (60, 1), "second": (1, 1),
        "millisecond": (1, 1_000), "microsecond": (1, 1_000_000),
        "nanosecond": (1, 1_000_000_000)}[part]
    # one part = part_sec_num/part_sec_den seconds = that * tps ticks
    num, den = part_sec_num * tps, part_sec_den
    if num % den == 0:                      # coarser: truncating divide
        q = jax.lax.div(v, jnp.int64(num // den))
        ok = (q >= _I32_LO) & (q <= _I32_HI)
    else:                                   # finer: checked multiply
        mult = den // num
        # bound BEFORE multiplying (the i64 product can wrap): fits-i32
        # iff v is within the pre-scaled i32 window
        lo, hi = -((-_I32_LO) // mult), _I32_HI // mult
        ok = (v >= lo) & (v <= hi)
        q = jnp.where(ok, v, 0) * jnp.int64(mult)
    return q.astype(jnp.int32), ok


@functools.partial(jax.jit, static_argnames=("unit", "part"))
def _interval_part_stage(months, days, nanos, unit, part):
    """Interval date_part (temporal.rs:424-520).  For day_time, `nanos`
    carries MILLISECONDS and sub-second parts use the reference's
    i32 checked_mul (so nanosecond of ms>2147 is null)."""
    one = jnp.int64(1)
    if part == "year":
        q = jax.lax.div(months, jnp.int64(12))
    elif part == "month":
        q = jax.lax.rem(months, jnp.int64(12))
    elif part == "week":
        q = jax.lax.div(days, jnp.int64(7))
    elif part == "day":
        q = days
    elif unit == "day_time":
        ms = nanos                           # milliseconds, i64 of i32
        if part == "hour":
            q = jax.lax.div(ms, jnp.int64(3_600_000))
        elif part == "minute":
            q = jax.lax.rem(jax.lax.div(ms, jnp.int64(60_000)),
                            jnp.int64(60))
        elif part == "second":
            q = jax.lax.rem(jax.lax.div(ms, jnp.int64(1_000)),
                            jnp.int64(60))
        elif part == "millisecond":
            q = jax.lax.rem(ms, jnp.int64(60_000))
        elif part == "microsecond":
            q = jax.lax.rem(ms, jnp.int64(60_000)) * jnp.int64(1_000)
        else:                                # nanosecond
            q = jax.lax.rem(ms, jnp.int64(60_000)) * jnp.int64(1_000_000)
    else:                                    # month_day_nano nanos i64
        if part == "hour":
            q = jax.lax.div(nanos, jnp.int64(3_600_000_000_000))
        elif part == "minute":
            q = jax.lax.rem(jax.lax.div(nanos, jnp.int64(60_000_000_000)),
                            jnp.int64(60))
        elif part == "second":
            q = jax.lax.rem(jax.lax.div(nanos, jnp.int64(1_000_000_000)),
                            jnp.int64(60))
        elif part == "millisecond":
            q = jax.lax.div(jax.lax.rem(nanos, jnp.int64(60_000_000_000)),
                            jnp.int64(1_000_000))
        elif part == "microsecond":
            q = jax.lax.div(jax.lax.rem(nanos, jnp.int64(60_000_000_000)),
                            jnp.int64(1_000))
        else:                                # nanosecond
            q = jax.lax.rem(nanos, jnp.int64(60_000_000_000))
    ok = (q >= _I32_LO) & (q <= _I32_HI)
    return q.astype(jnp.int32), ok


_DURATION_PARTS = ("week", "day", "hour", "minute", "second",
                   "millisecond", "microsecond", "nanosecond")
_YM_PARTS = ("year", "month")
_DT_PARTS = _DURATION_PARTS
_MDN_PARTS = _YM_PARTS + ("week", "day", "hour", "minute", "second",
                          "millisecond", "microsecond", "nanosecond")


def _span_date_part(col, part: str) -> PrimitiveColumn:
    """date_part over Duration/Interval columns (temporal.rs:153-184 +
    the ExtractDatePartExt impls at :424-650)."""
    from ..core import validity as vd
    d = col.dtype
    if d.name == "duration":
        if part not in _DURATION_PARTS:
            raise ArrowTypeError(f"{part} does not support {d!r}")
        q, ok = _duration_part_stage(col.values.astype(jnp.int64),
                                     d.unit, part)
    elif d.unit == "year_month":
        if part not in _YM_PARTS:
            raise ArrowTypeError(f"{part} does not support {d!r}")
        q, ok = _interval_part_stage(col.values.astype(jnp.int64),
                                     jnp.zeros((len(col),), jnp.int64),
                                     jnp.zeros((len(col),), jnp.int64),
                                     "year_month", part)
    elif d.unit == "day_time":
        if part not in _DT_PARTS:
            raise ArrowTypeError(f"{part} does not support {d!r}")
        x = col.values.astype(jnp.int64)
        days = x >> 32
        ms = x.astype(jnp.int32).astype(jnp.int64)   # signed low half
        q, ok = _interval_part_stage(jnp.zeros_like(days), days, ms,
                                     "day_time", part)
    else:                                            # month_day_nano
        if part not in _MDN_PARTS:
            raise ArrowTypeError(f"{part} does not support {d!r}")
        q, ok = _interval_part_stage(col.months.astype(jnp.int64),
                                     col.days.astype(jnp.int64),
                                     col.nanos.astype(jnp.int64),
                                     "month_day_nano", part)
    validity = vd.union(col.validity, None if bool(jnp.all(ok)) else ok)
    return PrimitiveColumn(q, dt.int32, validity)


def date_part(col: PrimitiveColumn, part: str) -> PrimitiveColumn:
    d = col.dtype
    if d.name in ("duration", "interval"):
        return _span_date_part(col, part)
    v = col.values.astype(jnp.int64)
    tz = d.tz if d.name == "timestamp" else None
    if tz:
        trans, offs = _tz_tables(tz)
    else:
        trans = offs = jnp.zeros((1,), jnp.int64)
    out = _date_part_stage(v, trans, offs, d.name, d.unit, part,
                           tz is not None)
    return PrimitiveColumn(out, dt.int32, col.validity,
                           _canonical=col.validity is None)


def _days_from_civil(y, m, d):
    y = jnp.where(m <= 2, y - 1, y)
    era = jnp.floor_divide(y, 400)
    yoe = y - era * 400
    mp = jnp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = 365 * yoe + yoe // 4 - yoe // 100 + doy
    return era * 146_097 + doe - 719_468


def year(col):
    return date_part(col, "year")


def month(col):
    return date_part(col, "month")


def day(col):
    return date_part(col, "day")


def hour(col):
    return date_part(col, "hour")


def minute(col):
    return date_part(col, "minute")


def second(col):
    return date_part(col, "second")


def millisecond(col):
    return date_part(col, "millisecond")


def microsecond(col):
    return date_part(col, "microsecond")


def nanosecond(col):
    return date_part(col, "nanosecond")


def day_of_week(col):
    return date_part(col, "dow")


def day_of_year(col):
    return date_part(col, "doy")


def quarter(col):
    return date_part(col, "quarter")


def week(col):
    """ISO 8601 week number (temporal.rs DatePart::Week == WeekISO)."""
    return date_part(col, "week")


def iso_week(col):
    return date_part(col, "week_iso")


def iso_year(col):
    return date_part(col, "year_iso")


# ---- interval arithmetic (arrow-arith numeric.rs interval cases) --------------

def _days_in_month(y, m):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    base = jnp.asarray([31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31],
                       jnp.int64)
    d = base[m - 1]
    return jnp.where((m == 2) & leap, 29, d)


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("dname", "unit", "negate", "has_tz"))
def _add_mdn_stage(v, months, days, nanos, trans, offs, dname, unit,
                   negate, has_tz):
    """ONE jitted program for the whole calendar shift (the eager chain
    was ~25 remote dispatches).  With a tz, the civil math runs in
    LOCAL wall-clock like the reference (numeric.rs:369-426 passes Tz
    into add_year_month/add_day_time/add_month_day_nano), then converts
    back through the reverse transition lookup."""
    if negate:
        months, days, nanos = -months, -days, -nanos
    ep_days, time_ns = _epoch_days_and_time_ns_traced(
        v, trans if has_tz else None, offs if has_tz else None,
        dname, unit)
    y, m, dd = _civil_from_days(ep_days)
    m2 = m - 1 + months.astype(jnp.int64)
    y2 = y + jnp.floor_divide(m2, 12)
    m2 = m2 - jnp.floor_divide(m2, 12) * 12 + 1
    dd2 = jnp.minimum(dd, _days_in_month(y2, m2))      # clamp
    out_days = _days_from_civil(y2, m2, dd2) + days.astype(jnp.int64)
    total_ns = time_ns + nanos.astype(jnp.int64)
    out_days = out_days + jnp.floor_divide(total_ns, 86_400_000_000_000)
    total_ns = total_ns - jnp.floor_divide(
        total_ns, 86_400_000_000_000) * 86_400_000_000_000

    if dname == "date32":
        return out_days.astype(jnp.int32)
    if dname == "date64":
        return out_days * 86_400_000 + total_ns // 1_000_000
    scale = _UNIT_NS[unit]
    ns = out_days * (86_400 * 1_000_000_000) + total_ns
    if has_tz:
        # local -> UTC: regime i begins at wall-clock trans[i]+offs[i];
        # ambiguous wall-clocks resolve to the later regime, gap
        # wall-clocks to the later as well (chrono's from_local picks a
        # deterministic side; exactness over DST is test-pinned)
        secs_local = jnp.floor_divide(ns, 1_000_000_000)
        trans_local = trans + offs
        idx = jnp.clip(jnp.searchsorted(trans_local, secs_local,
                                        side="right") - 1,
                       0, offs.shape[0] - 1)
        ns = ns - offs[idx] * 1_000_000_000
    return ns // scale


def _add_months_days_nanos(col: PrimitiveColumn, months, days, nanos,
                           negate: bool):
    """Calendar-aware shift of a timestamp/date column: months add with
    end-of-month clamping (chrono checked_add_months semantics, the rule
    arrow-rs interval arithmetic uses), then whole days, then
    nanoseconds — in the column's LOCAL time when it carries a tz."""
    d = col.dtype
    tz = d.tz if d.name == "timestamp" else None
    if tz is not None:
        trans, offs = _tz_tables(tz)
        has_tz = True
    else:
        trans = offs = jnp.zeros((1,), jnp.int64)
        has_tz = False
    out = _add_mdn_stage(col.values.astype(jnp.int64),
                         jnp.asarray(months, jnp.int64),
                         jnp.asarray(days, jnp.int64),
                         jnp.asarray(nanos, jnp.int64),
                         trans, offs, d.name, d.unit or "us", negate,
                         has_tz)
    return PrimitiveColumn(out, d, col.validity,
                           _canonical=col.validity is None)


def add_interval(col: PrimitiveColumn, interval, *, negate: bool = False
                 ) -> PrimitiveColumn:
    """timestamp/date32/date64 + Interval column (numeric.rs interval
    arithmetic: YearMonth / DayTime / MonthDayNano, calendar-aware with
    chrono-style end-of-month clamping)."""
    from ..core import validity as vd
    from ..core.nested import IntervalMDNColumn
    if col.dtype.name not in ("timestamp", "date32", "date64"):
        raise ArrowTypeError(f"add_interval over {col.dtype!r}")
    if isinstance(interval, IntervalMDNColumn):
        months, days, nanos = (interval.months.astype(jnp.int64),
                               interval.days.astype(jnp.int64),
                               interval.nanos)
        iv_valid = interval.validity
    elif isinstance(interval, PrimitiveColumn) and \
            interval.dtype.name == "interval":
        if interval.dtype.unit == "year_month":
            months = interval.values.astype(jnp.int64)
            days = jnp.zeros_like(months)
            nanos = jnp.zeros_like(months)
        else:                                     # day_time: days<<32|ms
            packed = interval.values.astype(jnp.int64)
            days = packed >> 32
            # low 32 bits are SIGNED millis (interval.rs day_time;
            # unsigned decode turned ms=-500 into +49.7 days)
            ms = packed.astype(jnp.int32).astype(jnp.int64)
            months = jnp.zeros_like(days)
            nanos = ms * 1_000_000
        iv_valid = interval.validity
    else:
        raise ArrowTypeError(f"not an interval: {type(interval)}")
    out = _add_months_days_nanos(col, months, days, nanos, negate)
    validity = vd.union(out.validity, iv_valid)
    return out if validity is out.validity else out.with_validity(validity)


def sub_interval(col: PrimitiveColumn, interval) -> PrimitiveColumn:
    return add_interval(col, interval, negate=True)
