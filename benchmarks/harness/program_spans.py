"""Readings of the program's own spans and sync counters
(`sags_tpu_torch.utils.profiling`) over a traced run's profiled stretch:
its ranges are `record_function` ranges in the profiler's trace
(`Stretch.ranges`), and its records (`profiling.records()`) cover exactly
the time the profiler recorded. A program without them gives None."""

from __future__ import annotations

from typing import List, Optional

from benchmarks.harness import trace


def records():
    """The program's `profiling.records()`, or None where the program keeps
    none."""
    try:
        from sags_tpu_torch.utils import profiling
    except ImportError:
        return None
    fn = getattr(profiling, "records", None)
    return fn() if fn is not None else None


def idle_in(ops: List[trace.DeviceOp], ranges: List[trace.DeviceOp],
            name: str) -> Optional[float]:
    """Seconds of the device's idle gaps that began inside a range named
    `name` (so inside its children too); a whole gap counts where it began,
    as `trace.idle_gaps` does. None without device operations or without
    such a range."""
    rs = [(r.start_ns, r.start_ns + r.dur_ns) for r in ranges if r.name == name]
    if not ops or not rs:
        return None
    iv = trace.busy_intervals(ops)
    ns = sum(s1 - e0 for (_, e0), (s1, _) in zip(iv, iv[1:])
             if any(s <= e0 < e for s, e in rs))
    return ns * 1e-9


def host_s(ranges: List[trace.DeviceOp], name: str) -> Optional[float]:
    """Host seconds of the ranges named `name`; None without one."""
    d = [r.dur_ns for r in ranges if r.name == name]
    return sum(d) * 1e-9 if d else None


def per_unit_ms(seconds: Optional[float], units: int) -> Optional[float]:
    return seconds * 1e3 / units if seconds is not None and units else None


def device_ms_per_unit(name: str, units: int) -> Optional[float]:
    """Device ms a unit between the entry and exit events of the program's
    spans named `name`; None without such events."""
    r = records()
    ms = None if r is None else r.device_ms(name)
    return ms / units if ms is not None and units else None
