"""What a traced run reads: host spans the benchmark puts around the
program's module functions, the implicit host syncs, and the device's
operations from `torch.profiler`, over a short stretch of steady units.

Two stretches make a traced run's record. The profiled one gives the
device's operations (busy time as the union of their intervals, launches,
time by kernel, idle gaps by the host span they fell in). The other runs
without the profiler, under `torch.cuda.set_sync_debug_mode("warn")`, and
gives the host spans, the syncs and the stretch's wall time, which the
profiler would inflate.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch

MEMCPY = ("Memcpy", "Memset")


class Spans:
    """Wraps program functions: each call adds its host seconds to
    `seconds[name]`, and, while `annotate` is set, runs inside a
    `record_function(name)` range that labels the profiler's timeline."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.annotate = False
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, owner, attr: str, name: Optional[str] = None) -> None:
        name = name or attr
        orig = getattr(owner, attr)

        def wrapped(*a, **k):
            ctx = (torch.profiler.record_function(name) if self.annotate
                   else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx:
                out = orig(*a, **k)
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
            return out

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def reset(self) -> None:
        self.seconds.clear()

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int


@dataclasses.dataclass
class Stretch:
    """One stretch's readings. `ops` and `ranges` come from the profiler
    (empty when it was off); `syncs` from the sync debug mode."""

    units: int = 0
    wall_s: float = 0.0
    ops: List[DeviceOp] = dataclasses.field(default_factory=list)
    ranges: List[DeviceOp] = dataclasses.field(default_factory=list)
    syncs: int = 0
    spans: Dict[str, float] = dataclasses.field(default_factory=dict)
    captured: list = dataclasses.field(default_factory=list)  # the units' inputs
    work: Optional[dict] = None  # counted after the stretch (harness/work.py)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Return the freed program state's cached blocks to the card."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def profiled(run_units: Callable[[], int], device) -> Stretch:
    """Run `run_units()` (returns the units it ran) under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        n = run_units()
        sync(device)
        wall = time.perf_counter() - t0
    ops, ranges = [], []
    for e in prof.profiler.kineto_results.events():
        rec = DeviceOp(e.name(), int(e.start_ns()), int(e.duration_ns()))
        if e.is_user_annotation():
            if e.device_type() == torch.autograd.DeviceType.CPU:
                ranges.append(rec)
        elif e.device_type() != torch.autograd.DeviceType.CPU:
            ops.append(rec)
    return Stretch(units=n, wall_s=wall, ops=ops, ranges=ranges)


def counted(run_units: Callable[[], int], device) -> Stretch:
    """Run `run_units()` counting the implicit host syncs (each one a
    "synchronizing" warning of the sync debug mode, from any thread)."""
    on_card = torch.device(device).type == "cuda"
    sync(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            n = run_units()
            wall = time.perf_counter() - t0
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
    sync(device)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return Stretch(units=n, wall_s=wall, syncs=syncs)


def busy_intervals(ops: List[DeviceOp]) -> List[Tuple[int, int]]:
    """The union of the device operations' intervals, merged, in order."""
    iv = sorted((o.start_ns, o.start_ns + o.dur_ns) for o in ops if o.dur_ns > 0)
    out: List[List[int]] = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(ops: List[DeviceOp]) -> float:
    return sum(e - s for s, e in busy_intervals(ops)) * 1e-9


def is_kernel(op: DeviceOp) -> bool:
    return not op.name.startswith(MEMCPY)


def launches(ops: List[DeviceOp]) -> int:
    return sum(is_kernel(o) for o in ops)


def kernel_seconds(ops: List[DeviceOp], name: str) -> float:
    """Device seconds of the kernels whose (demangled) name holds `name`
    as a whole identifier."""
    return sum(o.dur_ns for o in ops if _kernel_name(o.name) == name) * 1e-9


def _kernel_name(full: str) -> str:
    """`void composite_bwd_kernel<...>(float const*, ...)` → the function's
    identifier."""
    head = full.split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else full


def top_ops(ops: List[DeviceOp], n: int = 10) -> List[list]:
    tot: Dict[str, float] = {}
    for o in ops:
        k = _kernel_name(o.name)
        tot[k] = tot.get(k, 0.0) + o.dur_ns * 1e-9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(ops: List[DeviceOp], ranges: List[DeviceOp], n: int = 10) -> List[list]:
    """Idle time between the device's busy intervals, summed by the
    innermost benchmark span the gap began in ("other" outside them)."""
    iv = busy_intervals(ops)
    rs = sorted(ranges, key=lambda r: r.start_ns)
    tot: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(iv, iv[1:]):
        label, best = "other", None
        for r in rs:
            if r.start_ns > e0:
                break
            if r.start_ns + r.dur_ns > e0 and (best is None or r.dur_ns < best):
                label, best = r.name, r.dur_ns
        tot[label] = tot.get(label, 0.0) + (s1 - e0) * 1e-9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
