"""Tracing and profiling (own copy of `sags_tpu.utils.profiling`).

  * `PhaseTimer` — per-phase wall times, fenced by `torch.cuda.synchronize`
    on the device of every CUDA tensor in a phase's output (device-truthful,
    unlike timing the asynchronous launches).
  * `span`, `host_read`, `count`, `records` — the program's own spans,
    sync counters and work counters. Tracing is on exactly while a
    `torch.profiler` session records, and off at every other time. On, a
    span is a `record_function` range in the profiler's trace, on the
    profiler's clock beside the device's kernels; a device span also
    records a CUDA event at entry and exit; every host read that goes
    through `host_read` counts one sync against the innermost open span of
    its thread; and `count(name, n)` adds `n` to the counter `name` of that
    span. Off, a span, a `host_read` or a `count` costs one flag test: no
    range, no event, no count.
  * `trace(logdir)` — the operator's path: a `torch.profiler` session
    around a block that writes its Chrome trace and `spans.json` (per span
    name: count, syncs, host and device ms) into `logdir`.

Each span records its name, its parent (the innermost span open on its
thread; on another thread than the main one, the `frame` or `train` span
open on the main thread), its thread ("main", "autograd" for the autograd
engine's device thread, else the thread's name), the frame or iteration it
belongs to (`unit`, inherited from the parent), its syncs and its counters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _profiler

# spans that take the spans of other threads as children
ROOTS = ("frame", "train")


def _cuda_devices(out, found=None) -> set:
    """The CUDA devices of the tensors in `out` (nested lists, tuples, named
    tuples, dicts and dataclasses are walked)."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(out) and not isinstance(out, type):
        for f in dataclasses.fields(out):
            _cuda_devices(getattr(out, f.name), found)
    return found


class PhaseTimer:
    def __init__(self):
        self.times: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, result=None):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            out = holder.get("out", result)
            if out is not None:
                for dev in _cuda_devices(out):
                    torch.cuda.synchronize(dev)
            self.times[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float):
        self.times[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "median_ms": float(np.median(v) * 1e3),
                "mean_ms": float(np.mean(v) * 1e3),
                "count": len(v),
            }
            for k, v in self.times.items()
        }

    def report(self) -> str:
        lines = [f"{k}: {s['median_ms']:.2f} ms (n={s['count']})"
                 for k, s in sorted(self.summary().items())]
        return "\n".join(lines)


# --- spans and sync counters ---------------------------------------------


@dataclasses.dataclass
class SpanRecord:
    id: int
    name: str
    parent: Optional[int]
    thread: str
    unit: Optional[int]
    syncs: int = 0
    start: Optional[torch.cuda.Event] = None
    end: Optional[torch.cuda.Event] = None
    device_ms: Optional[float] = None  # resolved by `records()`
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class _State:
    def __init__(self):
        self.live = False  # a profiler session's records are being kept
        self.spans: List[SpanRecord] = []
        self.outside = 0  # syncs counted with no span open
        self.roots: List[SpanRecord] = []  # the `ROOTS` spans open on the main thread


_S = _State()
_local = threading.local()
_lock = threading.Lock()  # session start and span ids, across threads
_NULL = contextlib.nullcontext()


def clear() -> None:
    """Forget the records. A session's first span or counted sync does the
    same once tracing was seen off since the last one (a span entered, or
    `records()` read, while off)."""
    _S.spans, _S.outside, _S.roots = [], 0, []
    _S.live = False


def _begin() -> None:
    with _lock:
        if not _S.live:
            clear()
            _S.live = True


def _stack() -> List[SpanRecord]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _thread_name() -> str:
    th = threading.current_thread()
    if th is threading.main_thread():
        return "main"
    if torch._C._current_graph_task_id() >= 0:
        return "autograd"
    return th.name


def _event_stream(device):
    """The CUDA stream a device span records its events on, or None."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.current_stream(device)
    return None


class _Span:
    __slots__ = ("name", "device", "unit", "rec", "rf", "stream")

    def __init__(self, name: str, device, unit: Optional[int]):
        self.name, self.device, self.unit = name, device, unit

    def __enter__(self) -> SpanRecord:
        if not _S.live:
            _begin()
        st = _stack()
        thread = _thread_name()
        if st:
            parent = st[-1]
        else:
            parent = _S.roots[-1] if thread != "main" and _S.roots else None
        unit = self.unit if self.unit is not None else (parent.unit if parent else None)
        with _lock:
            rec = self.rec = SpanRecord(len(_S.spans), self.name,
                                        parent.id if parent else None, thread, unit)
            _S.spans.append(rec)
        self.rf = _profiler.record_function(
            self.name, None if self.unit is None else str(self.unit))
        self.rf.__enter__()
        self.stream = _event_stream(self.device)
        if self.stream is not None:
            rec.start = torch.cuda.Event(enable_timing=True)
            rec.start.record(self.stream)
        st.append(rec)
        if thread == "main" and self.name in ROOTS:
            _S.roots.append(rec)
        return rec

    def __exit__(self, *exc) -> None:
        rec = self.rec
        if self.stream is not None:
            rec.end = torch.cuda.Event(enable_timing=True)
            rec.end.record(self.stream)
        st = _stack()
        if st and st[-1] is rec:
            st.pop()
        if _S.roots and _S.roots[-1] is rec:
            _S.roots.pop()
        self.rf.__exit__(None, None, None)


def span(name: str, device=None, unit: Optional[int] = None):
    """A context manager: while tracing is on, a `record_function(name)`
    range and a record of the span; a CUDA `device` (a device span) adds a
    CUDA event at entry and exit on its current stream; `unit` is the frame
    or iteration the span and its children belong to. While tracing is
    off, a shared null context."""
    if _profiler._is_profiler_enabled:
        return _Span(name, device, unit)
    _S.live = False
    return _NULL


def host_read(fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, a call that waits for the device: a host read
    (`.tolist()`, `bool(t)`, `int(t)`, `.item()`, `.cpu()`,
    `Event.synchronize`) or a blocking copy from pageable host memory
    (`torch.tensor(x, device=cuda)`). Counted as one sync against the
    innermost open span of this thread while tracing is on."""
    if _profiler._is_profiler_enabled:
        if not _S.live:
            _begin()
        st = getattr(_local, "stack", None)
        if st:
            st[-1].syncs += 1
        elif _S.roots and _thread_name() != "main":
            _S.roots[-1].syncs += 1
        else:
            _S.outside += 1
    return fn(*args, **kwargs)


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` of the innermost open span of this
    thread while tracing is on (a count with no span open is dropped)."""
    if _profiler._is_profiler_enabled:
        if not _S.live:
            _begin()
        st = getattr(_local, "stack", None)
        if st:
            st[-1].counts[name] = st[-1].counts.get(name, 0) + int(n)


@dataclasses.dataclass
class Records:
    """What tracing recorded since it last turned on: the spans in the order
    they were entered, device ms resolved, and the syncs counted with no
    span open."""

    spans: List[SpanRecord]
    outside_syncs: int = 0

    def named(self, name: str) -> List[SpanRecord]:
        return [r for r in self.spans if r.name == name]

    def count(self, name: str) -> int:
        return len(self.named(name))

    def within(self, name: str) -> List[SpanRecord]:
        """The spans named `name` and every span under them."""
        inside: Dict[int, bool] = {}
        out = []
        for r in self.spans:  # a parent is entered before its children
            inside[r.id] = r.name == name or inside.get(r.parent, False)
            if inside[r.id]:
                out.append(r)
        return out

    def syncs_within(self, name: str) -> int:
        return sum(r.syncs for r in self.within(name))

    def counter(self, name: str) -> int:
        """The counter `name` summed over every span."""
        return sum(r.counts.get(name, 0) for r in self.spans)

    def device_ms(self, name: str) -> Optional[float]:
        """Summed device ms between the entry and exit events of the spans
        named `name`; None when none has events."""
        ms = [r.device_ms for r in self.named(name) if r.device_ms is not None]
        return float(sum(ms)) if ms else None

    def summary(self) -> Dict[str, dict]:
        """Per span name: count, syncs (its own, not its children's),
        device ms (null for a span without events) and, where it has any,
        its counters."""
        out: Dict[str, dict] = {}
        for r in self.spans:
            s = out.setdefault(r.name, {"count": 0, "syncs": 0, "device_ms": None})
            s["count"] += 1
            s["syncs"] += r.syncs
            for k, n in r.counts.items():
                c = s.setdefault("counters", {})
                c[k] = c.get(k, 0) + n
            if r.device_ms is not None:
                s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
        return out


def records() -> Records:
    """The spans and syncs recorded since tracing last turned on. Waits for
    each device span's exit event to resolve its device ms."""
    if not _profiler._is_profiler_enabled:
        _S.live = False
    spans = list(_S.spans)
    for r in spans:
        if r.device_ms is None and r.end is not None:
            r.end.synchronize()
            r.device_ms = r.start.elapsed_time(r.end)
    return Records(spans, _S.outside)


# --- the operator's path -----------------------------------------------------


def _merged(intervals) -> List[List[int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_summary(prof, wall_s: float, top: int = 25) -> dict:
    """A finished `torch.profiler.profile`'s reading, with `records()`:
    the device's busy ms (the union of its operations' intervals, so
    overlapping kernels count once), launches, the `top` kernels by device
    ms, and per span name count, syncs, host ms (from the profiler's
    ranges) and device ms. Syncs counted with no span open go under
    `"-"`."""
    host_ms: Dict[str, float] = defaultdict(float)
    ops, kernels = [], defaultdict(lambda: [0, 0.0])
    for e in prof.profiler.kineto_results.events():
        cpu = e.device_type() == torch.autograd.DeviceType.CPU
        if e.is_user_annotation():
            if cpu:
                host_ms[e.name()] += e.duration_ns() * 1e-6
        elif not cpu:
            ops.append((int(e.start_ns()), int(e.start_ns()) + int(e.duration_ns())))
            k = kernels[e.name()]
            k[0] += 1
            k[1] += e.duration_ns() * 1e-6
    busy_ms = sum(e - s for s, e in _merged(ops)) * 1e-6
    rec = records()
    spans = rec.summary()
    for name, s in spans.items():
        s["host_ms"] = host_ms.get(name)
    spans["-"] = {"count": 0, "syncs": rec.outside_syncs, "device_ms": None, "host_ms": None}
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
        "device_idle_share": (1.0 - busy_ms / (wall_s * 1e3)) if ops and wall_s > 0 else None,
        "launches": sum(c for n, (c, _) in kernels.items()
                        if not n.startswith(("Memcpy", "Memset"))),
        "spans": spans,
        "top_device": [{"name": n[:90], "calls": c, "device_ms": ms} for n, (c, ms) in
                       sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]],
    }


def per_unit(summary: dict, units: int) -> dict:
    """`profile_summary`'s numbers a unit (frame, iteration, render): every
    count, sync and ms divided by `units`; the idle share as it is."""
    div = lambda v: None if v is None else v / units
    return {
        "units": units, "wall_ms": div(summary["wall_ms"]),
        "device_busy_ms": div(summary["device_busy_ms"]),
        "device_idle_share": summary["device_idle_share"],
        "launches": div(summary["launches"]),
        "spans": {k: {f: {c: div(n) for c, n in v.items()} if isinstance(v, dict) else div(v)
                      for f, v in s.items()} for k, s in summary["spans"].items()},
        "top_device": [dict(t, calls=div(t["calls"]), device_ms=div(t["device_ms"]))
                       for t in summary["top_device"]],
    }


@contextlib.contextmanager
def trace(logdir: str):
    """`torch.profiler` session (host, and the card's kernels when there is
    one) around a block. The records are cleared at entry; at exit, after a
    sync, `logdir` holds the Chrome trace (TensorBoard's
    `*.pt.trace.json`) and `spans.json`, `profile_summary` of the
    session. Yields `logdir`."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    clear()
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        t0 = time.perf_counter()
        yield logdir
        if cuda and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(profile_summary(prof, wall), f, indent=1)
