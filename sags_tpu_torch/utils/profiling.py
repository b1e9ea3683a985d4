"""Tracing and profiling (own copy of `sags_tpu.utils.profiling`).

Two tools:
  * `PhaseTimer` — per-phase wall times, fenced by `torch.cuda.synchronize`
    on the device of every CUDA tensor in a phase's output (device-truthful,
    unlike timing the asynchronous launches).
  * `trace()` — a context manager around `torch.profiler` that writes a
    TensorBoard / Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch


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


@contextlib.contextmanager
def trace(logdir: str = os.path.join(tempfile.gettempdir(), "sags_trace")):
    """`torch.profiler` trace (host, and the card's kernels when there is
    one) around a block, written into `logdir` on exit — open it in
    TensorBoard or chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir
