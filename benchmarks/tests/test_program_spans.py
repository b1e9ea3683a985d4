"""The readers of the program's own spans and counters on made-up ranges,
device operations and records, and each one's silence where the program
keeps none (a parent without `profiling.records` or without the spans)."""

import pytest

from benchmarks.harness import program_spans as ps
from benchmarks.harness import spec, trace
from sags_tpu_torch.utils import profiling

Op = trace.DeviceOp


def _read(name, rec):
    return spec.load_module("metrics", name).read(rec)


def _stretch(units=2):
    # busy [0,100) [300,400) [1000,1100) [1500,1600): gaps begin at 100, 400, 1100
    ops = [Op("k", 0, 100), Op("k", 300, 100), Op("k", 1000, 100), Op("k", 1500, 100)]
    ranges = [Op("frame", 0, 2000), Op("track", 50, 400),  # holds the gaps at 100 and 400
              Op("gicp.lm_trial", 80, 40),  # a child: its gap still counts in track
              Op("raster.bin", 1050, 100),  # the gap at 1100 (400 ns long)
              Op("bin_gaussians", 1040, 200),  # the benchmark's wrapper: not read
              Op("queue.wait", 1700, 250), Op("queue.wait", 1960, 30)]
    return {"profiled": trace.Stretch(units=units, ops=ops, ranges=ranges)}


def _records():
    R = profiling.SpanRecord
    spans = [R(0, "frame", None, "main", 0, syncs=1),
             R(1, "track", 0, "main", 0, syncs=0),
             R(2, "gicp.align", 1, "main", 0, syncs=4),
             R(3, "gicp.lm_trial", 2, "main", 0, syncs=3),
             R(4, "train", 0, "main", 7, device_ms=5.0),
             R(5, "raster.bin", 4, "main", 7, device_ms=1.5),
             R(6, "step.adam", 4, "main", 7, syncs=2, device_ms=0.25),
             R(7, "raster.composite_bwd", 4, "autograd", 7, device_ms=2.0),
             R(8, "track", 0, "main", 1, syncs=1),
             R(9, "raster.bin", 4, "main", 8, device_ms=0.5),
             R(10, "step.adam", 4, "main", 8, device_ms=0.75)]
    return profiling.Records(spans, outside_syncs=3)


def test_idle_readers_count_whole_gaps_where_they_began():
    rec = _stretch()
    assert ps.idle_in(rec["profiled"].ops, rec["profiled"].ranges, "track") == \
        pytest.approx((200 + 600) * 1e-9)
    assert _read("track_idle_ms.stream", rec) == pytest.approx(800e-6 / 2)
    assert _read("bin_idle_ms.stream", rec) == pytest.approx(400e-6 / 2)


def test_idle_readers_are_silent_without_a_trace_or_the_span():
    rec = _stretch()
    rec["profiled"].ops = []  # the CPU
    assert _read("track_idle_ms.stream", rec) is None
    rec = _stretch()
    rec["profiled"].ranges = [r for r in rec["profiled"].ranges if r.name != "raster.bin"]
    assert _read("bin_idle_ms.stream", rec) is None  # the wrapper alone does not count


def test_queue_wait_reads_host_ms_of_its_ranges():
    assert _read("queue_wait_ms.stream", _stretch(units=4)) == pytest.approx(280e-6 / 4)
    rec = _stretch()
    rec["profiled"].ranges = [r for r in rec["profiled"].ranges if r.name != "queue.wait"]
    assert _read("queue_wait_ms.stream", rec) is None


def test_record_readers(monkeypatch):
    monkeypatch.setattr(ps, "records", _records)
    rec = _stretch(units=2)
    # inside track: its own sync, gicp.align's 4, the trial's 3; frame's is outside
    assert _read("track_syncs_per_frame.stream", rec) == pytest.approx((0 + 4 + 3 + 1) / 2)
    assert _read("bin_device_ms.offline", rec) == pytest.approx((1.5 + 0.5) / 2)
    assert _read("adam_device_ms.offline", rec) == pytest.approx((0.25 + 0.75) / 2)


def test_record_readers_are_silent_without_events_or_spans(monkeypatch):
    R = profiling.SpanRecord
    no_events = profiling.Records([R(0, "raster.bin", None, "main", 0),
                                   R(1, "step.adam", None, "main", 0)])
    monkeypatch.setattr(ps, "records", lambda: no_events)
    rec = _stretch()
    assert _read("bin_device_ms.offline", rec) is None  # the CPU: no CUDA events
    assert _read("adam_device_ms.offline", rec) is None
    assert _read("track_syncs_per_frame.stream", rec) is None  # no track span


@pytest.mark.parametrize("name", ["track_syncs_per_frame.stream", "bin_device_ms.offline",
                                  "adam_device_ms.offline"])
def test_a_program_without_records_reads_nothing(monkeypatch, name):
    monkeypatch.delattr(profiling, "records")
    assert ps.records() is None
    assert _read(name, _stretch()) is None
