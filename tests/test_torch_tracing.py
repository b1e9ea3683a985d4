"""The port's own spans and sync counters (`sags_tpu_torch.utils.profiling`):
off, a span is a shared null context that enters no `record_function` and
records no CUDA event; under `torch.profiler` a tiny fused-pipeline frame
and an offline iteration emit the named spans with their nesting, one
`gicp.lm_trial` span a trial, and the syncs the tracker's code implies;
`trace(logdir)` writes the Chrome trace and `spans.json`. CPU only, no
JAX."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.io.datasets import SyntheticDataset
from sags_tpu_torch.slam import offline
from sags_tpu_torch.slam.pipeline import SLAMPipeline, camera_for
from sags_tpu_torch.utils import profiling

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py


def _cfg():
    return tconf.SLAMConfig(
        raster=tconf.RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=128, chunk=32),
        map=tconf.MapConfig(initial_capacity=4096, initial_scale=0.08),
        semantics=tconf.SemanticsConfig(cls3d_sample=32, num_classes=24),
        keyframes=tconf.KeyframeConfig(keyframe_freq=2, window=8),
        tracking=tconf.TrackingConfig(backend="gicp", max_points=512),
        gicp=tconf.GICPConfig(max_iterations=24, knn_max_distance=2.0),
        post_train_iters=0, metrics_interval=2)


@pytest.fixture(scope="module")
def frames():
    return list(SyntheticDataset(n_frames=4, width=64, height=48, n_world=4096,
                                 pts_per_frame=512, step=0.1, clutter=0.3, device="cpu"))


@pytest.fixture(scope="module")
def pipe(frames):
    p = SLAMPipeline(_cfg(), point_budget=512, device="cpu")
    p.run(frames[:1], post_train=0)  # the first frame aligns nothing
    return p


def _ranges(prof):
    """The profiler's user ranges on the host: [(name, start_ns, end_ns)]."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU]


def _inside(ranges, inner: str, outer: str) -> bool:
    """Every `inner` range lies within an `outer` range, and there is one."""
    ins = [r for r in ranges if r[0] == inner]
    outs = [r for r in ranges if r[0] == outer]
    return bool(ins) and all(any(o[1] <= i[1] and i[2] <= o[2] for o in outs) for i in ins)


def _ancestors(rec: profiling.Records, r: profiling.SpanRecord):
    by_id = {x.id: x for x in rec.spans}
    out = []
    while r.parent is not None:
        r = by_id[r.parent]
        out.append(r.name)
    return out


@pytest.fixture(scope="module")
def traced_frame(pipe, frames):
    """One keyframe (track, add, train) under the CPU profiler."""
    lm0, n0 = len(pipe.lm_log), pipe._n_frames
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = pipe.run(frames[1:2], post_train=0)
    return {"rec": profiling.records(), "ranges": _ranges(prof),
            "lm": pipe.lm_log[lm0:], "res": res, "frame": n0}


def test_span_off_enters_no_range_and_no_event(pipe, frames, monkeypatch):
    """With tracing off, a frame, an offline iteration and device spans run
    with `record_function` and `torch.cuda.Event` raising; nothing is
    recorded."""
    def boom(*a, **k):
        raise AssertionError("entered while tracing is off")

    assert not torch.autograd.profiler._is_profiler_enabled
    profiling.clear()
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    ctx = profiling.span("x", device=torch.device("cuda"))
    assert ctx is profiling.span("y", device=torch.device("cpu"), unit=3)
    with ctx:
        assert profiling.host_read(bool, torch.ones(())) is True
    res = pipe.run(frames[2:3], post_train=0)
    assert len(res.frame_times) == 1
    f = frames[0]
    st = offline.init_from_points(f.points, f.colors, _cfg(), device="cpu")
    cam = camera_for(_cfg(), f, f.pose, "cpu")
    offline.train_step(st, cam, torch.as_tensor(np.asarray(f.image)), _cfg())
    rec = profiling.records()
    assert rec.spans == [] and rec.outside_syncs == 0


def test_frame_spans_nest(traced_frame):
    """frame ⊃ track ⊃ gicp.align ⊃ gicp.lm_trial and train ⊃ raster.bin,
    in the profiler's ranges and in the records' parents."""
    ranges, rec = traced_frame["ranges"], traced_frame["rec"]
    for inner, outer in (("track", "frame"), ("gicp.align", "track"),
                         ("gicp.lm_trial", "gicp.align"), ("train", "frame"),
                         ("raster.bin", "train"), ("step.adam", "train"),
                         ("map.add", "frame"), ("track.covariances", "track")):
        assert _inside(ranges, inner, outer), (inner, outer)
    trial = rec.named("gicp.lm_trial")[0]
    assert _ancestors(rec, trial)[:3] == ["gicp.align", "track", "frame"]
    assert ["step.forward", "train", "frame"] == _ancestors(rec, rec.named("raster.bin")[0])
    frame, train = rec.named("frame")[0], rec.named("train")[0]
    assert frame.thread == "main" and frame.unit == traced_frame["frame"]
    assert train.unit is not None and all(r.unit == train.unit for r in rec.within("train"))
    assert all(r.unit in (frame.unit, train.unit) for r in rec.within("frame"))
    assert [r.thread for r in rec.named("queue.stage")] == ["frame-queue"]


def test_lm_trial_spans_count_the_trials(traced_frame):
    lm = traced_frame["lm"]
    assert len(lm) == 1 and lm[0][1] > 0
    assert traced_frame["rec"].count("gicp.lm_trial") == lm[0][1]


def test_track_syncs_are_the_trackers_reads(traced_frame):
    """An LM align of `outer` iterations and `inner` trials syncs
    2·outer + inner + 2 times (each linearization's `robust_inv3` check,
    each trial's flags, each outer convergence test, the two starting
    scalars copied to the device); nothing else in `track` does. The
    trials' own reads sit in their spans."""
    rec = traced_frame["rec"]
    outer, inner = traced_frame["lm"][0]
    assert rec.syncs_within("track") == 2 * outer + inner + 2
    assert sum(r.syncs for r in rec.named("gicp.lm_trial")) == inner
    assert rec.summary()["gicp.align"]["syncs"] == 2 * outer + 2


def test_device_ms_absent_on_the_cpu(traced_frame):
    rec = traced_frame["rec"]
    assert all(r.start is None and r.device_ms is None for r in rec.spans)
    assert rec.device_ms("train") is None


def test_offline_step_spans(frames):
    f = frames[0]
    cfg = _cfg()
    st = offline.init_from_points(f.points, f.colors, cfg, device="cpu")
    cam = camera_for(cfg, f, f.pose, "cpu")
    img = torch.as_tensor(np.asarray(f.image))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st, _ = offline.train_step(st, cam, img, cfg)
        st = offline.densify_event(st, cfg)
    ranges, rec = _ranges(prof), profiling.records()
    for inner in ("step.adam", "step.forward", "step.backward", "raster.bin",
                  "raster.composite", "raster.composite_bwd"):
        assert _inside(ranges, inner, "train"), inner
    assert [r.unit for r in rec.named("train")] == [0]
    assert rec.count("offline.densify") == 1 and rec.count("frame") == 0


def test_a_new_session_starts_new_records():
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("a"):
            profiling.host_read(int, torch.ones(()))
    assert profiling.records().summary()["a"] == {"count": 1, "syncs": 1, "device_ms": None}
    with profiling.span("off"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.host_read(int, torch.ones(()))
        with profiling.span("b"):
            pass
    rec = profiling.records()
    assert [r.name for r in rec.spans] == ["b"] and rec.outside_syncs == 1


def test_trace_writes_the_trace_and_spans_json(tmp_path):
    with profiling.trace(str(tmp_path)) as d:
        with profiling.span("train", unit=7):
            with profiling.span("step.adam"):
                profiling.host_read(torch.Tensor.tolist, torch.ones(2))
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path)
    assert d == str(tmp_path) and any(n.endswith(".pt.trace.json") for n in files)
    summary = json.loads((tmp_path / "spans.json").read_text())
    assert summary["spans"]["step.adam"]["syncs"] == 1
    assert summary["spans"]["train"]["count"] == 1 and summary["spans"]["train"]["syncs"] == 0
    assert summary["spans"]["train"]["host_ms"] > 0 and summary["wall_ms"] > 0
    assert summary["device_busy_ms"] == 0 and summary["device_idle_share"] is None
