"""Whole runs of each cell at a tiny size on the CPU, through the port's
plain versions: sound, they come out correct; with the timed path broken
underneath in each way the cell can break, `correct` comes out false."""

import time

import pytest
import torch

from benchmarks import run as bench_run
from benchmarks.harness import spec

CPU = torch.device("cpu")


def _run(tiny, name, traced=False, seconds=1.0):
    return bench_run.run(tiny(name), 2 ** 31 + 17, seconds, traced, CPU, time.perf_counter())


@pytest.mark.parametrize("name", ["fast_livo2.stream", "fast_livo2_offline.replay"])
def test_sound_run_is_correct(tiny_cell, name):
    out = _run(tiny_cell, name, traced=True)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0 and out["failed"] == 0
    bench = spec.benchmark()
    # a CPU run has no device trace: only host-side readers report
    for m in spec.metrics_of(bench, name, "per_layer"):
        if m["source"] == "device_trace":
            assert m["name"] not in out["metrics"]
    assert out["breakdown"]["device_ops"] == []


def _unchanged_step(orig, *a, **k):
    new, metrics = orig(*a, **k)
    return a[0], metrics


def _half_image(loss):
    def half(pred, gt, *a, **k):
        h = pred.shape[-2] // 2
        return loss(pred[..., :h, :], gt[..., :h, :], *a, **k)
    return half


def _faults_stream():
    from sags_tpu_torch.mapping import gaussian_map as gm
    from sags_tpu_torch.ops import gicp
    from sags_tpu_torch.slam import step

    def altered_colors(orig, m, points, colors, *a, **k):
        return orig(m, points, colors + 0.01, *a, **k)

    return {"unchanged": [(step, "slam_step", _unchanged_step)],
            "half_batch": [(step, "l1_loss", lambda orig, *a, **k: _half_image(orig)(*a, **k)),
                           (step, "ssim", lambda orig, *a, **k: _half_image(orig)(*a, **k))],
            "altered": [(gm, "add_points", altered_colors)],
            "track_unchanged": [(gicp, "gicp_align", lambda orig, *a, **k: orig(*a, **k)._replace(
                T=torch.eye(4, device=a[0].device)))]}


def _faults_replay():
    from sags_tpu_torch.slam import offline

    return {"unchanged": [(offline, "train_step",
                           lambda orig, st, *a, **k: (st, orig(st, *a, **k)[1]))],
            "half_batch": [(offline, "rgb_loss",
                            lambda orig, *a, **k: _half_image(orig)(*a, **k))],
            "altered": [(offline, "scale_init_from_points",
                         lambda orig, *a, **k: orig(*a, **k) + 0.01)]}


FAULTS = {"fast_livo2.stream": _faults_stream, "fast_livo2_offline.replay": _faults_replay}


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in (
    ("fast_livo2.stream", ("unchanged", "half_batch", "altered", "track_unchanged")),
    ("fast_livo2_offline.replay", ("unchanged", "half_batch", "altered"))) for f in fs])
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, name, fault):
    for owner, attr, fn in FAULTS[name]()[fault]:
        orig = getattr(owner, attr)
        monkeypatch.setattr(owner, attr, lambda *a, _o=orig, _f=fn, **k: _f(_o, *a, **k))
    out = _run(tiny_cell, name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["fast_livo2.stream", "fast_livo2_offline.replay"])
def test_the_control_is_not_correct(tiny_cell, name):
    """The TF32 control, through the harness's own verdict, fails the limits
    that the program's run meets (`control.py` on the card does the same)."""
    from benchmarks import control

    out = control.readings(tiny_cell(name), 2 ** 31 + 29, 1.0, CPU)
    assert out["program"]["correct"], out["program"]
    assert not out["control"]["correct"], out["control"]
