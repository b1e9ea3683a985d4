"""The benchmark is data: every cell names pieces that exist, and a new
cell, configuration or metric is found by adding files alone."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmarks.harness import spec, trace

HERE = spec.HERE


def test_every_cell_names_existing_pieces():
    bench = spec.benchmark()
    names = [w["name"] for w in bench["workloads"]]
    assert set(names) <= set(spec.cell_names())
    for name in spec.cell_names():  # those outside BENCHMARK.json wait for a fix
        cell = spec.load_cell(name)
        assert os.path.exists(os.path.join(HERE, "traffic", cell.traffic + ".py"))
        spec.load_module("traffic", cell.traffic)
        spec.slam_config(cell)  # every field the file writes is a field
        for m in spec.metrics_of(bench, name, "per_layer"):
            assert callable(spec.load_module("metrics", m["name"]).read)
        if name not in names:
            continue
        ends = spec.metrics_of(bench, name, "end_to_end")
        assert "setup_s" in [m["name"] for m in ends] and len(ends) >= 2
        assert spec.metrics_of(bench, name, "per_layer")
        assert cell.limits, f"{name} has no limits"


def test_benchmark_json_matches_the_files():
    bench = spec.benchmark()
    for c in bench["configs"]:
        data = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert (cell.config_name, cell.traffic, cell.chips, cell.why) == (
            w["config"], w["traffic"], w["chips"], w["why"])
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))


def test_a_dummy_cell_and_metric_added_as_files_are_found(tmp_path, monkeypatch):
    copy = tmp_path / "benchmarks"
    shutil.copytree(HERE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    w = json.loads((copy / "workloads" / "fast_livo2.stream.json").read_text())
    w["params"]["warm_frames"] = 1
    (copy / "workloads" / "fast_livo2.dummy.json").write_text(json.dumps(w))
    (copy / "configs" / "dummy_cfg.json").write_text(
        (copy / "configs" / "fast_livo2.json").read_text())
    (copy / "metrics" / "dummy_metric.stream.py").write_text(
        "def read(rec):\n    return 42.0\n")
    monkeypatch.setattr(spec, "HERE", str(copy))
    assert "fast_livo2.dummy" in spec.cell_names()
    cell = spec.load_cell("fast_livo2.dummy")
    assert cell.params["warm_frames"] == 1 and cell.traffic == "stream"
    assert spec.load_module("metrics", "dummy_metric.stream").read({}) == 42.0
    w["config"] = "dummy_cfg"
    (copy / "workloads" / "fast_livo2.dummy.json").write_text(json.dumps(w))
    assert spec.load_cell("fast_livo2.dummy").config_name == "dummy_cfg"


def test_a_missing_piece_is_named():
    with pytest.raises(FileNotFoundError, match="no cell"):
        spec.load_cell("no_such.cell")
    with pytest.raises(FileNotFoundError, match="no metrics module"):
        spec.load_module("metrics", "no_such_metric")


IMPORT_CHECK = """
import sys
sys.path.insert(0, {root!r})
import benchmarks.reference.render, benchmarks.reference.train, benchmarks.reference.track
import benchmarks.data.frames
from benchmarks.harness import device
top = {{m.split('.')[0] for m in sys.modules}}
assert 'sags_tpu_torch' not in top, 'the reference loaded the port'
assert not device.forbidden_modules()
from benchmarks.harness import spec
for kind in ('stream', 'replay'):
    spec.load_module('traffic', kind)
assert not device.forbidden_modules(), device.forbidden_modules()
print('ok')
"""


def test_import_guard():
    out = subprocess.run([sys.executable, "-c", IMPORT_CHECK.format(root=spec.ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    from benchmarks.harness import device

    monkeypatch.setitem(sys.modules, "sags_tpu_torch_lookalike", object())
    assert device.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sags_tpu.core", object())
    assert device.forbidden_modules() == ["sags_tpu.core"]


def test_trace_arithmetic_on_made_up_events():
    ops = [trace.DeviceOp("void composite_bwd_kernel<4>(float const*)", 0, 100),
           trace.DeviceOp("elementwise_kernel", 50, 100),  # overlaps the first
           trace.DeviceOp("Memcpy HtoD (Pinned -> Device)", 400, 100),
           trace.DeviceOp("fill_table_kernel", 700, 300)]
    assert trace.busy_intervals(ops) == [(0, 150), (400, 500), (700, 1000)]
    assert trace.busy_s(ops) == pytest.approx(550e-9)
    assert trace.launches(ops) == 3
    assert trace.kernel_seconds(ops, "composite_bwd_kernel") == pytest.approx(100e-9)
    ranges = [trace.DeviceOp("bin_gaussians", 100, 400), trace.DeviceOp("rasterize", 0, 1000)]
    gaps = dict((k, v) for k, v in trace.idle_gaps(ops, ranges))
    assert gaps == {"bin_gaussians": pytest.approx(250e-9), "rasterize": pytest.approx(200e-9)}
    top = trace.top_ops(ops)
    assert top[0] == ["fill_table_kernel", pytest.approx(300e-9)]
