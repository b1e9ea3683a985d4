"""`fast_livo2_efficientvit_l2.stream` at a tiny size on the CPU, with L2's
depths, head dim and scales at a quarter of its widths on a 256 canvas: a
sound run comes out correct and reports its host-side readers and the
encoder's spans; the TF32 control and an encoder broken underneath (LiteMLA
without its ones-row normalisation, the neck's bicubic resize replaced by
nearest-neighbour sampling) do not. The encoder's work count equals
`torch.utils.flop_counter` on the reference encoder at the published
widths, so the roofline cannot read over 100% by a count too high."""

import subprocess
import sys
import time

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmarks import run as bench_run
from benchmarks.harness import efficientvit_work, spec
from benchmarks.harness import program_spans as ps
from benchmarks.reference import efficientvit_sam as rev

CPU = torch.device("cpu")
NAME = "fast_livo2_efficientvit_l2.stream"


@pytest.fixture
def cell(tiny_cell):
    c = tiny_cell(NAME)
    c.params.update(pool_frames=24, warm_frames=8, stretch_units=5)
    c.config["segmenter"]["architecture"].update(
        img_size=256, width_list=[8, 16, 32, 64, 128], neck_width=64, prompt_embed_dim=32,
        decoder_mlp_dim=64, iou_head_hidden_dim=32)
    return c


def _run(cell, traced=False):
    return bench_run.run(cell, 2 ** 31 + 51, 1.0, traced, CPU, time.perf_counter())


def test_sound_run_is_correct(cell):
    out = _run(cell, traced=True)
    assert out["correct"], out["checks"]
    assert {"sam_gap", "mask_gap", "assoc_gap", "loss_gap"} <= set(out["checks"])
    m = out["metrics"]
    # a CPU run has no CUDA events or device trace: the host-side reader reports
    assert m["mfu.semantic_l2"]["value"] > 0
    assert not {"sam_encode_roofline.semantic_l2", "sam_mla_device_ms.semantic_l2",
                "sam_neck_device_ms.semantic_l2"} & set(m)
    r = ps.records()
    assert r.count("segment") == r.count("sam.encode") == r.count("sam.encode.neck") == 1
    assert r.count("sam.encode.mla") == 8
    assert r.counter("sam.mla.tokens") == 8 * 8 * 8  # the last stage's 8x8 grid


def _no_normalisation(qkv, dim, eps=1e-15):
    """LiteMLA's attention with the ones row's sum left out."""
    B, _, H, W = qkv.shape
    qkv = qkv.reshape(B, -1, 3 * dim, H * W)
    q, k, v = F.relu(qkv[:, :, :dim]), F.relu(qkv[:, :, dim:2 * dim]), qkv[:, :, 2 * dim:]
    return ((v @ k.transpose(-1, -2)) @ q).reshape(B, -1, H, W)


def _nearest(x, size):
    return F.interpolate(x, (size, size), mode="nearest")


@pytest.mark.parametrize("fault", ["normalisation", "resize"])
def test_a_broken_encoder_is_not_correct(cell, monkeypatch, fault):
    from sags_tpu_torch.models import efficientvit_sam as evs

    if fault == "normalisation":
        monkeypatch.setattr(evs, "relu_linear_attention", _no_normalisation)
    else:
        monkeypatch.setattr(evs, "resize", _nearest)
    out = _run(cell)
    assert not out["correct"]
    bad = [k for k, t in out["checks"].items() if t["value"] is None or t["value"] > t["limit"]]
    assert bad == ["sam_gap", "mask_gap"], out["checks"]


def test_the_control_is_not_correct(cell):
    from benchmarks import control

    out = control.readings(cell, 2 ** 31 + 53, 1.0, CPU)
    assert out["program"]["correct"], out["program"]
    assert not out["control"]["correct"], out["control"]
    assert out["control"]["checks"]["sam_gap"]["value"] > cell.limits["sam_gap"]
    assert out["control"]["checks"]["mask_gap"]["value"] > cell.limits["mask_gap"]
    assert out["faults"]["assoc_gap.identity"] > 10 * cell.limits["assoc_gap"]


@pytest.mark.parametrize("img_size", [1024, 512])
def test_the_work_count_is_the_flop_counters(img_size):
    """On meta tensors (shapes alone) at the published widths: 176.8
    GMACs at 1024; 44.2 at 512, where the published neck, fixed at 64x64,
    would add the 24.4 GMACs that bring it to the paper's 69."""
    a = dict(spec.load_cell(NAME).config["segmenter"]["architecture"], img_size=img_size)
    p = {n: torch.empty(s, device="meta") for n, s, _ in rev._shapes(a)}
    with FlopCounterMode(display=False) as fc:
        y = rev.encode(p, a, torch.empty(1, 3, img_size, img_size, device="meta"))
    assert y.shape == (1, 256, img_size // 16, img_size // 16)
    assert efficientvit_work.encoder_work(a)["fp"] == fc.get_total_flops()
    assert round(efficientvit_work.encoder_macs(a) / 1e8) == {1024: 1768, 512: 442}[img_size]


def test_the_cell_is_in_the_benchmark():
    bench = spec.benchmark()
    w = {x["name"]: x for x in bench["workloads"]}[NAME]
    assert (w["config"], w["traffic"], w["chips"]) == ("fast_livo2_efficientvit_l2",
                                                       "semantic_stream_l2", 1)
    ends = [m["name"] for m in spec.metrics_of(bench, NAME, "end_to_end")]
    assert ends == ["frame_ms", "setup_s"]
    layers = {m["name"] for m in spec.metrics_of(bench, NAME, "per_layer")}
    assert layers == {"sam_encode_roofline.semantic_l2", "sam_mla_device_ms.semantic_l2",
                      "sam_neck_device_ms.semantic_l2", "mfu.semantic_l2"}
    assert spec.load_cell(NAME).config["reduced"] == []


IMPORT_CHECK = """
import sys
sys.path.insert(0, {root!r})
import benchmarks.reference.efficientvit_sam, benchmarks.harness.efficientvit_work
assert not {{m.split('.')[0] for m in sys.modules}} & {{'sags_tpu_torch', 'sags_tpu', 'jax'}}
print('ok')
"""


def test_the_reference_imports_neither_the_port_nor_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_CHECK.format(root=spec.ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
