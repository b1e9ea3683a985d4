"""`fast_livo2_sam_vit_h.stream` at a tiny size on the CPU, with ViT-H's
depth, heads and global blocks at a tenth of its width (16 heads of 8) on a
256 canvas, windows of 6 on the 16x16 grid (padded to 18x18): a sound run
comes out correct and reports its host-side reader and the encoder's spans
and counters; the TF32 control and an encoder broken underneath (the
relative-position terms dropped, the global blocks windowed, the padded
keys masked) do not. The encoder's work count equals
`torch.utils.flop_counter` on the reference encoder at the published
widths, so the roofline cannot read over 100% by a count too high."""

import subprocess
import sys
import time

import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from benchmarks import run as bench_run
from benchmarks.harness import sam_vit_h_work, spec
from benchmarks.harness import program_spans as ps
from benchmarks.reference import sam_vit_h as rvh

CPU = torch.device("cpu")
NAME = "fast_livo2_sam_vit_h.stream"
WINDOW = 6


@pytest.fixture
def cell(tiny_cell):
    c = tiny_cell(NAME)
    c.params.update(pool_frames=24, warm_frames=8, stretch_units=5)
    c.config["segmenter"]["architecture"].update(
        img_size=256, vit_embed_dim=128, vit_window_size=WINDOW, prompt_embed_dim=32,
        decoder_mlp_dim=64, iou_head_hidden_dim=32)
    return c


def _run(cell, traced=False):
    return bench_run.run(cell, 2 ** 31 + 61, 1.0, traced, CPU, time.perf_counter())


def test_sound_run_is_correct(cell):
    out = _run(cell, traced=True)
    assert out["correct"], out["checks"]
    assert {"sam_gap", "mask_gap", "assoc_gap", "loss_gap"} <= set(out["checks"])
    m = out["metrics"]
    # a CPU run has no CUDA events or device trace: the host-side reader reports
    assert m["mfu.semantic_vit_h"]["value"] > 0
    assert not {"sam_encode_roofline.semantic_vit_h", "sam_global_attn_device_ms.semantic_vit_h",
                "sam_window_attn_device_ms.semantic_vit_h"} & set(m)
    r = ps.records()
    assert r.count("segment") == r.count("sam.encode") == r.count("sam.encode.neck") == 1
    assert r.count("sam.encode.global_attn") == 4 and r.count("sam.encode.window_attn") == 28
    assert r.counter("sam.attn.global_tokens") == 4 * 16 * 16
    assert r.counter("sam.attn.pad_tokens") == 28 * (18 * 18 - 16 * 16)


def _no_rel_pos(attn, q, Rh, Rw, size):
    return attn


def _windowed_global(orig, ws):
    """`ViTBlock.forward` with each global block computed over windows of
    `ws`, its tables cut to their central 2·ws−1 rows (the offsets a window
    holds)."""
    from sags_tpu_torch.models import sam_vit as sv

    def forward(self, x):
        if self.window:
            return orig(self, x)
        a, G = self.attn, x.shape[1]
        saved = a.rel_pos_h, a.rel_pos_w, a.rel_idx
        rows = slice(G - ws, G + ws - 1)
        a.rel_pos_h, a.rel_pos_w = nn.Parameter(saved[0][rows]), nn.Parameter(saved[1][rows])
        a.rel_idx = sv.rel_pos_index(ws)
        self.window = ws
        try:
            return orig(self, x)
        finally:
            self.window = 0
            a.rel_pos_h, a.rel_pos_w, a.rel_idx = saved
    return forward


def _masking_padded_keys(monkeypatch):
    """The windowed blocks with their padded keys masked out of the softmax:
    `window_partition` notes which windowed tokens are padding, the next
    relative-position add fills their logits with -inf."""
    from sags_tpu_torch.models import sam_vit as sv

    pending = {}
    partition, add = sv.window_partition, sv.add_decomposed_rel_pos_

    def window_partition(x, ws):
        B, H, W, _ = x.shape
        real = torch.ones(B, H, W, 1, device=x.device)
        pending["pad"] = partition(real, ws)[0].reshape(-1, ws * ws) == 0
        return partition(x, ws)

    def add_decomposed_rel_pos_(attn, q, Rh, Rw, size):
        attn = add(attn, q, Rh, Rw, size)
        pad = pending.pop("pad", None)
        if pad is not None:
            heads = attn.shape[0] // pad.shape[0]
            attn.masked_fill_(pad.repeat_interleave(heads, 0)[:, None, :], float("-inf"))
        return attn

    monkeypatch.setattr(sv, "window_partition", window_partition)
    monkeypatch.setattr(sv, "add_decomposed_rel_pos_", add_decomposed_rel_pos_)


@pytest.mark.parametrize("fault", ["rel_pos_dropped", "global_windowed", "pad_masked"])
def test_a_broken_encoder_is_not_correct(cell, monkeypatch, fault):
    from sags_tpu_torch.models import sam_vit as sv

    if fault == "rel_pos_dropped":
        monkeypatch.setattr(sv, "add_decomposed_rel_pos_", _no_rel_pos)
    elif fault == "global_windowed":
        monkeypatch.setattr(sv.ViTBlock, "forward", _windowed_global(sv.ViTBlock.forward, WINDOW))
    else:
        _masking_padded_keys(monkeypatch)
    out = _run(cell)
    assert not out["correct"]
    bad = [k for k, t in out["checks"].items() if t["value"] is None or t["value"] > t["limit"]]
    assert bad == ["sam_gap", "mask_gap"], out["checks"]
    # each reads at least 100 times the limit: the tables' draw is large enough
    assert out["checks"]["sam_gap"]["value"] > 100 * cell.limits["sam_gap"], out["checks"]


def test_the_control_is_not_correct(cell):
    from benchmarks import control

    out = control.readings(cell, 2 ** 31 + 63, 1.0, CPU)
    assert out["program"]["correct"], out["program"]
    assert not out["control"]["correct"], out["control"]
    assert out["control"]["checks"]["sam_gap"]["value"] > cell.limits["sam_gap"]
    assert out["control"]["checks"]["mask_gap"]["value"] > cell.limits["mask_gap"]
    assert out["faults"]["assoc_gap.identity"] > 10 * cell.limits["assoc_gap"]


@pytest.mark.parametrize("img_size", [1024, 448])
def test_the_work_count_is_the_flop_counters(img_size):
    """On meta tensors (shapes alone) at the published widths: 2,980.5
    GMACs at 1024 (28 windowed blocks of 88.4, 4 global of 124.2, the patch
    embedding and the neck); at 448 the 28x28 grid pads to the same 28x28
    (no padding) and the global blocks attend over 784 tokens."""
    a = dict(spec.load_cell(NAME).config["segmenter"]["architecture"], img_size=img_size)
    p = {n: torch.empty(s, device="meta") for n, s, _ in rvh._shapes(a)}
    with FlopCounterMode(display=False) as fc:
        y = rvh.encode(p, a, torch.empty(1, 3, img_size, img_size, device="meta"))
    assert y.shape == (1, 256, img_size // 16, img_size // 16)
    assert sam_vit_h_work.encoder_work(a)["fp"] == fc.get_total_flops()
    if img_size == 1024:
        assert round(sam_vit_h_work.encoder_macs(a) / 1e8) == 29805
        assert round(sam_vit_h_work.block_macs(a, 14) / 1e8) == 884
        assert round(sam_vit_h_work.block_macs(a, 0) / 1e8) == 1242
        assert sam_vit_h_work.n_floats(a) == 637_026_048
        assert abs(sam_vit_h_work.encoder_least_s(a) - 0.08897) < 1e-5


def test_the_cell_is_in_the_benchmark():
    bench = spec.benchmark()
    w = {x["name"]: x for x in bench["workloads"]}[NAME]
    assert (w["config"], w["traffic"], w["chips"]) == ("fast_livo2_sam_vit_h",
                                                       "semantic_stream_vit_h", 1)
    ends = [m["name"] for m in spec.metrics_of(bench, NAME, "end_to_end")]
    assert ends == ["frame_ms", "setup_s"]
    layers = {m["name"] for m in spec.metrics_of(bench, NAME, "per_layer")}
    assert layers == {"sam_encode_roofline.semantic_vit_h",
                      "sam_global_attn_device_ms.semantic_vit_h",
                      "sam_window_attn_device_ms.semantic_vit_h", "mfu.semantic_vit_h"}
    assert spec.load_cell(NAME).config["reduced"] == []


IMPORT_CHECK = """
import sys
sys.path.insert(0, {root!r})
import benchmarks.reference.sam_vit_h, benchmarks.harness.sam_vit_h_work
assert not {{m.split('.')[0] for m in sys.modules}} & {{'sags_tpu_torch', 'sags_tpu', 'jax'}}
print('ok')
"""


def test_the_reference_imports_neither_the_port_nor_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_CHECK.format(root=spec.ROOT)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
