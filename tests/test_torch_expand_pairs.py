"""The classic binning's pair expansion, `binning.expand_pairs`: the wrapper's
contract on the CPU (it takes the plain version there, and raises on inputs
the kernel does not take), and the plain version against a frozen copy of
the loop `rasterize.sort_pairs` ran before the expansion moved into
`ops/binning.py`: its live keys in the loop's order, their count, and
`sort_pairs` / `bin_gaussians` over them, on a scene with every case and on
the two edges (no live pair; every slot live over its whole window).
`tests/test_torch_cuda.py` holds the CUDA kernel against the plain version
on the card, on this file's `pair_scene` and `edge_scene`. CPU only, no
JAX."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.core.config import RasterizeConfig
from sags_tpu_torch.ops import binning
from sags_tpu_torch.ops import rasterize as rz

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

W, H = 200, 120  # 13 x 8 tiles of 16: rects wider than R = 8 fit
TILES_X, TILES_Y = 13, 8
P = 1237  # not a multiple of the kernel's 256-thread block


def pair_scene(seed, device, max_tiles=36, n=P):
    """(Preprocessed, cfg) of a seeded scene with every case the expansion
    meets: slots behind the camera and slots outside the active mask
    (invalid), rects clipped at the image's edges, rects wider and taller
    than R tiles (overflow), and opacities at `alpha_min` (gate level 0)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 8.0, n)
    z[rng.random(n) < 0.08] = rng.uniform(-2.0, 0.1)  # behind the near plane
    tx, ty = math.tan(0.6), math.tan(0.4)
    means = np.stack([rng.uniform(-1.3, 1.3, n) * tx * np.abs(z),
                      rng.uniform(-1.3, 1.3, n) * ty * np.abs(z), z], -1)
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.15), (n, 3)))
    big = rng.random(n) < 0.05
    scales[big] = rng.uniform(0.6, 2.0, (int(big.sum()), 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.02, 0.98, n).astype(np.float32)
    cfg = RasterizeConfig(max_tiles_per_gaussian=max_tiles, tile_capacity=64, chunk=32)
    opac[rng.random(n) < 0.05] = np.float32(cfg.alpha_min)
    active = rng.random(n) >= 0.1
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device),
                      W, H, 1.2, 0.8)
    pre = rz.preprocess(t(means), t(opac), t(scales), t(quats), cam, cfg,
                        colors=t(rng.uniform(0, 1, (n, 3))),
                        active_mask=t(active, torch.bool))
    return pre, cfg


def edge_scene(kind, device, max_tiles=36, n=300):
    """(Preprocessed, cfg) of `pair_scene` with one edge forced: "none", no
    slot valid (no live pair); "full", every slot valid over the whole image
    (rects of 13 x 8 tiles, wider than every R up to 8) with a nearly flat
    conic that passes the gate on every tile, so every slot is live at every
    one of the R×R offsets (and overflows the window)."""
    pre, cfg = pair_scene(4, device, max_tiles, n)
    if kind == "none":
        return pre._replace(valid=torch.zeros_like(pre.valid)), cfg
    assert kind == "full", kind
    full = lambda t, v: torch.full_like(t, v)
    return pre._replace(valid=torch.ones_like(pre.valid), rmin_x=full(pre.rmin_x, 0),
                        rmin_y=full(pre.rmin_y, 0), rmax_x=full(pre.rmax_x, TILES_X),
                        rmax_y=full(pre.rmax_y, TILES_Y), ca=full(pre.ca, 1e-8),
                        cb=full(pre.cb, 0.0), cc=full(pre.cc, 1e-8),
                        opacity=full(pre.opacity, 0.9)), cfg


def live_keys(keys):
    """The frozen loop's live keys, in its order: those whose tile < NT."""
    return keys[(keys >> 48) < TILES_X * TILES_Y]


def frozen_loop(pre, tiles_x, tiles_y, cfg):
    """The expansion as `rasterize.sort_pairs` ran it before it moved into
    `binning.expand_pairs_plain`, up to the sort: (combined keys int64
    [MT·P], overflow_rect). Frozen here; do not edit."""
    P = pre.mx.shape[0]
    dev = pre.mx.device
    MT = cfg.max_tiles_per_gaussian
    R = int(round(MT ** 0.5))
    NT = tiles_x * tiles_y
    rect_w = pre.rmax_x - pre.rmin_x
    rect_h = pre.rmax_y - pre.rmin_y
    n_rect = rect_w * rect_h
    covered = torch.clamp(rect_w, max=R) * torch.clamp(rect_h, max=R)
    overflow_rect = torch.sum(torch.where(pre.valid, n_rect - covered,
                                          torch.zeros_like(n_rect))).to(torch.int32)
    dq = rz._depth_quant(pre)
    T = float(cfg.tile)
    mx, my = pre.mx.detach(), pre.my.detach()
    qa, qb, qc = pre.ca.detach(), pre.cb.detach(), pre.cc.detach()
    c2 = binning.cull_c2(pre.opacity, cfg.alpha_min)
    keys = []
    for j in range(MT):
        dx_j, dy_j = j % R, j // R
        ok = pre.valid & (dx_j < rect_w) & (dy_j < rect_h)
        tx = pre.rmin_x + dx_j
        ty = pre.rmin_y + dy_j
        ok = ok & (binning.tile_qmin(qa, qb, qc, mx, my, tx, ty, T) <= c2)
        tile_id = ty * tiles_x + tx
        keys.append(torch.where(ok, (tile_id << 16) | dq,
                                torch.full_like(dq, NT << 16)))
    key = torch.stack(keys, 0).reshape(-1).to(torch.int64)
    gid = torch.arange(P, device=dev, dtype=torch.int64).repeat(MT)
    return (key << 32) | gid, overflow_rect


def scene_cases(pre, cfg, keys):
    """How many slots of each case the scene holds, and its live pairs
    (`keys`: the live keys, in any order)."""
    R = binning.offset_window(cfg.max_tiles_per_gaussian)
    w, h = pre.rmax_x - pre.rmin_x, pre.rmax_y - pre.rmin_y
    v = pre.valid
    at_gate = v & (pre.opacity == torch.tensor(cfg.alpha_min, dtype=torch.float32))
    live_slot = torch.zeros_like(v)
    live_slot[keys & 0xFFFFFFFF] = True
    return {"invalid": int((~v).sum()),
            "clipped": int((v & ((pre.rmin_x == 0) | (pre.rmin_y == 0)
                                 | (pre.rmax_x == TILES_X) | (pre.rmax_y == TILES_Y))).sum()),
            "over_R": int((v & ((w > R) | (h > R))).sum()),
            "at_gate": int(at_gate.sum()),
            "at_gate_live": int((at_gate & live_slot).sum()),
            "live": int(keys.numel())}


@pytest.mark.parametrize("max_tiles", [16, 36])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_expansion_equals_the_frozen_loop(seed, max_tiles):
    """Bit for bit on a scene holding every case: the live keys in the
    loop's order, their count, and the overflow."""
    pre, cfg = pair_scene(seed, "cpu", max_tiles)
    want, want_ov = frozen_loop(pre, TILES_X, TILES_Y, cfg)
    got, n_live, got_ov = binning.expand_pairs_plain(pre, rz._depth_quant(pre), TILES_X,
                                                     TILES_Y, cfg)
    assert got.dtype == torch.int64 and got.shape == (int(n_live),)
    assert n_live.dtype == torch.int32 and n_live.shape == ()
    assert torch.equal(got, live_keys(want)) and torch.equal(got_ov, want_ov)
    cases = scene_cases(pre, cfg, got)
    assert int(got_ov) > 0 and cases["live"] > 0, cases
    assert all(v > 0 for v in cases.values()), cases


@pytest.mark.parametrize("max_tiles", [16, 36, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_count_is_the_frozen_loops_live_keys(seed, max_tiles):
    """`n_live` is the number of the frozen loop's keys whose tile < NT, and
    `keys` is no longer than that."""
    pre, cfg = pair_scene(seed + 10, "cpu", max_tiles)
    want, _ = frozen_loop(pre, TILES_X, TILES_Y, cfg)
    keys, n_live, _ = binning.expand_pairs_plain(pre, rz._depth_quant(pre), TILES_X,
                                                 TILES_Y, cfg)
    n = int(((want >> 48) < TILES_X * TILES_Y).sum())
    assert int(n_live) == n == keys.shape[0] and 0 < n < max_tiles * P


def test_cpu_tensors_take_the_plain_version():
    pre, cfg = pair_scene(2, "cpu")
    dq = rz._depth_quant(pre)
    before = binning.EXPAND.launches
    got, n_live, ov = binning.expand_pairs(pre, dq, TILES_X, TILES_Y, cfg)
    want, want_n, want_ov = binning.expand_pairs_plain(pre, dq, TILES_X, TILES_Y, cfg)
    assert binning.EXPAND.launches == before
    assert torch.equal(got, want) and torch.equal(n_live, want_n) and torch.equal(ov, want_ov)
    assert ov.dtype == torch.int32 and ov.shape == ()


def check_sort_pairs(pre, cfg):
    """`sort_pairs` and `bin_gaussians` against the frozen loop's keys:
    `gid_s` is the live prefix of their sort (n_binned long), `starts` cuts
    it into tiles, the table is filled from it. Returns n_binned."""
    keys, ov = frozen_loop(pre, TILES_X, TILES_Y, cfg)
    combined = torch.sort(keys).values
    NT = TILES_X * TILES_Y
    n = int(((keys >> 48) < NT).sum())
    gid_s, starts, ov_rect = rz.sort_pairs(pre, TILES_X, TILES_Y, cfg)
    assert torch.equal(gid_s, (combined[:n] & 0xFFFFFFFF).to(torch.int32))
    bounds = torch.arange(NT + 1, dtype=torch.int32) << 16
    assert torch.equal(starts, torch.searchsorted((combined >> 32).to(torch.int32), bounds,
                                                  out_int32=True))
    assert torch.equal(ov_rect, ov)
    table, counts, n_binned, ov_b, _, _ = rz.bin_gaussians(pre, TILES_X, TILES_Y, cfg)
    assert torch.equal(table, binning.fill_table_plain(gid_s, starts, NT, cfg.tile_capacity))
    assert int(n_binned) == n and torch.equal(ov_b, ov)
    return n, table, counts


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_pairs_sorts_the_expansion(seed):
    """`sort_pairs` and `bin_gaussians` on the CPU: the frozen loop's keys
    sorted and cut at n_binned, cut into tiles, and the table filled from
    them."""
    pre, cfg = pair_scene(seed, "cpu")
    n, _, _ = check_sort_pairs(pre, cfg)
    assert 0 < n < cfg.max_tiles_per_gaussian * P


@pytest.mark.parametrize("max_tiles", [16, 64])
@pytest.mark.parametrize("kind", ["none", "full"])
def test_sort_pairs_at_the_edges(kind, max_tiles):
    """No live pair: n_binned 0, an empty `gid_s` and an all -1 table.
    Every slot live over its whole window: n_binned = MT·P."""
    pre, cfg = edge_scene(kind, "cpu", max_tiles)
    n, table, counts = check_sort_pairs(pre, cfg)
    P_edge = pre.mx.shape[0]
    if kind == "none":
        assert n == 0 and int(counts.sum()) == 0
        assert torch.equal(table, torch.full_like(table, -1))
    else:
        assert n == max_tiles * P_edge and int(counts.sum()) > 0


def test_traced_bin_counts_its_pairs_and_one_sync():
    """Under tracing a classic bin counts its live pairs (`bin.pairs`, equal
    to n_binned), its slots × offsets (`bin.slots`), and one host sync
    against `raster.bin`: the live count's read."""
    from torch.profiler import ProfilerActivity, profile

    from sags_tpu_torch.utils import profiling

    pre, cfg = pair_scene(6, "cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        n_binned = rz.bin_gaussians(pre, TILES_X, TILES_Y, cfg)[2]
    rec = profiling.records()
    assert rec.counter("bin.pairs") == int(n_binned) > 0
    assert rec.counter("bin.slots") == cfg.max_tiles_per_gaussian * P
    assert [r.syncs for r in rec.named("raster.bin")] == [1]


def _fault(pre, cfg, dq, fault):
    """Inputs with one fault: (pre, cfg, dq, tiles_x)."""
    if fault == "non_square":
        return pre, dataclasses.replace(cfg, max_tiles_per_gaussian=32), dq, TILES_X
    if fault == "too_many_tiles":
        return pre, cfg, dq, 1 << 15
    if fault == "float64_opacity":
        return pre._replace(opacity=pre.opacity.double()), cfg, dq, TILES_X
    if fault == "int64_rect":
        return pre._replace(rmin_x=pre.rmin_x.long()), cfg, dq, TILES_X
    if fault == "uint8_valid":
        return pre._replace(valid=pre.valid.to(torch.uint8)), cfg, dq, TILES_X
    if fault == "int64_dq":
        return pre, cfg, dq.long(), TILES_X
    if fault == "short_column":
        return pre._replace(cc=pre.cc[:-1]), cfg, dq, TILES_X
    if fault == "two_devices":
        return pre._replace(rmax_y=pre.rmax_y.to("meta")), cfg, dq, TILES_X
    raise AssertionError(fault)


@pytest.mark.parametrize("fault, error", [
    ("non_square", ValueError), ("too_many_tiles", ValueError),
    ("float64_opacity", TypeError), ("int64_rect", TypeError),
    ("uint8_valid", TypeError), ("int64_dq", TypeError),
    ("short_column", ValueError), ("two_devices", ValueError)])
def test_wrapper_raises_on_inputs_the_kernel_does_not_take(fault, error):
    """Checked before the device decides: the CPU raises as the card does."""
    pre, cfg = pair_scene(3, "cpu", n=300)
    pre, cfg, dq, tiles_x = _fault(pre, cfg, rz._depth_quant(pre), fault)
    with pytest.raises(error):
        binning.expand_pairs(pre, dq, tiles_x, TILES_Y, cfg)


@pytest.mark.parametrize("max_tiles", [289, 324])
def test_config_refuses_a_window_wider_than_the_kernel(max_tiles):
    """More than 16 x 16 offsets fails where the configuration is built, on
    the CPU too, not at the card's first classic bin."""
    with pytest.raises(ValueError, match="at most 256"):
        RasterizeConfig(max_tiles_per_gaussian=max_tiles)
    with pytest.raises(ValueError, match="at most 256"):
        dataclasses.replace(RasterizeConfig(), max_tiles_per_gaussian=max_tiles)
    assert RasterizeConfig(max_tiles_per_gaussian=256).max_tiles_per_gaussian == 256
