"""The rasterizer's preprocess kernel pair (`csrc/preprocess.cu`): its routing
and its wrapper's contract on the CPU. `rasterize.project` takes the plain
`preprocess` for CPU tensors and `preprocess_kernel` for tensors on the card,
whatever the call: the kernel pair runs the geometry, and the colour that it
does not make (`colors`, SH above degree 0, none) is made beside it as the
plain version makes it. The wrapper raises on inputs the kernel does not
take, before any launch. `tests/test_torch_cuda.py` holds the kernels
against the plain version on the card, on this file's `preprocess_scene`,
and against the JAX package's outputs stored in
`tests/data/preprocess_jax.npz` (`test_torch_kernels.py` checks that file).
CPU only, no JAX."""

import math
import os

import numpy as np
import pytest
import torch

from sags_tpu_torch.core.camera import make_camera
from sags_tpu_torch.core.config import RasterizeConfig
from sags_tpu_torch.ops import rasterize as rz

torch.set_num_threads(1)  # one intra-op thread per test process: see test_torch_core.py

W, H = 96, 64
P = 2345  # not a multiple of the kernels' 256-thread block
SAFE_Z_SLOT = 40  # the slot at depth 0
DIFF = ("mx", "my", "depth", "ca", "cb", "cc", "czx", "cyz", "color")


COLOUR_DRAWS = {"sh1": "sh4", "none": "sh"}  # the draws a scene's colour leaf takes


def preprocess_scene(seed, device, colour="sh", n=P, scales=(0.03, 0.2)):
    """(camera, leaves, active mask) of a seeded scene with every branch the
    projection takes: means beyond the 1.3·tan(fov) clamp on both axes,
    slots behind the near plane, one at depth 0 (|depth| < 1e-6: `safe_z`),
    three with zero scales (Σ3D = 0: det = 0 without the low-pass), quaternions
    of norms 0.5-2, negative SH degree-0 colours (clamped), 10% of the slots
    outside the active mask, and a zero `mean2d_offset` probe. The camera is
    turned about two axes. `leaves` require grad: means3d, opacities, scales,
    quats, the colour input (`colour`: "sh" [P,3,1], "sh4" [P,3,4] at degree
    0, "sh1" [P,3,4] at degree 1, "colors" [P,3], or "none", whose leaf no
    call takes) and mean2d_offset. Scales span `scales`, by default
    0.03-0.2 (at most 6.7:1): float32 gradients of needle-thin splats depend
    on the order of their operations (`test_torch_cuda.py`,
    `test_preprocess_kernel_gradients_on_thin_splats`)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(1.0, 6.0, n)
    x = rng.uniform(-0.9, 0.9, n) * z
    y = rng.uniform(-0.8, 0.8, n) * z
    x[:20] *= 3.0  # beyond the clamp, both axes
    y[10:30] *= -3.0
    z[30:40] = rng.uniform(-2.0, 0.15, 10)  # behind the near plane
    z[SAFE_Z_SLOT] = 0.0
    lo, hi = scales
    scales = np.exp(rng.uniform(np.log(lo), np.log(hi), (n, 3)))
    scales[50:53] = 0.0
    quats = rng.normal(size=(n, 4)) * rng.uniform(0.5, 2.0, (n, 1))
    a, b = 0.3, 0.2
    Ry = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]])
    Rx = np.array([[1, 0, 0], [0, math.cos(b), -math.sin(b)], [0, math.sin(b), math.cos(b)]])
    R, t = Ry @ Rx, np.array([0.3, -0.2, 0.1])
    means = np.stack([x, y, z], -1) @ R.T + t  # placed in the camera's frame

    def leaf(arr):
        return torch.tensor(np.asarray(arr, np.float32), device=device, requires_grad=True)

    colour_in = {"sh": rng.normal(0.0, 1.2, (n, 3, 1)),
                 "sh4": rng.normal(0.0, 1.2, (n, 3, 4)),
                 "colors": rng.uniform(0.0, 1.0, (n, 3))}[COLOUR_DRAWS.get(colour, colour)]
    leaves = {"means3d": leaf(means), "opacities": leaf(rng.uniform(0.01, 0.99, n)),
              "scales": leaf(scales), "quats": leaf(quats), "colour": leaf(colour_in),
              "mean2d_offset": leaf(np.zeros((n, 2)))}
    cam = make_camera(torch.tensor(R, dtype=torch.float32, device=device),
                      torch.tensor(t, dtype=torch.float32, device=device), W, H, 1.1, 0.8)
    active = torch.tensor(rng.uniform(size=n) > 0.1, device=device)
    return cam, leaves, active


def colour_kw(colour, leaves):
    """The colour arguments of a scene's `colour`: "sh1" takes its [P,3,4]
    coefficients at SH degree 1, "none" gives no colour input."""
    if colour == "none":
        return {}
    if colour == "colors":
        return {"colors": leaves["colour"]}
    return {"shs": leaves["colour"], "sh_degree": int(colour == "sh1")}


def run_project(fn, cam, leaves, active, cfg, colour="sh"):
    """`fn` (`rz.project` or `rz.preprocess`) over a scene's leaves."""
    L = leaves
    return fn(L["means3d"], L["opacities"], L["scales"], L["quats"], cam, cfg,
              active_mask=active, mean2d_offset=L["mean2d_offset"], **colour_kw(colour, L))


# The JAX package's `preprocess` and its VJP on `preprocess_scene(REF_SEED,
# n=REF_N)` at the default config, computed on the CPU by
# `test_torch_kernels.jax_preprocess_reference`, which also writes the file:
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_kernels.py
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "preprocess_jax.npz")
REF_SEED, REF_N = 5, 600
REF_OUTPUTS = ("mx", "my", "depth", "ca", "cb", "cc", "czx", "cyz", "color", "rcull2",
               "radius", "rmin_x", "rmin_y", "rmax_x", "rmax_y", "valid", "clamped")


def reference_inputs(cam, leaves, active):
    """The arrays the JAX reference is taken on, by name: the leaves, the
    active mask and upstream gradients of the differentiable outputs (seeded;
    zero at the depth-0 slot, whose gradients reach ~1e16)."""
    out = {k: v.detach().cpu().numpy() for k, v in leaves.items()}
    out["active"] = active.cpu().numpy()
    out["cam_R"] = cam.world_view[:3, :3].T.cpu().numpy()
    out["cam_t"] = cam.cam_center.cpu().numpy()
    rng = np.random.default_rng(REF_SEED + 100)
    n = out["means3d"].shape[0]
    for k in DIFF:
        up = rng.normal(size=(n, 3) if k == "color" else (n,)).astype(np.float32)
        up[SAFE_Z_SLOT] = 0.0
        out["up_" + k] = up
    return out


def reference_grads(pre, leaves, ref):
    """Gradients of Σ_k pre.k · up_k (the reference's upstream), by leaf."""
    dev = pre.mx.device
    loss = sum((getattr(pre, k) * torch.as_tensor(ref["up_" + k], device=dev)).sum()
               for k in DIFF)
    gs = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return {k: torch.zeros_like(x) if g is None else g
            for (k, x), g in zip(leaves.items(), gs)}


def assert_near_reference(pre, grads, ref):
    """A `Preprocessed` and its gradients against the JAX package's: integers
    and flags exactly; each float within 1e-6 of its column's scale over the
    slots but the depth-0 one, plus 1e-6 of its value (another order of the
    same float32 operations); each gradient within 1e-6 of its leaf's norm."""
    bulk = np.ones(pre.mx.shape[0], bool)
    bulk[SAFE_Z_SLOT] = False
    for k in REF_OUTPUTS:
        got, want = getattr(pre, k).detach().cpu().numpy(), ref[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if want.dtype.kind != "f":
            assert np.array_equal(got, want), (k, np.flatnonzero(got != want)[:8])
            continue
        tol = 1e-6 * (np.abs(want[bulk]).max() + np.abs(want))
        assert np.all(np.abs(got - want) <= tol), (k, float(np.abs(got - want).max()))
    for k, g in grads.items():
        want = ref["grad_" + k]
        gap = float(np.abs(g.detach().cpu().numpy() - want).max())
        assert gap <= 1e-6 * float(np.linalg.norm(want)), (k, gap)


def launches():
    return rz.PREPROCESS.launches, rz.PREPROCESS_BWD.launches


def test_cpu_tensors_take_the_plain_path():
    """On the CPU `project` is `preprocess` bit for bit, forward and backward,
    and no kernel launches."""
    cam, leaves, active = preprocess_scene(0, "cpu")
    cfg = RasterizeConfig()
    before = launches()
    got = run_project(rz.project, cam, leaves, active, cfg)
    want = run_project(rz.preprocess, cam, leaves, active, cfg)
    for name in rz.Preprocessed._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    up = {k: torch.randn(getattr(want, k).shape, generator=torch.Generator().manual_seed(1))
          for k in DIFF}
    grads = [torch.autograd.grad(sum((getattr(o, k) * up[k]).sum() for k in DIFF),
                                 list(leaves.values()), allow_unused=True) for o in (got, want)]
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)
    assert launches() == before


ROUTES = {"colors": ("colors", "kernel"), "sh": ("sh", "kernel_sh0"),
          "sh4": ("sh4", "kernel_sh0"), "sh_degree_1": ("sh1", "kernel"),
          "no_colour": ("none", "kernel"), "cov3d_precomp": ("sh", "raises"),
          "camera_grad": ("sh", "raises")}  # case: (the scene's colour, the route)


def _plain_kernel(cam, cfg, calls):
    """`_PreprocessFn` as the plain version computes it: on the CPU this
    stands in for the kernel pair, whose outputs are the plain version's."""

    def apply(means3d, scales, quats, shs, mean2d_offset, opacities, active_mask, V, M,
              meta):
        calls.append(shs)
        pre = rz.preprocess(means3d, opacities, scales, quats, cam, cfg, shs=shs,
                            active_mask=active_mask, mean2d_offset=mean2d_offset)
        return (*pre[:8], None if shs is None else pre.color, pre.rcull2, pre.radius,
                pre.rmin_x, pre.rmin_y, pre.rmax_x, pre.rmax_y, pre.valid, pre.clamped)

    return type("PlainFn", (), {"apply": staticmethod(apply)})


@pytest.mark.parametrize("case", list(ROUTES))
def test_project_routes_by_what_the_call_can_see(case, monkeypatch):
    """With every tensor taken as on the card, `project` takes the kernel
    pair for every call (stood in for by the plain version) and hands it the
    SH coefficients at degree 0 only; the colour of `colors`, of SH degree 1
    and of a call with neither is made beside it, so the outputs and
    gradients are the plain version's. A precomputed Σ3D and a camera that
    takes gradients raise. No kernel launches."""
    colour, route = ROUTES[case]
    cam, leaves, active = preprocess_scene(1, "cpu", colour=colour, n=300)
    cfg = RasterizeConfig()
    kw = colour_kw(colour, leaves)
    if case == "cov3d_precomp":
        kw["cov3d_precomp"] = torch.eye(3).expand(300, 3, 3) * 0.01
    if case == "camera_grad":
        cam.world_view = cam.world_view.clone().requires_grad_(True)
    L = leaves
    args = (L["means3d"], L["opacities"], L["scales"], L["quats"], cam, cfg)
    kw.update(active_mask=active, mean2d_offset=L["mean2d_offset"])
    want = None if route == "raises" else rz.preprocess(*args, **kw)
    calls = []
    monkeypatch.setattr(rz, "_PreprocessFn", _plain_kernel(cam, cfg, calls))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    before = launches()
    if want is None:
        with pytest.raises(ValueError):
            rz.project(*args, **kw)
        assert not calls and launches() == before
        return
    got = rz.project(*args, **kw)
    monkeypatch.undo()
    assert len(calls) == 1 and (calls[0] is L["colour"]) == (route == "kernel_sh0")
    for name in rz.Preprocessed._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.opacity is L["opacities"] and (case != "colors" or got.color is L["colour"])
    up = {k: torch.randn(getattr(want, k).shape, generator=torch.Generator().manual_seed(2))
          for k in DIFF}
    grads = [torch.autograd.grad(sum((getattr(o, k) * up[k]).sum() for k in DIFF),
                                 list(leaves.values()), allow_unused=True) for o in (got, want)]
    for name, a, b in zip(leaves, *grads):
        assert (a is None and b is None) or torch.equal(a, b), name
    assert launches() == before


def _bad_inputs(case):
    cam, leaves, active = preprocess_scene(2, "cpu", n=300)
    args = {k: v.detach() for k, v in leaves.items()}
    kw = {}
    if case == "float64_means":
        args["means3d"] = args["means3d"].double()
    elif case == "noncontiguous_quats":
        args["quats"] = args["quats"].t().contiguous().t()
    elif case == "mismatched_scales":
        args["scales"] = torch.cat([args["scales"], args["scales"][:1]])
    elif case == "mismatched_offset":
        args["mean2d_offset"] = args["mean2d_offset"][:-1]
    elif case == "int_active":
        active = active.to(torch.int32)
    elif case == "cov3d_precomp":
        kw["cov3d_precomp"] = torch.eye(3).expand(300, 3, 3) * 0.01
    elif case == "camera_grad":
        cam.world_view = cam.world_view.clone().requires_grad_(True)
    return cam, args, active, kw


BAD = {"float64_means": (TypeError, "means3d must be float32"),
       "noncontiguous_quats": (ValueError, "quats must be contiguous"),
       "mismatched_scales": (ValueError, "scales must be"),
       "mismatched_offset": (ValueError, "mean2d_offset must be"),
       "int_active": (TypeError, "active_mask must be bool"),
       "cov3d_precomp": (ValueError, "takes no cov3d_precomp"),
       "on_the_cpu": (ValueError, "one CUDA device"),
       "camera_grad": (ValueError, "gradient of the camera")}


@pytest.mark.parametrize("case", list(BAD))
def test_kernel_wrapper_raises_on_inputs_it_does_not_take(case):
    """Wrong dtype, a non-contiguous input, a P that disagrees, a precomputed
    Σ3D, CPU tensors and a camera that takes gradients each raise before any
    launch."""
    cam, a, active, kw = _bad_inputs(case)
    before = launches()
    with pytest.raises(BAD[case][0], match=BAD[case][1]):
        rz.preprocess_kernel(a["means3d"], a["opacities"], a["scales"], a["quats"], cam,
                             RasterizeConfig(), shs=a["colour"], active_mask=active,
                             mean2d_offset=a["mean2d_offset"], **kw)
    assert launches() == before


def test_consts_are_rounded_as_pytorch_rounds_them():
    """Each scalar as PyTorch rounds a Python number to float32; a divisor as
    its reciprocal taken in double, then rounded, which PyTorch's CUDA
    division by a Python scalar multiplies by (not the reciprocal of the
    rounded divisor)."""
    cam, _, _ = preprocess_scene(3, "cpu", n=64)
    cfg = RasterizeConfig(tile=16, alpha_min=1.0 / 255.0, low_pass=0.3, near=0.2)
    c = list(rz._preprocess_consts(cam, cfg))
    f = np.float32
    assert c[:9] == [float(f(v)) for v in (W, H, cam.focal_x, cam.focal_y,
                                          1.3 * cam.tan_fovx, 1.3 * cam.tan_fovy, 0.2, 0.3,
                                          1.0)]
    assert c[9] == float(f(1.0 / cfg.alpha_min)) != float(f(1.0) / f(cfg.alpha_min))
    assert c[10:] == [16.0, 0.0625, float(f(0.28209479177387814))]
