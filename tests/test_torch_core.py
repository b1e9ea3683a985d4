"""Port parity: `sags_tpu_torch.core` (config, transforms, camera, SH) against
`sags_tpu.core`, and the port's import and device rules."""

import dataclasses
import subprocess
import sys
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sags_tpu.core import camera as jcam
from sags_tpu.core import config as jconf
from sags_tpu.core import sh as jsh
from sags_tpu.core import transforms as jtf
import sags_tpu_torch
from sags_tpu_torch.core import camera as tcam
from sags_tpu_torch.core import config as tconf
from sags_tpu_torch.core import sh as tsh
from sags_tpu_torch.core import transforms as ttf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quats(rng, n=64):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_import_leaves_jax_unloaded():
    """conftest imports JAX in this process, so check in a fresh one."""
    code = ("import sys; import sags_tpu_torch.slam.pipeline, sags_tpu_torch.interop; "
            "import sags_tpu_torch.ops.rasterize; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'flax', 'optax', 'sags_tpu.'))]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        sags_tpu_torch.resolve_device(None)
    assert sags_tpu_torch.resolve_device("cpu").type == "cpu"


def test_config_copy_matches():
    assert dataclasses.asdict(tconf.SLAMConfig()) == dataclasses.asdict(jconf.SLAMConfig())
    for name in jconf.PRESETS:
        assert dataclasses.asdict(tconf.preset(name)) == dataclasses.asdict(jconf.preset(name))


@pytest.mark.parametrize("step", [0, 1, 7, 250, 9999, 20000])
def test_expon_lr_matches(step):
    kw = dict(lr_init=4e-6, lr_final=4e-7, lr_delay_steps=100, lr_delay_mult=0.01,
              max_steps=10_000)
    np.testing.assert_allclose(tconf.expon_lr(step, **kw),
                               float(jconf.expon_lr(step, **kw)), rtol=1e-6)


def test_transforms_match(rng):
    q = _quats(rng)
    qt = torch.as_tensor(q)
    np.testing.assert_allclose(ttf.quat_to_rotmat(qt).numpy(),
                               np.asarray(jtf.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    R = np.asarray(jtf.quat_to_rotmat(jnp.asarray(q)))
    np.testing.assert_allclose(ttf.rotmat_to_quat(torch.as_tensor(R)).numpy(),
                               np.asarray(jtf.rotmat_to_quat(jnp.asarray(R))), atol=1e-6)
    q2 = _quats(rng)
    np.testing.assert_allclose(ttf.quat_multiply(qt, torch.as_tensor(q2)).numpy(),
                               np.asarray(jtf.quat_multiply(jnp.asarray(q), jnp.asarray(q2))),
                               atol=1e-6)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:4] *= 1e-5  # small-angle branch
    np.testing.assert_allclose(ttf.so3_exp(torch.as_tensor(w)).numpy(),
                               np.asarray(jtf.so3_exp(jnp.asarray(w))), atol=1e-6)
    np.testing.assert_allclose(ttf.so3_log(torch.as_tensor(R)).numpy(),
                               np.asarray(jtf.so3_log(jnp.asarray(R))), atol=1e-4)
    np.testing.assert_allclose(ttf.skew(torch.as_tensor(w)).numpy(),
                               np.asarray(jtf.skew(jnp.asarray(w))), atol=0)
    s = rng.uniform(0.01, 1.0, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(ttf.quat_scale_to_cov(torch.as_tensor(s), qt).numpy(),
                               np.asarray(jtf.quat_scale_to_cov(jnp.asarray(s), jnp.asarray(q))),
                               atol=1e-6)
    T = np.asarray(jtf.se3_matrix(jnp.asarray(R[0]), jnp.asarray(w[5])))
    np.testing.assert_allclose(ttf.se3_inverse(torch.as_tensor(T)).numpy(),
                               np.asarray(jtf.se3_inverse(jnp.asarray(T))), atol=1e-6)
    np.testing.assert_array_equal(ttf.LIDAR_TO_CAM, jtf.LIDAR_TO_CAM)


def test_camera_matches(rng):
    R = np.asarray(jtf.so3_exp(jnp.asarray([0.1, -0.2, 0.05], jnp.float32)))
    t = np.array([0.3, -0.1, 2.0], np.float32)
    fovx, fovy = jcam.focal2fov(431.8, 640), jcam.focal2fov(431.8, 512)
    assert tcam.focal2fov(431.8, 640) == fovx
    cj = jcam.make_camera(R, t, 640, 512, fovx, fovy)
    ct = tcam.make_camera(R, t, 640, 512, fovx, fovy, device="cpu")
    np.testing.assert_allclose(ct.world_view.numpy(), np.asarray(cj.world_view), atol=1e-6)
    np.testing.assert_allclose(ct.full_proj.numpy(), np.asarray(cj.full_proj), atol=1e-5)
    assert (ct.focal_x, ct.focal_y, ct.tan_fovx) == (cj.focal_x, cj.focal_y, cj.tan_fovx)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_matches(rng, deg):
    n = 32
    sh = rng.normal(size=(n, 3, 25)).astype(np.float32)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    cam = np.array([0.1, 0.2, -3.0], np.float32)
    rgb_j, cl_j = jsh.sh_to_color(deg, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(cam))
    rgb_t, cl_t = tsh.sh_to_color(deg, torch.as_tensor(sh), torch.as_tensor(means),
                                  torch.as_tensor(cam))
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_array_equal(cl_t.numpy(), np.asarray(cl_j))
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    np.testing.assert_allclose(tsh.rgb_to_sh(torch.as_tensor(rgb)).numpy(),
                               np.asarray(jsh.rgb_to_sh(jnp.asarray(rgb))), atol=1e-6)
