"""Helpers shared by the port's test files (not collected: no tests here).

Writers of the dataset layouts and of a ROS1 bag from synthetic frames, a
SIBR viewer client, the bitwise comparison of two `SLAMState`s, the bar on
a kNN fallback's distances, and the kernels' launch counters.
"""

from __future__ import annotations

import json
import os
import socket
import time

import numpy as np
import torch


def quantized(f, scale: float):
    """A frame's image as 8-bit RGB [H, W, 3] and its depth as uint16 at
    `scale` a metre, 0 (no depth) where it does not fit."""
    rgb = np.clip(np.round(f.image.transpose(1, 2, 0) * 255), 0, 255).astype(np.uint8)
    d = np.round(f.depth.astype(np.float64) * scale)
    return rgb, np.where((d > 0) & (d <= 65535), d, 0).astype(np.uint16)


def write_tum(root: str, frames, t0: float = 1000.0) -> None:
    """`frames` in the TUM RGB-D layout: rgb/ and depth/ PNGs (depth at 5000
    a metre), rgb.txt, depth.txt 3 ms and groundtruth.txt 2 ms off the rgb
    stamps, poses as position and xyzw quaternion."""
    from sags_tpu_torch.cli.main import write_png
    from sags_tpu_torch.utils.traj import _rotmat_to_quat_xyzw

    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    rows = {"rgb.txt": [], "depth.txt": [], "groundtruth.txt": []}
    for f in frames:
        t = t0 + f.timestamp
        rgb, d16 = quantized(f, 5000.0)
        write_png(os.path.join(root, "rgb", f"{t:.6f}.png"), rgb)
        write_png(os.path.join(root, "depth", f"{t + 0.003:.6f}.png"), d16)
        rows["rgb.txt"].append(f"{t:.6f} rgb/{t:.6f}.png")
        rows["depth.txt"].append(f"{t + 0.003:.6f} depth/{t + 0.003:.6f}.png")
        q = _rotmat_to_quat_xyzw(f.pose[:3, :3].astype(np.float64))
        rows["groundtruth.txt"].append(
            f"{t - 0.002:.6f} " + " ".join(repr(float(v)) for v in (*f.pose[:3, 3], *q)))
    for name, lines in rows.items():
        with open(os.path.join(root, name), "w") as fh:
            fh.write(f"# {name}\n" + "\n".join(lines) + "\n")


def write_replica(root: str, frames) -> None:
    """`frames` in the Replica layout: results/frame%06d.png,
    results/depth%06d.png at 6553.5 a metre, traj.txt (16 floats a line)."""
    from sags_tpu_torch.cli.main import write_png

    os.makedirs(os.path.join(root, "results"), exist_ok=True)
    for i, f in enumerate(frames):
        rgb, d16 = quantized(f, 6553.5)
        write_png(os.path.join(root, "results", f"frame{i:06d}.png"), rgb)
        write_png(os.path.join(root, "results", f"depth{i:06d}.png"), d16)
    np.savetxt(os.path.join(root, "traj.txt"),
               np.stack([f.pose.reshape(-1) for f in frames]), fmt="%.9g")


# a velodyne→cam0 extrinsic of KITTI's shape: an axis remap and a lever arm
KITTI_TR = ((0.0, -1.0, 0.0, -0.004), (0.0, 0.0, -1.0, -0.076), (1.0, 0.0, 0.0, -0.272))


def write_kitti(root: str, frames) -> dict:
    """`frames`' scans in the KITTI odometry layout: velodyne/%06d.bin (x, y,
    z, intensity), poses.txt in the cam0 frame through `KITTI_TR`
    (T_cam0 = Tr · T · Tr⁻¹, so the reader's Tr⁻¹ · T_cam0 · Tr gives T
    back), calib.txt with the `Tr:` line, times.txt. Returns the paths."""
    velo = os.path.join(root, "velodyne")
    os.makedirs(velo, exist_ok=True)
    Tr = np.eye(4)
    Tr[:3, :4] = np.asarray(KITTI_TR)
    for i, f in enumerate(frames):
        rec = np.concatenate([f.scan, np.full((len(f.scan), 1), 0.5, np.float32)], 1)
        rec.astype(np.float32).tofile(os.path.join(velo, f"{i:06d}.bin"))
    cam = Tr[None] @ np.stack([f.pose.astype(np.float64) for f in frames]) @ np.linalg.inv(Tr)
    paths = {k: os.path.join(root, k) for k in ("poses.txt", "calib.txt", "times.txt")}
    np.savetxt(paths["poses.txt"], cam[:, :3, :4].reshape(len(frames), 12), fmt="%.17g")
    with open(paths["calib.txt"], "w") as fh:
        fh.write("P0: " + " ".join(["0"] * 12) + "\n")
        fh.write("Tr: " + " ".join(f"{v:.17g}" for v in Tr[:3, :4].reshape(-1)) + "\n")
    np.savetxt(paths["times.txt"], [f.timestamp for f in frames], fmt="%.9f")
    return dict(paths, velodyne=velo)


def write_rosbag(path: str, frames, imu: bool = True, t0: float = 100.0) -> int:
    """`frames` as a ROS1 bag of the node's topics (`/rgb_img`,
    `/cloud_registered`, `/aft_mapped_to_init`, `/imu`), written with the
    port's encoders: the cloud's and the odometry's stamps 10 and 20 ms after
    the image's (within the synchronizer's slop); before each frame its IMU
    samples, stamped at the ends of their intervals, the bag's first one
    led by a sample at its interval's start (the reader gives a bag's first
    sample dt 0). Returns the file's size in bytes."""
    from sags_tpu_torch.io import rosbag as rb

    msgs, led = [], False
    for f in frames:
        t = t0 + f.timestamp
        if imu and f.imu is not None:
            dts = f.imu[:, 6].astype(np.float64)
            ends = t - (dts[::-1].cumsum()[::-1] - dts)
            if not led:
                start = float(ends[0] - dts[0])
                msgs.append(("/imu", "sensor_msgs/Imu", start,
                             rb.encode_imu(start, f.imu[0, :3], f.imu[0, 3:6])))
                led = True
            for te, row in zip(ends, f.imu):
                msgs.append(("/imu", "sensor_msgs/Imu", float(te),
                             rb.encode_imu(float(te), row[:3], row[3:6])))
        msgs += [("/rgb_img", "sensor_msgs/Image", t, rb.encode_image(t, f.image)),
                 ("/cloud_registered", "sensor_msgs/PointCloud2", t + 0.01,
                  rb.encode_pointcloud2(t + 0.01, f.points, f.colors)),
                 ("/aft_mapped_to_init", "nav_msgs/Odometry", t + 0.02,
                  rb.encode_odometry(t + 0.02, f.pose))]
    rb.write_bag(path, msgs)
    return os.path.getsize(path)


def sibr_request(cam) -> dict:
    """A SIBR viewer request for the port `Camera` `cam`: its matrices
    transposed (the wire's convention) with the y/z columns flipped as the
    viewer sends them."""
    V = cam.world_view.cpu().numpy().T.copy()
    PV = cam.full_proj.cpu().numpy().T.copy()
    V[:, 1:3] *= -1
    PV[:, 1] *= -1
    return {"resolution_x": cam.width, "resolution_y": cam.height, "train": False,
            "fov_y": cam.fovy, "fov_x": cam.fovx, "z_near": cam.znear, "z_far": cam.zfar,
            "shs_python": False, "rot_scale_python": False, "keep_alive": True,
            "scaling_modifier": 1.0, "view_matrix": V.reshape(-1).tolist(),
            "view_projection_matrix": PV.reshape(-1).tolist()}


def unflip(msg):
    """A request's view and view-projection as `NetworkGUI.receive` hands
    them to `MiniCam`."""
    V = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
    PV = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
    V[:, 1:3] *= -1
    PV[:, 1] *= -1
    return V, PV


def viewer_client(port: int, requests, out: dict) -> None:
    """A SIBR viewer: each request sent, its RGB reply and verify string
    read, the milliseconds from send to reply kept."""
    out["replies"], out["ms"] = [], []
    with socket.create_connection(("127.0.0.1", port), timeout=120) as c:
        def exact(n):
            buf = b""
            while len(buf) < n:
                chunk = c.recv(n - len(buf))
                if not chunk:
                    raise ConnectionError("the viewer server closed")
                buf += chunk
            return buf

        for msg in requests:
            payload = json.dumps(msg).encode()
            t0 = time.perf_counter()
            c.sendall(len(payload).to_bytes(4, "little") + payload)
            img = exact(msg["resolution_x"] * msg["resolution_y"] * 3)
            verify = exact(int.from_bytes(exact(4), "little")).decode()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["replies"].append((img, verify))


def assert_states_bitwise(a, b, generator=True) -> None:
    """Two port `SLAMState`s equal bit for bit, leaf by leaf in the
    checkpoint's order (`checkpoint._leaves`; tensors moved to the CPU, so
    the two may live on different devices) and, with `generator`, their
    draw hooks' generator states."""
    from sags_tpu_torch.slam import checkpoint

    cpu = lambda x: torch.as_tensor(x).cpu()
    la, lb = checkpoint._leaves(a), checkpoint._leaves(b)
    differ = [i for i, (x, y) in enumerate(zip(la, lb))
              if cpu(x).dtype != cpu(y).dtype or not torch.equal(cpu(x), cpu(y))]
    assert not differ, f"{len(differ)} of {len(la)} leaves differ: {differ}"
    if generator:
        assert torch.equal(a.rng.generator.get_state(), b.rng.generator.get_state()), \
            "the generator states differ"


def knn_bar(queries, d2):
    """The bar on a kNN fallback's squared distances [M, k] to `queries`'
    neighbours: 1e-5 plus the float32 rounding of |q|^2 + |p|^2 - 2 q.p
    (8 ulps of |q|^2 + |p|^2, with |p| <= |q| + sqrt(d2))."""
    qn = np.linalg.norm(queries.astype(np.float64), axis=1)[:, None]
    pn = qn + np.sqrt(np.maximum(d2.astype(np.float64), 0.0))
    return 1e-5 + 8 * float(np.finfo(np.float32).eps) * (qn ** 2 + pn ** 2)


def launch_counts() -> dict:
    """Each CUDA kernel's launches since the last `_build.reset_launch_counts`,
    by its C symbol."""
    from sags_tpu_torch.ops import _build

    return {k.symbol: k.launches for k in _build.kernels()}
