"""Command-line entry points (`sags_tpu.cli.main` in torch).

`python -m sags_tpu_torch.cli.main <command>`, or `main(argv)` in-process:
  run-slam  — online SLAM over a dataset (synthetic, TUM, Replica), a ROS1
              bag or a live TCP stream.
  train     — offline 3DGS optimization over a replayed frame set.
  run-gicp  — scan-to-scan or scan-to-keyframe-map odometry over a dataset
              (KITTI velodyne scans too).
  align     — pairwise-alignment timing harness over two point clouds.
  render    — render a view of a saved PLY map to a PNG.
  viewer    — serve a saved PLY map to a SIBR remote viewer.
  eval      — PSNR/SSIM/LPIPS of a saved map against a dataset.
  serve     — publish a dataset as a live TCP frame stream.

Flags, defaults and JSON lines are the JAX package's. One flag is the
port's own: `--device` (default `cuda`), the only way to run on the CPU;
without a GPU the default raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import struct
import sys
import time
import zlib

import numpy as np

from sags_tpu_torch import resolve_device


def _load_dataset(args, device):
    from sags_tpu_torch.io import datasets as D

    if args.dataset == "synthetic":
        # clutter blobs make z observable for geometric tracking; IMU
        # substeps feed the ESIKF propagate path
        return list(D.SyntheticDataset(
            n_frames=args.frames, width=args.width, height=args.height,
            clutter=0.35, imu_substeps=5, texture=args.texture, step=args.step,
            n_world=args.world_points, pts_per_frame=args.scan_points, device=device))
    if args.dataset == "tum":
        return list(D.TUMDataset(args.path))
    if args.dataset == "replica":
        return list(D.ReplicaDataset(args.path))
    if args.dataset == "kitti":
        # KITTI odometry velodyne scans (`src/kitti.cpp` KittiLoader)
        return list(D.KITTIOdometryDataset(
            args.path, poses_file=args.poses, times_file=args.times,
            calib_file=args.calib, max_points=args.max_points))
    if args.dataset == "rosbag":
        # ROS1 bag replay of the node's three topics (io/rosbag.py): a
        # generator, staged frame by frame like the socket source
        from sags_tpu_torch.io.rosbag import RosbagDataset

        return iter(RosbagDataset(
            args.path, image_topic=args.image_topic, cloud_topic=args.cloud_topic,
            odom_topic=args.odom_topic, imu_topic=args.imu_topic or None))
    if args.dataset == "socket":
        # live TCP ingestion (io/stream.py): a generator, not a list — the
        # pipeline stages it frame by frame and applies timeout_s silence
        from sags_tpu_torch.io.stream import socket_frames

        # generous connect window: a publisher may still be loading/rendering
        return socket_frames(args.port, connect_timeout=180.0)
    raise SystemExit(f"unknown dataset {args.dataset}")


def mask_generator(args, cfg, device):
    """run-slam's mask generator from `--mask-backend`: geometric clusters,
    SAM with the shipped synthetic-trained weights, or, at their published
    widths with weights drawn from the config's seed, MobileSAM (its
    TinyViT encoder), MobileSAMv2's EfficientViT-SAM-L2 encoder or SAM's
    ViT-H encoder behind the same decoder (no checkpoint is in the repository;
    `models.mobile_sam.load_checkpoint` loads one)."""
    if args.mask_backend == "geometric":
        from sags_tpu_torch.semantics.geometric import GeometricMaskGenerator

        return GeometricMaskGenerator(num_classes=cfg.semantics.num_classes)
    from sags_tpu_torch.semantics.masks import MaskGenerator

    sam = None
    if args.mask_backend in ("mobile_sam", "efficientvit_l2", "sam_vit_h"):
        from sags_tpu_torch.models.mobile_sam import MobileSAM, MobileSAMConfig

        encoder = "tiny_vit" if args.mask_backend == "mobile_sam" else args.mask_backend
        sam = MobileSAM(MobileSAMConfig(encoder=encoder), seed=cfg.seed, device=device)
    return MaskGenerator(sam=sam, num_classes=cfg.semantics.num_classes, device=device)


def cmd_run_slam(args):
    from sags_tpu_torch.core.config import SLAMConfig, preset
    from sags_tpu_torch.io.ply import save_map_ply
    from sags_tpu_torch.mapping.gaussian_map import compact, n_active
    from sags_tpu_torch.slam.pipeline import SLAMPipeline
    from sags_tpu_torch.utils.traj import ate_rmse

    device = resolve_device(args.device)
    resumed_state = None
    if args.resume:
        # a resumed run adopts the persisted config; explicit flags override
        from sags_tpu_torch.slam.checkpoint import load_state

        resumed_state, cfg = load_state(args.resume, device=device)
        print(f"resumed state+config from {args.resume}", file=sys.stderr)
        if args.preset:
            print("--preset ignored: --resume adopts the persisted config",
                  file=sys.stderr)
    else:
        cfg = preset(args.preset) if args.preset else SLAMConfig()
    # only EXPLICIT flags override (None = not given); fresh runs get the
    # documented defaults
    tracking = args.tracking if args.tracking is not None else (
        cfg.tracking.backend if args.resume else "none")
    post_train = args.post_train if args.post_train is not None else (
        cfg.post_train_iters if args.resume else 100)
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, backend=tracking),
                      post_train_iters=post_train)
    if args.capacity:
        cfg = cfg.replace(map=dataclasses.replace(cfg.map, initial_capacity=args.capacity))
    frames = _load_dataset(args, device)
    mask_gen = mask_generator(args, cfg, device) if args.semantics else None
    pipe = SLAMPipeline(cfg, mask_generator=mask_gen, point_budget=args.point_budget,
                        device=device)
    if resumed_state is not None:
        pipe.state = resumed_state
    t0 = time.perf_counter()
    res = pipe.run(frames)
    dt = time.perf_counter() - t0
    ate, _ = ate_rmse(res.poses_est, res.poses_gt)
    n_frames = len(frames) if isinstance(frames, list) else len(res.poses_est)
    if isinstance(frames, list):
        # evaluate at the poses the map was trained with (the estimated
        # trajectory); --eval-poses gt renders at the ground truth
        eval_poses = res.poses_est if args.eval_poses == "est" else None
        scores = pipe.evaluate(frames, every=max(1, n_frames // 5), poses=eval_poses)
        # None (JSON null), not NaN: bare NaN is invalid JSON
        psnr = float(np.mean([s["psnr"] for s in scores])) if scores else None
        ssim_v = float(np.mean([s["ssim"] for s in scores])) if scores else None
        lp = [s["lpips"] for s in scores if s.get("lpips") is not None]
        lpips_v = float(np.mean(lp)) if lp else None
        lpips_net = scores[0].get("lpips_net") if scores else None
        eval_overflow = (int(np.sum([s.get("overflow_pairs", 0) for s in scores]))
                         if scores else None)
    else:  # live stream: frames are consumed; no replay to evaluate against
        psnr = ssim_v = lpips_v = lpips_net = eval_overflow = None
    # steady-state loop rate: the sum of the second half's frame times
    tail = res.frame_times[len(res.frame_times) // 2:]
    fps_steady = (len(tail) / max(sum(tail), 1e-9)) if tail else None
    print(json.dumps({
        "frames": n_frames,
        "train_iters": res.train_iters,
        "fps": n_frames / max(dt, 1e-9),
        "fps_steady": fps_steady,
        "ate_rmse": ate if np.isfinite(ate) else None,
        "mean_psnr": psnr,
        "mean_ssim": ssim_v,
        "mean_lpips": lpips_v,
        "lpips_net": lpips_net,
        "eval_overflow_pairs": eval_overflow,
        "active_gaussians": int(n_active(res.state.map)),
        "keyframes": res.n_keyframes,
        "timed_out": res.timed_out,
        "tracking": cfg.tracking.backend,
    }))
    if args.traj_out:
        from sags_tpu_torch.utils.traj import save_tum_trajectory

        save_tum_trajectory(args.traj_out, res.poses_est)
        print(f"wrote trajectory (TUM format) to {args.traj_out}", file=sys.stderr)
    if args.traj_plot:
        from sags_tpu_torch.utils.traj import plot_trajectory

        if plot_trajectory(args.traj_plot, res.poses_est, res.poses_gt):
            print(f"wrote trajectory plot to {args.traj_plot}", file=sys.stderr)
    if args.save:
        save_map_ply(args.save, compact(res.state.map))
        print(f"saved map to {args.save}", file=sys.stderr)
    if args.checkpoint:
        from sags_tpu_torch.slam.checkpoint import save_state

        save_state(args.checkpoint, res.state, pipe.cfg)
        print(f"checkpointed state to {args.checkpoint}", file=sys.stderr)
    return res


def cmd_train(args):
    """Offline 3DGS optimization over a replayed frame set."""
    from sags_tpu_torch.core.config import SLAMConfig
    from sags_tpu_torch.io.ply import save_map_ply
    from sags_tpu_torch.mapping.gaussian_map import compact, n_active
    from sags_tpu_torch.slam import offline

    device = resolve_device(args.device)
    cfg = SLAMConfig()
    frames = _load_dataset(args, device)
    t0 = time.perf_counter()
    state, losses = offline.train_offline(
        frames, cfg, iterations=args.iters, capacity=args.capacity or None,
        log_every=max(args.iters // 10, 1), device=device)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "iters": args.iters,
        "final_loss": losses[-1] if losses else None,
        "active_gaussians": int(n_active(state.map)),
        "iters_per_sec": args.iters / dt,
    }))
    if args.save:
        save_map_ply(args.save, compact(state.map))
        print(f"saved map to {args.save}", file=sys.stderr)
    return state


def cmd_run_gicp(args):
    from sags_tpu_torch.ops import registration as R
    from sags_tpu_torch.utils.traj import ate_rmse

    device = resolve_device(args.device)
    frames = _load_dataset(args, device)
    reg = (R.FastVGICP if args.method == "vgicp" else R.FastGICP)(device=device)
    poses = [np.eye(4)]
    times = []
    # KITTI scans are raw sensor frames; their ground truth is optional
    raw_sensor = args.dataset == "kitti"
    has_gt = not raw_sensor or bool(args.poses)

    def sensor_frame(f):
        # frames carrying a raw `scan` feed it to the tracker; world-frame
        # frames give the scan back through the GT pose
        if f.scan is not None:
            pts = np.asarray(f.scan)
        else:
            T = np.asarray(f.pose)
            pts = (np.asarray(f.points) - T[:3, 3]) @ T[:3, :3]
        if args.downsample > 0:  # voxel-grid prefilter
            pts = R.downsample(pts, args.downsample, device=device)
        return pts

    if args.mode == "map":
        # scan-to-keyframe-map: every Nth scan joins a world-frame keyframe
        # stack that becomes the target; each scan aligns against it from
        # the previous world pose
        kf_stack = [sensor_frame(frames[0])]  # poses[0] = I: world := frame 0
        reg.set_input_target(kf_stack[0])
        for i in range(1, len(frames)):
            pts = sensor_frame(frames[i])
            reg.set_input_source(pts)
            t0 = time.perf_counter()
            pose = np.asarray(reg.align(poses[-1]))
            times.append(time.perf_counter() - t0)
            poses.append(pose)
            if i % args.keyframe_every == 1 or args.keyframe_every == 1:
                kf_stack.append(pts @ pose[:3, :3].T + pose[:3, 3])
                reg.set_input_target(np.vstack(kf_stack))
    else:
        # scan-to-scan with target <- source carry-over (the swap keeps the
        # covariances just estimated for the source)
        reg.set_input_target(sensor_frame(frames[0]))
        for i in range(1, len(frames)):
            reg.set_input_source(sensor_frame(frames[i]))
            t0 = time.perf_counter()
            delta = reg.align(np.eye(4))
            times.append(time.perf_counter() - t0)
            poses.append(poses[-1] @ delta)
            reg.swap_source_and_target()
    poses = np.stack(poses)
    gt = ate = None
    if has_gt:
        if raw_sensor and not args.calib:
            # KITTI GT is T_w_cam0 and the estimates are velodyne-frame:
            # without the Tr conjugation (--calib) the ATE mixes the frames
            print("WARNING: --poses without --calib: ATE mixes cam0-frame GT "
                  "with velodyne-frame estimates; pass the sequence's "
                  "calib.txt for a faithful metric", file=sys.stderr)
        gt = np.stack([np.asarray(f.pose) for f in frames])
        ate, _ = ate_rmse(poses, gt)
    print(json.dumps({
        "frames": len(frames),
        "method": args.method,
        "mode": args.mode,
        "ate_rmse": ate,
        "mean_align_ms": float(np.mean(times) * 1000) if times else None,
        "fps": 1.0 / float(np.mean(times)) if times else None,
    }))
    if args.out_poses:
        from sags_tpu_torch.utils.traj import save_kitti_trajectory

        save_kitti_trajectory(args.out_poses, poses)
        print(f"wrote poses (KITTI format) to {args.out_poses}", file=sys.stderr)
    if args.traj_plot:
        from sags_tpu_torch.utils.traj import plot_trajectory

        if plot_trajectory(args.traj_plot, poses, gt):
            print(f"wrote trajectory plot to {args.traj_plot}", file=sys.stderr)
    return poses


def _load_points(path: str) -> np.ndarray:
    """A raw [N,3] point cloud: .npy/.npz, .ply (vertex x,y,z), KITTI .bin
    (float32 x,y,z,reflectance), or whitespace text."""
    if path.endswith(".npy") or path.endswith(".npz"):
        arr = np.load(path)
        if hasattr(arr, "files"):
            arr = arr[arr.files[0]]
    elif path.endswith(".ply"):
        from sags_tpu_torch.io.ply import _read_ply_raw

        _, cols = _read_ply_raw(path)
        arr = np.stack([cols["x"], cols["y"], cols["z"]], 1)
    elif path.endswith(".bin"):
        arr = np.fromfile(path, dtype=np.float32).reshape(-1, 4)[:, :3]
    else:
        arr = np.loadtxt(path, dtype=np.float32)
    pts = np.asarray(arr, np.float32).reshape(-1, arr.shape[-1])[:, :3]
    return pts[np.isfinite(pts).all(axis=1)]


def cmd_align(args):
    """Pairwise-alignment timing harness: each method once cold, then `n`
    times for the steady-state rate."""
    from sags_tpu_torch.ops import registration as R

    device = resolve_device(args.device)
    target = _load_points(args.target)
    source = _load_points(args.source)
    if args.downsample > 0:
        target = R.downsample(target, args.downsample, device=device)
        source = R.downsample(source, args.downsample, device=device)
    methods = (["GICP", "GICP_ST", "VGICP", "VGICP_CUDA", "NDT_CUDA"]
               if args.method == "all" else [args.method.upper()])
    out = []
    for m in methods:
        def once():
            return R.align_points(target, source, method=m,
                                  voxel_resolution=args.voxel_resolution, device=device)

        t0 = time.perf_counter()
        T = once()
        single = time.perf_counter() - t0
        ts = []
        for _ in range(args.n):
            t0 = time.perf_counter()
            T = once()
            ts.append(time.perf_counter() - t0)
        out.append(np.asarray(T))
        print(json.dumps({
            "method": m,
            "n_target": len(target),
            "n_source": len(source),
            "single_ms": single * 1000.0,
            "avg_ms": float(np.mean(ts)) * 1000.0 if ts else None,
            "fps": 1.0 / float(np.mean(ts)) if ts else None,
            "translation": np.asarray(T)[:3, 3].tolist(),
        }))
    return out


def cmd_serve(args):
    """Publish a dataset as a live TCP frame stream (io/stream.py), the
    sensor side of `run-slam --dataset socket`."""
    from sags_tpu_torch.io.stream import serve_frames

    frames = _load_dataset(args, resolve_device(args.device))

    def paced():
        for f in frames:
            if args.hz > 0:
                time.sleep(1.0 / args.hz)
            yield f

    print(f"serving {len(frames)} frames on port {args.port} "
          f"(waiting for a consumer)...", file=sys.stderr)
    serve_frames(paced(), port=args.port)
    print("stream complete", file=sys.stderr)


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 image as an 8-bit RGB PNG, or an [H, W]
    uint16 one (a depth image) as a 16-bit gray PNG (stdlib only: every row
    filter 0, one zlib stream)."""
    if img.ndim == 2:
        img, depth, color = np.ascontiguousarray(img, ">u2"), 16, 0
    else:
        img, depth, color = np.ascontiguousarray(img, np.uint8), 8, 2
    H, W = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(H))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def cmd_render(args):
    import torch

    from sags_tpu_torch.core.camera import make_camera
    from sags_tpu_torch.core.config import SLAMConfig
    from sags_tpu_torch.io.ply import load_map_ply
    from sags_tpu_torch.slam.step import render_map

    device = resolve_device(args.device)
    cfg = SLAMConfig()
    m = load_map_ply(args.map, device=device)
    pose = np.eye(4, dtype=np.float32)
    if args.pose:
        pose = np.loadtxt(args.pose).reshape(4, 4).astype(np.float32)
    cam = make_camera(pose[:3, :3], pose[:3, 3], args.width, args.height, 1.2, 0.9,
                      device=device)
    with torch.no_grad():
        out = render_map(m, cam, cfg)
    img = np.clip(out.color.cpu().numpy().transpose(1, 2, 0) * 255, 0, 255).astype(np.uint8)
    write_png(args.out, img)
    print(f"wrote {args.out} ({args.width}x{args.height}, {int(m.count)} gaussians)")
    return img


def serve_viewer(gui, m, cfg, requests=None) -> int:
    """Answer SIBR viewer requests on `gui` with renders of the map `m` at
    `cfg` until `requests` were served (None: until interrupted); returns
    the number served."""
    import torch

    from sags_tpu_torch.slam.step import render_map

    def render(cam):
        with torch.no_grad():
            return render_map(m, cam, cfg).color

    served = 0
    while requests is None or served < requests:
        if gui.serve_once(render):
            served += 1
        else:
            time.sleep(0.02)  # no viewer connected yet
    return served


def cmd_viewer(args):
    """Serve the map to a SIBR remote viewer (`network_gui` protocol)."""
    from sags_tpu_torch.core.config import SLAMConfig
    from sags_tpu_torch.io.ply import load_map_ply
    from sags_tpu_torch.viz.network_gui import NetworkGUI

    device = resolve_device(args.device)
    m = load_map_ply(args.map, device=device)
    gui = NetworkGUI(port=args.port, device=device)
    print(f"viewer socket on 127.0.0.1:{args.port} ({int(m.count)} gaussians)",
          file=sys.stderr)
    try:
        serve_viewer(gui, m, SLAMConfig())
    except KeyboardInterrupt:
        pass
    finally:
        gui.close()


def cmd_eval(args):
    from sags_tpu_torch.core.config import SLAMConfig
    from sags_tpu_torch.io.ply import load_map_ply
    from sags_tpu_torch.slam.pipeline import SLAMPipeline

    device = resolve_device(args.device)
    cfg = SLAMConfig()
    frames = _load_dataset(args, device)
    pipe = SLAMPipeline(cfg, device=device)
    pipe.state = pipe.state._replace(map=load_map_ply(args.map, device=device))
    scores = pipe.evaluate(frames, every=args.every)
    agg = {k: float(np.mean([s[k] for s in scores if s.get(k) is not None] or [np.nan]))
           for k in ("psnr", "ssim", "lpips")}
    lpips_net = scores[0].get("lpips_net") if scores else None
    print(json.dumps({"n_eval": len(scores), **agg, "lpips_net": lpips_net}))
    return scores


def main(argv=None):
    p = argparse.ArgumentParser(prog="sags-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (cpu runs the kernels' plain "
                             "PyTorch versions)")

    def add_dataset_args(sp, live=False, kitti=False):
        # "socket"/"rosbag" (consumed-once generators) only make sense for
        # the online SLAM loop; train/run-gicp/eval index a materialized list
        choices = ["synthetic", "tum", "replica"] + (
            ["socket", "rosbag"] if live else []) + (["kitti"] if kitti else [])
        sp.add_argument("--dataset", default="synthetic", choices=choices)
        sp.add_argument("--path", default="")
        sp.add_argument("--frames", type=int, default=20)
        sp.add_argument("--width", type=int, default=160)
        sp.add_argument("--height", type=int, default=120)
        sp.add_argument("--texture", type=float, default=0.0,
                        help="synthetic-world procedural texture strength "
                             "(0..1; view-consistent instance texture)")
        sp.add_argument("--step", type=float, default=0.4,
                        help="synthetic trajectory step per frame")
        sp.add_argument("--world-points", type=int, default=4096,
                        help="synthetic world point count")
        sp.add_argument("--scan-points", type=int, default=2048,
                        help="synthetic per-frame scan point count")
        if live:
            sp.add_argument("--image-topic", default="/rgb_img")
            sp.add_argument("--cloud-topic", default="/cloud_registered")
            sp.add_argument("--odom-topic", default="/aft_mapped_to_init")
            sp.add_argument("--imu-topic", default="")
        if kitti:
            sp.add_argument("--poses", default="",
                            help="KITTI GT poses.txt (12 floats/line) for ATE")
            sp.add_argument("--times", default="", help="KITTI times.txt")
            sp.add_argument("--calib", default="",
                            help="KITTI calib.txt with a Tr: velo→cam0 line")
            sp.add_argument("--max-points", type=int, default=0,
                            help="subsample each scan to at most N points")
        add_device_arg(sp)

    sp = sub.add_parser("run-slam")
    add_dataset_args(sp, live=True)
    sp.add_argument("--preset", default="", choices=["", "fast_livo2", "replica", "tum"])
    # default=None so --resume can tell "flag given" from "default": a
    # resumed run adopts the persisted config and only explicit flags
    # override it
    sp.add_argument("--tracking", default=None,
                    choices=["none", "gicp", "vgicp", "gicp_map", "esikf"])
    sp.add_argument("--semantics", action="store_true")
    sp.add_argument("--mask-backend", default="geometric",
                    choices=["geometric", "sam", "mobile_sam", "efficientvit_l2",
                             "sam_vit_h"])
    sp.add_argument("--port", type=int, default=7011,
                    help="TCP port for --dataset socket (io/stream.py)")
    sp.add_argument("--post-train", type=int, default=None)
    sp.add_argument("--eval-poses", default="est", choices=["est", "gt"],
                    help="render eval views at the estimated (trained-with) "
                         "poses or at ground-truth poses")
    sp.add_argument("--point-budget", type=int, default=4096)
    sp.add_argument("--capacity", type=int, default=0)
    sp.add_argument("--save", default="")
    sp.add_argument("--checkpoint", default="",
                    help="save the full SLAM state (map + Adam + generator) here")
    sp.add_argument("--resume", default="",
                    help="restore a --checkpoint state (and its config) before running")
    sp.add_argument("--traj-out", default="",
                    help="write the estimated trajectory (TUM format)")
    sp.add_argument("--traj-plot", default="",
                    help="write a top-down est-vs-gt trajectory PNG")
    sp.set_defaults(fn=cmd_run_slam)

    sp = sub.add_parser("train")
    add_dataset_args(sp)
    sp.add_argument("--iters", type=int, default=2000)
    sp.add_argument("--capacity", type=int, default=0)
    sp.add_argument("--save", default="")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("run-gicp")
    add_dataset_args(sp, kitti=True)
    sp.add_argument("--method", default="gicp", choices=["gicp", "vgicp"])
    sp.add_argument("--mode", default="scan", choices=["scan", "map"],
                    help="scan: scan-to-scan deltas; map: scan-to-keyframe-map")
    sp.add_argument("--keyframe-every", type=int, default=30)
    sp.add_argument("--downsample", type=float, default=0.0,
                    help="voxel-grid leaf size in m (kitti.cpp uses 0.25)")
    sp.add_argument("--out-poses", default="",
                    help="write estimated poses in KITTI 3x4 format")
    sp.add_argument("--traj-plot", default="",
                    help="write a top-down est-vs-gt trajectory PNG")
    sp.set_defaults(fn=cmd_run_gicp)

    sp = sub.add_parser("render")
    sp.add_argument("--map", required=True)
    sp.add_argument("--pose", default="")
    sp.add_argument("--out", default="render.png")
    sp.add_argument("--width", type=int, default=640)
    sp.add_argument("--height", type=int, default=480)
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("viewer")
    sp.add_argument("--map", required=True)
    sp.add_argument("--port", type=int, default=6009)
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_viewer)

    sp = sub.add_parser("eval")
    add_dataset_args(sp)
    sp.add_argument("--map", required=True)
    sp.add_argument("--every", type=int, default=1)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("align")
    sp.add_argument("--target", required=True)
    sp.add_argument("--source", required=True)
    sp.add_argument("--method", default="all")
    sp.add_argument("--n", type=int, default=10)
    sp.add_argument("--downsample", type=float, default=-1.0)
    sp.add_argument("--voxel-resolution", type=float, default=1.0)
    add_device_arg(sp)
    sp.set_defaults(fn=cmd_align)

    sp = sub.add_parser("serve")
    add_dataset_args(sp)
    sp.add_argument("--port", type=int, default=7011)
    sp.add_argument("--hz", type=float, default=0.0,
                    help="publish rate (0 = as fast as the consumer reads)")
    sp.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
