"""A quick look at the tile-sharded mesh on one card, without the SLAM loop:

    python3 tools/mesh_probe.py

On a seeded scene of 4096 splats at 192x160 (120 tiles), the classic and
windowed renders and their gradients through the kernels:
  * one NCCL rank in this process against `mesh=None` (bitwise or not);
  * 2 and 3 gloo ranks spawned on the card: an all-gather and an
    all-reduce of CUDA tensors, each rank's render and gradients against
    the unsharded ones (the image's largest difference, the gradients'
    largest relative difference), whether the ranks agree bitwise, and
    each rank's launch counts;
  * the host clock over 3 all-reduces of a [2^18, 32] float32 tensor (the
    first call included, so the group's set-up counts).
Prints the card's name and power limit first.
"""

import datetime
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

W, H = 192, 160


def scene(device):
    rng = np.random.default_rng(0)
    n = 4096
    z = rng.uniform(2.0, 10.0, (n, 1))
    xy = rng.uniform(-0.5, 0.5, (n, 2)) * z
    means = np.concatenate([xy, z], 1).astype(np.float32)
    scales = (rng.uniform(0.005, 0.02, (n, 3)) * z).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, -1, keepdims=True)
    opac = rng.uniform(0.3, 0.9, (n,)).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    objs = rng.normal(size=(n, 16)).astype(np.float32)
    tgt = rng.uniform(0, 1, (3, H, W)).astype(np.float32)
    return ([torch.as_tensor(a, device=device)
             for a in (means, opac, scales, quats, colors, objs)],
            torch.as_tensor(tgt, device=device))


def render(mesh, device, windowed):
    """The render's image, the gradients of a squared loss w.r.t. the means
    and object features (on the host), and the launch counts."""
    from sags_tpu_torch.core.camera import make_camera
    from sags_tpu_torch.core.config import RasterizeConfig
    from sags_tpu_torch.ops import _build
    from sags_tpu_torch.ops import rasterize as rz

    A, tgt = scene(device)
    cfg = RasterizeConfig(max_tiles_per_gaussian=16, tile_capacity=256, chunk=32,
                          window_blocks=24, windowed_mid_frac=1.0, windowed_big_frac=1.0)
    m = A[0].clone().requires_grad_(True)
    o = A[5].clone().requires_grad_(True)
    cam = make_camera(torch.eye(3, device=device), torch.zeros(3, device=device), W, H,
                      1.2, 0.9)
    _build.reset_launch_counts()
    r = rz.rasterize(m, A[1], A[2], A[3], cam, cfg, colors=A[4], obj_features=o,
                     windowed=windowed, mesh=mesh)
    loss = (((r.color - tgt) ** 2).sum() + (r.final_T ** 2).sum()
            + (r.objects ** 2).sum() * 1e-3)
    g = torch.autograd.grad(loss, (m, o))
    torch.cuda.synchronize()
    return {"color": r.color.detach().cpu(), "g": [x.cpu() for x in g],
            "launches": {k.symbol: k.launches for k in _build.kernels()}}


def rank_main(rank, n, root):
    from sags_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(n, devices=["cuda:0"] * n)
        x = torch.full((4, 3), float(rank + 1), device=mesh.device)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        y = x.clone()
        dist.all_reduce(y)
        res = {"gather": [float(p[0, 0]) for p in parts], "reduce": float(y[0, 0])}
        for w in (False, True):
            res[w] = render(mesh, mesh.device, w)
        big = torch.ones((2 ** 18, 32), device=mesh.device)
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_reduce(big)
        torch.cuda.synchronize()
        res["allreduce_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        torch.save(res, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def same(a, b) -> bool:
    return torch.equal(a["color"], b["color"]) and all(
        torch.equal(x, y) for x, y in zip(a["g"], b["g"]))


def main() -> int:
    from sags_tpu_torch.ops import _build, binning, composite, windowed  # noqa: F401
    from sags_tpu_torch.parallel.mesh import make_mesh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    _build.build_all()
    device = torch.device("cuda:0")
    ref = {w: render(None, device, w) for w in (False, True)}
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group("nccl", init_method=f"file://{root}/rendezvous", rank=0,
                                world_size=1)
        try:
            mesh = make_mesh()
            for w in (False, True):
                print("nccl, 1 rank,", "windowed" if w else "classic", "bitwise:",
                      same(render(mesh, mesh.device, w), ref[w]), flush=True)
        finally:
            dist.destroy_process_group()
    for n in (2, 3):
        with tempfile.TemporaryDirectory() as root:
            mp.start_processes(rank_main, args=(n, root), nprocs=n, start_method="spawn")
            res = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
                   for r in range(n)]
        print(f"gloo, {n} ranks: all_gather {res[0]['gather']}, all_reduce "
              f"{res[0]['reduce']}, all-reduce of 32 MiB ms {[r['allreduce_ms'] for r in res]}")
        for w in (False, True):
            a, b = res[0][w], ref[w]
            print(f"  {'windowed' if w else 'classic'}: image max diff "
                  f"{float((a['color'] - b['color']).abs().max())}, gradients max rel diff "
                  f"{[float((x - y).abs().max() / y.abs().max()) for x, y in zip(a['g'], b['g'])]},"
                  f" ranks bitwise {all(same(r[w], a) for r in res)}, launches "
                  f"{[r[w]['launches'] for r in res]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
