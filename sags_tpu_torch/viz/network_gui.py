"""SIBR remote-viewer socket — `gaussian_renderer/network_gui.py` equivalent
(own copy of `sags_tpu.viz.network_gui`).

Protocol (`network_gui.py:43-86`): length-prefixed (4-byte little-endian)
JSON request carrying resolution, fovs, near/far, train flags, scaling
modifier and row-flattened view / view-projection matrices (with the SIBR
y/z column sign flip); the server replies with raw RGB bytes + a
length-prefixed verification string.

The render itself goes through this package's rasterizer on the map's
device; the socket stays a plain blocking host thread (it is a debugging
tool, not a data path), and a reply's bytes come from one copy of the
render to the host.
"""

from __future__ import annotations

import json
import socket
from typing import Callable, Optional

import numpy as np
import torch

from sags_tpu_torch import resolve_device


class MiniCam:
    """The viewer-supplied camera (`scene/cameras.py` MiniCam): matrices come
    from the wire, already composed, and land in a `Camera` on `device`
    (default: the card)."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view, full_proj, device=None):
        from sags_tpu_torch.core.camera import Camera

        device = resolve_device(device)
        # wire matrices are row-flattened torch-convention (transposed);
        # convert to math convention
        V = np.asarray(world_view, np.float32).reshape(4, 4).T
        PV = np.asarray(full_proj, np.float32).reshape(4, 4).T
        cam_center = np.linalg.inv(V)[:3, 3]
        to = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        self.camera = Camera(width, height, fovx, fovy, to(V), to(PV), to(cam_center),
                             znear=znear, zfar=zfar)


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009, device=None):
        self.host, self.port = host, port
        self.device = device  # where MiniCam puts the cameras (None: the card)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def receive(self):
        """→ (MiniCam|None, do_training, keep_alive, scaling_modifier)."""
        msg = self.read()
        w, h = msg["resolution_x"], msg["resolution_y"]
        if w == 0 or h == 0:
            return None, None, None, None
        V = np.asarray(msg["view_matrix"], np.float32).reshape(4, 4)
        PV = np.asarray(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        # SIBR flips y/z columns (`network_gui.py:73-76`)
        V[:, 1] *= -1
        V[:, 2] *= -1
        PV[:, 1] *= -1
        cam = MiniCam(w, h, msg["fov_y"], msg["fov_x"], msg["z_near"],
                      msg["z_far"], V, PV, device=self.device)
        return cam, bool(msg["train"]), bool(msg["keep_alive"]), msg["scaling_modifier"]

    def serve_once(self, render_fn: Callable, verify: str = "ok") -> bool:
        """One request/response cycle. `render_fn(camera) -> [3,H,W] float`
        (a tensor on any device, or an array). Returns False when no client
        is connected."""
        if self.conn is None:
            self.try_connect()
            if self.conn is None:
                return False
        try:
            cam, do_training, keep_alive, scale_mod = self.receive()
            img_bytes = None
            if cam is not None:
                img = render_fn(cam.camera)
                img = img.cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
                img = np.clip(img * 255, 0, 255).astype(np.uint8)
                img_bytes = memoryview(np.ascontiguousarray(img.transpose(1, 2, 0)))
            self.send(img_bytes, verify)
            return True
        except (ConnectionError, OSError):
            self.conn = None
            return False

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
