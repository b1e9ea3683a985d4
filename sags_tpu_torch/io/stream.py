"""ROS-free live frame streaming over TCP (own copy of `sags_tpu.io.stream`).

A publisher sends already-synchronized `Frame`s as length-prefixed npz
records over a socket, and `socket_frames` yields them as a generator that
plugs straight into `SLAMPipeline.run` (which stages frames through
`io.queue.FrameQueue` and applies the `cfg.timeout_s` source-silence
shutdown).

Wire format per record: 8-byte big-endian length, then an `np.savez`
archive of the Frame's array fields (npz, not pickle — safe to receive
from an untrusted peer). A zero length terminates the stream. The format is
the JAX package's: a record written by either package decodes in the other.
A field that holds a tensor (on any device) is written through numpy.
"""

from __future__ import annotations

import io as _io
import socket
import struct
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from sags_tpu_torch.io.datasets import Frame

_LEN = struct.Struct(">Q")
MAX_RECORD_BYTES = 256 << 20  # reject absurd headers (DoS / desync guard)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _encode(frame: Frame) -> bytes:
    buf = _io.BytesIO()
    arrays = {
        "image": _np(frame.image),
        "points": _np(frame.points),
        "colors": _np(frame.colors),
        # pose=None (pose-less raw-odometry stream) rides as NaNs — npz has
        # no null; the decoder maps all-NaN back to None
        "pose": (np.full((4, 4), np.nan, np.float32)
                 if frame.pose is None else _np(frame.pose)),
        "timestamp": np.float64(frame.timestamp),
    }
    for name in ("depth", "imu", "scan"):
        if getattr(frame, name) is not None:
            arrays[name] = _np(getattr(frame, name))
    np.savez(buf, **arrays)
    return buf.getvalue()


def _decode(payload: bytes) -> Frame:
    z = np.load(_io.BytesIO(payload))
    pose = z["pose"]
    return Frame(
        image=z["image"], points=z["points"], colors=z["colors"],
        pose=None if np.isnan(pose).all() else pose,
        timestamp=float(z["timestamp"]),
        depth=z["depth"] if "depth" in z else None,
        imu=z["imu"] if "imu" in z else None,
        scan=z["scan"] if "scan" in z else None,
    )


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        b = conn.recv(min(n, 1 << 20))
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def serve_frames(frames: Iterable[Frame], port: int = 0, host: str = "127.0.0.1",
                 ready=None) -> int:
    """Publish `frames` to the first client that connects; returns the bound
    port (useful with port=0). `ready`, if given, is a `threading.Event`
    set once listening, with the bound port as its `port` attribute."""
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(1)
    bound = srv.getsockname()[1]
    if ready is not None:
        ready.port = bound  # type: ignore[attr-defined]
        ready.set()
    conn, _ = srv.accept()
    try:
        for f in frames:
            payload = _encode(f)
            conn.sendall(_LEN.pack(len(payload)))
            conn.sendall(payload)
        conn.sendall(_LEN.pack(0))
    finally:
        conn.close()
        srv.close()
    return bound


def socket_frames(port: int, host: str = "127.0.0.1", connect_timeout: float = 10.0,
                  first_frame_timeout: Optional[float] = 60.0) -> Iterator[Frame]:
    """Generator of Frames from a `serve_frames` publisher. Blocks on the
    socket between frames; the first frame gets `first_frame_timeout`, after
    which source silence belongs to the pipeline's FrameQueue. A clean
    stream ends with the zero-length terminator; bare EOF or a desynced or
    oversized header raises ConnectionError. Connection attempts retry until
    `connect_timeout` elapses."""
    deadline = time.monotonic() + connect_timeout
    while True:
        try:
            conn = socket.create_connection((host, port), timeout=2.0)
            break
        except OSError:
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.25)
    conn.settimeout(first_frame_timeout)
    try:
        first = True
        while True:
            try:
                hdr = _recv_exact(conn, _LEN.size)
            except socket.timeout:
                raise ConnectionError(
                    f"publisher sent no frame within {first_frame_timeout}s")
            if hdr is None:
                raise ConnectionError("stream ended without the zero-length terminator "
                                      "(publisher crashed?)")
            (n,) = _LEN.unpack(hdr)
            if n == 0:
                return
            if n > MAX_RECORD_BYTES:
                raise ConnectionError(f"record header {n} bytes: desync/DoS")
            payload = _recv_exact(conn, n)
            if payload is None:
                raise ConnectionError("stream ended mid-record")
            if first:
                conn.settimeout(None)  # silence now belongs to FrameQueue
                first = False
            yield _decode(payload)
    finally:
        conn.close()
