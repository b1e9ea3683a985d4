"""Host-side async frame queue (`sags_tpu.io.queue` in torch): a producer
thread stages each frame into fixed-size device buffers behind a bounded
queue, so the upload of frame k+1 overlaps the work on frame k. On a CUDA
device the staging goes through pinned host memory with `non_blocking`
copies."""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from sags_tpu_torch.io.datasets import Frame
from sags_tpu_torch.utils.profiling import span


class DeviceFrame(NamedTuple):
    """A frame staged on the device with static shapes (points padded + masked)."""

    image: torch.Tensor  # [3,H,W]
    points: torch.Tensor  # [P,3]
    colors: torch.Tensor  # [P,3]
    mask: torch.Tensor  # [P]
    pose: torch.Tensor  # [4,4]
    timestamp: float
    sensor_frame: bool = False  # `points` holds the sensor-frame scan
    scan: Optional[torch.Tensor] = None  # [S,3] tracker input
    scan_mask: Optional[torch.Tensor] = None  # [S]


def upload(a, device) -> torch.Tensor:
    """A host array as a tensor on `device`: on CUDA through pinned memory
    with a `non_blocking` copy, which does not wait for the host."""
    device = torch.device(device)
    t = torch.from_numpy(np.array(a))  # own, writable, contiguous copy
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def stage_frame(frame: Frame, point_budget: int, device,
                scan_budget: Optional[int] = None) -> DeviceFrame:
    put = lambda a: upload(a, device)

    sensor = frame.pose is None
    src = frame.scan if sensor else frame.points
    n = min(len(src), point_budget)
    pts = np.zeros((point_budget, 3), np.float32)
    cols = np.zeros((point_budget, 3), np.float32)
    msk = np.zeros(point_budget, bool)
    pts[:n] = src[:n]
    cols[:n] = frame.colors[:n]
    msk[:n] = True
    scan_d = scan_mask_d = None
    if scan_budget is not None:
        if frame.scan is not None:
            sc = np.asarray(frame.scan, np.float32)
        elif frame.pose is not None:
            Tw = np.asarray(frame.pose, np.float32)
            sc = (np.asarray(frame.points, np.float32) - Tw[:3, 3]) @ Tw[:3, :3]
        else:
            sc = np.zeros((0, 3), np.float32)
        ns = min(len(sc), scan_budget)
        scan_p = np.zeros((scan_budget, 3), np.float32)
        scan_p[:ns] = sc[:ns]
        smsk = np.zeros(scan_budget, bool)
        smsk[:ns] = True
        scan_d, scan_mask_d = put(scan_p), put(smsk)
    pose = np.eye(4, dtype=np.float32) if sensor else np.asarray(frame.pose, np.float32)
    return DeviceFrame(
        image=put(np.asarray(frame.image, np.float32)), points=put(pts),
        colors=put(cols), mask=put(msk), pose=put(pose),
        timestamp=frame.timestamp, sensor_frame=sensor, scan=scan_d,
        scan_mask=scan_mask_d)


class FrameQueue:
    """Bounded prefetch queue: a daemon thread stages frames ahead of use and
    yields `(DeviceFrame, Frame)` pairs. `timeout_s` ends the stream after
    that much source silence (the reference's topic-silence shutdown)."""

    _DONE = object()

    def __init__(self, frames: Iterable[Frame], point_budget: int, device,
                 prefetch: int = 2, timeout_s: Optional[float] = None,
                 scan_budget: Optional[int] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._point_budget = point_budget
        self._scan_budget = scan_budget
        self._device = device
        self._timeout_s = timeout_s
        self.timed_out = False
        self._err: Optional[BaseException] = None
        self._waiting_source = True
        self._stop = False
        self._last_rx = time.monotonic()
        self._thread = threading.Thread(target=self._produce, args=(iter(frames),),
                                        daemon=True, name="frame-queue")
        self._thread.start()

    def _produce(self, it: Iterator[Frame]):
        try:
            while not self._stop:
                self._waiting_source = True
                try:
                    f = next(it)
                except StopIteration:
                    break
                self._waiting_source = False
                self._last_rx = time.monotonic()
                with span("queue.stage"):
                    item = (stage_frame(f, self._point_budget, self._device,
                                        scan_budget=self._scan_budget), f)
                if not self._put_unless_stopped(item):
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._err = e
        finally:
            self._put_unless_stopped(self._DONE)

    def _put_unless_stopped(self, item) -> bool:
        while True:
            try:
                self._q.put(item, timeout=0.25)
                return True
            except queue.Full:
                if self._stop:
                    return False

    def close(self) -> None:
        """Stop the producer and wait for it."""
        self._stop = True
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)

    def __iter__(self):
        first = True
        while True:
            try:
                poll = 0.25 if (self._timeout_s is not None and not first) else None
                with span("queue.wait"):
                    item = self._q.get(timeout=poll)
            except queue.Empty:
                if (self._waiting_source
                        and time.monotonic() - self._last_rx > self._timeout_s):
                    self.timed_out = True
                    self.close()
                    return
                continue
            if item is self._DONE:
                self._thread.join()
                if self._err is not None:
                    raise self._err
                return
            first = False
            yield item
