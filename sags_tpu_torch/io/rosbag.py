"""Pure-Python ROS1 bag ingestion — the reference's actual front door (own
copy of `sags_tpu.io.rosbag`: the same records, codecs, synchronizer and
writer; frames are this package's `io.datasets.Frame`).

The reference node is driven by three ROS topics joined by an
ApproximateTimeSynchronizer (`scripts/gaussian_splatting.py:227-235`):
`/rgb_img` (sensor_msgs/Image), `/cloud_registered` (sensor_msgs/
PointCloud2), `/aft_mapped_to_init` (nav_msgs/Odometry), usually replayed
from a rosbag. This module provides the same ingestion path without any
ROS installation:

  * `read_bag` — a ROS1 "#ROSBAG V2.0" record/chunk parser (none or bz2
    chunk compression) yielding (topic, type, stamp, raw_bytes) without
    needing the bag's index records.
  * message codecs for the four message types the contract uses
    (Image, PointCloud2, Odometry, Imu), matching the node's decode
    behavior: `read_points_direct`'s structured-dtype PointCloud2 parse and
    the packed-float rgb split (`scripts/gaussian_splatting.py:105-134`).
  * `ApproximateTimeSynchronizer` — queue_size/slop matching with the same
    contract as `message_filters.ApproximateTimeSynchronizer` (greedy
    minimum-spread pivot matching; behavioral equivalent, documented).
  * `RosbagDataset` — bag → synchronized `Frame` stream that plugs into
    `SLAMPipeline.run` like any other dataset (generator: frames are
    staged through the pipeline's queue, honoring `cfg.timeout_s`).
  * `write_bag` — a minimal unindexed-bag writer (fixtures, or exporting
    any dataset back into ROS tooling; `rosbag reindex` restores the
    index).
"""

from __future__ import annotations

import bz2
import collections
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_IDX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONN = 0x07

_u32 = struct.Struct("<I")
_u8 = struct.Struct("<B")


# ---------------------------------------------------------------------------
# Record-level bag format
# ---------------------------------------------------------------------------


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = _u32.unpack_from(buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        k, _, v = field.partition(b"=")
        fields[k] = v
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = _u32.unpack_from(buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = _u32.unpack_from(buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


def _iter_file_records(f) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    """Stream top-level records from an open bag file handle — O(record)
    memory, so multi-GB bags never materialize in RAM (chunk payloads are
    decompressed one chunk at a time by the caller)."""
    while True:
        head = f.read(4)
        if len(head) < 4:
            return
        (hlen,) = _u32.unpack(head)
        header = _parse_header(f.read(hlen))
        dhead = f.read(4)
        if len(dhead) < 4:
            return
        (dlen,) = _u32.unpack(dhead)
        data = f.read(dlen)
        if len(data) < dlen:
            return
        yield header, data


def read_bag(
    path: str, topics: Optional[Sequence[str]] = None
) -> Iterator[Tuple[str, str, float, bytes]]:
    """Yield (topic, msg_type, stamp_seconds, raw_message_bytes) in file
    order. Reads sequentially through chunk records — no bag index needed
    (works on unindexed/crashed bags, like `rosbag reindex` input) — and
    STREAMS from the file handle: peak memory is one (decompressed) chunk,
    not the bag size."""
    want = set(topics) if topics is not None else None
    conns: Dict[int, Tuple[str, str]] = {}  # conn id -> (topic, type)

    def _emit(records):
        for header, data in records:
            op = header.get(b"op", b"\x00")[0]
            if op == _OP_CONN:
                (cid,) = _u32.unpack(header[b"conn"])
                ch = _parse_header(data)
                topic = header.get(b"topic", ch.get(b"topic", b"")).decode()
                mtype = ch.get(b"type", b"").decode()
                conns[cid] = (topic, mtype)
            elif op == _OP_MSG:
                (cid,) = _u32.unpack(header[b"conn"])
                secs, nsecs = struct.unpack("<II", header[b"time"])
                topic, mtype = conns.get(cid, ("?", "?"))
                if want is None or topic in want:
                    yield topic, mtype, secs + nsecs * 1e-9, data
            elif op == _OP_CHUNK:
                comp = header.get(b"compression", b"none")
                if comp == b"bz2":
                    payload = bz2.decompress(data)
                elif comp in (b"none", b""):
                    payload = data
                else:
                    raise ValueError(
                        f"unsupported bag chunk compression: {comp.decode()!r}"
                        " (only none/bz2; re-write the bag uncompressed)"
                    )
                yield from _emit(_iter_records(payload))
            # bag header / index / chunk-info records carry no messages

    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"not a ROS1 v2.0 bag: {path}")
        yield from _emit(_iter_file_records(f))


# ---------------------------------------------------------------------------
# ROS1 message codecs (little-endian wire format)
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self):
        (v,) = _u8.unpack_from(self.buf, self.off)
        self.off += 1
        return v

    def u32(self):
        (v,) = _u32.unpack_from(self.buf, self.off)
        self.off += 4
        return v

    def f64(self, n=1):
        v = np.frombuffer(self.buf, "<f8", n, self.off)
        self.off += 8 * n
        return v if n > 1 else float(v[0])

    def string(self):
        n = self.u32()
        s = self.buf[self.off:self.off + n]
        self.off += n
        return s.decode("utf-8", "replace")

    def raw(self, n):
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def header(self):
        seq = self.u32()
        secs, nsecs = self.u32(), self.u32()
        frame_id = self.string()
        return seq, secs + nsecs * 1e-9, frame_id


_PF_DTYPE = {1: "i1", 2: "u1", 3: "i2", 4: "u2", 5: "i4", 6: "u4",
             7: "f4", 8: "f8"}


def decode_image(raw: bytes) -> Tuple[float, np.ndarray]:
    """sensor_msgs/Image → (stamp, [3,H,W] float32 in [0,1]) for color
    encodings, or [H,W] float32 for mono/depth (16UC1 in millimeters →
    meters, matching the TUM convention)."""
    r = _Reader(raw)
    _, stamp, _ = r.header()
    H, W = r.u32(), r.u32()
    enc = r.string()
    r.u8()  # is_bigendian (ROS1 wire is LE in practice)
    step = r.u32()
    data = r.raw(r.u32())
    if enc in ("rgb8", "bgr8"):
        img = np.frombuffer(data, np.uint8).reshape(H, step)[:, : W * 3]
        img = img.reshape(H, W, 3).astype(np.float32) / 255.0
        if enc == "bgr8":
            img = img[..., ::-1]
        return stamp, np.ascontiguousarray(img.transpose(2, 0, 1))
    if enc == "mono8":
        img = np.frombuffer(data, np.uint8).reshape(H, step)[:, :W]
        return stamp, img.astype(np.float32) / 255.0
    if enc == "16UC1":
        img = np.frombuffer(data, "<u2").reshape(H, step // 2)[:, :W]
        return stamp, img.astype(np.float32) / 1000.0
    if enc == "32FC1":
        img = np.frombuffer(data, "<f4").reshape(H, step // 4)[:, :W]
        return stamp, img.astype(np.float32)
    raise ValueError(f"unsupported image encoding {enc}")


def decode_pointcloud2(raw: bytes) -> Tuple[float, np.ndarray, np.ndarray]:
    """sensor_msgs/PointCloud2 → (stamp, points [N,3] f32, colors [N,3] f32).

    Structured-dtype zero-copy parse with the packed-float rgb split —
    the node's `read_points_direct`/`read_xyz_rgb_from_raw`
    (`scripts/gaussian_splatting.py:105-134`). Clouds without an rgb field
    get mid-gray colors."""
    r = _Reader(raw)
    _, stamp, _ = r.header()
    H, W = r.u32(), r.u32()
    names, formats, offsets = [], [], []
    for _ in range(r.u32()):
        name = r.string()
        offset = r.u32()
        datatype = r.u8()
        count = r.u32()
        if count == 1 and datatype in _PF_DTYPE:
            names.append(name)
            formats.append("<" + _PF_DTYPE[datatype])
            offsets.append(offset)
    r.u8()  # is_bigendian
    point_step = r.u32()
    r.u32()  # row_step
    data = r.raw(r.u32())
    dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                   "itemsize": point_step})
    n = H * W
    arr = np.frombuffer(data[: n * point_step], dtype=dt)
    pts = np.stack([arr["x"], arr["y"], arr["z"]], 1).astype(np.float32)
    if "rgb" in names:
        packed = arr["rgb"].astype(np.float32).view(np.uint32)
        cols = np.stack(
            [(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], 1
        ).astype(np.float32) / 255.0
    else:
        cols = np.full((n, 3), 0.5, np.float32)
    finite = np.isfinite(pts).all(1)
    return stamp, pts[finite], cols[finite]


def decode_odometry(raw: bytes) -> Tuple[float, np.ndarray]:
    """nav_msgs/Odometry → (stamp, [4,4] pose). Quaternion is wire-order
    x,y,z,w (geometry_msgs/Quaternion)."""
    r = _Reader(raw)
    _, stamp, _ = r.header()
    r.string()  # child_frame_id
    px, py, pz = r.f64(), r.f64(), r.f64()
    qx, qy, qz, qw = r.f64(), r.f64(), r.f64(), r.f64()
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _quat_to_rot(qx, qy, qz, qw)
    T[:3, 3] = (px, py, pz)
    return stamp, T


def decode_imu(raw: bytes) -> Tuple[float, np.ndarray, np.ndarray]:
    """sensor_msgs/Imu → (stamp, gyro [3], accel [3])."""
    r = _Reader(raw)
    _, stamp, _ = r.header()
    r.f64(4)  # orientation
    r.f64(9)
    gyro = np.array([r.f64(), r.f64(), r.f64()], np.float32)
    r.f64(9)
    accel = np.array([r.f64(), r.f64(), r.f64()], np.float32)
    return stamp, gyro, accel


def _quat_to_rot(x, y, z, w) -> np.ndarray:
    n = max((x * x + y * y + z * z + w * w) ** 0.5, 1e-12)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float32)


# ---------------------------------------------------------------------------
# Approximate-time synchronization
# ---------------------------------------------------------------------------


class ApproximateTimeSynchronizer:
    """Join N timestamped streams — `message_filters.ApproximateTimeSynchronizer
    (queue_size=10, slop=0.1)` as used at `scripts/gaussian_splatting.py:227-235`.

    Behavioral equivalent (greedy pivot matching, not the upstream optimal
    set search): on every `add`, pick the latest head among the queues as
    the pivot, match each other queue's closest-in-time message, and emit
    when the worst pairwise offset is within `slop`; otherwise evict the
    globally oldest head once queues are full."""

    def __init__(self, n_streams: int, queue_size: int = 10, slop: float = 0.1):
        self.queues: List[collections.deque] = [
            collections.deque() for _ in range(n_streams)
        ]
        self.queue_size = queue_size
        self.slop = slop

    def add(self, stream: int, stamp: float, msg) -> List[Tuple]:
        """Returns the list of emitted synchronized tuples
        ((stamp_i, msg_i) per stream), possibly empty."""
        self.queues[stream].append((stamp, msg))
        out = []
        while True:
            group = self._try_match()
            if group is None:
                break
            out.append(group)
        for q in self.queues:
            while len(q) > self.queue_size:
                q.popleft()
        return out

    def _try_match(self):
        if any(not q for q in self.queues):
            return None
        pivot = max(q[0][0] for q in self.queues)
        chosen = []
        for q in self.queues:
            best = min(range(len(q)), key=lambda i: abs(q[i][0] - pivot))
            chosen.append(best)
        stamps = [q[i][0] for q, i in zip(self.queues, chosen)]
        if max(stamps) - min(stamps) <= self.slop:
            group = tuple(q[i] for q, i in zip(self.queues, chosen))
            for q, i in zip(self.queues, chosen):
                for _ in range(i + 1):  # drop the match and everything older
                    q.popleft()
            return group
        if all(len(q) >= self.queue_size for q in self.queues):
            oldest = min(range(len(self.queues)),
                         key=lambda s: self.queues[s][0][0])
            self.queues[oldest].popleft()
            return self._try_match()
        return None


# ---------------------------------------------------------------------------
# Dataset adapter
# ---------------------------------------------------------------------------


class RosbagDataset:
    """Iterate a bag's (image, cloud, odom[, imu]) topics as synchronized
    `Frame`s — the replayed-sensor equivalent of the reference's live node.

    `lidar_axes=True` applies the LiDAR→camera axis fix the node bakes into
    keyframe poses: `R · Rz(90°) · Rx(−90°)`
    (`scripts/gaussian_splatting.py:309-315`)."""

    def __init__(
        self,
        path: str,
        image_topic: str = "/rgb_img",
        cloud_topic: str = "/cloud_registered",
        odom_topic: str = "/aft_mapped_to_init",
        imu_topic: Optional[str] = None,
        queue_size: int = 10,
        slop: float = 0.1,
        lidar_axes: bool = False,
    ):
        self.path = path
        self.topics = {image_topic: 0, cloud_topic: 1, odom_topic: 2}
        self.imu_topic = imu_topic
        self.queue_size = queue_size
        self.slop = slop
        self.lidar_axes = lidar_axes

    def __iter__(self):
        from sags_tpu_torch.io.datasets import Frame

        want = list(self.topics) + ([self.imu_topic] if self.imu_topic else [])
        sync = ApproximateTimeSynchronizer(3, self.queue_size, self.slop)
        imu_buf: List[np.ndarray] = []
        last_imu_t: Optional[float] = None
        rot_fix = None
        if self.lidar_axes:
            # the reference's exact FLU→RDF fix — the SAME shared constant
            # the pipeline's keyframing applies (`gaussian_splatting.py:
            # 309-315`); an earlier quaternion-composed version here used
            # Rz(+90) and pointed the camera backwards
            from sags_tpu_torch.core.transforms import LIDAR_TO_CAM

            rot_fix = LIDAR_TO_CAM

        for topic, _, _, raw in read_bag(self.path, want):
            if topic == self.imu_topic:
                t, gyro, accel = decode_imu(raw)
                dt = 0.0 if last_imu_t is None else max(t - last_imu_t, 0.0)
                last_imu_t = t
                imu_buf.append(np.concatenate([gyro, accel, [dt]]).astype(np.float32))
                continue
            stream = self.topics[topic]
            if stream == 0:
                stamp, msg = decode_image(raw)
            elif stream == 1:
                stamp, pts, cols = decode_pointcloud2(raw)
                msg = (pts, cols)
            else:
                stamp, msg = decode_odometry(raw)
            for (ti, img), (_, (pts, cols)), (_, pose) in sync.add(
                stream, stamp, msg
            ):
                if rot_fix is not None:
                    pose = pose.copy()
                    pose[:3, :3] = pose[:3, :3] @ rot_fix
                imu = (np.stack(imu_buf) if imu_buf else None)
                imu_buf = []
                # /cloud_registered is world-frame (the FAST-LIVO2 output
                # contract); recover the sensor-frame scan through the SAME
                # (axis-fixed) pose so trackers get raw-scan semantics on
                # bag replays too
                scan = ((pts - pose[:3, 3]) @ pose[:3, :3]).astype(np.float32)
                yield Frame(image=img, points=pts, colors=cols, pose=pose,
                            timestamp=ti, imu=imu, scan=scan)


# ---------------------------------------------------------------------------
# Minimal writer (fixtures / exporting datasets into ROS tooling)
# ---------------------------------------------------------------------------


def _field(k: bytes, v: bytes) -> bytes:
    body = k + b"=" + v
    return _u32.pack(len(body)) + body


def _record(fields: Dict[bytes, bytes], data: bytes) -> bytes:
    header = b"".join(_field(k, v) for k, v in fields.items())
    return _u32.pack(len(header)) + header + _u32.pack(len(data)) + data


def _w_string(s: str) -> bytes:
    b = s.encode()
    return _u32.pack(len(b)) + b


def _w_header(stamp: float, frame_id: str = "map") -> bytes:
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    return struct.pack("<III", 0, secs, nsecs) + _w_string(frame_id)


def encode_image(stamp: float, img: np.ndarray) -> bytes:
    """[3,H,W] float32 → rgb8, or [H,W] float32 meters → 32FC1."""
    if img.ndim == 3:
        H, W = img.shape[1:]
        data = (np.clip(img.transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        enc, step, payload = "rgb8", W * 3, data.tobytes()
    else:
        H, W = img.shape
        enc, step = "32FC1", W * 4
        payload = img.astype("<f4").tobytes()
    return (_w_header(stamp) + struct.pack("<II", H, W) + _w_string(enc)
            + _u8.pack(0) + _u32.pack(step)
            + _u32.pack(len(payload)) + payload)


def encode_pointcloud2(stamp: float, pts: np.ndarray,
                       cols: Optional[np.ndarray] = None) -> bytes:
    n = len(pts)
    fields = [("x", 0, 7), ("y", 4, 7), ("z", 8, 7), ("rgb", 16, 7)]
    point_step = 32  # x y z pad rgb pad — FAST-LIVO2-style padded layout
    body = np.zeros((n, point_step // 4), "<f4")
    body[:, 0:3] = pts
    if cols is None:
        cols = np.full((n, 3), 0.5, np.float32)
    rgbu = ((np.clip(cols[:, 0], 0, 1) * 255).astype(np.uint32) << 16) | \
           ((np.clip(cols[:, 1], 0, 1) * 255).astype(np.uint32) << 8) | \
           (np.clip(cols[:, 2], 0, 1) * 255).astype(np.uint32)
    body[:, 4] = rgbu.view(np.float32)
    fbytes = _u32.pack(len(fields)) + b"".join(
        _w_string(nm) + _u32.pack(off) + _u8.pack(dt) + _u32.pack(1)
        for nm, off, dt in fields
    )
    payload = body.tobytes()
    return (_w_header(stamp) + struct.pack("<II", 1, n) + fbytes
            + _u8.pack(0) + struct.pack("<II", point_step, point_step * n)
            + _u32.pack(len(payload)) + payload + _u8.pack(1))


def encode_odometry(stamp: float, pose: np.ndarray) -> bytes:
    # branch-robust Shepperd conversion — the trace-only formula divides by
    # ~0 for rotations near 180° (trace → −1) and wrote garbage quaternions
    from sags_tpu_torch.utils.traj import _rotmat_to_quat_xyzw

    R = pose[:3, :3]
    t = pose[:3, 3]
    qx, qy, qz, qw = (float(v) for v in _rotmat_to_quat_xyzw(R))
    return (_w_header(stamp) + _w_string("base")
            + struct.pack("<7d", t[0], t[1], t[2], qx, qy, qz, qw)
            + struct.pack("<36d", *([0.0] * 36))
            + struct.pack("<6d", *([0.0] * 6))
            + struct.pack("<36d", *([0.0] * 36)))


def encode_imu(stamp: float, gyro: np.ndarray, accel: np.ndarray) -> bytes:
    return (_w_header(stamp)
            + struct.pack("<4d", 0, 0, 0, 1) + struct.pack("<9d", *([0.0] * 9))
            + struct.pack("<3d", *map(float, gyro))
            + struct.pack("<9d", *([0.0] * 9))
            + struct.pack("<3d", *map(float, accel))
            + struct.pack("<9d", *([0.0] * 9)))


_TYPES = {
    "sensor_msgs/Image": "060021388200f6f0f447d0fcd9c64743",
    "sensor_msgs/PointCloud2": "1158d486dd51d683ce2f1be655c3c181",
    "nav_msgs/Odometry": "cd5e73d190d741a2f92e81eda573aca7",
    "sensor_msgs/Imu": "6a62c6daae103f4ff57a132d6f95cec2",
}


def write_bag(path: str, messages: Iterable[Tuple[str, str, float, bytes]]):
    """Write an unindexed ROS1 v2.0 bag. `messages` are
    (topic, msg_type, stamp_seconds, raw_bytes) — the same tuples
    `read_bag` yields, with bodies from the encode_* helpers."""
    msgs = list(messages)
    conn_ids: Dict[str, int] = {}
    chunk = b""
    for topic, mtype, _, _ in msgs:
        if topic not in conn_ids:
            cid = len(conn_ids)
            conn_ids[topic] = cid
            ch = (_field(b"topic", topic.encode())
                  + _field(b"type", mtype.encode())
                  + _field(b"md5sum", _TYPES.get(mtype, "*").encode())
                  + _field(b"message_definition", b""))
            chunk += _record(
                {b"op": b"\x07", b"conn": _u32.pack(cid),
                 b"topic": topic.encode()}, ch
            )
    for topic, _, stamp, raw in msgs:
        secs = int(stamp)
        nsecs = int(round((stamp - secs) * 1e9))
        chunk += _record(
            {b"op": b"\x02", b"conn": _u32.pack(conn_ids[topic]),
             b"time": struct.pack("<II", secs, nsecs)}, raw
        )
    with open(path, "wb") as f:
        f.write(MAGIC)
        bag_hdr = {b"op": b"\x03", b"index_pos": struct.pack("<Q", 0),
                   b"conn_count": _u32.pack(len(conn_ids)),
                   b"chunk_count": _u32.pack(1)}
        hdr_rec_body = b" " * 4096  # spec: header record padded with spaces
        f.write(_record(bag_hdr, hdr_rec_body))
        f.write(_record(
            {b"op": b"\x05", b"compression": b"none",
             b"size": _u32.pack(len(chunk))}, chunk
        ))
