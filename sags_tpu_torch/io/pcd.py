"""PCL .pcd point-cloud I/O (ascii + binary), the fast_gicp test-data format
(an own copy of `sags_tpu.io.pcd`; numpy only)."""

from __future__ import annotations

import numpy as np

_DTYPES = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 4): "<i4", ("U", 4): "<u4",
           ("I", 1): "<i1", ("U", 1): "<u1", ("I", 2): "<i2", ("U", 2): "<u2"}


def load_pcd(path: str, fields=("x", "y", "z")) -> np.ndarray:
    """Read a .pcd file, returning the requested fields as [N, len(fields)]."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val.split()
            if key == "DATA":
                break
        names = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = [t for t in header["TYPE"]]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(names))]
        n = int(header["POINTS"][0])
        fmt = header["DATA"][0]

        dtype = np.dtype(
            [
                (nm if cnt == 1 else f"{nm}", _DTYPES[(tp, sz)], (cnt,) if cnt > 1 else ())
                for nm, sz, tp, cnt in zip(names, sizes, types, counts)
            ]
        )
        if fmt == "binary":
            data = np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype, count=n)
        elif fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            out = np.stack([data[:, names.index(fl)] for fl in fields], -1)
            return out.astype(np.float32)
        else:
            raise ValueError(f"unsupported PCD data format {fmt!r}")
    return np.stack([np.asarray(data[fl], np.float32) for fl in fields], -1)


def save_pcd(path: str, points: np.ndarray):
    """Write [N,3] float32 points as a binary x y z .pcd."""
    points = np.asarray(points, np.float32)
    n = len(points)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(points.tobytes())
