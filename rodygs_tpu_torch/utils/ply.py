"""Minimal PLY reader/writer (ascii and binary little-endian), numpy only.
Port of `rodygs_tpu/utils/ply.py` (unchanged): vertex elements with float
or uchar properties (x y z, red green blue, nx ny nz, time), the RoDyGS
data contract's point clouds.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Read the `vertex` element into a dict of per-property arrays."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, np_dtype)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    # list properties unsupported (not in the data contract);
                    # only legal for non-vertex elements we skip anyway.
                    elements[-1][2].append(("__list__", tokens[-1]))
                else:
                    elements[-1][2].append((tokens[-1], _DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        out: dict[str, np.ndarray] = {}
        for name, count, props in elements:
            if any(p[0] == "__list__" for p in props):
                raise ValueError(f"{path}: list properties unsupported")
            if fmt == "ascii":
                rows = np.loadtxt(
                    [f.readline() for _ in range(count)], dtype=np.float64,
                    ndmin=2)
                if name == "vertex":
                    for i, (pname, dt) in enumerate(props):
                        out[pname] = rows[:, i].astype(dt)
            else:
                endian = "<" if "little" in fmt else ">"
                dtype = np.dtype([(p, endian + d) for p, d in props])
                data = np.frombuffer(f.read(count * dtype.itemsize),
                                     dtype=dtype, count=count)
                if name == "vertex":
                    for pname, _ in props:
                        out[pname] = np.ascontiguousarray(data[pname])
        return out


def write_ply(path: str | Path, points: np.ndarray,
              colors: np.ndarray | None = None,
              normals: np.ndarray | None = None,
              time: np.ndarray | None = None) -> None:
    """Write a binary little-endian vertex PLY with the RoDyGS field layout."""
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if time is not None:
        fields += [("time", "<f4")]
    arr = np.empty(n, dtype=np.dtype(fields))
    arr["x"], arr["y"], arr["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        arr["nx"], arr["ny"], arr["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        c = np.clip(colors * 255.0, 0, 255).astype(np.uint8) \
            if colors.dtype.kind == "f" else colors.astype(np.uint8)
        arr["red"], arr["green"], arr["blue"] = c[:, 0], c[:, 1], c[:, 2]
    if time is not None:
        arr["time"] = np.asarray(time).reshape(-1)

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    type_names = {"<f4": "float", "u1": "uchar"}
    for name, dt in fields:
        header.append(f"property {type_names[dt]} {name}")
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(arr.tobytes())


def fetch_pointcloud(path: str | Path):
    """The reference `fetchPly` contract: positions, colors in [0,1],
    normals (zeros if absent), time (None if absent)."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        cols = cols.astype(np.float32)
        if cols.max() > 1.001:
            cols = cols / 255.0
    else:
        cols = np.zeros_like(pts)
    if "nx" in v:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    time = v["time"].astype(np.float32)[:, None] if "time" in v else None
    return pts, cols, normals, time
