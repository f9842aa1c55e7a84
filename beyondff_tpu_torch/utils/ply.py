"""Minimal PLY reader (ascii + binary_little_endian), torch/open3d-free.

Covers the vertex properties the pipeline needs (x/y/z, colors); replaces the
reference's Open3D and plyfile dependencies (reference: tools/utils/
ply2npy.py:9, evaluation/eval/instance_eval_util.py:32-41). The port's copy
of beyondff_tpu/utils/ply.py.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply_vertices(path: str) -> Dict[str, np.ndarray]:
    """Returns a dict of vertex property arrays (e.g. x, y, z, red, ...)."""
    with open(path, "rb") as f:
        header, offset = _read_header(f)
    fmt = header["format"]
    count = header["vertex_count"]
    props = header["properties"]
    if fmt == "ascii":
        data = np.loadtxt(path, skiprows=header["header_lines"], max_rows=count)
        if data.ndim == 1:
            data = data[None]
        return {name: data[:, i] for i, (name, _) in enumerate(props)}
    if fmt != "binary_little_endian":
        raise ValueError(f"unsupported PLY format {fmt!r}")
    dtype = np.dtype([(name, "<" + _TYPES[t]) for name, t in props])
    with open(path, "rb") as f:
        f.seek(offset)
        arr = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)
    return {name: np.array(arr[name]) for name, _ in props}


def read_point_cloud(path: str) -> np.ndarray:
    """(N, 3) xyz float64."""
    v = read_ply_vertices(path)
    return np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)


def read_point_cloud_with_colors(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """((N,3) xyz, (N,3) rgb in [0,1]); zeros when the file has no colors."""
    v = read_ply_vertices(path)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    if "red" in v:
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float64)
        if rgb.max() > 1.0:
            rgb = rgb / 255.0
    else:
        rgb = np.zeros_like(xyz)
    return xyz, rgb


def _read_header(f):
    line = f.readline().strip()
    if line != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    props = []
    vertex_count = 0
    in_vertex = False
    header_lines = 1
    while True:
        line = f.readline()
        header_lines += 1
        parts = line.strip().decode("ascii", "replace").split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                vertex_count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list property on vertex element unsupported")
            props.append((parts[2], parts[1]))
        elif parts[0] == "end_header":
            break
    return (
        {"format": fmt, "vertex_count": vertex_count, "properties": props,
         "header_lines": header_lines},
        f.tell(),
    )
