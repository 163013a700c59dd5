"""Binary and ascii PLY point-cloud I/O on numpy structured arrays (the
port's own copy of regtr_tpu/utils/ply.py; a CPU test holds files written
by either readable by both, bitwise).
"""
from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}
_INV_TYPES = {"i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
              "i4": "int", "u4": "uint", "f4": "float", "f8": "double"}


def read_ply(path):
    """Read a PLY file -> dict of property name -> 1-D numpy array
    (vertex element only)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a ply file")
        fmt = None
        num_verts = 0
        props = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii", "ignore")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    num_verts = int(count)
            elif line.startswith("property") and in_vertex:
                parts = line.split()
                if parts[1] == "list":
                    raise ValueError("list properties unsupported for vertex")
                props.append((parts[2], _PLY_TYPES[parts[1]]))
            elif line == "end_header":
                break

        if fmt == "ascii":
            data = np.loadtxt(f, max_rows=num_verts)
            return {
                name: data[:, i].astype(dt)
                for i, (name, dt) in enumerate(props)
            }
        endian = "<" if fmt == "binary_little_endian" else ">"
        dtype = np.dtype([(n, endian + t) for n, t in props])
        data = np.frombuffer(f.read(num_verts * dtype.itemsize), dtype=dtype)
        return {n: np.ascontiguousarray(data[n]) for n, _ in props}


def read_ply_xyz(path) -> np.ndarray:
    """(N, 3) float32 xyz from a PLY file."""
    d = read_ply(path)
    return np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)


def write_ply(path, arrays, names):
    """Write named per-point arrays to a binary little-endian PLY.

    Args:
        arrays: (N, k) array or list of (N,)/(N, ki) arrays.
        names: list of property names, total length = sum of ki.
    """
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    cols = []
    for a in arrays:
        a = np.asarray(a)
        if a.ndim == 1:
            a = a[:, None]
        for i in range(a.shape[1]):
            cols.append(np.ascontiguousarray(a[:, i]))
    if len(cols) != len(names):
        raise ValueError(f"{len(cols)} columns but {len(names)} names")
    n = len(cols[0])
    dtype = np.dtype([
        (name, "<" + col.dtype.str[1:]) for name, col in zip(names, cols)
    ])
    out = np.empty(n, dtype=dtype)
    for name, col in zip(names, cols):
        out[name] = col
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name, col in zip(names, cols):
            f.write(
                f"property {_INV_TYPES[col.dtype.str[1:]]} {name}\n".encode()
            )
        f.write(b"end_header\n")
        f.write(out.tobytes())
