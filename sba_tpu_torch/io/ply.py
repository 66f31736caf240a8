"""Minimal PLY point-cloud IO (ascii + binary_little_endian).

Port of ``sba_tpu/io/ply.py`` (host numpy; the same files byte for byte).

Used by model_transformer and the dense pipeline for point clouds with
float x/y/z (+ optional nx/ny/nz, uchar r/g/b). Capability slice of the
reference's util/ply.{h,cc} ReadPly/WritePly.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "char": ("i1", 1), "int8": ("i1", 1),
    "short": ("i2", 2), "ushort": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
}


def read_ply(path):
    """Returns dict with 'xyz' [N,3] f64 and optional 'rgb' [N,3] u8,
    'normals' [N,3] f64."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        props = []          # (name, numpy dtype str) for 'vertex'
        counts = {}
        element = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            parts = line.decode("ascii", "replace").strip().split()
            if not parts:
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                element = parts[1]
                counts[element] = int(parts[2])
            elif parts[0] == "property" and element == "vertex":
                if parts[1] == "list":
                    raise ValueError("list property on vertex unsupported")
                props.append((parts[2], _DTYPES[parts[1]][0]))
            elif parts[0] == "end_header":
                break
        n = counts.get("vertex", 0)
        if fmt == "ascii":
            rows = []
            for _ in range(n):
                rows.append(f.readline().split())
            arr = np.array(rows, dtype=np.float64)
            data = {name: arr[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(name, "<" + d) for name, d in props])
            raw = np.frombuffer(f.read(dt.itemsize * n), dt)
            data = {name: raw[name].astype(np.float64)
                    for name, _ in props}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    out = {"xyz": np.stack([data["x"], data["y"], data["z"]], -1)}
    if all(k in data for k in ("red", "green", "blue")):
        out["rgb"] = np.stack([data["red"], data["green"],
                               data["blue"]], -1).astype(np.uint8)
    if all(k in data for k in ("nx", "ny", "nz")):
        out["normals"] = np.stack([data["nx"], data["ny"], data["nz"]], -1)
    return out


def write_ply(path, xyz, rgb=None, normals=None, binary=True):
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    header = ["ply",
              "format binary_little_endian 1.0" if binary
              else "format ascii 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    cols = [xyz]
    if normals is not None:
        header += ["property float nx", "property float ny",
                   "property float nz"]
        cols.append(np.asarray(normals, np.float32))
    fields = [("xyz", "<f4", 3)]
    if normals is not None:
        fields.append(("n", "<f4", 3))
    if rgb is not None:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
        fields.append(("rgb", "u1", 3))
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if binary:
            dt = np.dtype([(name, d, (k,)) for name, d, k in fields])
            rec = np.zeros(n, dt)
            rec["xyz"] = xyz
            if normals is not None:
                rec["n"] = np.asarray(normals, np.float32)
            if rgb is not None:
                rec["rgb"] = np.asarray(rgb, np.uint8)
            f.write(rec.tobytes())
        else:
            for i in range(n):
                row = list(xyz[i])
                if normals is not None:
                    row += list(np.asarray(normals[i], np.float32))
                if rgb is not None:
                    row += [int(v) for v in rgb[i]]
                f.write((" ".join(str(v) for v in row) + "\n").encode())
