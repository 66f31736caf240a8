"""COLMAP dense-map binary IO (depth_maps/*.bin, normal_maps/*.bin).

Port of ``sba_tpu/mvs/depth_maps.py`` (numpy only, kept here as the
port's own copy). Format parity with ref: src/mvs/mat.h
``Mat<T>::Read/Write``: an ASCII header ``"<width>&<height>&<channels>&"``
followed by little-endian float32 data, slice-major planes, row-major
within a plane. Files written here load in stock COLMAP and vice versa.
"""

from __future__ import annotations

import os

import numpy as np


def write_colmap_map(arr: np.ndarray, path):
    """arr: [H, W] or [H, W, C] float32."""
    a = np.asarray(arr, np.float32)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode())
        # On-disk layout per ref mvs/mat.h:115 Get():
        # data[slice*W*H + row*W + col] — slice-major planes, row-major
        # within a plane. (The reference's python write_array transposes
        # differently and does NOT round-trip with its own reader for
        # C>1; mat.h is the ground truth we match.)
        f.write(np.ascontiguousarray(a.transpose(2, 0, 1)).tobytes())


def read_colmap_map(path) -> np.ndarray:
    """Returns [H, W] (C==1 squeezed) or [H, W, C] float32."""
    with open(path, "rb") as f:
        header = b""
        amp = 0
        while amp < 3:
            ch = f.read(1)
            if not ch:
                raise IOError(f"truncated header in {path}")
            header += ch
            if ch == b"&":
                amp += 1
        w, h, c = (int(x) for x in header.decode().split("&")[:3])
        data = np.frombuffer(f.read(), np.float32)
    if data.size != w * h * c:
        raise IOError(
            f"size mismatch in {path}: {data.size} != {w}x{h}x{c}")
    arr = data.reshape((w, h, c), order="F").transpose(1, 0, 2)
    return arr[:, :, 0] if c == 1 else arr
