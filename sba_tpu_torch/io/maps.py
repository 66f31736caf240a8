"""Depth / semantic map IO: float32 TIFF maps and matrix JPEG dumps.

Port of ``sba_tpu/io/maps.py``. The side-channel layout of semantic
bundle adjustment is a directory of per-image files,
``<data_path>/<image_stem>_depth.tiff`` and ``..._semantic.tiff`` (one
float map per registered image); `load_depth_semantic_maps` finds them
as the reference's filename-prefix matching does and returns stacked
``[N, H, W]`` arrays.

TIFFs are read as sba_tpu reads them: through the native C++ decoder
(``io/native_loader.py``) when it is available, with PIL otherwise and
for files the decoder does not take (compressed or exotic TIFFs).
"""

from __future__ import annotations

import os
import re
from typing import List, Sequence, Tuple

import numpy as np
from PIL import Image as PILImage


def read_float_map_tiff(path) -> np.ndarray:
    """Read a single-channel float TIFF into [H, W] float32: the native
    decoder (the counterpart of ref util/matrix_vis.h:130 readTiffFloat)
    when it is available and takes the file, PIL otherwise."""
    from sba_tpu_torch.io import native_loader

    if native_loader.is_available():
        arr = native_loader.decode_image_native(str(path))
        if arr is not None:
            return arr
    arr = np.asarray(PILImage.open(path), dtype=np.float32)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr


def write_float_map_tiff(arr: np.ndarray, path) -> None:
    PILImage.fromarray(np.asarray(arr, dtype=np.float32), mode="F").save(
        path)


def write_matrix_jpeg(arr: np.ndarray, path, vmin=None, vmax=None) -> None:
    """Normalized grayscale JPEG dump of a float matrix
    (ref: src/util/matrix_vis.h:12 writeMatrixJpeg)."""
    a = np.asarray(arr, dtype=np.float32)
    lo = np.min(a) if vmin is None else vmin
    hi = np.max(a) if vmax is None else vmax
    scale = 255.0 / max(hi - lo, 1e-12)
    img = np.clip((a - lo) * scale, 0, 255).astype(np.uint8)
    PILImage.fromarray(img, mode="L").save(path)


def _stem(name: str) -> str:
    return os.path.splitext(os.path.basename(name))[0]


def find_map_path(data_path: str, image_name: str, kind: str) -> str:
    """Locate `<stem>*<kind>*.tiff` for an image (the reference's
    filename-prefix matching of depth/semantic files)."""
    stem = _stem(image_name)
    candidates = [
        os.path.join(data_path, f"{stem}_{kind}.tiff"),
        os.path.join(data_path, f"{stem}_{kind}.tif"),
        os.path.join(data_path, kind, f"{stem}.tiff"),
        os.path.join(data_path, kind, f"{stem}.tif"),
        os.path.join(data_path, f"{stem}.{kind}.tiff"),
    ]
    for c in candidates:
        if os.path.isfile(c):
            return c
    if os.path.isdir(data_path):
        pat = re.compile(re.escape(stem) + r".*" + re.escape(kind)
                         + r".*\.tiff?$")
        for fn in sorted(os.listdir(data_path)):
            if pat.match(fn):
                return os.path.join(data_path, fn)
    raise FileNotFoundError(
        f"no {kind} map for image '{image_name}' under {data_path}")


def load_depth_semantic_maps(
    data_path: str, image_names: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image depth + semantic maps, stacked [N, H, W] float32. All
    maps must share one resolution."""
    depths: List[np.ndarray] = []
    semantics: List[np.ndarray] = []
    for name in image_names:
        depths.append(read_float_map_tiff(
            find_map_path(data_path, name, "depth")))
        semantics.append(read_float_map_tiff(
            find_map_path(data_path, name, "semantic")))
    shapes = {d.shape for d in depths} | {s.shape for s in semantics}
    if len(shapes) != 1:
        raise ValueError(f"inconsistent map shapes: {shapes}")
    return np.stack(depths), np.stack(semantics)
