"""Image ingestion: EXIF focal-length priors + camera assignment.

Port of ``sba_tpu/io/image_reader.py`` (the port's own copy of its host
code, on PIL; capability parity with ref: src/base/image_reader.{h,cc} (`ImageReader`:
per-image camera creation, EXIF focal extraction with the
focal35/sensor-width fallback chain) and src/util/camera_specs.{h,cc}
(sensor-width database — here a compact common-sensor table; unknown
models fall back to the default focal prior like the reference).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# Sensor widths (mm) for common camera makes — the reference ships a large
# generated table (util/camera_specs.cc); this covers the frequent cases
# and the fallback path handles the rest identically.
_SENSOR_WIDTHS_MM = {
    "canon": 22.3, "nikon": 23.5, "sony": 23.5, "fujifilm": 23.6,
    "olympus": 17.3, "panasonic": 17.3, "apple": 4.8, "samsung": 5.76,
    "google": 6.17, "xiaomi": 6.4, "huawei": 6.17, "dji": 6.17,
    "gopro": 6.17,
}

_DEFAULT_FOCAL_FACTOR = 1.2  # ref: ImageReaderOptions.default_focal_length_factor


@dataclass
class ImageReaderOptions:
    """Mirrors ref: image_reader.h ImageReaderOptions (subset)."""

    camera_model: str = "SIMPLE_RADIAL"
    single_camera: bool = False
    default_focal_length_factor: float = _DEFAULT_FOCAL_FACTOR


def focal_length_from_exif(path: str, width: int, height: int
                           ) -> Tuple[Optional[float], bool]:
    """-> (focal_px or None, has_prior). Chain mirrors ref
    image_reader.cc: FocalLengthIn35mmFilm first, then FocalLength +
    sensor width from the make table."""
    try:
        from PIL import ExifTags, Image as PILImage

        with PILImage.open(path) as im:
            exif = im.getexif()
            if not exif:
                return None, False
            tags = {ExifTags.TAGS.get(k, k): v for k, v in exif.items()}
            # Merge in the Exif IFD (focal lengths usually live there).
            try:
                ifd = exif.get_ifd(0x8769)
                tags.update({ExifTags.TAGS.get(k, k): v
                             for k, v in ifd.items()})
            except Exception:
                pass
            max_size = max(width, height)
            f35 = tags.get("FocalLengthIn35mmFilm")
            if f35:
                return float(f35) / 36.0 * max_size, True
            f_mm = tags.get("FocalLength")
            make = str(tags.get("Make", "")).strip().lower()
            if f_mm:
                f_mm = float(f_mm)
                for key, sensor_mm in _SENSOR_WIDTHS_MM.items():
                    if key in make:
                        return f_mm / sensor_mm * max_size, True
    except Exception:
        pass
    return None, False


def camera_params_for_image(path: str, width: int, height: int,
                            options: Optional[ImageReaderOptions] = None):
    """-> (model_name, params list, prior_focal: bool)."""
    from sba_tpu_torch.geometry import camera_models

    opt = options or ImageReaderOptions()
    focal, has_prior = focal_length_from_exif(path, width, height)
    if focal is None:
        focal = opt.default_focal_length_factor * max(width, height)
    spec = camera_models.model_by_name(opt.camera_model)
    cx, cy = width / 2.0, height / 2.0
    base = {
        "SIMPLE_PINHOLE": [focal, cx, cy],
        "PINHOLE": [focal, focal, cx, cy],
        "SIMPLE_RADIAL": [focal, cx, cy, 0.0],
        "SIMPLE_RADIAL_FISHEYE": [focal, cx, cy, 0.0],
        "RADIAL": [focal, cx, cy, 0.0, 0.0],
        "RADIAL_FISHEYE": [focal, cx, cy, 0.0, 0.0],
        "OPENCV": [focal, focal, cx, cy, 0, 0, 0, 0],
        "OPENCV_FISHEYE": [focal, focal, cx, cy, 0, 0, 0, 0],
        "FULL_OPENCV": [focal, focal, cx, cy, 0, 0, 0, 0, 0, 0, 0, 0],
        "FOV": [focal, focal, cx, cy, 1e-2],
        "THIN_PRISM_FISHEYE": [focal, focal, cx, cy, 0, 0, 0, 0, 0, 0, 0, 0],
    }.get(spec.name)
    if base is None:
        base = [focal, cx, cy]
    return spec.name, base, has_prior
