"""Image loading for the dense path.

Only `load_image_gray` of ``sba_tpu/features/sift.py`` is ported so far;
SIFT extraction itself (the banded pyramid, DoG extrema, orientation and
descriptors) comes with the front-end slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def load_image_gray(path, max_size: Optional[int] = None) -> np.ndarray:
    """Host-side image loading -> [H, W] f32 in [0, 1] (replaces the
    reference's FreeImage Bitmap, ref: util/bitmap.h)."""
    from PIL import Image as PILImage

    im = PILImage.open(path).convert("L")
    if max_size is not None and max(im.size) > max_size:
        sc = max_size / max(im.size)
        im = im.resize((max(1, int(im.width * sc)),
                        max(1, int(im.height * sc))), PILImage.BILINEAR)
    return np.asarray(im, dtype=np.float32) / 255.0
