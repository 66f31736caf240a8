"""Multi-resolution visibility scoring for next-view selection.

Port of ``sba_tpu/sfm/visibility_pyramid.py`` (host numpy). Capability
parity with ref: src/base/visibility_pyramid.{h,cc}
(`VisibilityPyramid`): a pyramid of 2^l x 2^l cell grids over the image;
score of an image = sum over levels of (occupied cells x level weight),
rewarding spatially well-spread 2D-3D correspondences.
"""

from __future__ import annotations

import numpy as np


class VisibilityPyramid:
    """Ref: base/visibility_pyramid.h. Vectorized over points."""

    def __init__(self, num_levels: int, width: int, height: int):
        self.num_levels = num_levels
        self.width = max(width, 1)
        self.height = max(height, 1)
        self.cells = [np.zeros((1 << (l + 1), 1 << (l + 1)), np.int32)
                      for l in range(num_levels)]
        self.score = 0
        self.max_score = sum(((1 << (l + 1)) ** 2) * (1 << (l + 1)) ** 2
                             for l in range(num_levels))

    def _cell(self, level, xy):
        n = 1 << (level + 1)
        cx = np.clip((xy[0] / self.width * n).astype(int) if hasattr(
            xy[0], "astype") else int(xy[0] / self.width * n), 0, n - 1)
        cy = np.clip(int(xy[1] / self.height * n), 0, n - 1)
        return int(cy), int(cx)

    def set_point(self, x: float, y: float):
        for l in range(self.num_levels):
            cy, cx = self._cell(l, (x, y))
            self.cells[l][cy, cx] += 1
            if self.cells[l][cy, cx] == 1:
                # newly occupied cell: weight = (cells per side)^2 at level
                self.score += (1 << (l + 1)) ** 2

    def reset_point(self, x: float, y: float):
        for l in range(self.num_levels):
            cy, cx = self._cell(l, (x, y))
            if self.cells[l][cy, cx] > 0:
                self.cells[l][cy, cx] -= 1
                if self.cells[l][cy, cx] == 0:
                    self.score -= (1 << (l + 1)) ** 2

    def set_points(self, xy):
        """`set_point` of every row of xy [n, 2] at once; the same cells
        (truncation toward zero, then the clip) and the same score."""
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        for l in range(self.num_levels):
            n = 1 << (l + 1)
            cx = np.clip((xy[:, 0] / self.width * n).astype(int), 0, n - 1)
            cy = np.clip((xy[:, 1] / self.height * n).astype(int), 0, n - 1)
            before = np.count_nonzero(self.cells[l])
            np.add.at(self.cells[l], (cy, cx), 1)
            self.score += int(np.count_nonzero(self.cells[l]) - before) * n * n
