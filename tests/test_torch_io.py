"""COLMAP model IO and scene views of the port against sba_tpu.

A model written by one package, read and rewritten by the other, must
come back byte for byte; both packages must build the same dense view.
"""

import numpy as np
import pytest
import torch

from sba_tpu.models.reconstruction import Reconstruction as JRec
from sba_tpu.utils.synthetic import make_synthetic_reconstruction as jmake
from sba_tpu_torch.models.reconstruction import Reconstruction as TRec
from sba_tpu_torch.utils.synthetic import make_synthetic_reconstruction

torch.set_num_threads(1)

_FILES = {".bin": ("cameras.bin", "images.bin", "points3D.bin"),
          ".txt": ("cameras.txt", "images.txt", "points3D.txt")}


@pytest.mark.parametrize("ext", [".bin", ".txt"])
def test_model_roundtrip_bytes_across_packages(tmp_path, ext):
    rec = jmake(num_images=5, num_points=60, seed=2)
    rec.write(str(tmp_path / "a"), ext)
    TRec.read(str(tmp_path / "a")).write(str(tmp_path / "b"), ext)
    JRec.read(str(tmp_path / "b")).write(str(tmp_path / "c"), ext)
    for name in _FILES[ext]:
        a = (tmp_path / "a" / name).read_bytes()
        assert (tmp_path / "b" / name).read_bytes() == a, name
        assert (tmp_path / "c" / name).read_bytes() == a, name


def test_synthetic_reconstruction_and_arrays_match_sba_tpu(tmp_path):
    t_rec = make_synthetic_reconstruction(num_images=6, num_points=80,
                                          seed=4)
    j_rec = jmake(num_images=6, num_points=80, seed=4)
    t_arr, j_arr = t_rec.to_arrays(), j_rec.to_arrays()
    for field in ("image_ids", "qvecs", "tvecs", "image_camera_idx",
                  "camera_ids", "camera_model_ids", "camera_params",
                  "point_ids", "points", "obs_image", "obs_point", "obs_xy"):
        np.testing.assert_allclose(getattr(t_arr, field),
                                   getattr(j_arr, field), atol=1e-12,
                                   err_msg=field)
    assert t_arr.image_names == j_arr.image_names
    np.testing.assert_allclose(t_rec.compute_mean_reprojection_error(),
                               j_rec.compute_mean_reprojection_error(),
                               atol=1e-9)
    # update_from_arrays writes back the same values in both packages
    # (both read the model that sba_tpu wrote).
    j_rec.write(str(tmp_path / "src"))
    t_rec = TRec.read(str(tmp_path / "src"))
    j_rec = JRec.read(str(tmp_path / "src"))
    t_arr, j_arr = t_rec.to_arrays(), j_rec.to_arrays()
    new = dict(qvecs=j_arr.qvecs[::-1].copy(), tvecs=j_arr.tvecs + 0.25,
               points=j_arr.points + 0.5)
    t_rec.update_from_arrays(t_arr, **new)
    j_rec.update_from_arrays(j_arr, **new)
    t_rec.write(str(tmp_path / "t"))
    j_rec.write(str(tmp_path / "j"))
    for name in _FILES[".bin"]:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name
