"""Port of the sba_tpu sub-package of the same name (meshing is not
ported yet)."""

from sba_tpu_torch.mvs.patch_match import (
    PatchMatchOptions,
    patch_match_stereo,
)
from sba_tpu_torch.mvs.fusion import (
    StereoFusionOptions,
    fuse_depth_maps,
)
from sba_tpu_torch.mvs.depth_maps import (
    read_colmap_map,
    write_colmap_map,
)
