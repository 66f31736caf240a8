"""Port of the sba_tpu sub-package of the same name: PatchMatch stereo,
fusion, the COLMAP map files and meshing."""

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
from sba_tpu_torch.mvs.meshing import (
    Mesh,
    TSDFOptions,
    mesh_from_depth_maps,
    surface_nets,
    tsdf_fuse,
    write_mesh_ply,
)
