"""GPS coordinate transforms: WGS84 ellipsoidal <-> ECEF <-> ENU.

Port of ``sba_tpu/geometry/gps.py`` (host numpy in float64, as there).
Capability parity with ref: src/base/gps.{h,cc} (`GPSTransform` with
ELL <-> XYZ (ECEF) conversions and the ENU local frame used by
spatial matching / model_aligner --ref_is_gps).

Vectorized over [N, 3] arrays (numpy host math; these are tiny metadata
transforms feeding pair selection and alignment, not device kernels).
"""

from __future__ import annotations

import numpy as np

# WGS84 parameters (ref: gps.cc constructor).
_A = 6378137.0                  # semi-major axis
_F = 1.0 / 298.257223563        # flattening
_B = _A * (1.0 - _F)            # semi-minor axis
_E2 = _F * (2.0 - _F)           # first eccentricity^2
_EP2 = (_A * _A - _B * _B) / (_B * _B)  # second eccentricity^2


def ell_to_xyz(lat_lon_alt: np.ndarray) -> np.ndarray:
    """[N, 3] (latitude deg, longitude deg, altitude m) -> ECEF [N, 3]
    (ref: GPSTransform::EllToXYZ)."""
    lla = np.atleast_2d(np.asarray(lat_lon_alt, np.float64))
    lat = np.radians(lla[:, 0])
    lon = np.radians(lla[:, 1])
    alt = lla[:, 2]
    sin_lat = np.sin(lat)
    cos_lat = np.cos(lat)
    n = _A / np.sqrt(1.0 - _E2 * sin_lat ** 2)
    x = (n + alt) * cos_lat * np.cos(lon)
    y = (n + alt) * cos_lat * np.sin(lon)
    z = (n * (1.0 - _E2) + alt) * sin_lat
    return np.stack([x, y, z], -1)


def xyz_to_ell(xyz: np.ndarray) -> np.ndarray:
    """ECEF [N, 3] -> (lat deg, lon deg, alt m) via Bowring's closed form
    (ref: GPSTransform::XYZToEll)."""
    p = np.atleast_2d(np.asarray(xyz, np.float64))
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    lon = np.arctan2(y, x)
    r = np.hypot(x, y)
    theta = np.arctan2(z * _A, r * _B)
    lat = np.arctan2(z + _EP2 * _B * np.sin(theta) ** 3,
                     r - _E2 * _A * np.cos(theta) ** 3)
    sin_lat = np.sin(lat)
    n = _A / np.sqrt(1.0 - _E2 * sin_lat ** 2)
    alt = r / np.cos(lat) - n
    return np.stack([np.degrees(lat), np.degrees(lon), alt], -1)


def ell_to_enu(lat_lon_alt: np.ndarray,
               ref_lat_lon_alt=None) -> np.ndarray:
    """Geodetic -> local East-North-Up around a reference point (defaults
    to the first row), used for spatial pair selection and GPS alignment
    (ref: GPSTransform::EllToENU)."""
    lla = np.atleast_2d(np.asarray(lat_lon_alt, np.float64))
    if ref_lat_lon_alt is None:
        ref_lat_lon_alt = lla[0]
    ref = np.asarray(ref_lat_lon_alt, np.float64)
    xyz = ell_to_xyz(lla)
    xyz0 = ell_to_xyz(ref[None, :])[0]
    lat0 = np.radians(ref[0])
    lon0 = np.radians(ref[1])
    sl, cl = np.sin(lat0), np.cos(lat0)
    so, co = np.sin(lon0), np.cos(lon0)
    R = np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl]])
    return (xyz - xyz0) @ R.T


def enu_to_ell(enu: np.ndarray, ref_lat_lon_alt) -> np.ndarray:
    """Inverse of `ell_to_enu`."""
    e = np.atleast_2d(np.asarray(enu, np.float64))
    ref = np.asarray(ref_lat_lon_alt, np.float64)
    xyz0 = ell_to_xyz(ref[None, :])[0]
    lat0 = np.radians(ref[0])
    lon0 = np.radians(ref[1])
    sl, cl = np.sin(lat0), np.cos(lat0)
    so, co = np.sin(lon0), np.cos(lon0)
    R = np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl]])
    return xyz_to_ell(e @ R + xyz0)
