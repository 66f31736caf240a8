"""The 11 COLMAP camera models as batched torch functions.

Port of ``sba_tpu/geometry/camera_models.py``: same model ids, names,
parameter orders and distortion math. Every model is a pair
``world_to_image(params, uv)`` / ``image_to_world(params, xy)`` on
``[..., 2]`` points with broadcastable ``[..., K]`` parameters.
Undistortion is Newton iteration whose 2x2 Jacobian comes from
forward-mode differentiation (``torch.func.jvp``) of the distortion map.
This is the plain path: the CUDA kernels of ``ops/ba_kernels.py`` carry
their own analytic heads for the models they support.
`world_to_image_switch` / `image_to_world_switch` dispatch on a model id
held as data (a scalar, or one id a row), on zero-padded parameters.
"""

from __future__ import annotations

from typing import Dict

import torch

MAX_NUM_PARAMS = 12

_MODELS_BY_ID: Dict[int, "CameraModelSpec"] = {}
_MODELS_BY_NAME: Dict[str, "CameraModelSpec"] = {}


class CameraModelSpec:
    """Static description + functions for one camera model."""

    def __init__(self, model_id, name, num_params, params_info,
                 focal_idxs, principal_idxs, extra_idxs,
                 world_to_image, image_to_world, init_params):
        self.model_id = model_id
        self.name = name
        self.num_params = num_params
        self.params_info = params_info
        self.focal_idxs = focal_idxs
        self.principal_idxs = principal_idxs
        self.extra_idxs = extra_idxs
        self.world_to_image = world_to_image
        self.image_to_world = image_to_world
        self.init_params = init_params

    def __repr__(self):
        return (f"CameraModelSpec({self.name}, id={self.model_id}, "
                f"k={self.num_params})")


def _register(spec: CameraModelSpec) -> CameraModelSpec:
    _MODELS_BY_ID[spec.model_id] = spec
    _MODELS_BY_NAME[spec.name] = spec
    return spec


def model_by_id(model_id: int) -> CameraModelSpec:
    return _MODELS_BY_ID[int(model_id)]


def all_models():
    return [_MODELS_BY_ID[i] for i in sorted(_MODELS_BY_ID)]


def model_by_name(name: str) -> CameraModelSpec:
    return _MODELS_BY_NAME[name]


# ---------------------------------------------------------------------------
# Distortion maps: (extra [..., E], uv [..., 2]) -> delta duv
# (distorted = uv + duv).
# ---------------------------------------------------------------------------

def _distortion_simple_radial(extra, uv):
    k = extra[..., 0:1]
    r2 = torch.sum(uv * uv, dim=-1, keepdim=True)
    return uv * (k * r2)


def _distortion_radial(extra, uv):
    k1 = extra[..., 0:1]
    k2 = extra[..., 1:2]
    r2 = torch.sum(uv * uv, dim=-1, keepdim=True)
    return uv * (k1 * r2 + k2 * r2 * r2)


def _distortion_opencv(extra, uv):
    k1, k2, p1, p2 = (extra[..., i] for i in range(4))
    u, v = uv[..., 0], uv[..., 1]
    u2, v2, uvp = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2)
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2)
    return torch.stack([du, dv], dim=-1)


def _fisheye_theta_delta(uv, poly_of_theta2):
    """duv = uv * (theta_d / r - 1), guarded at r -> 0."""
    r2 = torch.sum(uv * uv, dim=-1, keepdim=True)
    r = torch.sqrt(r2)
    safe_r = torch.clamp(r, min=1e-12)
    theta = torch.arctan(r)
    thetad = theta * poly_of_theta2(theta * theta)
    scale = torch.where(r > 2.2e-16, thetad / safe_r - 1.0,
                        torch.zeros_like(r))
    return uv * scale


def _distortion_opencv_fisheye(extra, uv):
    k1, k2, k3, k4 = (extra[..., i:i + 1] for i in range(4))

    def poly(t2):
        t4 = t2 * t2
        return 1.0 + k1 * t2 + k2 * t4 + k3 * t4 * t2 + k4 * t4 * t4

    return _fisheye_theta_delta(uv, poly)


def _distortion_full_opencv(extra, uv):
    k1, k2, p1, p2, k3, k4, k5, k6 = (extra[..., i] for i in range(8))
    u, v = uv[..., 0], uv[..., 1]
    u2, v2, uvp = u * u, v * v, u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    radial = ((1.0 + k1 * r2 + k2 * r4 + k3 * r6)
              / (1.0 + k4 * r2 + k5 * r4 + k6 * r6))
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2) - u
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2) - v
    return torch.stack([du, dv], dim=-1)


def _nonzero(x, eps):
    return torch.where(torch.abs(x) > eps, x, torch.ones_like(x))


def _fov_factor(omega, radius2, distort: bool):
    """FOV scaling factor with the reference's Taylor guards."""
    eps = 1e-4
    omega2 = omega * omega
    radius = torch.sqrt(torch.clamp(radius2, min=1e-20))
    tan_half = torch.tan(omega / 2.0)
    if distort:
        safe_om = _nonzero(omega, 1e-12)
        main = torch.arctan(radius * 2.0 * tan_half) / (radius * safe_om)
        small_r = ((-2.0 * tan_half * (4.0 * radius2 * tan_half * tan_half
                                       - 3.0)) / (3.0 * safe_om))
    else:
        safe_th = _nonzero(tan_half, 1e-12)
        main = torch.tan(radius * omega) / (radius * 2.0 * safe_th)
        small_r = (omega * (omega2 * radius2 + 3.0)) / (6.0 * safe_th)
    small_omega = (omega2 * radius2) / 3.0 - omega2 / 12.0 + 1.0
    factor = torch.where(radius2 < eps, small_r, main)
    return torch.where(omega2 < eps, small_omega, factor)


def _distortion_simple_radial_fisheye(extra, uv):
    k = extra[..., 0:1]
    return _fisheye_theta_delta(uv, lambda t2: 1.0 + k * t2)


def _distortion_radial_fisheye(extra, uv):
    k1 = extra[..., 0:1]
    k2 = extra[..., 1:2]
    return _fisheye_theta_delta(uv, lambda t2: 1.0 + k1 * t2 + k2 * t2 * t2)


def _distortion_thin_prism(extra, uv):
    k1, k2, p1, p2, k3, k4, sx1, sy1 = (extra[..., i] for i in range(8))
    u, v = uv[..., 0], uv[..., 1]
    u2, v2, uvp = u * u, v * v, u * v
    r2 = u2 + v2
    r4 = r2 * r2
    r6 = r4 * r2
    r8 = r6 * r2
    radial = k1 * r2 + k2 * r4 + k3 * r6 + k4 * r8
    du = u * radial + 2.0 * p1 * uvp + p2 * (r2 + 2.0 * u2) + sx1 * r2
    dv = v * radial + 2.0 * p2 * uvp + p1 * (r2 + 2.0 * v2) + sy1 * r2
    return torch.stack([du, dv], dim=-1)


# ---------------------------------------------------------------------------
# Newton undistortion with a forward-mode Jacobian.
# ---------------------------------------------------------------------------

_UNDISTORT_ITERS = 25


def _newton_undistort(distortion_fn, extra, uv_distorted):
    """Solve uv + D(uv) = uv_distorted by Newton iteration (fixed trip
    count, closed-form 2x2 solves)."""
    x = uv_distorted
    basis = torch.zeros((2,) + x.shape, dtype=x.dtype, device=x.device)
    basis[0, ..., 0] = 1.0
    basis[1, ..., 1] = 1.0

    def dist(p):
        return distortion_fn(extra, p)

    # Both Jacobian columns from one jvp vmapped over the two tangents
    # (each column's bits are those of its own jvp).
    cols = torch.func.vmap(lambda p, t: torch.func.jvp(dist, (p,), (t,)),
                           in_dims=(None, 0))
    for _ in range(_UNDISTORT_ITERS):
        d, jac = cols(x, basis)
        d, jcol0, jcol1 = d[0], jac[0], jac[1]
        f = x + d - uv_distorted
        j00 = 1.0 + jcol0[..., 0]
        j10 = jcol0[..., 1]
        j01 = jcol1[..., 0]
        j11 = 1.0 + jcol1[..., 1]
        det = j00 * j11 - j01 * j10
        ok = torch.abs(det) > 1e-20
        safe_det = torch.where(ok, det, torch.ones_like(det))
        step_u = (j11 * f[..., 0] - j01 * f[..., 1]) / safe_det
        step_v = (-j10 * f[..., 0] + j00 * f[..., 1]) / safe_det
        step = torch.stack([step_u, step_v], dim=-1)
        x = x - torch.where(ok[..., None], step, torch.zeros_like(step))
    return x


# ---------------------------------------------------------------------------
# Model assembly.
# ---------------------------------------------------------------------------

def _split_f1(params):
    """f, cx, cy layout -> (focal [..., 2], principal [..., 2], extra)."""
    f = torch.stack([params[..., 0], params[..., 0]], dim=-1)
    return f, params[..., 1:3], params[..., 3:]


def _split_f2(params):
    """fx, fy, cx, cy layout."""
    return params[..., 0:2], params[..., 2:4], params[..., 4:]


def _make_standard_model(split_fn, distortion_fn):
    def world_to_image(params, uv):
        f, c, extra = split_fn(params)
        return f * (uv + distortion_fn(extra, uv)) + c

    def image_to_world(params, xy):
        f, c, extra = split_fn(params)
        return _newton_undistort(distortion_fn, extra, (xy - c) / f)

    return world_to_image, image_to_world


def _sp_world_to_image(params, uv):
    return params[..., 0:1] * uv + params[..., 1:3]


def _sp_image_to_world(params, xy):
    return (xy - params[..., 1:3]) / params[..., 0:1]


SIMPLE_PINHOLE = _register(CameraModelSpec(
    0, "SIMPLE_PINHOLE", 3, "f, cx, cy", (0,), (1, 2), (),
    _sp_world_to_image, _sp_image_to_world,
    lambda f, w, h: [f, w / 2.0, h / 2.0]))


def _p_world_to_image(params, uv):
    return params[..., 0:2] * uv + params[..., 2:4]


def _p_image_to_world(params, xy):
    return (xy - params[..., 2:4]) / params[..., 0:2]


PINHOLE = _register(CameraModelSpec(
    1, "PINHOLE", 4, "fx, fy, cx, cy", (0, 1), (2, 3), (),
    _p_world_to_image, _p_image_to_world,
    lambda f, w, h: [f, f, w / 2.0, h / 2.0]))

_sr_w2i, _sr_i2w = _make_standard_model(_split_f1, _distortion_simple_radial)
SIMPLE_RADIAL = _register(CameraModelSpec(
    2, "SIMPLE_RADIAL", 4, "f, cx, cy, k", (0,), (1, 2), (3,),
    _sr_w2i, _sr_i2w, lambda f, w, h: [f, w / 2.0, h / 2.0, 0.0]))

_r_w2i, _r_i2w = _make_standard_model(_split_f1, _distortion_radial)
RADIAL = _register(CameraModelSpec(
    3, "RADIAL", 5, "f, cx, cy, k1, k2", (0,), (1, 2), (3, 4),
    _r_w2i, _r_i2w, lambda f, w, h: [f, w / 2.0, h / 2.0, 0.0, 0.0]))

_cv_w2i, _cv_i2w = _make_standard_model(_split_f2, _distortion_opencv)
OPENCV = _register(CameraModelSpec(
    4, "OPENCV", 8, "fx, fy, cx, cy, k1, k2, p1, p2", (0, 1), (2, 3),
    (4, 5, 6, 7), _cv_w2i, _cv_i2w,
    lambda f, w, h: [f, f, w / 2.0, h / 2.0, 0.0, 0.0, 0.0, 0.0]))

_cvf_w2i, _cvf_i2w = _make_standard_model(_split_f2,
                                          _distortion_opencv_fisheye)
OPENCV_FISHEYE = _register(CameraModelSpec(
    5, "OPENCV_FISHEYE", 8, "fx, fy, cx, cy, k1, k2, k3, k4", (0, 1),
    (2, 3), (4, 5, 6, 7), _cvf_w2i, _cvf_i2w,
    lambda f, w, h: [f, f, w / 2.0, h / 2.0, 0.0, 0.0, 0.0, 0.0]))

_fcv_w2i, _fcv_i2w = _make_standard_model(_split_f2, _distortion_full_opencv)
FULL_OPENCV = _register(CameraModelSpec(
    6, "FULL_OPENCV", 12, "fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6",
    (0, 1), (2, 3), tuple(range(4, 12)), _fcv_w2i, _fcv_i2w,
    lambda f, w, h: [f, f, w / 2.0, h / 2.0] + [0.0] * 8))


# FOV's Distortion returns the full distorted coordinates, not a delta.
def _fov_world_to_image(params, uv):
    f, c, omega = params[..., 0:2], params[..., 2:4], params[..., 4]
    factor = _fov_factor(omega, torch.sum(uv * uv, dim=-1), distort=True)
    return f * (uv * factor[..., None]) + c


def _fov_image_to_world(params, xy):
    f, c, omega = params[..., 0:2], params[..., 2:4], params[..., 4]
    uv = (xy - c) / f
    factor = _fov_factor(omega, torch.sum(uv * uv, dim=-1), distort=False)
    return uv * factor[..., None]


FOV = _register(CameraModelSpec(
    7, "FOV", 5, "fx, fy, cx, cy, omega", (0, 1), (2, 3), (4,),
    _fov_world_to_image, _fov_image_to_world,
    lambda f, w, h: [f, f, w / 2.0, h / 2.0, 1e-2]))

_srf_w2i, _srf_i2w = _make_standard_model(
    _split_f1, _distortion_simple_radial_fisheye)
SIMPLE_RADIAL_FISHEYE = _register(CameraModelSpec(
    8, "SIMPLE_RADIAL_FISHEYE", 4, "f, cx, cy, k", (0,), (1, 2), (3,),
    _srf_w2i, _srf_i2w, lambda f, w, h: [f, w / 2.0, h / 2.0, 0.0]))

_rf_w2i, _rf_i2w = _make_standard_model(_split_f1,
                                        _distortion_radial_fisheye)
RADIAL_FISHEYE = _register(CameraModelSpec(
    9, "RADIAL_FISHEYE", 5, "f, cx, cy, k1, k2", (0,), (1, 2), (3, 4),
    _rf_w2i, _rf_i2w, lambda f, w, h: [f, w / 2.0, h / 2.0, 0.0, 0.0]))


# THIN_PRISM_FISHEYE: equidistant theta pre-map, then OpenCV-style and
# thin-prism terms.
def _tp_world_to_image(params, uv):
    f, c, extra = params[..., 0:2], params[..., 2:4], params[..., 4:12]
    r = torch.sqrt(torch.sum(uv * uv, dim=-1, keepdim=True))
    theta = torch.arctan(r)
    scale = torch.where(r > 2.2e-16, theta / torch.clamp(r, min=1e-12),
                        torch.ones_like(r))
    uuvv = uv * scale
    return f * (uuvv + _distortion_thin_prism(extra, uuvv)) + c


def _tp_image_to_world(params, xy):
    f, c, extra = params[..., 0:2], params[..., 2:4], params[..., 4:12]
    uv = _newton_undistort(_distortion_thin_prism, extra, (xy - c) / f)
    theta = torch.linalg.norm(uv, dim=-1, keepdim=True)
    theta_cos = theta * torch.cos(theta)
    scale = torch.where(theta_cos > 2.2e-16,
                        torch.sin(theta) / torch.clamp(theta_cos, min=1e-12),
                        torch.ones_like(theta))
    return uv * scale


THIN_PRISM_FISHEYE = _register(CameraModelSpec(
    10, "THIN_PRISM_FISHEYE", 12,
    "fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1",
    (0, 1), (2, 3), tuple(range(4, 12)),
    _tp_world_to_image, _tp_image_to_world,
    lambda f, w, h: [f, f, w / 2.0, h / 2.0] + [0.0] * 8))


def world_to_image(model_id: int, params, uv):
    """Static-id dispatch; params may be zero-padded to [..., 12]."""
    m = model_by_id(model_id)
    return m.world_to_image(params[..., : m.num_params], uv)


def image_to_world(model_id: int, params, xy):
    m = model_by_id(model_id)
    return m.image_to_world(params[..., : m.num_params], xy)


# ---------------------------------------------------------------------------
# Heterogeneous dispatch on a model id held as data (sba_tpu's lax.switch).
# ---------------------------------------------------------------------------

def pad_params(params_list):
    """Pad a python list/array of parameters to [MAX_NUM_PARAMS]."""
    import numpy as np

    out = np.zeros(MAX_NUM_PARAMS, dtype=np.float64)
    p = np.asarray(params_list, dtype=np.float64)
    out[: p.shape[0]] = p
    return out


def _switch(fn: str, model_id, params_padded, pts):
    """`fn` of the model `model_id` names: a scalar (int or 0-d tensor;
    sba_tpu's `lax.switch`) or a tensor of ids broadcast against the
    points' leading axes (what the switch gives under a vmap over ids):
    each model present computes all rows, its own rows are kept."""
    ids = torch.as_tensor(model_id)
    if ids.dim() == 0:
        m = model_by_id(int(ids))
        return getattr(m, fn)(params_padded[..., : m.num_params], pts)
    out = None
    for mid in torch.unique(ids).tolist():
        m = model_by_id(int(mid))
        res = getattr(m, fn)(params_padded[..., : m.num_params], pts)
        out = res if out is None else torch.where(
            (ids == mid).to(res.device)[..., None], res, out)
    return out


def world_to_image_switch(model_id, params_padded, uv):
    """Dispatch on a model id held as data; params_padded: [..., 12]."""
    return _switch("world_to_image", model_id, params_padded, uv)


def image_to_world_switch(model_id, params_padded, xy):
    return _switch("image_to_world", model_id, params_padded, xy)
