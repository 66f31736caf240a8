"""Quaternion and rigid-pose algebra on batched torch tensors.

Port of ``sba_tpu/geometry/quaternions.py``; same conventions:

- Hamilton quaternions stored ``[w, x, y, z]`` (w first).
- A pose ``(qvec, tvec)`` maps WORLD -> CAMERA: ``x_cam = R(q) x + t``.

Every function broadcasts over leading batch dimensions. The numpy
helpers at the end are the host-side variants the IO and model code use.
"""

from __future__ import annotations

import numpy as np
import torch


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_normalize(q, eps=1e-12):
    """Unit quaternion. q: [..., 4] (w, x, y, z)."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=eps)


def quat_conjugate(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_inverse_rotation(q):
    """Inverse rotation quaternion = normalized conjugate."""
    return quat_conjugate(quat_normalize(q))


def quat_multiply(qa, qb):
    """Hamilton product qa * qb, [..., 4] each, broadcasting."""
    aw, ax, ay, az = qa.unbind(-1)
    bw, bx, by, bz = qb.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_rotate(q, p):
    """Rotate points p [..., 3] by the normalized q [..., 4]:
    p' = p + 2 w (v x p) + 2 v x (v x p)."""
    q = quat_normalize(q)
    w = q[..., :1]
    v = q[..., 1:]
    vxp = _cross(v, p)
    return p + 2.0 * (w * vxp + _cross(v, vxp))


def quat_to_rotmat(q):
    """Normalized quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    r = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def rotmat_to_quat(R):
    """Rotation matrix [..., 3, 3] -> quaternion [..., 4] (w >= 0);
    branch-free Shepperd selection by the largest discriminant."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    one = torch.ones_like(tr)
    qw = torch.stack([one + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, one + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, one - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      one - m00 - m11 + m22], dim=-1)
    s = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                     -m00 - m11 + m22], dim=-1)
    best = torch.argmax(s, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)   # [..., pivot, coeff]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def angle_axis_to_quat(aa):
    """Angle-axis [..., 3] -> quaternion [..., 4]; differentiable at 0
    (Taylor branch in |aa|^2, sqrt only of values away from 0)."""
    n2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = n2 < 1e-14
    safe_n2 = torch.where(small, torch.ones_like(n2), n2)
    angle = torch.sqrt(safe_n2)
    half = 0.5 * angle
    k = torch.where(small, 0.5 - n2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - n2 / 8.0, torch.cos(half))
    return torch.cat([w, k * aa], dim=-1)


def quat_to_angle_axis(q):
    """Quaternion [..., 4] -> angle-axis [..., 3]."""
    q = quat_normalize(q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    s2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = s2 < 1e-14
    sin_half = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    angle = 2.0 * torch.atan2(sin_half, w)
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-6) - 2.0 * s2 / 3.0,
                    angle / sin_half)
    return k * v


def angle_axis_rotate(aa, p):
    """Rotate p [..., 3] by angle-axis aa [..., 3] (Rodrigues)."""
    return quat_rotate(angle_axis_to_quat(aa), p)


def quat_retract(q, delta):
    """Right-multiplicative so(3) retraction: q * exp(delta / 2)."""
    return quat_normalize(quat_multiply(q, angle_axis_to_quat(delta)))


def pose_inverse(qvec, tvec):
    """Invert a world->camera pose: (q^-1, -R(q^-1) t)."""
    q_inv = quat_inverse_rotation(qvec)
    return q_inv, -quat_rotate(q_inv, tvec)


def pose_product(qa, ta, qb, tb):
    """Compose poses: x -> R_A (R_B x + t_B) + t_A."""
    return quat_multiply(qa, qb), quat_rotate(qa, tb) + ta


def pose_transform(qvec, tvec, points):
    """R(q) p + t for points [..., 3]."""
    return quat_rotate(qvec, points) + tvec


def quat_slerp(q0, q1, t):
    """Spherical interpolation between unit quaternions."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.abs(torch.clamp(d, -1.0, 1.0))
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe = torch.clamp(sin_theta, min=1e-20)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t * torch.ones_like(theta),
                     torch.sin(t * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# Numpy (host) variants for the IO / scene code.
# ---------------------------------------------------------------------------

def np_quat_rotate(q, v):
    """q [..., 4] w-first (normalized here), v [..., 3]."""
    q = np.asarray(q, np.float64)
    v = np.asarray(v, np.float64)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    q = np.broadcast_to(q, v.shape[:-1] + (4,))
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def np_quat_to_rotmat(q):
    """q [4] w-first (normalized here) -> [3, 3]."""
    q = np.asarray(q, np.float64)
    q = q / max(np.linalg.norm(q), 1e-12)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def np_quat_normalize(q, eps=1e-12):
    q = np.asarray(q, np.float64)
    n = np.linalg.norm(q, axis=-1, keepdims=True)
    return q / np.maximum(n, eps)


def np_angle_axis_to_quat(aa):
    """Angle-axis [3] -> w-first quaternion [4] (first-order branch
    below 1e-12 rad)."""
    aa = np.asarray(aa, np.float64)
    angle = np.linalg.norm(aa)
    if angle < 1e-12:
        return np_quat_normalize(np.concatenate([[1.0], 0.5 * aa]))
    axis = aa / angle
    return np.concatenate([[np.cos(angle / 2.0)],
                           np.sin(angle / 2.0) * axis])


def np_rotmat_to_quat(R):
    """Numpy rotation matrix [3, 3] -> w-first quaternion (Shepperd,
    branch by the trace and then the largest diagonal entry)."""
    R = np.asarray(R, np.float64)
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = np.array([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                      (m10 - m01) / s])
    elif m00 >= m11 and m00 >= m22:
        s = 2.0 * np.sqrt(1.0 + m00 - m11 - m22)
        q = np.array([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                      (m02 + m20) / s])
    elif m11 >= m22:
        s = 2.0 * np.sqrt(1.0 + m11 - m00 - m22)
        q = np.array([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                      (m12 + m21) / s])
    else:
        s = 2.0 * np.sqrt(1.0 + m22 - m00 - m11)
        q = np.array([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                      0.25 * s])
    return np_quat_normalize(q)


def np_quat_to_angle_axis(q):
    """w-first quaternion [4] (normalized here) -> angle-axis [3]; the
    small-angle branch returns 2 (x, y, z) sign(w)."""
    q = np_quat_normalize(q)
    w = np.clip(q[0], -1.0, 1.0)
    angle = 2.0 * np.arccos(np.abs(w))
    sin_half = np.sqrt(max(1.0 - w * w, 0.0))
    axis = q[1:] * (np.sign(w) if w != 0 else 1.0)
    if sin_half < 1e-12:
        return 2.0 * axis
    return axis / sin_half * angle
