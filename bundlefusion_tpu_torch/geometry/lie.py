"""so(3)/se(3) Lie-group math on float32 torch tensors.

Port of ``bundlefusion_tpu/geometry/lie.py`` with the same conventions: a
*pose* is ``[omega(3), t(3)]`` (axis-angle rotation + matrix translation),
matrices are 4x4 row-major, and every function broadcasts over leading
batch dimensions.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-7


def _hat(w):
    """3-vector -> skew-symmetric 3x3."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def so3_exp(w):
    """Rodrigues: axis-angle 3-vector -> 3x3 rotation. Small-angle-safe."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    )
    W = _hat(w)
    return _eye3(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R):
    """3x3 rotation -> axis-angle 3-vector. Handles angle near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )
    sin_theta = torch.sin(theta)
    scale = torch.where(
        torch.abs(sin_theta) < 1e-5,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * sin_theta + _EPS),
    )
    w_generic = scale[..., None] * v
    # near pi: extract the axis from the diagonal of (R + I) / 2
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], -1)
    axis2 = torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None] + _EPS), min=0.0
    )
    axis = torch.sqrt(axis2 + _EPS * _EPS)
    m01 = R[..., 0, 1] + R[..., 1, 0]
    m02 = R[..., 0, 2] + R[..., 2, 0]
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    sy_pi = torch.where(m01 < 0, -1.0, 1.0)
    sz_pi = torch.where(m02 < 0, -1.0, 1.0)
    w_pi = theta[..., None] * torch.stack([ax, sy_pi * ay, sz_pi * az], -1)
    near_pi = torch.abs(math.pi - theta) < 1e-3
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w):
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS)
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta + _EPS),
    )
    W = _hat(w)
    return _eye3(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def _rt_to_mat(R, t):
    top = torch.cat([R, t[..., None]], -1)
    # built on the device: a host constant would be a blocking copy per call
    bottom = R.new_zeros(R.shape[:-2] + (1, 4))
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)


def se3_exp(xi):
    """Twist 6-vector [omega, v] -> 4x4 transform."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    t = (_so3_left_jacobian(w) @ v[..., None])[..., 0]
    return _rt_to_mat(R, t)


def se3_log(T):
    """4x4 transform -> twist 6-vector [omega, v]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    Jinv = torch.linalg.inv(_so3_left_jacobian(w))
    v = (Jinv @ t[..., None])[..., 0]
    return torch.cat([w, v], -1)


def pose_to_matrix(pose):
    """[omega, t] 6-vector -> 4x4; R = exp(omega^), translation stored directly."""
    return _rt_to_mat(so3_exp(pose[..., :3]), pose[..., 3:])


def matrix_to_pose(T):
    """4x4 -> [omega, t] 6-vector."""
    return torch.cat([so3_log(T[..., :3, :3]), T[..., :3, 3]], -1)


def pose_compose(Ta, Tb):
    return Ta @ Tb


def pose_inverse(T):
    """Rigid-transform inverse without a general 4x4 solve."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    return _rt_to_mat(Rt, ti)


def transform_points(T, pts):
    """Apply 4x4 transform(s) to points [..., 3]."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., :3, 3]


def rotate_vectors(T, vecs):
    return vecs @ T[..., :3, :3].transpose(-1, -2)


def pose_delta(Ta, Tb, rot_scale: float = 2.0):
    """Translation distance plus ``rot_scale`` times the rotation angle."""
    dt = torch.linalg.norm(Ta[..., :3, 3] - Tb[..., :3, 3], dim=-1)
    dR = Ta[..., :3, :3].transpose(-1, -2) @ Tb[..., :3, :3]
    trace = dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2]
    ang = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    return dt + rot_scale * ang
