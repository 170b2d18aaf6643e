"""Rotations (quaternion), projections and 4x4 matrix helpers.

Port of ``render_engine_tpu/math/transforms.py``. Conventions are
unchanged: column vectors (p' = M @ p), right-handed world, +Y up, camera
looking down -Z, GL clip space, quaternions (w, x, y, z).

Coordinate math stays full float32: a TF32 matrix product keeps ~3 decimal
digits, which puts the far plane of a proj @ view hundreds of units off
(the same failure the JAX package hit with bf16 products), so TF32 is
switched off for both matmuls and cuDNN when this module is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from render_engine_tpu_torch.utils.consts import const

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def mm44(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """4x4 (or batched) matrix compose in full float32."""
    return torch.matmul(a, b)


def inv44(m: torch.Tensor) -> torch.Tensor:
    """4x4 inverse without the singularity check (``inv_ex`` does not wait
    for the device to report its LU status)."""
    return torch.linalg.inv_ex(m)[0]


def quat_identity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=torch.float32, device=device)
    q[..., 0] = 1.0
    return q


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor
                         ) -> torch.Tensor:
    n = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    safe = torch.where(n > 1e-12, n, torch.ones_like(n))
    u = torch.where(n > 1e-12, axis / safe, torch.zeros_like(axis))
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), torch.sin(half) * u], dim=-1)


def quat_from_rotvec(rotvec: torch.Tensor) -> torch.Tensor:
    angle = torch.linalg.vector_norm(rotvec, dim=-1)
    return quat_from_axis_angle(rotvec, angle)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (apply b first, then a)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.where(n > 1e-12, n, torch.ones_like(n))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors (..., 3) by quaternions (..., 4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def compose_trs(translation: torch.Tensor, quat: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """T @ R @ S as a (..., 4, 4) matrix."""
    rs = quat_to_matrix(quat) * scale[..., None, :]  # scales the columns
    batch = torch.broadcast_shapes(rs.shape[:-2], translation.shape[:-1])
    m = torch.zeros(batch + (4, 4), dtype=torch.float32, device=rs.device)
    m[..., :3, :3] = rs
    m[..., :3, 3] = translation
    m[..., 3, 3] = 1.0
    return m


def apply_transform(matrix: torch.Tensor, points: torch.Tensor
                    ) -> torch.Tensor:
    """Apply a (..., 4, 4) affine to (..., N, 3) points -> (..., N, 3). The
    products are formed term by term, so they stay full float32 whatever
    the matmul settings."""
    rot = matrix[..., None, :3, :3]
    trans = matrix[..., :3, 3]
    return (rot * points[..., None, :]).sum(dim=-1) + trans[..., None, :]


def translation_update(matrix: torch.Tensor, new_translation: torch.Tensor
                       ) -> torch.Tensor:
    """A copy of ``matrix`` with only its translation column replaced."""
    out = matrix.clone()
    out[..., :3, 3] = new_translation
    return out


def look_at(eye: torch.Tensor, target: torch.Tensor, up: torch.Tensor
            ) -> torch.Tensor:
    """Right-handed look-at view matrix, (4, 4)."""
    f = target - eye
    f = f / torch.linalg.vector_norm(f)
    s = cross(f, up)
    s = s / torch.linalg.vector_norm(s)
    u = cross(s, f)
    zero = torch.zeros((), dtype=eye.dtype, device=eye.device)
    one = torch.ones((), dtype=eye.dtype, device=eye.device)
    rows = [
        torch.cat([s, -(s * eye).sum()[None]]),
        torch.cat([u, -(u * eye).sum()[None]]),
        torch.cat([-f, (f * eye).sum()[None]]),
        torch.stack([zero, zero, zero, one]),
    ]
    return torch.stack(rows)


def _matrix(entries: dict, like: torch.Tensor) -> torch.Tensor:
    """The (4, 4) float32 identity on ``like``'s device with the given
    {(row, col): float or 0-d tensor} entries written over it. The float
    entries are one cached constant; each tensor entry is selected in on
    the device (writing a 0-d device tensor into an element waits for the
    device)."""
    dev = like.device
    base = [float(r == c) for r in range(4) for c in range(4)]
    for (r, c), v in entries.items():
        if not isinstance(v, torch.Tensor):
            base[4 * r + c] = float(v)
    m = const(tuple(base), device=dev)
    for (r, c), v in entries.items():
        if isinstance(v, torch.Tensor):
            at = const(tuple(i == 4 * r + c for i in range(16)), torch.bool,
                       dev)
            m = torch.where(at, v.to(torch.float32), m)
    return m.reshape(4, 4)


def perspective(fov_y_rad, aspect: float, near: float, far,
                device=None) -> torch.Tensor:
    """GL-style perspective projection, NDC z in [-1, 1]. ``fov_y_rad``
    and ``far`` may be 0-d float32 tensors (the light cameras); the matrix
    is built where ``fov_y_rad`` lives, then moved to ``device``."""
    fov = fov_y_rad if isinstance(fov_y_rad, torch.Tensor) else \
        torch.as_tensor(fov_y_rad, dtype=torch.float32)
    t = 1.0 / torch.tan(0.5 * fov)
    m = _matrix({(0, 0): t / float(np.float32(aspect)),
                 (1, 1): t,
                 (2, 2): (far + near) / (near - far),
                 (2, 3): 2.0 * far * near / (near - far),
                 (3, 2): -1.0, (3, 3): 0.0}, t)
    return m if device is None else m.to(device)


def orthographic(left, right, bottom, top, near, far) -> torch.Tensor:
    """GL-style orthographic projection (the directional-light shadow
    camera); the bounds may be 0-d float32 tensors."""
    like = next((v for v in (left, right, bottom, top, near, far)
                 if isinstance(v, torch.Tensor)), torch.zeros(()))
    return _matrix({(0, 0): 2.0 / (right - left),
                    (1, 1): 2.0 / (top - bottom),
                    (2, 2): -2.0 / (far - near),
                    (0, 3): -(right + left) / (right - left),
                    (1, 3): -(top + bottom) / (top - bottom),
                    (2, 3): -(far + near) / (far - near)}, like)


def direction_from_yaw_pitch(yaw: torch.Tensor, pitch: torch.Tensor
                             ) -> torch.Tensor:
    """Camera forward vector; yaw = -90 deg looks down -Z."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    d = torch.stack([cy * cp, sp, sy * cp], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def frustum_planes(proj_view: torch.Tensor) -> torch.Tensor:
    """Six normalized Gribb-Hartmann planes (left, right, bottom, top,
    near, far), shape (6, 4); inside iff dot(n, p) + d >= 0."""
    r0, r1, r2, r3 = proj_view.unbind(0)
    planes = torch.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r3 + r2,
                          r3 - r2])
    n = torch.linalg.vector_norm(planes[:, :3], dim=-1, keepdim=True)
    return planes / torch.where(n > 1e-12, n, torch.ones_like(n))
