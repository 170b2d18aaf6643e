"""Quaternions, the camera's matrices and frustum tests, by the engine's
conventions: column vectors, right-handed, +Y up, the camera looking down
-Z, GL clip space (NDC in [-1, 1]), quaternions stored (w, x, y, z).
Every matrix product goes through ``torch.matmul`` or ``torch.einsum``
(the products the control rounds to TF32)."""

from __future__ import annotations

import torch


def norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def quat_rotate(q, v):
    qv, w = q[..., 1:], q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_from_rotvec(rv):
    n = norm(rv, keepdim=True)
    u = torch.where(n > 1e-12, rv / torch.where(n > 1e-12, n, 1.0), 0.0)
    half = 0.5 * n
    return torch.cat([torch.cos(half), torch.sin(half) * u], -1)


def quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def quat_normalize(q):
    n = norm(q, keepdim=True)
    return q / torch.where(n > 1e-12, n, 1.0)


def direction(yaw, pitch):
    d = torch.stack([torch.cos(yaw) * torch.cos(pitch), torch.sin(pitch),
                     torch.sin(yaw) * torch.cos(pitch)])
    return d / norm(d)


def look_at(eye, target, up):
    f = target - eye
    f = f / norm(f)
    s = cross(f, up)
    s = s / norm(s)
    u = cross(s, f)
    m = torch.eye(4, dtype=torch.float32, device=eye.device)
    m[0, :3], m[1, :3], m[2, :3] = s, u, -f
    m[0, 3] = -(s * eye).sum()
    m[1, 3] = -(u * eye).sum()
    m[2, 3] = (f * eye).sum()
    return m


def perspective(fov, aspect, near, far, device):
    """The camera's fixed projection, worked out on the host as the engine
    does (a last bit of difference in a frustum plane decides whether an
    entity on the plane takes logic, and so the world)."""
    t = 1.0 / torch.tan(0.5 * torch.tensor(fov, dtype=torch.float32))
    m = torch.zeros(4, 4, dtype=torch.float32)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m.to(device)


def proj_view(camv, cam):
    """The camera's projection times its view, from the camera vector
    (position, yaw, pitch, velocity) and its fixed settings."""
    eye = camv[0:3]
    up = torch.tensor([0.0, 1.0, 0.0], device=camv.device)
    view = look_at(eye, eye + direction(camv[3], camv[4]), up)
    proj = perspective(cam["fov_y"], cam["aspect"], cam["near"], cam["far"],
                       camv.device)
    return torch.matmul(proj, view)


def frustum_planes(pv):
    """Left, right, bottom, top, near, far: p is inside plane i where
    ``planes[i, :3] . p + planes[i, 3] >= 0`` (Gribb and Hartmann)."""
    r0, r1, r2, r3 = pv.unbind(0)
    planes = torch.stack([r3 + r0, r3 - r0, r3 + r1, r3 - r1, r3 + r2,
                          r3 - r2])
    n = norm(planes[:, :3], keepdim=True)
    return planes / torch.where(n > 1e-12, n, 1.0)


def aabb_in_frustum(planes, lo, hi):
    """Boxes that reach inside every plane (their most positive corner
    lies on its inner side)."""
    nrm = planes[:, :3]
    corner = torch.where(nrm[None] >= 0.0, hi[:, None], lo[:, None])
    dist = (corner * nrm[None]).sum(-1) + planes[None, :, 3]
    return (dist >= 0.0).all(-1)


def spot_proj_view(pos, direction_, cutoff_outer, fov, radius):
    """A spot light's camera: perspective along its direction, wide enough
    for its outer cone (+5%), out to its radius."""
    dev = pos.device
    dlen = norm(direction_)
    d = torch.where(dlen > 1e-6, direction_ / dlen.clamp(min=1e-6),
                    torch.tensor([0.0, -1.0, 0.0], device=dev))
    up = torch.where(d[1].abs() > 0.99, torch.tensor([1.0, 0.0, 0.0],
                                                       device=dev),
                     torch.tensor([0.0, 1.0, 0.0], device=dev))
    view = look_at(pos, pos + d, up)
    fov = fov.clamp(0.2, 3.0)
    cone = 2.0 * torch.arccos(cutoff_outer.clamp(-0.999, 0.999)) * 1.05
    if float(cutoff_outer) > 1e-3:
        fov = torch.maximum(fov, cone).clamp(0.2, 3.0)
    far = torch.where(radius > 0.0, radius, torch.tensor(600.0, device=dev))
    far = torch.maximum(far, torch.tensor(2.0, device=dev))
    t = 1.0 / torch.tan(0.5 * fov)
    near = 1.0
    p = torch.zeros(4, 4, dtype=torch.float32, device=dev)
    p[0, 0] = t / 1.0
    p[1, 1] = t
    p[2, 2] = (far + near) / (near - far)
    p[2, 3] = 2.0 * far * near / (near - far)
    p[3, 2] = -1.0
    return torch.matmul(p, view)

