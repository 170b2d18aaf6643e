"""Skyboxes: the star-splat background of the space demo, and cubemaps.

Port of ``render_engine_tpu/render/skybox.py``. A ``Starfield`` is N unit
directions projected through the camera basis and splatted 2x2 into a
deep-space base color with a scatter-max (order-independent, so the result
is deterministic). A cubemap is sampled per background pixel along its
camera ray: ``sample_cubemap`` takes four taps from (6, S, S, 3) faces,
``sample_cubemap_rows`` one row of a precomputed 2x2-footprint table
(``cubemap_rows``), with the same values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.utils import consts
from render_engine_tpu_torch.utils.consts import const

SPACE_BASE_COLOR = (0.004, 0.005, 0.012)


@dataclasses.dataclass(frozen=True)
class Starfield:
    dirs: torch.Tensor  # (N, 3) unit directions
    colors: torch.Tensor  # (N, 3) linear color


def make_starfield(n_stars: int = 2400, seed: int = 7, device="cpu"
                   ) -> Starfield:
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_stars, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    brightness = rng.uniform(0.25, 1.0, (n_stars, 1)).astype(np.float32)
    tint = rng.uniform(0.85, 1.0, (n_stars, 3)).astype(np.float32)
    return Starfield(
        dirs=torch.as_tensor(d.astype(np.float32), device=device),
        colors=torch.as_tensor(brightness * tint, device=device))


def starfield_background(camera, stars: Starfield, height: int, width: int,
                         base_color=SPACE_BASE_COLOR) -> torch.Tensor:
    """(H, W, 3) background: base color + scattered 2x2 star splats."""
    dev = stars.dirs.device
    fwd, right, up = _camera_basis(camera, dev)
    dx = stars.dirs @ right
    dy = stars.dirs @ up
    dz = stars.dirs @ fwd
    t = torch.tan(0.5 * const(float(camera.fov_y), device=dev))
    safe = torch.where(dz > 1e-6, dz, torch.ones_like(dz))
    ndc_x = dx / (safe * t * camera.aspect)
    ndc_y = dy / (safe * t)
    # bound the floats before the int cast (an out-of-range cast is
    # undefined); the bounds keep every off-screen star off-screen
    px = ((ndc_x * 0.5 + 0.5) * width).clamp(-2.0, width + 2.0).to(
        torch.int64)
    py = ((0.5 - ndc_y * 0.5) * height).clamp(-2.0, height + 2.0).to(
        torch.int64)
    ok = (dz > 1e-6) & (px >= 0) & (px < width - 1) & (py >= 0) \
        & (py < height - 1)
    n_px = height * width
    bg = const(tuple(map(float, base_color)), device=dev).expand(
        n_px + 1, 3).clone()  # last row absorbs the dropped splats
    for oy in (0, 1):
        for ox in (0, 1):
            w_ = 1.0 if (ox == 0 and oy == 0) else 0.45
            flat = torch.where(ok, (py + oy) * width + (px + ox),
                               torch.full_like(px, n_px))
            bg.scatter_reduce_(0, flat[:, None].expand(-1, 3),
                               stars.colors * w_, reduce="amax")
    return bg[:n_px].reshape(height, width, 3)


def _camera_basis(camera, device):
    fwd = camera.direction()
    up0 = const((0.0, 1.0, 0.0), device=device)
    right = T.cross(fwd, up0)
    right = right / torch.linalg.vector_norm(right)
    return fwd, right, T.cross(right, fwd)


@consts.cached(maxsize=8)
def _pixel_center_ndc(n: int, device) -> torch.Tensor:
    """(i + 0.5) / n * 2 - 1 for the n pixel centers of one axis, computed
    on the host: numpy rounds the division like the JAX package (CUDA
    multiplies by a host scalar's reciprocal instead)."""
    f32 = np.float32
    return torch.tensor((np.arange(n, dtype=f32) + f32(0.5)) / f32(n)
                        * f32(2.0) - f32(1.0), device=device)


def pixel_ray_directions(camera, height: int, width: int) -> torch.Tensor:
    """World-space unit ray direction through every pixel center,
    (H, W, 3)."""
    dev = camera.device
    fwd, right, up = _camera_basis(camera, dev)
    t = torch.tan(0.5 * const(float(camera.fov_y), device=dev))
    x_ndc = _pixel_center_ndc(width, dev)
    y_ndc = -_pixel_center_ndc(height, dev)
    d = (fwd[None, None]
         + x_ndc[None, :, None] * (t * camera.aspect) * right[None, None]
         + y_ndc[:, None, None] * t * up[None, None])
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def _face_uv(dirs):
    """Cube face (+X, -X, +Y, -Y, +Z, -Z) and per-face [-1, 1] uv of unit
    directions (..., 3), in the GL orientation."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(is_x, torch.where(x >= 0, 0, 1),
                       torch.where(is_y, torch.where(y >= 0, 2, 3),
                                   torch.where(z >= 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp(min=1e-9)
    u = torch.where(is_x, torch.where(x >= 0, -z, z),
                    torch.where(is_y, x, torch.where(z >= 0, x, -x))) / ma
    v = torch.where(is_x, -y,
                    torch.where(is_y, torch.where(y >= 0, z, -z), -y)) / ma
    return face, u, v


def _texel(u, v, s):
    """Continuous texel coordinates of face uv and their clamped floor."""
    uf = (u * 0.5 + 0.5) * (s - 1)
    vf = (v * 0.5 + 0.5) * (s - 1)
    u0 = torch.floor(uf).clamp(0.0, s - 1.0)
    v0 = torch.floor(vf).clamp(0.0, s - 1.0)
    return (uf - u0)[..., None], (vf - v0)[..., None], u0.long(), v0.long()


def _bilinear(c00, c01, c10, c11, fu, fv):
    return (c00 * (1 - fu) * (1 - fv) + c01 * fu * (1 - fv)
            + c10 * (1 - fu) * fv + c11 * fu * fv)


def sample_cubemap(cubemap: torch.Tensor, dirs: torch.Tensor
                   ) -> torch.Tensor:
    """Bilinear sample of (6, S, S, 3) faces along unit vectors (..., 3),
    taps clamped to their face's edge."""
    face, u, v = _face_uv(dirs)
    s = cubemap.shape[1]
    fu, fv, u0, v0 = _texel(u, v, s)
    u1 = (u0 + 1).clamp(max=s - 1)
    v1 = (v0 + 1).clamp(max=s - 1)
    return _bilinear(cubemap[face, v0, u0], cubemap[face, v0, u1],
                     cubemap[face, v1, u0], cubemap[face, v1, u1], fu, fv)


@dataclasses.dataclass(frozen=True)
class CubemapRows:
    rows: torch.Tensor  # (6*S*S, 16): [c00 c01 c10 c11 | pad] per texel
    size: int


def cubemap_rows(cubemap, device=None) -> CubemapRows:
    """The 2x2-footprint row table of (6, S, S, 3) faces (a tensor or an
    array), edge-clamped within each face like ``sample_cubemap``'s taps."""
    if isinstance(cubemap, torch.Tensor):
        device = cubemap.device if device is None else device
        cubemap = cubemap.cpu().numpy()
    c = np.asarray(cubemap, np.float32)
    s = c.shape[1]
    right = np.concatenate([c[:, :, 1:], c[:, :, -1:]], axis=2)
    down = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    downright = np.concatenate([right[:, 1:], right[:, -1:]], axis=1)
    rows = np.concatenate(
        [c, right, down, downright,
         np.zeros(c.shape[:-1] + (4,), np.float32)], axis=-1
    ).reshape(6 * s * s, 16)
    return CubemapRows(rows=torch.as_tensor(rows, device=device or "cpu"),
                       size=s)


def sample_cubemap_rows(cm: CubemapRows, dirs: torch.Tensor) -> torch.Tensor:
    """``sample_cubemap``'s values from one row gather per pixel."""
    face, u, v = _face_uv(dirs)
    s = cm.size
    fu, fv, u0, v0 = _texel(u, v, s)
    r = cm.rows[face * (s * s) + v0 * s + u0]
    return _bilinear(r[..., 0:3], r[..., 3:6], r[..., 6:9], r[..., 9:12],
                     fu, fv)


def starfield_cubemap(size: int = 256, stars_per_face: int = 400,
                      seed: int = 7, device="cpu") -> torch.Tensor:
    """A procedural (6, S, S, 3) space skybox: single-texel stars on a
    deep-space base color."""
    rng = np.random.default_rng(seed)
    faces = np.zeros((6, size, size, 3), np.float32)
    faces[:] = np.array(SPACE_BASE_COLOR)
    for f in range(6):
        xs = rng.integers(0, size, stars_per_face)
        ys = rng.integers(0, size, stars_per_face)
        brightness = rng.uniform(0.3, 1.0, stars_per_face).astype(np.float32)
        tint = rng.uniform(0.85, 1.0, (stars_per_face, 3)).astype(np.float32)
        faces[f, ys, xs] = brightness[:, None] * tint
    return torch.as_tensor(faces, device=device)


def background_for(camera, cubemap, height: int, width: int,
                   clear_color=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """(H, W, 3) background of any skybox kind: a ``Starfield``'s splats,
    ``CubemapRows`` (one row gather a pixel), raw (6, S, S, 3) faces (four
    taps a pixel), or the clear color."""
    if isinstance(cubemap, Starfield):
        return starfield_background(camera, cubemap, height, width)
    if isinstance(cubemap, CubemapRows):
        return sample_cubemap_rows(
            cubemap, pixel_ray_directions(camera, height, width))
    if cubemap is not None:
        return sample_cubemap(
            cubemap, pixel_ray_directions(camera, height, width))
    return const(tuple(map(float, clear_color)),
                 device=camera.device).expand(height, width, 3).clone()
