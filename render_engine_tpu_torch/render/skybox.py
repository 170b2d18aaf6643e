"""Star-splat skybox: the space demo's background.

Port of ``make_starfield``, ``starfield_background`` and ``background_for``
from ``render_engine_tpu/render/skybox.py``: N unit directions projected
through the camera basis and splatted 2x2 into a deep-space base color with
a scatter-max (order-independent, so the result is deterministic).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from render_engine_tpu_torch.math import transforms as T

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
    fwd = camera.direction()
    up0 = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=dev)
    right = T.cross(fwd, up0)
    right = right / torch.linalg.vector_norm(right)
    up = T.cross(right, fwd)
    dx = stars.dirs @ right
    dy = stars.dirs @ up
    dz = stars.dirs @ fwd
    t = torch.tan(0.5 * torch.tensor(camera.fov_y, dtype=torch.float32,
                                     device=dev))
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
    bg = torch.tensor(base_color, dtype=torch.float32, device=dev).expand(
        n_px + 1, 3).clone()  # last row absorbs the dropped splats
    for oy in (0, 1):
        for ox in (0, 1):
            w_ = 1.0 if (ox == 0 and oy == 0) else 0.45
            flat = torch.where(ok, (py + oy) * width + (px + ox),
                               torch.full_like(px, n_px))
            bg.scatter_reduce_(0, flat[:, None].expand(-1, 3),
                               stars.colors * w_, reduce="amax")
    return bg[:n_px].reshape(height, width, 3)


def background_for(camera, cubemap, height: int, width: int,
                   clear_color=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """(H, W, 3) background: a Starfield's splats, else the clear color.
    (The cubemap skyboxes are not ported yet.)"""
    if isinstance(cubemap, Starfield):
        return starfield_background(camera, cubemap, height, width)
    if cubemap is not None:
        raise NotImplementedError("cubemap skyboxes are not ported yet")
    return torch.tensor(clear_color, dtype=torch.float32,
                        device=camera.device).expand(height, width,
                                                     3).clone()
