"""Visibility culling: frustum and distance tests over entity AABBs.

Port of ``render_engine_tpu/world/culling.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def aabb_in_frustum(planes: torch.Tensor, mn: torch.Tensor,
                    mx: torch.Tensor) -> torch.Tensor:
    """P-vertex test: True where an AABB intersects the 6-plane frustum."""
    normals = planes[:, :3]
    d = planes[:, 3]
    pv = torch.where(normals[None] >= 0.0, mx[:, None, :], mn[:, None, :])
    dist = (pv * normals[None]).sum(dim=-1) + d[None]
    return (dist >= 0.0).all(dim=-1)


def within_distance(center: torch.Tensor, mn: torch.Tensor, mx: torch.Tensor,
                    radius) -> torch.Tensor:
    """True where an AABB lies within ``radius`` (a float or a 0-d float32
    tensor) of ``center``."""
    clamped = torch.minimum(torch.maximum(center[None, :], mn), mx)
    d2 = ((clamped - center[None, :]) ** 2).sum(dim=-1)
    if isinstance(radius, torch.Tensor):
        return d2 <= radius * radius
    r = np.float32(radius)
    return d2 <= float(r * r)


def visible_mask(world, camera, logic_radius=None) -> torch.Tensor:
    """Render-frustum OR logic-sphere visibility over alive entities."""
    mn, mx = world["aabb_min"], world["aabb_max"]
    vis = aabb_in_frustum(camera.frustum_planes(), mn, mx)
    if logic_radius is not None:
        vis = vis | within_distance(camera.position, mn, mx, logic_radius)
    return world.alive & vis
