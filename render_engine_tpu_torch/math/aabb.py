"""Axis-aligned bounding boxes as (min, max) tensor pairs.

Port of ``render_engine_tpu/math/aabb.py``: an AABB is a pair of
``(..., 3)`` float32 tensors and every op broadcasts over leading axes.
"""

from __future__ import annotations

import torch

from render_engine_tpu_torch.math import transforms as T


def from_points(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """AABB of a point cloud: (..., N, 3) -> ((..., 3), (..., 3))."""
    return points.amin(dim=-2), points.amax(dim=-2)


def translate(mn, mx, offset):
    return mn + offset, mx + offset


def combine(mn_a, mx_a, mn_b, mx_b):
    """The smallest AABB containing both."""
    return torch.minimum(mn_a, mn_b), torch.maximum(mx_a, mx_b)


def intersects(mn_a, mx_a, mn_b, mx_b) -> torch.Tensor:
    """Closed-interval overlap test over the last axis."""
    return ((mn_a <= mx_b) & (mn_b <= mx_a)).all(dim=-1)


def contains_point(mn, mx, p) -> torch.Tensor:
    return ((mn <= p) & (p <= mx)).all(dim=-1)


def corners(mn, mx) -> torch.Tensor:
    """The 8 corners, shape (..., 8, 3)."""
    sel = torch.tensor(
        [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
         [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]],
        dtype=torch.float32, device=mn.device)
    return mn[..., None, :] * (1.0 - sel) + mx[..., None, :] * sel


def transform(mn, mx, matrix) -> tuple[torch.Tensor, torch.Tensor]:
    """AABB of this AABB under a (..., 4, 4) affine transform (its 8 corners
    moved, then bounded)."""
    return from_points(T.apply_transform(matrix, corners(mn, mx)))


def center(mn, mx) -> torch.Tensor:
    return 0.5 * (mn + mx)


def half_extent(mn, mx) -> torch.Tensor:
    return 0.5 * (mx - mn)


def bounding_sphere_radius(mn, mx) -> torch.Tensor:
    """Radius of the sphere enclosing the AABB (conservative)."""
    return torch.linalg.vector_norm(half_extent(mn, mx), dim=-1)


def distance_to_point(mn, mx, p) -> torch.Tensor:
    """Conservative: center distance minus the bounding-sphere radius,
    clamped at 0."""
    d = torch.linalg.vector_norm(center(mn, mx) - p, dim=-1)
    return (d - bounding_sphere_radius(mn, mx)).clamp(min=0.0)


def exact_distance_to_point(mn, mx, p) -> torch.Tensor:
    """Exact point-to-AABB distance (0 inside)."""
    clamped = torch.minimum(torch.maximum(p, mn), mx)
    return torch.linalg.vector_norm(p - clamped, dim=-1)


def out_of_bounds(mn, mx, world_min, world_max) -> torch.Tensor:
    return ((mn < world_min) | (mx > world_max)).any(dim=-1)
