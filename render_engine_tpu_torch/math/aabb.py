"""Axis-aligned bounding boxes as (min, max) tensor pairs.

Port of ``render_engine_tpu/math/aabb.py``: an AABB is a pair of
``(..., 3)`` float32 tensors and every op broadcasts over leading axes.
"""

from __future__ import annotations

import torch


def intersects(mn_a, mx_a, mn_b, mx_b) -> torch.Tensor:
    """Closed-interval overlap test over the last axis."""
    return ((mn_a <= mx_b) & (mn_b <= mx_a)).all(dim=-1)


def corners(mn, mx) -> torch.Tensor:
    """The 8 corners, shape (..., 8, 3)."""
    sel = torch.tensor(
        [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
         [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]],
        dtype=torch.float32, device=mn.device)
    return mn[..., None, :] * (1.0 - sel) + mx[..., None, :] * sel


def center(mn, mx) -> torch.Tensor:
    return 0.5 * (mn + mx)


def half_extent(mn, mx) -> torch.Tensor:
    return 0.5 * (mx - mn)


def out_of_bounds(mn, mx, world_min, world_max) -> torch.Tensor:
    return ((mn < world_min) | (mx > world_max)).any(dim=-1)
