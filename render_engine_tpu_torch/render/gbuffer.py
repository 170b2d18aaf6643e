"""G-buffer: the deferred first pass's render targets as (H, W, C) tensors.

Port of ``render_engine_tpu/render/gbuffer.py``. An int32 material-id
channel and the winning-triangle id mark background pixels.
"""

from __future__ import annotations

import dataclasses

import torch

MATERIAL_BACKGROUND = -1  # no geometry: skybox / clear color pixels


@dataclasses.dataclass(frozen=True)
class GBuffer:
    depth: torch.Tensor  # (H, W) NDC depth, +1 = far/empty
    position: torch.Tensor  # (H, W, 3) world-space position
    normal: torch.Tensor  # (H, W, 3) world-space unit normal
    albedo: torch.Tensor  # (H, W, 3)
    material: torch.Tensor  # (H, W) int32, MATERIAL_BACKGROUND where empty
    tri_id: torch.Tensor  # (H, W) int32 winning triangle, -1 where empty

    @property
    def shape(self):
        return tuple(self.depth.shape)

    def covered(self) -> torch.Tensor:
        return self.tri_id >= 0


def empty_gbuffer(height: int, width: int, device="cpu") -> GBuffer:
    f32, i32 = torch.float32, torch.int32
    return GBuffer(
        depth=torch.ones((height, width), dtype=f32, device=device),
        position=torch.zeros((height, width, 3), dtype=f32, device=device),
        normal=torch.zeros((height, width, 3), dtype=f32, device=device),
        albedo=torch.zeros((height, width, 3), dtype=f32, device=device),
        material=torch.full((height, width), MATERIAL_BACKGROUND, dtype=i32,
                            device=device),
        tri_id=torch.full((height, width), -1, dtype=i32, device=device))
