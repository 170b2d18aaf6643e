"""Light extraction: fixed-budget per-type light arrays from the world.

Port of ``LightArrays``, ``extract_lights`` and the shading constants of
``render_engine_tpu/render/lighting.py``. The lighting math itself lives
in the fused shade kernel (``shade_pallas.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from render_engine_tpu_torch.ecs import registry as R
from render_engine_tpu_torch.ecs.world import World
from render_engine_tpu_torch.models.bank import DEFAULT_SHININESS

SHININESS = DEFAULT_SHININESS
DIFFUSE_FLOOR = 0.08


@dataclasses.dataclass(frozen=True)
class LightArrays:
    dir_direction: torch.Tensor  # (ND, 3)
    dir_diffuse: torch.Tensor
    dir_specular: torch.Tensor
    dir_ambient: torch.Tensor
    dir_count: torch.Tensor  # () int32
    dir_entity: torch.Tensor  # (ND,) entity id, -1 empty
    pt_position: torch.Tensor  # (NP, 3)
    pt_diffuse: torch.Tensor
    pt_specular: torch.Tensor
    pt_ambient: torch.Tensor
    pt_atten: torch.Tensor  # (NP, 2)
    pt_radius: torch.Tensor  # (NP,)
    pt_count: torch.Tensor
    pt_entity: torch.Tensor
    sp_position: torch.Tensor  # (NS, 3)
    sp_direction: torch.Tensor
    sp_diffuse: torch.Tensor
    sp_specular: torch.Tensor
    sp_ambient: torch.Tensor
    sp_atten: torch.Tensor
    sp_cutoff: torch.Tensor  # (NS, 2) cos inner, cos outer
    sp_count: torch.Tensor
    sp_entity: torch.Tensor


def _select_bucket(world: World, bucket: int, budget: int):
    """Lowest entity indices of one sortable bucket, up to ``budget``."""
    m = world.sortable_mask(bucket)
    cap = world.capacity
    ar = torch.arange(cap, dtype=torch.int64, device=world.device)
    idx = torch.sort(torch.where(m, ar, torch.full_like(ar, cap))).values
    idx = idx[:budget]
    if idx.shape[0] < budget:  # a budget above capacity pads with empties
        idx = torch.cat([idx, idx.new_full((budget - idx.shape[0],), cap)])
    valid = idx < cap
    return (idx.clamp(0, cap - 1), valid,
            m.sum(dtype=torch.int32).clamp(0, budget))


def extract_lights(world: World, *, max_dir: int = 4, max_point: int = 256,
                   max_spot: int = 16) -> LightArrays:
    di, dv, dc = _select_bucket(world, R.SORTABLE_DIRECTIONAL, max_dir)
    pi, pv, pc = _select_bucket(world, R.SORTABLE_POINT, max_point)
    si, sv, sc = _select_bucket(world, R.SORTABLE_SPOT, max_spot)

    def g(name, idx, valid):
        a = world[name][idx]
        v = valid.reshape(valid.shape + (1,) * (a.ndim - 1))
        return torch.where(v, a, torch.zeros_like(a))

    def ent(idx, valid):
        return torch.where(valid, idx, torch.full_like(idx, -1)).to(
            torch.int32)

    return LightArrays(
        dir_direction=g("light_direction", di, dv),
        dir_diffuse=g("light_diffuse", di, dv),
        dir_specular=g("light_specular", di, dv),
        dir_ambient=g("light_ambient", di, dv),
        dir_count=dc, dir_entity=ent(di, dv),
        pt_position=g("position", pi, pv),
        pt_diffuse=g("light_diffuse", pi, pv),
        pt_specular=g("light_specular", pi, pv),
        pt_ambient=g("light_ambient", pi, pv),
        pt_atten=g("light_atten", pi, pv),
        pt_radius=g("light_radius", pi, pv),
        pt_count=pc, pt_entity=ent(pi, pv),
        sp_position=g("position", si, sv),
        sp_direction=g("light_direction", si, sv),
        sp_diffuse=g("light_diffuse", si, sv),
        sp_specular=g("light_specular", si, sv),
        sp_ambient=g("light_ambient", si, sv),
        sp_atten=g("light_atten", si, sv),
        sp_cutoff=g("light_cutoff", si, sv),
        sp_count=sc, sp_entity=ent(si, sv),
    )
