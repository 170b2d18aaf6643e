"""Kinematics integration, world-AABB refresh and out-of-bounds handling.

Port of ``render_engine_tpu/logic/kinematics.py``.
"""

from __future__ import annotations

import torch

from render_engine_tpu_torch.ecs import registry as R
from render_engine_tpu_torch.ecs.world import World
from render_engine_tpu_torch.logic import types as LT
from render_engine_tpu_torch.math import transforms as T


def integrate(world: World, dt: float, mask: torch.Tensor
              ) -> tuple[World, torch.Tensor, torch.Tensor]:
    """v += a dt, p += v dt; angular velocity advances the orientation.
    Returns (world, moved, rotated) and sets HAS_MOVED / HAS_ROTATED."""
    kin = mask & world.has_components("position", "velocity")
    has_acc = world.has_components("acceleration")
    vel = world["velocity"]
    vel = torch.where((kin & has_acc)[:, None],
                      vel + world["acceleration"] * dt, vel)
    pos = world["position"]
    new_pos = torch.where(kin[:, None], pos + vel * dt, pos)
    moved = kin & (vel != 0.0).any(dim=-1)

    rot = mask & world.has_components("orientation", "ang_vel")
    has_aacc = world.has_components("ang_acc")
    ang_vel = world["ang_vel"]
    ang_vel = torch.where((rot & has_aacc)[:, None],
                          ang_vel + world["ang_acc"] * dt, ang_vel)
    dq = T.quat_from_rotvec(ang_vel * dt)
    quat = world["orientation"]
    new_quat = torch.where(rot[:, None],
                           T.quat_normalize(T.quat_mul(dq, quat)), quat)
    rotated = rot & (ang_vel != 0.0).any(dim=-1)

    flags = world["flags"]
    flags = torch.where(moved, flags | R.FLAG_HAS_MOVED, flags)
    flags = torch.where(rotated, flags | R.FLAG_HAS_ROTATED, flags)
    world = world.replace(position=new_pos, velocity=vel,
                          orientation=new_quat, ang_vel=ang_vel, flags=flags)
    return world, moved, rotated


def refresh_transforms(world: World, model_aabb_min: torch.Tensor,
                       model_aabb_max: torch.Tensor, dirty: torch.Tensor
                       ) -> World:
    """Recompute world AABBs where ``dirty``: the rotated, scaled model box
    bounded through |R| columns; model-less entities get a unit box."""
    mid = world["model_id"].clamp(0, model_aabb_min.shape[0] - 1).long()
    no_model = (world["model_id"] < 0)[:, None]
    obj_mn = torch.where(no_model, torch.full_like(model_aabb_min[mid], -0.5),
                         model_aabb_min[mid])
    obj_mx = torch.where(no_model, torch.full_like(model_aabb_max[mid], 0.5),
                         model_aabb_max[mid])
    quat = world["orientation"]
    scale = world["scale"]
    c_obj = 0.5 * (obj_mn + obj_mx)
    h_obj = 0.5 * (obj_mx - obj_mn)
    eye = torch.eye(3, dtype=torch.float32, device=quat.device)
    r0 = T.quat_rotate(quat, eye[0].expand_as(scale)).abs()
    r1 = T.quat_rotate(quat, eye[1].expand_as(scale)).abs()
    r2 = T.quat_rotate(quat, eye[2].expand_as(scale)).abs()
    sh = scale.abs() * h_obj
    half_w = r0 * sh[:, 0:1] + r1 * sh[:, 1:2] + r2 * sh[:, 2:3]
    center_w = T.quat_rotate(quat, scale * c_obj) + world["position"]
    d = dirty[:, None]
    return world.replace(
        aabb_min=torch.where(d, center_w - half_w, world["aabb_min"]),
        aabb_max=torch.where(d, center_w + half_w, world["aabb_max"]))


def world_transforms(world: World, indices=None) -> torch.Tensor:
    """TRS matrices on demand, for every row or for ``indices`` (the read
    path for user logic; the step never builds them)."""
    pos, quat, scale = (world["position"], world["orientation"],
                        world["scale"])
    if indices is not None:
        pos, quat, scale = pos[indices], quat[indices], scale[indices]
    return T.compose_trs(pos, quat, scale)


def handle_out_of_bounds(world: World, types
                         ) -> tuple[World, torch.Tensor, torch.Tensor]:
    """Clamp / mark / delete per type policy. Returns
    (world, kill_mask, oob_mask)."""
    cfg = world.config
    lo = torch.tensor(cfg.world_min, dtype=torch.float32,
                      device=world.device)
    hi = lo + cfg.world_length
    pos = world["position"]
    oob = world.alive & ((pos < lo) | (pos > hi)).any(dim=-1)
    clamp_mask = torch.zeros_like(oob)
    kill_mask = torch.zeros_like(oob)
    mark_mask = torch.zeros_like(oob)
    for t in types:
        tm = oob & (world["type_id"] == t.index)
        if t.out_of_bounds == LT.OOB_DELETE:
            kill_mask = kill_mask | tm
        elif t.out_of_bounds == LT.OOB_MARK:
            mark_mask = mark_mask | tm
        else:
            clamp_mask = clamp_mask | tm
    clamp_mask = clamp_mask | (oob & (world["type_id"] < 0))
    new_pos = torch.where(clamp_mask[:, None],
                          torch.minimum(torch.maximum(pos, lo), hi), pos)
    flags = world["flags"]
    flags = torch.where(mark_mask | kill_mask, flags | R.FLAG_OUT_OF_BOUNDS,
                        flags)
    return world.replace(position=new_pos, flags=flags), kill_mask, oob
