"""The world tick, as one function over tensors.

Port of ``render_engine_tpu/logic/step.py``, stage for stage: active mask,
user input, kinematics, out-of-bounds, transform refresh, collisions with
per-pair callbacks, per-type logic, the frame's ChangeSet, a second
refresh, and the camera snapped to the user entity.

Randomness: as in the JAX step, the frame's key is ``key(rng_seed)`` and
each random callback gets its own subkey, split off in the JAX order
(``rng, sub = split(rng)``). Keys and draws are the threefry of
``logic/random.py`` on the world's device, bit for bit those of
``jax.random``.

Per-frame values arrive as tensors: the seed as a 0-dim int64 tensor and
``dt`` as a 0-dim float32 tensor (``InputState.unpack_with_dt`` of the
packed wire), so the tick reads nothing back from the device and uploads
nothing, and runs inside a captured frame program as it runs eagerly.

Its four stages are spans of a traced program (``profiling.mark``):
``step.kinematics`` (active mask, user input, integration, out-of-bounds,
refresh), ``step.collisions`` (grid, ``find_collisions``, pair callbacks),
``step.logic`` (per-type logic) and ``step.changes`` (the ChangeSet, the
second refresh, the camera).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Sequence

import numpy as np
import torch

from render_engine_tpu_torch.ecs import changes as C
from render_engine_tpu_torch.ecs import registry as R
from render_engine_tpu_torch.ecs.world import World
from render_engine_tpu_torch.logic import collision as COL
from render_engine_tpu_torch.logic import kinematics as K
from render_engine_tpu_torch.logic import random as RND
from render_engine_tpu_torch.logic.types import EntityType, InputState
from render_engine_tpu_torch.runtime import profiling as P
from render_engine_tpu_torch.utils.indexing import gather_row, whole
from render_engine_tpu_torch.world import culling
from render_engine_tpu_torch.world import grid as G


def _accepts_other_type(fn) -> bool:
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    if "other_type" in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


STEP_DROP_KEYS = (
    "collision_cell_dropped",
    "collision_large_dropped",
    "collision_pair_dropped",
    "collision_query_dropped",
    "oob_killed",
    "spawn_dropped",
)


def pack_drop_stats(stats: dict) -> torch.Tensor:
    """The step's counters as one int32 vector in STEP_DROP_KEYS order."""
    return torch.stack([stats[k].to(torch.int32) for k in STEP_DROP_KEYS])


def unpack_drop_stats(vec) -> dict:
    vals = np.asarray(vec.cpu() if isinstance(vec, torch.Tensor) else vec)
    return {k: int(vals[i]) for i, k in enumerate(STEP_DROP_KEYS)}


def make_step(types: Sequence[EntityType], *, logic_radius=None,
              spawn_budget: int = 0, collision_budget: int = 8,
              collision_pairs: int = 4, collision_large_budget: int = 8):
    """Build the world tick for a closed set of entity types. The returned
    ``step(world, camera, inputs, dt, aabb_min, aabb_max)`` gives
    ``(world, camera, stats)``; ``inputs`` is the device form of
    ``InputState`` (``InputState.to_device`` or ``unpack_with_dt``), whose
    ``rng_seed`` is an int64 tensor on the world's device; ``dt`` a 0-dim
    float32 tensor there (``unpack_with_dt``)."""
    types = tuple(types)

    def step(world: World, camera, inputs: InputState, dt: torch.Tensor,
             model_aabb_min, model_aabb_max):
        P.mark("step.kinematics")
        dev = world.device
        rng = RND.key(inputs.rng_seed)

        world = world.replace(
            flags=world["flags"] & ~(R.FLAG_HAS_MOVED | R.FLAG_HAS_ROTATED))

        radius = camera.draw_distance if logic_radius is None \
            else logic_radius
        vis = culling.visible_mask(world, camera, logic_radius=radius)
        active = (vis | world.flag_set(R.FLAG_ALWAYS_LOGIC)) \
            & ~world.flag_set(R.FLAG_STATIC)

        cs = C.empty_changeset(world, spawn_budget=spawn_budget)

        for t in types:
            if t.user_input is not None:
                cs, camera = t.user_input(world, camera, inputs, dt, cs)

        world, moved, rotated = K.integrate(world, dt, active)

        world, kill_oob, oob = K.handle_out_of_bounds(world, types)
        for t in types:
            if t.out_of_bounds_logic is not None:
                cs = t.out_of_bounds_logic(world, oob & world.of_type(t.index),
                                           cs)

        world = K.refresh_transforms(world, model_aabb_min, model_aabb_max,
                                     moved | rotated)

        P.mark("step.collisions")
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        stats = {
            "collision_query_dropped": zero,
            "collision_cell_dropped": zero,
            "collision_pair_dropped": zero,
            "collision_large_dropped": zero,
            "spawn_dropped": zero,
            "oob_killed": kill_oob.sum(dtype=torch.int32),
        }
        if any(t.collision is not None or t.random_collision is not None
               for t in types):
            grid = G.build_grid(world)
            qmask = COL.collision_query_mask(world, moved)
            colres = COL.find_collisions(
                world, grid, camera.position, qmask,
                per_cell_budget=collision_budget,
                large_budget=collision_large_budget)
            stats["collision_query_dropped"] = colres.query_dropped
            stats["collision_cell_dropped"] = colres.cell_dropped
            stats["collision_large_dropped"] = colres.large_dropped
            pairs = max(1, collision_pairs)
            others, hitm, otypes, pair_dropped = colres.hits_topk(world,
                                                                  pairs)
            stats["collision_pair_dropped"] = pair_dropped
            for t in types:
                for fn, with_rng in ((t.collision, False),
                                     (t.random_collision, True)):
                    if fn is None:
                        continue
                    wants = _accepts_other_type(fn)
                    for j in range(pairs):
                        tmask = hitm[:, j] & world.of_type(t.index)
                        sub = ()
                        if with_rng:
                            rng, key = RND.split(rng)
                            sub = (key,)
                        kw = {"other_type": otypes[:, j]} if wants else {}
                        cs = fn(world, others[:, j], tmask, *sub, cs, **kw)

        P.mark("step.logic")
        for t in types:
            tmask = active & world.of_type(t.index)
            if t.logic is not None:
                cs = t.logic(world, dt, tmask, cs)
            if t.random_logic is not None:
                rng, sub = RND.split(rng)
                cs = t.random_logic(world, dt, tmask, sub, cs)

        P.mark("step.changes")
        cs = C.with_despawn(cs, kill_oob)
        logic_dirty = torch.zeros(world.capacity, dtype=torch.bool,
                                  device=dev)
        for name in ("position", "orientation", "scale"):
            if name in cs.updates:
                logic_dirty = logic_dirty | cs.updates[name][1]
        alive_before = world.alive
        world = C.apply_changeset(world, cs)
        if cs.spawns is not None:
            landed = world.alive & ~alive_before
            logic_dirty = logic_dirty | landed
            stats["spawn_dropped"] = (cs.spawns.count - whole(
                landed.sum(dtype=torch.int32))).clamp(min=0)
        world = K.refresh_transforms(world, model_aabb_min, model_aabb_max,
                                     logic_dirty)

        has_user = world.flag_set(R.FLAG_USER)
        uidx = has_user.to(torch.int8).argmax()
        camera = dataclasses.replace(
            camera, position=torch.where(has_user.any(),
                                         gather_row(world["position"], uidx),
                                         camera.position))
        return world, camera, stats

    return step
