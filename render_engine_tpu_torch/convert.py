"""Carry the JAX package's state across, as numpy arrays, into the port.

Every function takes plain numpy arrays (the caller applies ``np.asarray``
to the JAX side), so this module imports neither JAX nor the JAX package.
``uint32`` bit-set columns come back as the port's int32 bit patterns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from render_engine_tpu_torch.ecs import world as W
from render_engine_tpu_torch.ecs.world import World, WorldConfig
from render_engine_tpu_torch.math.camera import Camera
from render_engine_tpu_torch.models.bank import ModelBank
from render_engine_tpu_torch.render.geometry import TriangleBatch
from render_engine_tpu_torch.render.render_system import CompiledSystems
from render_engine_tpu_torch.render.shadows import ShadowState
from render_engine_tpu_torch.render.skybox import Starfield
from render_engine_tpu_torch.render.textures import TextureAtlas

BANK_FIELDS = ("vertices", "normals", "uvs", "tri_v", "tri_material",
               "tri_offset", "tri_count", "vtx_offset", "aabb_min",
               "aabb_max", "mat_albedo", "mat_emissive", "mat_alpha",
               "mat_specular", "mat_shininess", "mat_textures", "lov_table",
               "lov_fractions")


def _t(a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    # a copy: np.asarray of a JAX array is a read-only view
    return torch.tensor(a, device=device)


def world_from_numpy(config: WorldConfig, alive, comp_mask, comps: dict,
                     device="cpu") -> World:
    """World columns (name -> array) and ``alive`` -> a port World."""
    return W.restore(config, {"alive": alive, "comp_mask": comp_mask,
                              "comps": comps}, device)


def bank_from_numpy(arrays: dict, names, device="cpu") -> ModelBank:
    """``arrays``: field name -> array for every ``BANK_FIELDS`` entry."""
    return ModelBank(**{k: _t(arrays[k], device) for k in BANK_FIELDS},
                     names=tuple(names))


def atlas_from_numpy(layers, tex_layer, uv_rect, bilin_rows,
                     device="cpu") -> TextureAtlas:
    return TextureAtlas(layers=_t(layers, device),
                        tex_layer=_t(tex_layer, device),
                        uv_rect=_t(uv_rect, device),
                        bilin_rows=_t(bilin_rows, device))


def triangle_batch_from_numpy(fields: dict, device="cpu") -> TriangleBatch:
    """TriangleBatch field name -> array, as a port TriangleBatch."""
    return TriangleBatch(**{f.name: _t(fields[f.name], device)
                            for f in dataclasses.fields(TriangleBatch)})


def camera_from_serialized(vec, template: Camera, device="cpu") -> Camera:
    """The 8-float camera vector applied to a port camera template."""
    return template.to(device).apply_serialized(
        _t(np.asarray(vec, np.float32), device))


def starfield_from_numpy(dirs, colors, device="cpu") -> Starfield:
    return Starfield(dirs=_t(dirs, device), colors=_t(colors, device))


def cubemap_from_numpy(faces, device="cpu") -> torch.Tensor:
    """(6, S, S, 3) cubemap faces as the port's raw cubemap tensor."""
    return _t(np.asarray(faces, np.float32), device)


def systems_from_numpy(model_system, sys_table, sys_lov, names,
                       device="cpu", src=()) -> CompiledSystems:
    """A JAX ``CompiledSystems``' tables as the port's. ``src``: the port's
    own ``RenderSystem`` records when the systems carry callbacks (a
    callback is written once per package, in jnp and in torch)."""
    return CompiledSystems(model_system=_t(model_system, device),
                           sys_table=_t(sys_table, device),
                           sys_lov=_t(sys_lov, device), names=tuple(names),
                           src=tuple(src))


def shadow_state_from_numpy(maps, light_mats, slot_entity, slot_face, cursor,
                            tick, resolution, pcf_scale,
                            device="cpu") -> ShadowState:
    """A JAX ``ShadowState``'s fields as a port ShadowState (its
    ``maps_pcf`` table is not needed: the port reads the taps from
    ``maps``); ``cursor`` and ``tick`` become host integers."""
    return ShadowState(maps=_t(maps, device),
                       light_mats=_t(light_mats, device),
                       slot_entity=_t(slot_entity, device),
                       slot_face=_t(slot_face, device),
                       cursor=int(np.asarray(cursor)),
                       tick=int(np.asarray(tick)),
                       resolution=int(resolution), pcf_scale=int(pcf_scale))
