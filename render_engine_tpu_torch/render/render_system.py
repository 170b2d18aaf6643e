"""Render systems: user pipelines bound to sets of models, compiled to data.

Port of ``RenderSystem``, ``RenderSystemBuilder``, ``compile_systems`` and
``entity_shade_attrs`` from ``render_engine_tpu/render/render_system.py``.
Systems become per-model routing and per-system shading rows folded into
the one fused pass. Per-frame draw callbacks and custom fragment shading
are not ported yet: building a system with either raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from render_engine_tpu_torch.ecs.world import World


@dataclasses.dataclass(frozen=True)
class RenderSystem:
    name: str
    model_ids: tuple
    lit: bool = True
    emissive_boost: float = 1.0
    casts_lov: bool = True
    uniforms: tuple = ()


class RenderSystemBuilder:
    def __init__(self, name: str):
        self._name = name
        self._models: list[int] = []
        self._lit = True
        self._emissive_boost = 1.0
        self._lov = True
        self._uniforms: list[tuple] = []

    def with_models(self, *model_ids: int) -> "RenderSystemBuilder":
        self._models.extend(int(m) for m in model_ids)
        return self

    def with_lighting(self, lit: bool = True) -> "RenderSystemBuilder":
        self._lit = lit
        return self

    def with_emissive_boost(self, boost: float) -> "RenderSystemBuilder":
        self._emissive_boost = float(boost)
        return self

    def with_levels_of_view(self, enabled: bool) -> "RenderSystemBuilder":
        self._lov = enabled
        return self

    def write_uniform(self, name: str, value) -> "RenderSystemBuilder":
        if not isinstance(name, str) or not name:
            raise TypeError("uniform name must be a non-empty string")
        if not isinstance(value, (int, float, tuple)):
            raise TypeError(
                f"uniform {name!r}: unsupported type {type(value).__name__}")
        self._uniforms.append((name, value))
        return self

    def build(self) -> RenderSystem:
        if not self._models:
            raise ValueError(f"render system {self._name!r}: no models bound")
        return RenderSystem(name=self._name, model_ids=tuple(self._models),
                            lit=self._lit,
                            emissive_boost=self._emissive_boost,
                            casts_lov=self._lov,
                            uniforms=tuple(self._uniforms))


RECOGNIZED_UNIFORMS = {"albedo_tint": tuple, "alpha_scale": float,
                       "emissive_boost": float}


@dataclasses.dataclass(frozen=True)
class CompiledSystems:
    """model_system (M,) int32: the system drawing each model (-1 none);
    sys_table (S, 6) f32 [unlit, boost, tint rgb, alpha_scale]; sys_lov
    (S,) f32 casts_lov per system."""

    model_system: torch.Tensor
    sys_table: torch.Tensor
    sys_lov: torch.Tensor
    names: tuple


def compile_systems(systems, bank) -> CompiledSystems:
    systems = tuple(systems)
    nm = bank.num_models
    model_system = np.full(nm, -1, np.int32)
    table = np.zeros((max(len(systems), 1), 6), np.float32)
    lov = np.ones(max(len(systems), 1), np.float32)
    lov_table = bank.lov_table.cpu().numpy()
    for s, sys_ in enumerate(systems):
        boost = float(sys_.emissive_boost)
        tint = (1.0, 1.0, 1.0)
        alpha_scale = 1.0
        for name, value in sys_.uniforms:
            if name not in RECOGNIZED_UNIFORMS:
                raise ValueError(f"render system {sys_.name!r}: unknown "
                                 f"uniform {name!r}")
            if name == "albedo_tint":
                tint = tuple(float(v) for v in value)
            elif name == "alpha_scale":
                alpha_scale = float(value)
            else:
                boost *= float(value)
        table[s] = [0.0 if sys_.lit else 1.0, boost, *tint, alpha_scale]
        lov[s] = 1.0 if sys_.casts_lov else 0.0
        for m in sys_.model_ids:
            if not 0 <= m < nm:
                raise ValueError(f"render system {sys_.name!r}: model id {m} "
                                 "not in bank")
            if model_system[m] >= 0 and model_system[m] != s:
                raise ValueError(f"model {m} bound to two render systems")
            model_system[m] = s
            for variant in lov_table[m]:
                if model_system[variant] < 0:
                    model_system[variant] = s
    dev = bank.device
    return CompiledSystems(model_system=torch.as_tensor(model_system,
                                                        device=dev),
                           sys_table=torch.as_tensor(table, device=dev),
                           sys_lov=torch.as_tensor(lov, device=dev),
                           names=tuple(s.name for s in systems))


def entity_shade_attrs(world: World, systems: CompiledSystems
                       ) -> torch.Tensor:
    """(CAP, 6) per-entity shading rows from each entity's model's system
    (identity row for unrouted entities)."""
    table = systems.sys_table
    mid = world["model_id"]
    ms = systems.model_system[mid.clamp(
        0, systems.model_system.shape[0] - 1).long()]
    rows = table[ms.clamp(0, table.shape[0] - 1).long()]
    identity = torch.tensor([0.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                            dtype=torch.float32, device=world.device)
    return torch.where(((ms >= 0) & (mid >= 0))[:, None], rows, identity)
