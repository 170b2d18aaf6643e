"""The World: one fixed-capacity structure-of-arrays of tensors.

Port of ``render_engine_tpu/ecs/world.py``. Entity ids are row indices;
``alive`` marks live rows; each component is a ``(CAP, ...)`` tensor on the
world's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from render_engine_tpu_torch.ecs import registry as R


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    capacity: int = 1024
    world_min: tuple = (0.0, 0.0, 0.0)
    world_length: float = 16384.0
    section_length: float = 64.0
    registry: R.ComponentRegistry = dataclasses.field(
        default_factory=R.ComponentRegistry)

    @property
    def grid_cells_per_axis(self) -> int:
        return max(1, int(round(self.world_length / self.section_length)))


@dataclasses.dataclass(frozen=True)
class World:
    alive: torch.Tensor  # bool[CAP]
    comp_mask: torch.Tensor  # int32[CAP] bit set
    comps: dict  # name -> (CAP, ...) tensor
    config: WorldConfig

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.comps[name]

    def replace(self, **updates) -> "World":
        comps = dict(self.comps)
        top = {}
        for k, v in updates.items():
            if k in ("alive", "comp_mask"):
                top[k] = v
            else:
                if k not in comps:
                    raise KeyError(f"unknown component {k!r}")
                comps[k] = v
        return dataclasses.replace(self, comps=comps, **top)

    @property
    def capacity(self) -> int:
        return self.config.capacity

    @property
    def device(self) -> torch.device:
        return self.alive.device

    def has_components(self, *names: str) -> torch.Tensor:
        bits = self.config.registry.bits(*names)
        return self.alive & ((self.comp_mask & bits) == bits)

    def of_type(self, type_index: int) -> torch.Tensor:
        return self.alive & (self.comps["type_id"] == type_index)

    def flag_set(self, flag: int) -> torch.Tensor:
        return self.alive & ((self.comps["flags"] & flag) != 0)

    def sortable_mask(self, bucket: int) -> torch.Tensor:
        return self.alive & (self.comps["sortable"] == bucket)

    def clone(self) -> "World":
        return dataclasses.replace(
            self, alive=self.alive.clone(), comp_mask=self.comp_mask.clone(),
            comps={k: v.clone() for k, v in self.comps.items()})


def _default_column(spec: R.ComponentSpec, rows: int, device) -> torch.Tensor:
    arr = torch.full((rows,) + spec.shape, spec.default,
                     dtype=R.torch_dtype(spec), device=device)
    if spec.name == "orientation":
        arr[:, 0] = 1.0
    if spec.name == "transform":
        arr = torch.eye(4, dtype=torch.float32, device=device).expand(
            rows, 4, 4).clone()
    return arr


def create_world(config: WorldConfig, device="cpu") -> World:
    """An empty world: every slot dead, components at their defaults."""
    cap = config.capacity
    comps = {s.name: _default_column(s, cap, device)
             for s in config.registry.specs}
    return World(alive=torch.zeros(cap, dtype=torch.bool, device=device),
                 comp_mask=torch.zeros(cap, dtype=torch.int32, device=device),
                 comps=comps, config=config)


def spawn_host(world: World, count: int, **values) -> tuple[World, np.ndarray]:
    """Spawn ``count`` entities into the first free slots (scene setup).
    ``values[name]`` broadcasts to (count,) + spec.shape."""
    reg = world.config.registry
    alive = world.alive.cpu().numpy()
    free = np.flatnonzero(~alive)
    if len(free) < count:
        raise ValueError(
            f"world capacity exhausted: need {count} slots, have {len(free)}")
    idx = free[:count]
    idx_t = torch.as_tensor(idx, dtype=torch.long, device=world.device)
    new_alive = world.alive.clone()
    new_alive[idx_t] = True
    comps = dict(world.comps)
    mask_bits = 0
    for name, val in values.items():
        if name not in reg:
            raise KeyError(f"unknown component {name!r}")
        spec = reg.specs[reg.slot(name)]
        arr = np.asarray(val)
        if spec.dtype == "uint32":
            arr = arr.astype(np.uint32).view(np.int32)
        arr = np.broadcast_to(arr.astype(spec.dtype.replace("uint", "int")),
                              (count,) + spec.shape)
        col = comps[name].clone()
        col[idx_t] = torch.tensor(arr, device=world.device)
        comps[name] = col
        mask_bits |= reg.bit(name)
    new_mask = world.comp_mask.clone()
    new_mask[idx_t] = R.as_bits(mask_bits)
    return dataclasses.replace(world, alive=new_alive, comp_mask=new_mask,
                               comps=comps), idx
