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

    def get(self, name: str) -> torch.Tensor:
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

    def user_index(self) -> torch.Tensor:
        """Row of the dedicated user entity (the first row with
        ``FLAG_USER``; 0 when there is none)."""
        return torch.argmax(self.flag_set(R.FLAG_USER).to(torch.int32))

    def count_alive(self) -> torch.Tensor:
        return self.alive.sum()

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


def despawn(world: World, kill_mask: torch.Tensor) -> World:
    """Kill the entities where ``kill_mask`` is True; killing a dead slot
    is a no-op."""
    return dataclasses.replace(
        world, alive=world.alive & ~kill_mask,
        comp_mask=torch.where(kill_mask, torch.zeros_like(world.comp_mask),
                              world.comp_mask))


def _jax_dtype(reg: R.ComponentRegistry, name: str) -> np.dtype:
    """The JAX package's dtype of a column: the registry's, so the
    ``uint32`` bit sets stored here as int32 come back as uint32."""
    return np.dtype(reg.specs[reg.slot(name)].dtype)


def snapshot(world: World) -> dict:
    """Host copies of every column in the JAX package's dtypes (``alive``
    bool, ``comp_mask`` and the registry's ``uint32`` columns uint32), so a
    snapshot written here restores in the JAX package with the same hash.
    The columns cross to the host as one byte buffer: one read-back."""
    reg = world.config.registry
    names = sorted(world.comps)
    cols = [world.alive, world.comp_mask] + [world.comps[n] for n in names]
    dtypes = [np.dtype(bool), np.dtype(np.uint32)] + [
        _jax_dtype(reg, n) for n in names]
    raw = torch.cat([c.contiguous().reshape(-1).view(torch.uint8)
                     for c in cols]).cpu().numpy()
    out, at = [], 0
    for c, dt in zip(cols, dtypes):
        n = c.numel() * c.element_size()
        out.append(raw[at:at + n].copy().view(dt).reshape(tuple(c.shape)))
        at += n
    return {"alive": out[0], "comp_mask": out[1],
            "comps": dict(zip(names, out[2:]))}


def _to_port(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


def restore(config: WorldConfig, snap: dict, device="cpu") -> World:
    """A World on ``device`` from a snapshot in the JAX package's dtypes
    (``snapshot``'s, or a JAX-written history log's): uint32 columns
    become the port's int32 bit patterns."""
    return World(alive=_to_port(snap["alive"], device).to(torch.bool),
                 comp_mask=_to_port(snap["comp_mask"], device),
                 comps={k: _to_port(v, device)
                        for k, v in snap["comps"].items()},
                 config=config)
