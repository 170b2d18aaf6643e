"""Component registry: names -> tensor columns, shapes, dtypes, defaults.

Port of ``render_engine_tpu/ecs/registry.py``. The JAX package's
``uint32`` bit-set columns (``flags``, ``comp_mask``) are stored as
``int32`` bit patterns here: PyTorch's unsigned 32-bit type has no bitwise
kernels on the GPU, and every flag bit in use fits below bit 31.
"""

from __future__ import annotations

import dataclasses

import torch

MAX_COMPONENTS = 32


@dataclasses.dataclass(frozen=True)
class ComponentSpec:
    name: str
    shape: tuple
    dtype: str  # "float32", "int32" or "uint32" (stored as int32 bits)
    default: float = 0.0


BUILTIN_COMPONENTS: tuple[ComponentSpec, ...] = (
    ComponentSpec("position", (3,), "float32"),
    ComponentSpec("velocity", (3,), "float32"),
    ComponentSpec("acceleration", (3,), "float32"),
    ComponentSpec("orientation", (4,), "float32"),
    ComponentSpec("ang_vel", (3,), "float32"),
    ComponentSpec("ang_acc", (3,), "float32"),
    ComponentSpec("scale", (3,), "float32", 1.0),
    ComponentSpec("transform", (4, 4), "float32"),
    ComponentSpec("aabb_min", (3,), "float32"),
    ComponentSpec("aabb_max", (3,), "float32"),
    ComponentSpec("model_id", (), "int32", -1),
    ComponentSpec("type_id", (), "int32", -1),
    ComponentSpec("sortable", (), "int32", 0),
    ComponentSpec("flags", (), "uint32", 0),
    ComponentSpec("light_diffuse", (3,), "float32"),
    ComponentSpec("light_specular", (3,), "float32"),
    ComponentSpec("light_ambient", (3,), "float32"),
    ComponentSpec("light_atten", (2,), "float32"),
    ComponentSpec("light_cutoff", (2,), "float32"),
    ComponentSpec("light_direction", (3,), "float32"),
    ComponentSpec("light_radius", (), "float32"),
    ComponentSpec("light_fov", (), "float32"),
    ComponentSpec("parent", (), "int32", -1),
    ComponentSpec("ref_edges", (4,), "int32", -1),
)

FLAG_STATIC = 1 << 0
FLAG_COLLIDABLE = 1 << 1
FLAG_ALWAYS_LOGIC = 1 << 2
FLAG_OUT_OF_BOUNDS = 1 << 3
FLAG_HAS_MOVED = 1 << 4
FLAG_HAS_ROTATED = 1 << 5
FLAG_USER = 1 << 6
FLAG_DELETE_ON_OOB = 1 << 7
FLAG_TRANSPARENT = 1 << 8
FLAG_EMISSIVE = 1 << 9
FLAG_USER_ALWAYS_COLLIDES = 1 << 10

SORTABLE_DEFAULT = 0
SORTABLE_DIRECTIONAL = 1
SORTABLE_POINT = 2
SORTABLE_SPOT = 3

_TORCH_DTYPES = {"float32": torch.float32, "int32": torch.int32,
                 "uint32": torch.int32}


def torch_dtype(spec: ComponentSpec) -> torch.dtype:
    return _TORCH_DTYPES[spec.dtype]


def as_bits(value: int) -> int:
    """A uint32 bit pattern as the int32 value that stores it."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >= (1 << 31) else value


class ComponentRegistry:
    """Immutable component table, in declaration order."""

    def __init__(self, custom: tuple[ComponentSpec, ...] = ()):
        specs = BUILTIN_COMPONENTS + tuple(custom)
        if len(specs) > MAX_COMPONENTS:
            raise ValueError(
                f"{len(specs)} components exceeds the {MAX_COMPONENTS} budget")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate component names")
        self._specs = specs
        self._slot = {s.name: i for i, s in enumerate(specs)}

    @property
    def specs(self) -> tuple[ComponentSpec, ...]:
        return self._specs

    def slot(self, name: str) -> int:
        return self._slot[name]

    def bit(self, name: str) -> int:
        return 1 << self._slot[name]

    def bits(self, *names: str) -> int:
        out = 0
        for n in names:
            out |= self.bit(n)
        return out

    def __contains__(self, name: str) -> bool:
        return name in self._slot

    def __hash__(self):
        return hash(self._specs)

    def __eq__(self, other):
        return (isinstance(other, ComponentRegistry)
                and self._specs == other._specs)
