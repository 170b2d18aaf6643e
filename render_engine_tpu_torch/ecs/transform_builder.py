"""EntityTransformBuilder: serializable entity-spawn specifications.

Port of ``render_engine_tpu/ecs/transform_builder.py`` (host-side numpy; the
port keeps its own copy). A declarative spec of translation / velocity /
acceleration / rotation (with its velocity and acceleration) / scale plus
static / collision / light flags, flattened by ``spawn_kwargs`` to the plain
numpy component values that both ``ecs.world.spawn_host`` and
``ecs.changes.queue_spawn`` take; ``serialize`` gives a plain dict, so a
spec can ride a history log.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from render_engine_tpu_torch.ecs import registry as R


@dataclasses.dataclass
class EntityTransformBuilder:
    translation: tuple = (0.0, 0.0, 0.0)
    velocity: tuple | None = None
    acceleration: tuple | None = None
    rotation_axis: tuple | None = None  # axis-angle
    rotation_angle: float = 0.0
    rotation_velocity: tuple | None = None  # rotvec rate (axis * rad/s)
    rotation_acceleration: tuple | None = None
    scale: tuple = (1.0, 1.0, 1.0)
    is_static: bool = False
    causes_collisions: bool = False
    always_execute_logic: bool = False
    transparent: bool = False
    light_type: int | None = None  # R.SORTABLE_{DIRECTIONAL,POINT,SPOT}

    # ----------------------------------------------------------------- chain
    def with_translation(self, x, y, z):
        self.translation = (x, y, z)
        return self

    def with_velocity(self, x, y, z):
        self.velocity = (x, y, z)
        return self

    def with_acceleration(self, x, y, z):
        self.acceleration = (x, y, z)
        return self

    def with_rotation(self, axis, angle):
        self.rotation_axis, self.rotation_angle = tuple(axis), float(angle)
        return self

    def with_rotation_velocity(self, rotvec):
        self.rotation_velocity = tuple(rotvec)
        return self

    def with_scale(self, x, y=None, z=None):
        self.scale = (x, y if y is not None else x, z if z is not None else x)
        return self

    def static(self, yes=True):
        self.is_static = yes
        return self

    def collidable(self, yes=True):
        self.causes_collisions = yes
        return self

    def always_logic(self, yes=True):
        self.always_execute_logic = yes
        return self

    def as_light(self, sortable_index: int):
        self.light_type = int(sortable_index)
        return self

    # -------------------------------------------------------------- applies
    def spawn_kwargs(self, count: int = 1, model_id: int | None = None,
                     type_id: int | None = None, **extra) -> dict:
        """Flatten to component kwargs for spawn_host / queue_spawn. The
        spec broadcasts over ``count`` instances; ``extra`` adds custom
        components."""
        import torch

        from render_engine_tpu_torch.math import transforms as T

        kw: dict = {}

        def rep(v, width):
            return np.broadcast_to(
                np.asarray(v, np.float32), (count, width)
            ).copy()

        kw["position"] = rep(self.translation, 3)
        if self.velocity is not None:
            kw["velocity"] = rep(self.velocity, 3)
        if self.acceleration is not None:
            kw["acceleration"] = rep(self.acceleration, 3)
        if self.rotation_axis is not None:
            q = T.quat_from_axis_angle(
                torch.tensor(self.rotation_axis, dtype=torch.float32),
                torch.tensor(self.rotation_angle, dtype=torch.float32),
            ).numpy()
            kw["orientation"] = np.broadcast_to(q, (count, 4)).copy()
        if self.rotation_velocity is not None:
            kw["ang_vel"] = rep(self.rotation_velocity, 3)
        if self.rotation_acceleration is not None:
            kw["ang_acc"] = rep(self.rotation_acceleration, 3)
        kw["scale"] = rep(self.scale, 3)

        flags = 0
        if self.is_static:
            flags |= int(R.FLAG_STATIC)
        if self.causes_collisions:
            flags |= int(R.FLAG_COLLIDABLE)
        if self.always_execute_logic:
            flags |= int(R.FLAG_ALWAYS_LOGIC)
        if self.transparent:
            flags |= int(R.FLAG_TRANSPARENT)
        if flags:
            kw["flags"] = np.full(count, flags, np.uint32)
        if self.light_type is not None:
            kw["sortable"] = np.full(count, self.light_type, np.int32)
        if model_id is not None:
            kw["model_id"] = np.full(count, model_id, np.int32)
        if type_id is not None:
            kw["type_id"] = np.full(count, type_id, np.int32)
        kw.update(extra)
        return kw

    # ---------------------------------------------------------- serialization
    def serialize(self) -> dict:
        """Plain-dict form, for embedding in logs."""
        return dataclasses.asdict(self)

    @staticmethod
    def deserialize(d: dict) -> "EntityTransformBuilder":
        return EntityTransformBuilder(**d)
