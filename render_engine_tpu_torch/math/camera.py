"""Camera: dynamic state as tensors, static configuration as floats.

Port of ``render_engine_tpu/math/camera.py``. ``position``, ``yaw``,
``pitch`` and ``velocity`` are float32 tensors on the engine's device (the
per-frame state); the projection parameters and the inertial
``movement_factor`` are plain floats. The exact 8-float ``serialize`` /
``apply_serialized`` codec is kept: it is the camera's whole dynamic state,
bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from render_engine_tpu_torch.math import transforms as T

PERSPECTIVE = 0
ORTHOGRAPHIC = 1


@dataclasses.dataclass(frozen=True)
class Camera:
    position: torch.Tensor  # (3,)
    yaw: torch.Tensor  # () radians
    pitch: torch.Tensor  # () radians
    velocity: torch.Tensor  # (3,)
    fov_y: float = 0.7853982
    aspect: float = 16.0 / 9.0
    near: float = 0.1
    far: float = 1000.0
    draw_distance: float = 1000.0
    projection_kind: int = PERSPECTIVE
    ortho_half_extent: float = 100.0
    movement_factor: float = 0.9  # inertial decay per step

    @property
    def device(self) -> torch.device:
        return self.position.device

    def direction(self) -> torch.Tensor:
        return T.direction_from_yaw_pitch(self.yaw, self.pitch)

    def view_matrix(self) -> torch.Tensor:
        up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32,
                          device=self.device)
        return T.look_at(self.position, self.position + self.direction(), up)

    def projection_matrix(self) -> torch.Tensor:
        if self.projection_kind == ORTHOGRAPHIC:
            h = self.ortho_half_extent
            return T.orthographic(-h, h, -h / self.aspect, h / self.aspect,
                                  self.near, self.far).to(self.device)
        return T.perspective(self.fov_y, self.aspect, self.near, self.far,
                             device=self.device)

    def proj_view(self) -> torch.Tensor:
        return T.mm44(self.projection_matrix(), self.view_matrix())

    def frustum_planes(self) -> torch.Tensor:
        return T.frustum_planes(self.proj_view())

    def rotated(self, d_yaw, d_pitch) -> "Camera":
        """Mouse-look with pitch clamped to +/- 89 degrees."""
        limit = float(torch.tensor(89.0 * math.pi / 180.0,
                                   dtype=torch.float32))
        return dataclasses.replace(
            self, yaw=self.yaw + d_yaw,
            pitch=torch.clamp(self.pitch + d_pitch, -limit, limit))

    def float_position(self, accel, dt) -> "Camera":
        """Inertial movement: the velocity integrates ``accel`` and decays
        by ``movement_factor``, then moves the position, in float32 in the
        JAX package's order."""
        dt = float(np.float32(dt))
        vel = (self.velocity + accel * dt) * float(
            np.float32(self.movement_factor))
        return dataclasses.replace(self, velocity=vel,
                                   position=self.position + vel * dt)

    def force_hard_position(self, position) -> "Camera":
        """Snap to ``position`` and zero the inertia."""
        return dataclasses.replace(
            self, position=torch.as_tensor(position, dtype=torch.float32,
                                           device=self.device).clone(),
            velocity=torch.zeros_like(self.velocity))

    def serialize(self) -> torch.Tensor:
        """Dynamic state as one (8,) float32 vector."""
        return torch.cat([self.position, self.yaw[None], self.pitch[None],
                          self.velocity]).to(torch.float32)

    def apply_serialized(self, data: torch.Tensor) -> "Camera":
        return dataclasses.replace(self, position=data[0:3], yaw=data[3],
                                   pitch=data[4], velocity=data[5:8])

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, position=self.position.to(device), yaw=self.yaw.to(device),
            pitch=self.pitch.to(device), velocity=self.velocity.to(device))


class CameraBuilder:
    """Host-side builder (same chain as the JAX package's)."""

    def __init__(self):
        self._kw = {}
        self._position = (0.0, 0.0, 0.0)
        self._yaw = -90.0
        self._pitch = 0.0

    def with_position(self, x, y, z):
        self._position = (x, y, z)
        return self

    def with_yaw_pitch_degrees(self, yaw, pitch):
        self._yaw, self._pitch = yaw, pitch
        return self

    def with_fov_degrees(self, fov):
        self._kw["fov_y"] = float(fov) * 3.14159265358979 / 180.0
        return self

    def with_aspect(self, aspect):
        self._kw["aspect"] = float(aspect)
        return self

    def with_near_far(self, near, far):
        self._kw["near"], self._kw["far"] = float(near), float(far)
        return self

    def with_draw_distance(self, d):
        self._kw["draw_distance"] = float(d)
        return self

    def with_orthographic(self, half_extent):
        self._kw["projection_kind"] = ORTHOGRAPHIC
        self._kw["ortho_half_extent"] = float(half_extent)
        return self

    def with_movement_factor(self, f):
        self._kw["movement_factor"] = float(f)
        return self

    def build(self, device="cpu") -> Camera:
        to_rad = 3.14159265358979 / 180.0

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        return Camera(position=f32(self._position),
                      yaw=f32(self._yaw * to_rad),
                      pitch=f32(self._pitch * to_rad),
                      velocity=torch.zeros(3, dtype=torch.float32,
                                           device=device),
                      **self._kw)
