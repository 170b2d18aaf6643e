"""The reference of the ``playback`` program (``programs/playback.py``): a
recorded session replayed with a detached camera.

The scene is the ``space`` program's reference, built from the seed. The
recorded session is the configuration's ``recording``: its frames are the
recording traffic's frames 0 to ``recording.frames - 1`` under the seed,
so a replayed frame steps the world, and where the run's frame renders
updates the shadow maps, exactly as the ``space`` reference steps that
traffic frame, through the recorded camera. Only the image differs: it is
drawn through the detached camera, which starts at the baseline camera
(Esc before the first frame) and flies on each frame's controls, before
the step, at the recorded frame's ``dt``, by the specification's flight
(``fly``). Past the recording's end the frames run live as the
specification's Player runs them: the frame at the end is Up's idle frame,
seeded with its index; later frames take the run's inputs; both at the
engine's default ``dt`` and drawn through the recorded camera, which the
detached camera no longer replaces.

The state the check reads holds two entries more in its ``world``:
``playback.frame``, the index of the next frame, and
``playback.detached_camv``, the detached camera's vector. ``Control`` is
the same one precision below the configuration's. Nothing here imports
the port."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench import manifest
from port_bench.reference import frames, render, step
from port_bench.reference import xform as X
from port_bench.reference.precision import TF32
from port_bench.reference.programs import space
from port_bench.traffic import NUM_KEYS, Traffic

FLY_ACCEL = 60.0  # the detached camera's acceleration, units/s^2
MOVEMENT_FACTOR = 0.9  # the camera's inertial decay a frame
LIVE_DT = 1.0 / 60.0  # a live frame's dt past the end (the engine's default)
KEY_W, KEY_A, KEY_S, KEY_D, KEY_SPACE, KEY_SHIFT = range(6)
FRAME, DETACHED = "playback.frame", "playback.detached_camv"


def fly(camv: torch.Tensor, keys, mouse_delta, dt: float) -> torch.Tensor:
    """The detached camera vector after one frame of its flight: mouse
    look (yaw, pitch clamped to +/- 89 degrees), then WASD and Space/Shift
    along the camera's forward, right and world-up axes as acceleration,
    integrated into the velocity, which decays by the movement factor and
    moves the position."""
    dev = camv.device
    c = camv.clone()
    limit = torch.tensor(89.0 * 3.141592653589793 / 180.0,
                         dtype=torch.float32, device=dev)
    mouse = torch.as_tensor(mouse_delta, dtype=torch.float32).to(dev)
    c[3] = c[3] + mouse[0]
    c[4] = torch.clamp(c[4] + mouse[1], -limit, limit)
    k = torch.as_tensor(np.asarray(keys, np.float32), device=dev)
    fwd = X.direction(c[3], c[4])
    up = torch.tensor([0.0, 1.0, 0.0], device=dev)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right).clamp(min=1e-6)
    accel = (fwd * (k[KEY_W] - k[KEY_S]) + right * (k[KEY_D] - k[KEY_A])
             + up * (k[KEY_SPACE] - k[KEY_SHIFT])) * FLY_ACCEL
    dt = torch.tensor(dt, dtype=torch.float32, device=dev)
    vel = (c[5:8] + accel * dt) * torch.tensor(MOVEMENT_FACTOR,
                                              dtype=torch.float32)
    c[5:8] = vel
    c[0:3] = c[0:3] + vel * dt
    return c


class Reference(space.Reference):
    """The reference of a playback configuration, its scene built from
    ``seed`` on ``device``; ``overrides`` changes ``space_config``
    arguments (the tests' small sizes). ``i`` is the index of the next
    frame."""

    def __init__(self, cfg: dict, seed: int, device, overrides=None):
        super().__init__(cfg, seed, device, overrides)
        rec = cfg["recording"]
        self.recorded = int(rec["frames"])
        self.recording = Traffic(manifest.traffic(rec["traffic"]), seed)
        self.i = 0
        self.detached = self.camv.clone()

    def state(self) -> dict:
        s = super().state()
        s["world"][FRAME] = torch.tensor(self.i, dtype=torch.int64)
        s["world"][DETACHED] = self.detached.clone()
        return s

    def load(self, state: dict):
        world = dict(state["world"])
        self.i = int(world.pop(FRAME))
        self.detached = world.pop(DETACHED).to(self.camv.device).clone()
        super().load(dict(state, world=world))

    def frame(self, fr, render_image: bool = True):
        """The run's next frame, ``fr`` its traffic frame (the controls of
        a replayed frame): the step, and where ``fr`` renders the
        shadow-map update and (``render_image``) the image. Returns the
        image or None."""
        i = self.i
        self.i += 1
        if i < self.recorded:
            inputs = self.recording.frame(i)
            dt = float(np.float32(inputs.dt))
            with self.mode():
                self.detached = fly(self.detached, fr.keys, fr.mouse_delta,
                                    dt)
            view = self.detached
        else:
            inputs = fr if i > self.recorded else dataclasses.replace(
                fr, keys=np.zeros(NUM_KEYS, bool),
                mouse_delta=np.zeros(2, np.float32), rng_seed=i & 0xFFFFFFFF)
            inputs = dataclasses.replace(inputs, dt=LIVE_DT)
            view = None
        with self.mode():
            self.world, self.camv = step.step(self.world, self.camv, self.sc,
                                              inputs)
            if not fr.render:
                return None
            if self.shadow is not None:
                self.shadow = render.update_shadows(self.shadow, self.world,
                                                    self.sc, self.camv[0:3])
            if not render_image:
                return None
            return render.frame_image(self.world, self.camv if view is None
                                      else view, self.shadow, self.sc)


class Control(Reference):
    """The reference with every float32 matrix product's operands rounded
    to TF32: the step the configuration's precision (float32, TF32 off)
    would tempt a later change to take."""

    @staticmethod
    def mode():
        return TF32()


def state_of(prog) -> dict:
    """The program's state as ``reference/frames.py`` reads it, with its
    frame index and its detached camera vector in the ``world``."""
    s = frames.state_of(prog)
    s["world"][FRAME] = torch.tensor(int(prog.frame_index),
                                     dtype=torch.int64)
    s["world"][DETACHED] = prog.detached_camera.serialize().clone()
    return s
