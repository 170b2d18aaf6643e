"""Playback: deterministic replay with the five-mode state machine.

Port of ``render_engine_tpu/runtime/replay.py``:

  * RUN                   -- live simulation
  * DEBUG                 -- replaying the recording frame by frame
  * DEBUG_CUSTOM_MOVEMENT -- replay goes on with the camera detached and
                             free to fly (Esc detaches, Insert reattaches)
  * ONE_PAST_LAST_FRAME   -- the recording's end; Up simulates one live
                             frame
  * ONE_PAST_LAST_PAUSE   -- paused past the end; Right resumes RUN

Replay runs the step again on the recorded inputs, from the recorded
baseline; the detached camera renders the replayed states from elsewhere
and never feeds the step, so the replayed world is the recorded one.

The determinism contract: on one card, with
``torch.use_deterministic_algorithms`` off (the normal path), a replayed
frame's world, and the shadow state its frames leave, equal the live
frame's to the bit. A replayed frame runs the Engine's captured programs
that advanced it live (the recorded advance flag), over the same packed
inputs, and nothing on that path depends on the order in which the device
runs its threads: no float atomic, no write of two values to one place
that both survive.

What a detached frame runs, each frame, rendering once: the recorded frame
through ``Engine.frame`` without ``render`` (a recorded step frame: the
``("step",)`` program; a recorded fused frame: the ``("frame", decision)``
program it ran live, whose image is not copied), then for a step frame
``Engine.update_shadows`` (the shadow update the live render would have
made: ``("shadows", "map")`` on a map decision, nothing on a skip), then
``Engine.render_only`` through the detached camera (the ``("render",
camera configuration, False)`` program over the maps just updated), whose
clone is the frame's image. The update reads the stepped world and the
recorded camera, as the recorded camera's render would have, so the world
and the shadow state are the live run's to the bit; the recorded camera's
image is never made. The detached camera's flight (a few small eager
kernels) is queued behind the frame's programs.

Tracing (``Engine.set_tracing``): each ``step`` is a call ``player.step``
on the Engine's tracer, with host spans ``player.controls`` (the mode
keys), ``player.history`` (the recorded frame decoded and its events
applied) and ``player.camera`` (the detached camera's flight); the
Engine's calls inside it are calls within it. Counters: ``replayed_frames``,
``detached_renders``, ``single_render_frames`` (replayed frames that ran
no render from the recorded camera) and ``live_frames`` (frames run past
the recording's end).
"""

from __future__ import annotations

import contextlib
import enum

import torch

from render_engine_tpu_torch.logic.types import (KEY_A, KEY_D, KEY_ESC,
                                                 KEY_INSERT, KEY_RIGHT, KEY_S,
                                                 KEY_SHIFT, KEY_SPACE, KEY_UP,
                                                 KEY_W, InputState)
from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.runtime.history import HistoryLog
from render_engine_tpu_torch.utils.consts import const
from render_engine_tpu_torch.utils.hashing import world_hash

FLY_ACCEL = 60.0  # detached-camera flight acceleration, units/s^2
# the counters a traced Player keeps on the Engine's tracer
COUNTERS = ("replayed_frames", "detached_renders", "single_render_frames",
            "live_frames")
_OFF = contextlib.nullcontext()


def _flight_accel(camera, keys) -> torch.Tensor:
    """WASD + Space/Shift acceleration in the camera's frame, on the
    camera's device, with no upload; ``keys`` is the host-side bool
    vector."""
    fwd = camera.direction()
    world_up = const((0.0, 1.0, 0.0), device=fwd.device)
    right = T.cross(fwd, world_up)
    right = right / torch.linalg.vector_norm(right).clamp(min=1e-6)
    a = torch.zeros(3, dtype=torch.float32, device=fwd.device)
    for key, sign, axis in ((KEY_W, 1, fwd), (KEY_S, -1, fwd),
                            (KEY_D, 1, right), (KEY_A, -1, right),
                            (KEY_SPACE, 1, world_up),
                            (KEY_SHIFT, -1, world_up)):
        if bool(keys[key]):
            a = a + axis if sign > 0 else a - axis
    return a * FLY_ACCEL


class PlaybackMode(enum.Enum):
    RUN = "run"
    DEBUG = "debug"
    DEBUG_CUSTOM_MOVEMENT = "debug_custom_movement"
    ONE_PAST_LAST_FRAME = "one_past_last_frame"
    ONE_PAST_LAST_PAUSE = "one_past_last_pause"


class Player:
    """Drives an Engine from a HistoryLog with the five-mode state
    machine."""

    def __init__(self, engine, history: HistoryLog):
        self.engine = engine
        self.history = history
        self.mode = PlaybackMode.DEBUG
        self.cursor = 0  # next recorded frame to apply
        self.detached_camera = None
        # the baseline was taken after the transform refresh: used as it
        # is, since deriving anything again could round differently
        engine.world = history.restore_world(engine.world_config,
                                             engine.device)
        engine.camera = history.restore_camera(engine.camera)

    # -- state machine -------------------------------------------------------
    def handle_controls(self, controls: InputState):
        """Mode changes from the playback keys."""
        k = controls.keys
        if self.mode in (PlaybackMode.DEBUG,
                         PlaybackMode.DEBUG_CUSTOM_MOVEMENT):
            if bool(k[KEY_ESC]):
                self.mode = PlaybackMode.DEBUG_CUSTOM_MOVEMENT
                if self.detached_camera is None:
                    self.detached_camera = self.engine.camera
            elif bool(k[KEY_INSERT]):
                self.mode = PlaybackMode.DEBUG
                self.detached_camera = None
        if self.mode == PlaybackMode.ONE_PAST_LAST_PAUSE and bool(
                k[KEY_RIGHT]):
            self.mode = PlaybackMode.RUN

    # -- stepping ------------------------------------------------------------
    def step(self, controls: InputState | None = None, render: bool = True):
        """Advance one playback frame. Returns (image or None, at_end)."""
        tr = self.engine.tracer
        if tr is None:
            return self._step(None, controls, render)
        for name in COUNTERS:
            tr.tally(name, 0)  # each reads 0 until it counts
        with tr.call("player.step"):
            return self._step(tr, controls, render)

    def _step(self, tr, controls, render):
        if controls is not None:
            with tr.host("player.controls") if tr else _OFF:
                self.handle_controls(controls)
        eng = self.engine

        if self.mode in (PlaybackMode.DEBUG,
                         PlaybackMode.DEBUG_CUSTOM_MOVEMENT):
            if self.cursor >= self.history.num_frames:
                self.mode = PlaybackMode.ONE_PAST_LAST_FRAME
                return None, True
            with tr.host("player.history") if tr else _OFF:
                # recorded config changes apply before the frame they
                # preceded
                event = self.history.events.get(self.cursor)
                if event:
                    eng.apply_config_event(event)
                inputs, dt = self.history.frame(self.cursor)
                # the recorded advance flag, verbatim: it decides the
                # shadow update, so shadow maps and images follow the live
                # run
                adv = "fused" if self.history.advance_fused(self.cursor) \
                    else "step"
                self.cursor += 1
            detached = self.mode == PlaybackMode.DEBUG_CUSTOM_MOVEMENT
            view = detached and render and self.detached_camera is not None
            # a detached view shows only the detached camera's image: the
            # recorded frame runs without its render, and a step frame
            # then takes the shadow update that render would have made
            img = eng.frame(inputs, dt, render=render and not view,
                            advance=adv)
            if view and adv == "step":
                eng.update_shadows()
                if tr:
                    tr.tally("single_render_frames")
            if tr:
                tr.tally("replayed_frames")
            if detached and controls is not None:
                # mouse look and WASD flight, queued behind the frame (the
                # recorded camera drives the step, and the flight reads
                # nothing the frame writes)
                with tr.host("player.camera") if tr else _OFF:
                    cam = self.detached_camera.rotated(
                        float(controls.mouse_delta[0]),
                        float(controls.mouse_delta[1]))
                    self.detached_camera = cam.float_position(
                        _flight_accel(cam, controls.keys), dt)
            if view:
                img = eng.render_only(self.detached_camera)
                if tr:
                    tr.tally("detached_renders")
            return img, self.cursor >= self.history.num_frames

        if self.mode == PlaybackMode.ONE_PAST_LAST_FRAME:
            # Up: simulate one live frame, then pause
            if controls is not None and bool(controls.keys[KEY_UP]):
                img = eng.frame(InputState.idle(seed=eng.frame_index),
                                render=render)
                if tr:
                    tr.tally("live_frames")
                self.mode = PlaybackMode.ONE_PAST_LAST_PAUSE
                return img, True
            return None, True

        if self.mode == PlaybackMode.ONE_PAST_LAST_PAUSE:
            return None, True

        # RUN: live simulation past the recording
        img = eng.frame(controls or InputState.idle(seed=eng.frame_index),
                        render=render)
        if tr:
            tr.tally("live_frames")
        return img, True

    # -- verification ---------------------------------------------------------
    def replay_all(self, render: bool = False) -> list[str]:
        """Replay the rest of the recording; the world hash of every
        frame."""
        hashes = []
        while self.cursor < self.history.num_frames:
            self.step(render=render)
            hashes.append(world_hash(self.engine.world))
        return hashes
