"""Supervision: history flushed on any exit, a heartbeat, a NaN check.

Port of ``render_engine_tpu/runtime/supervisor.py``. A context manager
around the frame loop that (a) flushes the history log on any exit,
graceful or by an exception, which it never swallows, so the frame that
failed is in the log and replays; (b) counts a heartbeat another thread can
poll; (c) optionally checks the live rows of every float column for NaN
and Inf, so corrupted state is caught at the frame that made it.
"""

from __future__ import annotations

import time
import traceback

import torch


class Supervisor:
    def __init__(self, engine, nan_check_every: int = 0):
        self.engine = engine
        self.nan_check_every = nan_check_every
        self.heartbeat = 0  # frames completed
        self.failed = False
        self.failure_info: str | None = None
        self._t_last = time.monotonic()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.failed = True
            self.failure_info = "".join(
                traceback.format_exception(exc_type, exc, tb))
        path = self.engine.flush_history()
        if self.failed and path:
            print(f"[supervisor] failure captured; history flushed to {path}")
        return False  # never swallow the exception

    def tick(self, inputs=None, dt: float = 1.0 / 60.0, render: bool = True):
        """Run one supervised frame."""
        img = self.engine.frame(inputs, dt, render=render)
        self.heartbeat += 1
        self._t_last = time.monotonic()
        if self.nan_check_every and self.heartbeat % self.nan_check_every == 0:
            self.check_state_health()
        return img

    def check_state_health(self):
        """Raise FloatingPointError if a float column holds NaN or Inf in a
        live row. One read-back from the world's device."""
        world = self.engine.world
        dead = ~world.alive
        floats = [(n, a) for n, a in world.comps.items()
                  if a.is_floating_point()]
        finite = torch.stack([
            (torch.isfinite(a).reshape(a.shape[0], -1).all(1) | dead).all()
            for _, a in floats]).tolist()
        for (name, _), ok in zip(floats, finite):
            if not ok:
                self.failed = True
                self.failure_info = f"non-finite values in {name!r}"
                raise FloatingPointError(
                    f"[supervisor] NaN/Inf detected in component {name!r} "
                    f"at frame {self.engine.frame_index}")

    def seconds_since_heartbeat(self) -> float:
        return time.monotonic() - self._t_last
