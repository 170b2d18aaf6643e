"""The reference of the ``space`` program (``programs/space.py``): the demo
scene. ``Reference`` builds the scene from the seed with ``demo``, then
computes frames with ``step`` and ``render``: from its own state, or from
a state loaded from a record. ``Control`` is the same computed one
precision below the configurations' (see ``precision``). Nothing here
imports the port."""

from __future__ import annotations

import torch

from port_bench.reference import demo, render, step
from port_bench.reference.precision import TF32


class Reference:
    """The reference of a configuration, its scene built from ``seed`` on
    ``device``; ``overrides`` changes ``space_config`` arguments (the
    tests' small sizes)."""

    def __init__(self, cfg: dict, seed: int, device, overrides=None):
        with self.mode():
            self.sc = demo.build(cfg, seed, device, overrides)
            w = self.sc.world
            step.refresh_bounds(w, self.sc.bank, w["alive"].clone())
        self.world, self.camv = w, self.sc.camv.clone()
        self.shadow = (render.new_shadows(self.sc)
                       if self.sc.settings.shadows else None)

    @staticmethod
    def mode():
        import contextlib

        return contextlib.nullcontext()

    def state(self) -> dict:
        sh = None if self.shadow is None else {
            k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in self.shadow.items()}
        return {"world": {k: v.clone() for k, v in self.world.items()},
                "camv": self.camv.clone(), "shadow": sh}

    def load(self, state: dict):
        """Make ``state`` (a record of the program's) the current state."""
        dev = self.camv.device
        self.world = {k: v.to(dev).clone() for k, v in state["world"].items()}
        self.camv = state["camv"].to(dev).clone()
        sh = state["shadow"]
        if sh is not None:
            self.shadow = {k: (v.to(dev).clone() if torch.is_tensor(v) else v)
                           for k, v in sh.items()}
            for k in ("slot_entity", "slot_face"):
                self.shadow[k] = self.shadow[k].to(torch.int64)

    def frame(self, fr, render_image: bool = True):
        """One traffic frame from the current state: the step, and where
        the frame renders the shadow-map update and (``render_image``) the
        image. Returns the image or None."""
        with self.mode():
            self.world, self.camv = step.step(self.world, self.camv, self.sc,
                                              fr)
            if not fr.render:
                return None
            if self.shadow is not None:
                self.shadow = render.update_shadows(self.shadow, self.world,
                                                    self.sc, self.camv[0:3])
            if not render_image:
                return None
            return render.frame_image(self.world, self.camv, self.shadow,
                                      self.sc)


class Control(Reference):
    """The reference with every float32 matrix product's operands rounded
    to TF32: the step the configurations' precision (float32, TF32 off)
    would tempt a later change to take."""

    @staticmethod
    def mode():
        return TF32()
