"""The reference of the ``lights`` program (``programs/lights.py``): the
demo scene with the many-lights rig. The scene is ``demo``'s with the
configuration's ``scene``, the rig spawned after it (``lights.rig``); the
step and the shadow maps are the ``space`` program's reference (a point
light that takes a shadow slot raises, as the demo's lights are spot
lights); the image is ``lights.frame_image``, every live light of the
table at every covered pixel, with no per-tile light list. ``Control``
is the same computed one precision below the configuration's. Nothing
here imports the port."""

from __future__ import annotations

from port_bench.reference import demo, lights, render, step
from port_bench.reference.precision import TF32
from port_bench.reference.programs import space


class Reference(space.Reference):
    """The reference of a configuration, its scene and rig built from
    ``seed`` on ``device`` (the rig from the configuration's own seed);
    ``overrides`` changes ``space_config`` arguments and ``n_lights`` (the
    tests' small sizes)."""

    def __init__(self, cfg: dict, seed: int, device, overrides=None):
        with self.mode():
            self.sc = demo.build(cfg, seed, device, overrides)
            w = self.sc.world
            lights.spawn(w, lights.rig(cfg["lights"], overrides))
            step.refresh_bounds(w, self.sc.bank, w["alive"].clone())
        self.world, self.camv = w, self.sc.camv.clone()
        self.shadow = (render.new_shadows(self.sc)
                       if self.sc.settings.shadows else None)
        self.budget = lights.budgets(cfg["lights"], overrides)

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
            return lights.frame_image(self.world, self.camv, self.shadow,
                                      self.sc, self.budget)


class Control(Reference):
    """The reference with every float32 matrix product's operands rounded
    to TF32: the step the configuration's precision (float32, TF32 off)
    would tempt a later change to take."""

    @staticmethod
    def mode():
        return TF32()
