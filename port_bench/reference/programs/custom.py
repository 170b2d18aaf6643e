"""The reference of the ``custom`` program (``programs/custom.py``): the
demo scene with the user's render systems. The scene, the step and the
shadow maps are the ``space`` program's reference; the image is
``reference/custom.py``'s, with the material's four uniforms read from
the configuration file. ``Control`` is the same computed one precision
below the configuration's. Nothing here imports the port."""

from __future__ import annotations

from port_bench.reference import custom, render, step
from port_bench.reference.precision import TF32
from port_bench.reference.programs import space


class Reference(space.Reference):
    """The reference of a configuration, its scene built from ``seed`` on
    ``device``; ``overrides`` changes ``space_config`` arguments (the
    tests' small sizes). ``last`` holds the last rendered frame's layers
    (``custom.frame``)."""

    def __init__(self, cfg: dict, seed: int, device, overrides=None):
        super().__init__(cfg, seed, device, overrides)
        self.material = {k: cfg["material"][k] for k in custom.MATERIAL_KEYS}
        self.last = None

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
            self.last = custom.frame(self.world, self.camv, self.shadow,
                                     self.sc, self.material)
            return self.last["image"]


class Control(Reference):
    """The reference with every float32 matrix product's operands rounded
    to TF32: the step the configuration's precision (float32, TF32 off)
    would tempt a later change to take."""

    @staticmethod
    def mode():
        return TF32()
