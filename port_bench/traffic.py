"""The one generator of frame inputs, driven by a traffic file.

A traffic file holds ``keys`` (the key indices held every frame),
``mouse_delta``, ``dt`` (seconds a frame) and ``render`` (whether a frame
renders). Frame ``i`` of a run with seed ``s`` gets those inputs and the
threefry seed ``splitmix64(s * 2**32 + i)`` mod 2**32, so the same seed
gives the same frames, and the work of a frame does not depend on how many
frames a faster program reaches."""

from __future__ import annotations

import dataclasses

import numpy as np

NUM_KEYS = 16  # the engine's key table

_MASK = (1 << 64) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


@dataclasses.dataclass(frozen=True)
class Frame:
    keys: np.ndarray  # bool (NUM_KEYS,)
    mouse_delta: np.ndarray  # float32 (2,)
    rng_seed: int
    dt: float
    render: bool


class Traffic:
    def __init__(self, spec: dict, seed: int):
        self.spec, self.seed = spec, int(seed)
        keys = np.zeros(NUM_KEYS, bool)
        keys[list(spec.get("keys", []))] = True
        self._keys = keys
        self._mouse = np.asarray(spec.get("mouse_delta", (0.0, 0.0)),
                                 np.float32)

    @property
    def renders(self) -> bool:
        return bool(self.spec["render"])

    def frame(self, i: int) -> Frame:
        rng_seed = splitmix64(((self.seed & _MASK) << 32 | i) & _MASK)
        return Frame(keys=self._keys.copy(), mouse_delta=self._mouse.copy(),
                     rng_seed=rng_seed & 0xFFFFFFFF,
                     dt=float(self.spec["dt"]), render=self.renders)

    def prev_keys(self, i: int) -> np.ndarray:
        """The keys of frame ``i - 1`` (none before frame 0), which the
        engine hands the step as ``prev_keys``."""
        return (self.frame(i - 1).keys if i > 0
                else np.zeros(NUM_KEYS, bool))
