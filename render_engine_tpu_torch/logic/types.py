"""Entity types, logic callbacks and the per-frame input snapshot.

Port of ``render_engine_tpu/logic/types.py``. Callback signatures are the
JAX package's, over tensors:

  logic(world, dt, mask, cs) -> cs
  random_logic(world, dt, mask, rng, cs) -> cs   (rng: a threefry key,
                                                  see logic/random.py)
  collision(world, other_idx, mask, cs, other_type=None) -> cs
  user_input(world, camera, inputs, dt, cs) -> (cs, camera)

``InputState`` keeps the host-side numpy constructors and the replay
codecs (``serialize`` and the packed ``pack_with_dt`` wire); ``to_device``
turns one into the tensors the step reads.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

OOB_CLAMP = "clamp"
OOB_DELETE = "delete"
OOB_MARK = "mark"


@dataclasses.dataclass(frozen=True)
class EntityType:
    name: str
    index: int
    logic: Optional[Callable] = None
    random_logic: Optional[Callable] = None
    collision: Optional[Callable] = None
    random_collision: Optional[Callable] = None
    user_input: Optional[Callable] = None
    out_of_bounds: str = OOB_CLAMP
    out_of_bounds_logic: Optional[Callable] = None


KEY_W, KEY_A, KEY_S, KEY_D = 0, 1, 2, 3
KEY_SPACE, KEY_SHIFT = 4, 5
KEY_UP, KEY_DOWN, KEY_LEFT, KEY_RIGHT = 6, 7, 8, 9
KEY_ESC, KEY_INSERT = 10, 11
NUM_KEYS = 16
PACKED_INPUT_LEN = 2 * NUM_KEYS + 5


@dataclasses.dataclass(frozen=True)
class InputState:
    """One frame's input: keys bool[NUM_KEYS], mouse_delta (2,) f32 radians,
    rng_seed (uint32, the frame's threefry seed), prev_keys (engine-
    maintained). Host-built inputs hold numpy arrays; ``to_device`` gives
    the tensor form the step consumes (``rng_seed`` stays a Python int)."""

    keys: object
    mouse_delta: object
    rng_seed: int
    prev_keys: object = None

    def __post_init__(self):
        if self.prev_keys is None:
            object.__setattr__(self, "prev_keys", np.zeros(NUM_KEYS, bool))

    @staticmethod
    def idle(seed: int = 0) -> "InputState":
        return InputState(keys=np.zeros(NUM_KEYS, bool),
                          mouse_delta=np.zeros(2, np.float32),
                          rng_seed=int(np.uint32(seed)))

    def with_keys(self, *indices: int) -> "InputState":
        keys = np.array(self.keys)
        for i in indices:
            keys[i] = True
        return dataclasses.replace(self, keys=keys)

    def pressed(self, i: int):
        """Key ``i`` went down this frame."""
        return self.keys[i] & ~self.prev_keys[i]

    def released(self, i: int):
        return ~self.keys[i] & self.prev_keys[i]

    def held(self, i: int):
        """Key ``i`` is down this frame and was down the frame before."""
        return self.keys[i] & self.prev_keys[i]

    def with_prev(self, prev_keys) -> "InputState":
        return dataclasses.replace(self, prev_keys=prev_keys)

    def to_device(self, device) -> "InputState":
        return InputState(
            keys=torch.as_tensor(np.asarray(self.keys, bool), device=device),
            mouse_delta=torch.as_tensor(
                np.asarray(self.mouse_delta, np.float32), device=device),
            rng_seed=int(np.uint32(self.rng_seed)),
            prev_keys=torch.as_tensor(np.asarray(self.prev_keys, bool),
                                      device=device))

    def serialize(self) -> np.ndarray:
        """History-log row: keys | mouse | seed as a bit-exact uint32 view."""
        return np.concatenate([
            np.asarray(self.keys, np.float32),
            np.asarray(self.mouse_delta, np.float32),
            np.asarray([self.rng_seed], np.uint32).view(np.float32)])

    @staticmethod
    def deserialize(v) -> "InputState":
        v = np.asarray(v, np.float32)
        return InputState(
            keys=v[:NUM_KEYS] > 0.5,
            mouse_delta=v[NUM_KEYS:NUM_KEYS + 2],
            rng_seed=int(v[NUM_KEYS + 2:NUM_KEYS + 3].view(np.uint32)[0]))

    def pack_with_dt(self, dt) -> np.ndarray:
        """keys | prev_keys | mouse | seed lo/hi 16-bit halves | dt."""
        seed = int(np.uint32(self.rng_seed))
        out = np.empty(PACKED_INPUT_LEN, np.float32)
        k = NUM_KEYS
        out[0:k] = np.asarray(self.keys, np.float32)
        out[k:2 * k] = np.asarray(self.prev_keys, np.float32)
        out[2 * k:2 * k + 2] = np.asarray(self.mouse_delta, np.float32)
        out[2 * k + 2] = seed & 0xFFFF
        out[2 * k + 3] = seed >> 16
        out[2 * k + 4] = np.float32(dt)
        return out

    @staticmethod
    def unpack_with_dt(vec) -> tuple["InputState", np.float32]:
        """Inverse of ``pack_with_dt`` (host-side)."""
        v = np.asarray(vec, np.float32)
        k = NUM_KEYS
        seed = (int(v[2 * k + 3]) << 16) | int(v[2 * k + 2])
        return InputState(keys=v[0:k] > 0.5, mouse_delta=v[2 * k:2 * k + 2],
                          rng_seed=seed, prev_keys=v[k:2 * k] > 0.5), \
            np.float32(v[2 * k + 4])
