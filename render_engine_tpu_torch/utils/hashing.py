"""Bit-exact world hashing for determinism checks.

Port of ``render_engine_tpu/utils/hashing.py``: SHA-256 over the bytes the
JAX package hashes, in its order, so that a world hashes the same in both
packages. The JAX package walks the World pytree: ``.alive``, then
``.comp_mask``, then ``.comps['<name>']`` with the names sorted; each leaf
adds its key string, its numpy ``dtype.str``, ``str(shape)`` and its raw
bytes. The port's int32 bit-set columns are hashed as the JAX package's
uint32 (``ecs.world.snapshot``).
"""

from __future__ import annotations

import hashlib

from render_engine_tpu_torch.ecs import world as W


def world_hash(world) -> str:
    """SHA-256 hex digest of the world's columns (one read-back from the
    world's device)."""
    snap = W.snapshot(world)
    leaves = [(".alive", snap["alive"]), (".comp_mask", snap["comp_mask"])]
    leaves += [(f".comps[{name!r}]", snap["comps"][name])
               for name in sorted(snap["comps"])]
    h = hashlib.sha256()
    for key, arr in leaves:
        h.update(key.encode())
        h.update(arr.dtype.str.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()
