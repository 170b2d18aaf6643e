"""Device constants that a captured frame program may read.

A CUDA graph keeps the raw device addresses of the tensors it reads, so a
constant that the frame builds once and caches must outlive every graph
that reads it, and must not be uploaded again inside a captured region
(a pageable host-to-device copy cannot be captured). Two helpers:

* ``const(values, dtype, device)``: a small table, uploaded on first use
  and kept for the process's lifetime;
* ``cached(maxsize)``: ``functools.lru_cache`` whose results are also
  handed to every list opened with ``holding``. The Engine opens one while
  it captures a program and keeps the list with the program, so an entry
  the cache evicts stays alive as long as a graph reads it.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

_CONSTS: dict = {}
_HOLDERS: list[list] = []


def _held(value):
    for holder in _HOLDERS:
        holder.append(value)
    return value


@contextlib.contextmanager
def holding(into: list):
    """Append every constant that ``const`` or a ``cached`` function
    returns inside the block to ``into``."""
    _HOLDERS.append(into)
    try:
        yield into
    finally:
        _HOLDERS.remove(into)


def const(values, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``torch.tensor(values, dtype=, device=)``, built once per (values,
    dtype, device); ``values`` is a number or nested tuples of numbers."""
    key = (values, dtype, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return _held(t)


def _hashable(value):
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, (list, tuple)):
        return tuple(_hashable(v) for v in value)
    return value.item() if isinstance(value, np.generic) else value


def on_device(value, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``torch.as_tensor(value, dtype=, device=)`` that never uploads twice:
    a tensor moves (a no-op where it lies already), a number, a nested
    sequence or an array becomes a ``const``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    return const(_hashable(value), dtype, device)


def cached(maxsize: int):
    """``functools.lru_cache(maxsize)`` whose results ``holding`` sees."""
    def wrap(fn):
        inner = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            return _held(inner(*args))

        call.cache_clear = inner.cache_clear
        call.cache_info = inner.cache_info
        return call

    return wrap
