"""Indexing by a device index without a read on the host, and the rows
a partitioned step has to see whole.

PyTorch reads a 0-dim tensor used as an index back to the host as a
Python number, which waits for the device and cannot be captured in a
CUDA graph. ``gather_row`` gathers with a one-element index tensor instead.

The partitioned step (``parallel/step.py``) runs the step on DTensors whose
rows are split over the ranks. Where the step indexes a column by global
row numbers, ``whole`` gives every rank all of its rows first, and
``placed_like`` puts a tensor that every rank builds alike beside them. On
plain tensors both return their argument, so the single-device step is
the same code.
"""

from __future__ import annotations

import sys

import torch


def gather_row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-dim integer tensor ``i`` on ``t``'s device (of the
    whole column on a partitioned world)."""
    return whole(t).index_select(0, i.reshape(1).long())[0]


def _dtensor_class():
    """``DTensor`` once ``torch.distributed.tensor`` is imported, else None
    (no DTensor can exist before that, and the import is not free)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def placed_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor every rank builds alike, in ``ref``'s form: a
    replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor (the
    partitioned step, ``parallel/step.py``), else ``t`` itself. For the
    in-place writes that DTensor does not take into a plain tensor."""
    dtensor = _dtensor_class()
    if dtensor is None or not isinstance(ref, dtensor):
        return t
    from torch.distributed.tensor import Replicate

    mesh = ref.device_mesh
    return dtensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` with all its rows on every rank: a DTensor split over the
    ranks (or partial) is all-gathered (or reduced) into a replicated
    one; anything else is returned as it is."""
    dtensor = _dtensor_class()
    if dtensor is None or not isinstance(t, dtensor):
        return t
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    if all(p.is_replicate() for p in t.placements):
        return t
    return t.redistribute(mesh, [Replicate()] * mesh.ndim)


def whole_local(t: torch.Tensor) -> torch.Tensor:
    """All of ``t``'s rows as a plain tensor on this rank: ``whole(t)``'s
    local tensor (``t`` itself when it is plain)."""
    t = whole(t)
    dtensor = _dtensor_class()
    return t.to_local() if dtensor is not None and isinstance(t, dtensor) \
        else t
