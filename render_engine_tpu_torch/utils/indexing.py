"""Indexing by a device index without a read on the host.

PyTorch reads a 0-dim tensor used as an index back to the host as a
Python number, which waits for the device and cannot be captured in a
CUDA graph. ``gather_row`` gathers with a one-element index tensor instead.
"""

from __future__ import annotations

import torch


def gather_row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[i]`` for a 0-dim integer tensor ``i`` on ``t``'s device."""
    return t.index_select(0, i.reshape(1).long())[0]
