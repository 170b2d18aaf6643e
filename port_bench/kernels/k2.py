"""K2: ``resolve_kernel``, from ``raster_pallas.resolve_attributes_pallas``'s
calls. The arithmetic is a frozen copy of the port's
``kernel_bounds.resolve_work``."""

from __future__ import annotations

import torch

PROFILER_NAME = "resolve_kernel"
EXCLUDE = None
WRAPS = ("render_engine_tpu_torch.render.raster_pallas:"
         "resolve_attributes_pallas")


def work(slot, rows, *a, **kw):
    return resolve_work(slot, rows)


def resolve_work(slot, rows):
    """K2: the output, the slots and each distinct referenced row."""
    tb, th, tw = slot.shape
    _, k, a = rows.shape
    flat = slot.reshape(tb, th * tw).long()
    hit = (flat >= 0) & (flat < k)
    key = torch.arange(tb, device=slot.device)[:, None] * k + flat
    n_rows = int(torch.unique(key[hit]).numel())
    return {"bytes": (a * tb * th * tw + slot.numel()) * 4 + n_rows * a * 4,
            "ops": 0, "rows": n_rows}
