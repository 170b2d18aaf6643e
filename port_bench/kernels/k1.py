"""K1, two-pass: the main raster's ``tile_raster_kernel<true>`` (both
layers), from ``raster_pallas.tile_raster``'s calls with ``two_pass``.
The arithmetic is a frozen copy of the port's
``kernel_bounds.tile_raster_work``."""

from __future__ import annotations

import torch

PROFILER_NAME = "tile_raster_kernel"
EXCLUDE = "<false>"
WRAPS = "render_engine_tpu_torch.render.raster_pallas:tile_raster"

K1_OPS_PER_PAIR = 25  # edge tests, area, depth and compare per pixel
K1_BYTES_PER_CANDIDATE = 44  # 10 f32 scalars and one i32 id


def work(data, ids, counts, **kw):
    """The call's work, or None for a one-pass call (``k1_one_pass``)."""
    if not kw["two_pass"]:
        return None
    return tile_raster_work(data, ids, counts, **kw)


def k1_live(counts, k, tile_budget, trans_budget):
    """(NT, K) bool: the candidate slots K1 visits (its clamped trip
    counts over the opaque window, the transparent window and the global
    list)."""
    cnt = counts[:, 0, :].long()
    glob0 = tile_budget + trans_budget
    n0 = cnt[:, 0].clamp(0, tile_budget)[:, None]
    n1 = cnt[:, 1].clamp(0, trans_budget)[:, None]
    n2 = cnt[:, 2].clamp(0, k - glob0)[:, None]
    i = torch.arange(k, device=counts.device)[None]
    return ((i < n0) | ((i >= tile_budget) & (i < tile_budget + n1))
            | ((i >= glob0) & (i < glob0 + n2)))


def tile_raster_work(data, ids, counts, *, tiles_x, tile_h, tile_w,
                     tile_budget, trans_budget, two_pass):
    """K1: live candidates x 44 B + counts + 12 B (one layer) or 24 B (two
    layers) per tile pixel; 25 operations per (live candidate, pixel centre
    of its tile inside the candidate's screen bounding box) pair."""
    nt, _, k = data.shape
    live = k1_live(counts, k, tile_budget, trans_budget)
    v = data[:, :6].double()
    x, y = v[:, 0::2], v[:, 1::2]  # (NT, 3, K)
    tids = torch.arange(nt, device=data.device)
    ox = ((tids % tiles_x) * tile_w).double()[:, None]
    oy = (torch.div(tids, tiles_x, rounding_mode="floor")
          * tile_h).double()[:, None]

    def span(lo, hi, o, n):
        # pixel columns c in [o, o + n) with lo <= c + 0.5 <= hi
        first = torch.clamp(torch.ceil(lo - 0.5), min=o, max=o + n)
        last = torch.clamp(torch.floor(hi - 0.5), min=o - 1, max=o + n - 1)
        return torch.nan_to_num(torch.clamp(last - first + 1, min=0), nan=0)

    nx = span(x.amin(1), x.amax(1), ox, tile_w)
    ny = span(y.amin(1), y.amax(1), oy, tile_h)
    pairs = int(torch.where(live, nx * ny, torch.zeros_like(nx)).sum())
    n_live = int(live.sum())
    out_bytes = nt * tile_h * tile_w * (24 if two_pass else 12)
    return {"bytes": n_live * K1_BYTES_PER_CANDIDATE + counts.numel() * 4
            + out_bytes, "ops": K1_OPS_PER_PAIR * pairs, "pairs": pairs,
            "live_candidates": n_live}
