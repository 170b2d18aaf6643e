"""K1, one-pass: the shadow raster's ``tile_raster_kernel<false>`` (one
layer), from ``raster_pallas.tile_raster``'s calls without ``two_pass``;
its work is K1's (``k1.tile_raster_work``)."""

from __future__ import annotations

from port_bench.kernels.k1 import tile_raster_work

PROFILER_NAME = "tile_raster_kernel<false>"
EXCLUDE = None
WRAPS = "render_engine_tpu_torch.render.raster_pallas:tile_raster"


def work(data, ids, counts, **kw):
    """The call's work, or None for a two-pass call (``k1``)."""
    if kw["two_pass"]:
        return None
    return tile_raster_work(data, ids, counts, **kw)
