"""The frame rendered in bands of tile rows, one band a rank.

Port of ``render_engine_tpu/parallel/render.py``. The single-device fused
tiled frame (``render/frame.py`` ``tiled_fused_core``) runs unchanged on
every rank over its band of tile rows:

* the draw callbacks, the triangle batch, the per-triangle system ids, the
  entity shade attributes and the lights are computed from the whole world
  on every rank (``frame.frame_inputs``, the JAX package's outer jit; the
  batch is small);
* each rank shifts the triangles' y into its band, then bins, rasters
  (K1), resolves (K2) and shades (K3) only its rows, shadow-slot PCF
  factors and per-tile light lists included; everything that needs the
  global row (the unprojection, the factor tiles' grids, the light lists'
  pyramids, custom shading's positions) takes ``y_off`` with the whole
  image's height;
* the background is the whole image's, and each rank takes its band.

``render_frame_band`` is one rank's body, without a process group;
``render_frame_sharded`` runs it for this process's rank of a ``Mesh``,
and ``gather_image`` joins the bands. Every rank holds the whole world and
steps it alike (the step is deterministic), so a frame moves no world
rows between ranks: only the bands are gathered. The image height is
padded so that every band holds a whole number of tile rows; the pad rows
are cropped.
"""

from __future__ import annotations

import dataclasses

import torch

from render_engine_tpu_torch.parallel.mesh import Mesh, all_gather_rows
from render_engine_tpu_torch.render.frame import (RenderSettings,
                                                  frame_inputs,
                                                  tiled_fused_core)
from render_engine_tpu_torch.utils import consts


def render_frame_band(world, camera, bank, settings: RenderSettings, *,
                      rank: int, n_ranks: int, cubemap=None, atlas=None,
                      shadow_state=None, systems=None,
                      inputs=None) -> torch.Tensor:
    """Rank ``rank``'s band of ``n_ranks``, (band, W, 3) float32 linear
    color: image rows ``[rank * band, (rank + 1) * band)`` of the frame
    ``render_frame`` gives with ``fused_shading=True``, the last band's
    rows past the image padded.
    ``world`` is the whole world. A band renders through the fused tiled
    path (``tiled_fused_core``) whatever ``fused_shading`` says, as the
    JAX package's ``render_frame_band``; ``backend="jnp"`` is refused."""
    from render_engine_tpu_torch.render import render_system as RS

    if settings.backend == "jnp":
        raise ValueError("a band renders on the fused tiled path only "
                         "(backend 'auto' or 'pallas')")
    h, w = settings.height, settings.width
    th = settings.raster.tile_h
    band = -(-h // (n_ranks * th)) * th  # whole tile rows a rank
    y_off = rank * band
    f = frame_inputs(world, camera, bank, settings, cubemap=cubemap,
                     systems=systems, inputs=inputs)
    tri_sys = None
    if systems is not None and systems.has_shade_callbacks():
        tri_sys = RS.triangle_system_ids(f["batch"], world, systems)
    # the whole image's background, this band's rows (the JAX package
    # samples it at the padded height, which stretches the sky when the
    # height is no multiple of n_ranks tile rows)
    rows = f["background"][y_off:y_off + band]
    if rows.shape[0] < band:
        rows = torch.cat([rows, rows.new_zeros(band - rows.shape[0], w, 3)])
    batch = f["batch"]
    shift = consts.const((0.0, float(y_off)), device=batch.xy.device)
    return tiled_fused_core(
        dataclasses.replace(batch, xy=batch.xy - shift), f["lights"], bank,
        settings, camera, width=w, h_total=h, h_local=band,
        y_off=float(y_off), background=rows, ent_attrs=f["ent_attrs"],
        atlas=atlas, shadow_state=shadow_state, systems=systems,
        draw_ctx=f["draw_ctx"], tri_sys=tri_sys)


def render_frame_sharded(world, camera, bank, settings: RenderSettings,
                         mesh: Mesh, *, cubemap=None, atlas=None,
                         shadow_state=None, systems=None,
                         inputs=None) -> torch.Tensor:
    """This rank's band of the frame (``render_frame_band`` with
    ``mesh.rank`` of ``mesh.size``): the output is sharded by rows and not
    gathered. ``world`` is the whole world, since the geometry needs every
    entity; a world of ``shard_world``'s rows is refused (``gather_world``
    joins it)."""
    if world.alive.shape[0] != world.capacity:
        raise ValueError(f"a world of {world.alive.shape[0]} of its "
                         f"{world.capacity} rows: render_frame_sharded "
                         "needs the whole world (gather_world)")
    return render_frame_band(
        world, camera, bank, settings, rank=mesh.rank, n_ranks=mesh.size,
        cubemap=cubemap, atlas=atlas, shadow_state=shadow_state,
        systems=systems, inputs=inputs)


def gather_image(band: torch.Tensor, mesh: Mesh, height: int
                 ) -> torch.Tensor:
    """Every rank's band joined in rank order and cropped to the image:
    (height, W, 3) on every rank."""
    return all_gather_rows(band, mesh)[:height]
