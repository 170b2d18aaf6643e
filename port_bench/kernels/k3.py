"""K3: ``fused_shade_kernel``, from ``shade_pallas.shade_tiles``'s calls.
The arithmetic is a frozen copy of the port's
``kernel_bounds.fused_shade_work``."""

from __future__ import annotations

import torch

PROFILER_NAME = "fused_shade_kernel"
EXCLUDE = None
WRAPS = "render_engine_tpu_torch.render.shade_pallas:shade_tiles"

K3_OPS_PER_LIGHT = 60  # Blinn-Phong terms per (pixel, layer, light)
K3_ROW_FLOATS = 35  # channels 0-34 of an attribute row are read
K3_BLOCK_PIXELS = 256  # a block of K3 shades two rows of an 8x128 tile
K3_BLOCK_THREADS = 128  # one item a thread a round


def work(*a, **kw):
    return fused_shade_work(*a, **kw)


def _max(x):
    return int(x.max()) if x.numel() else 0


def fused_shade_work(rows, s_o, s_t, d_o, d_t, ltab, lcount, cam, ipv, org,
                     *, sf=None, sfi=None, ovr=None, ovr_chans=4, tlist=None,
                     tcount=None, **_):
    """K3: the four slot / depth planes, the eight output planes, and for
    covered (pixel, layer) items only: their override values, the opaque
    items' slot-factor values of mapped tiles, and the 35 used floats of
    each distinct referenced row; about 60 operations per (item, light).
    Beside them the counts the light loop's critical path comes from:
    the most items in a tile and in one of the kernel's blocks
    (``shade_block_items``), the most (item, light) iterations of a tile,
    and ``critical_path``, the most light iterations one thread of a block
    runs: ceil(items / BLOCK_THREADS) x n_iter, the maximum over blocks."""
    nt, k, _a = rows.shape
    npx = s_o.shape[1] * s_o.shape[2]
    cov = torch.stack([s_o.reshape(nt, npx) >= 0,
                       s_t.reshape(nt, npx) >= 0])  # (2, NT, npx)
    per_tile = cov.sum(dim=(0, 2))  # items a tile
    n_items = int(per_tile.sum())
    if tlist is not None:
        n_iter = tcount.long().clamp(0, tlist.shape[1])
    else:
        n_iter = lcount.long().clamp(0, ltab.shape[0]).expand(nt)
    ops = K3_OPS_PER_LIGHT * int((per_tile * n_iter).sum())
    nb = -(-npx // K3_BLOCK_PIXELS)
    pad = nb * K3_BLOCK_PIXELS - npx
    per_block = torch.nn.functional.pad(cov, (0, pad)).reshape(
        2, nt, nb, K3_BLOCK_PIXELS).sum(dim=(0, 3))  # items a block
    rounds = (per_block.long() + K3_BLOCK_THREADS - 1) // K3_BLOCK_THREADS
    slots = torch.stack([s_o.reshape(nt, npx), s_t.reshape(nt, npx)])
    key = (torch.arange(nt, device=rows.device)[None, :, None] * k
           + slots.long().clamp(max=k - 1))
    n_rows = int(torch.unique(key[cov]).numel())
    nbytes = nt * npx * (4 * 4 + 8 * 4) + n_rows * K3_ROW_FLOATS * 4
    nbytes += ltab.numel() * 4
    if ovr is not None:
        nbytes += n_items * ovr_chans * 4
    if sf is not None:
        # a factor is read where the tile is mapped in a slot a live light
        # owns
        n_slots = sf.shape[0]
        owned = (ltab[:int(lcount.reshape(-1)[0]), 21:21 + n_slots]
                 > 0.5).any(dim=0)
        mapped = ((sfi >= 0) & owned[:, None]).sum(dim=0)  # (NT,)
        nbytes += (int((cov[0].sum(dim=1) * mapped).sum()) * 4
                   + sfi.numel() * 4)
    if tlist is not None:
        nbytes += (tlist.numel() + tcount.numel()) * 4
    return {"bytes": nbytes, "ops": ops, "items": n_items,
            "items_opaque": int(cov[0].sum()),
            "items_transparent": int(cov[1].sum()), "rows": n_rows,
            "items_max_tile": _max(per_tile),
            "items_max_block": _max(per_block),
            "light_iters_max_tile": _max(per_tile * n_iter),
            "critical_path": _max(rounds * n_iter[:, None])}
