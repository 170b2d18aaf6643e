"""The least time an NVIDIA H100 could take for each kernel's work.

A frozen copy of render_engine_tpu_torch/kernel_bounds.py's arithmetic:
the benchmark's yardstick for the ``*_roofline`` metrics, which later
changes to the port cannot move.

For a kernel call on given inputs, ``bound_ms`` is the larger of two times:
the bytes the work must move (each input byte it needs read once, each
output byte written once) over the card's memory rate, and the float
operations these inputs need over the card's float32 rate outside the
tensor cores. The rates are NVIDIA's data-sheet peaks for the H100 SXM at
its 700 W limit (3.35 TB/s, 67 TFLOP/s); a card set below 700 W reaches
less. Work that depends on the data is counted for these inputs.

Each ``*_work`` function takes a kernel's captured arguments (the same as
its wrapper's) and returns a dict with ``bytes`` and ``ops`` and the counts
they come from. ``bound`` turns bytes and operations into
``(bound_ms, "bytes" | "operations")``.
"""

from __future__ import annotations

import torch


# NVIDIA's data sheet, H100 SXM at 700 W: HBM3 bytes a second and float32
# operations a second outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

K1_OPS_PER_PAIR = 25  # edge tests, area, depth and compare per pixel
K1_BYTES_PER_CANDIDATE = 44  # 10 f32 scalars and one i32 id
K3_OPS_PER_LIGHT = 60  # Blinn-Phong terms per (pixel, layer, light)
K3_ROW_FLOATS = 35  # channels 0-34 of an attribute row are read
K3_BLOCK_PIXELS = 256  # a block of K3 shades two rows of an 8x128 tile
K3_BLOCK_THREADS = 128  # one item a thread a round


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max(x):
    return int(x.max()) if x.numel() else 0


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
