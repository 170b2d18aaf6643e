"""Uniform spatial grid over the world cube, as a sorted section-key index.

Port of ``render_engine_tpu/world/grid.py``. The JAX package replaces
``searchsorted`` with a two-sort merge because the TPU runs it as a
sequential loop; ``torch.searchsorted`` is a parallel kernel here and gives
the same integers.
"""

from __future__ import annotations

import dataclasses

import torch

from render_engine_tpu_torch.ecs.world import World, WorldConfig
from render_engine_tpu_torch.utils.consts import const
from render_engine_tpu_torch.utils.indexing import (placed_like, whole,
                                                  whole_local)

_DEAD_KEY = 2 ** 31 - 1


def section_key(position: torch.Tensor, config: WorldConfig) -> torch.Tensor:
    """Packed int32 key kx + G*(ky + G*kz); out-of-world cells clamp."""
    g = config.grid_cells_per_axis
    lo = const(tuple(map(float, config.world_min)), device=position.device)
    cell = (position - lo) / config.section_length
    # a position far outside the world must clamp, not wrap: bound the
    # float before the int cast (an out-of-range cast is undefined)
    k = cell.clamp(-1.0, float(g)).to(torch.int32).clamp(0, g - 1)
    return k[..., 0] + g * (k[..., 1] + g * k[..., 2])


def unpack_key(key: torch.Tensor, config: WorldConfig) -> torch.Tensor:
    g = config.grid_cells_per_axis
    return torch.stack([key % g, (key // g) % g, key // (g * g)], dim=-1)


@dataclasses.dataclass(frozen=True)
class GridIndex:
    perm: torch.Tensor  # int64[CAP] entity index in sorted-key order
    sorted_keys: torch.Tensor  # int32[CAP]
    keys: torch.Tensor  # int32[CAP]; dead entities carry _DEAD_KEY

    @property
    def capacity(self) -> int:
        return self.perm.shape[0]


def build_grid(world: World) -> GridIndex:
    """The keys of every row, sorted. On a partitioned world each rank
    computes its rows' keys and the keys are all-gathered once: the sort
    and the neighbour windows need all of them."""
    keys = section_key(world["position"], world.config)
    keys = whole(torch.where(world.alive, keys,
                             torch.full_like(keys, _DEAD_KEY)))
    perm = torch.argsort(keys, stable=True)
    return GridIndex(perm=perm, sorted_keys=keys[perm], keys=keys)


def neighbor_cell_keys(key: torch.Tensor, config: WorldConfig
                       ) -> torch.Tensor:
    """The 27 cells around each key, (...,) -> (..., 27), edge-clamped."""
    g = config.grid_cells_per_axis
    r = torch.arange(-1, 2, dtype=torch.int32, device=key.device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(27, 3)
    n = (unpack_key(key, config)[..., None, :] + offs).clamp(0, g - 1)
    return n[..., 0] + g * (n[..., 1] + g * n[..., 2])


def first_occurrence_mask(nk: torch.Tensor) -> torch.Tensor:
    """True only at each key's first occurrence in its 27-cell window."""
    n = nk.shape[-1]
    eq = nk[..., :, None] == nk[..., None, :]
    idx = torch.arange(n, device=nk.device)
    earlier = idx[None, :] < idx[:, None]
    return ~(eq & earlier).any(dim=-1)


def _searchsorted(sk: torch.Tensor, v: torch.Tensor, right: bool = False
                  ) -> torch.Tensor:
    """``torch.searchsorted``. DTensor has no sharding rule for it: on a
    partitioned world both sides are whole on every rank, so each rank
    searches its own copy."""
    out = torch.searchsorted(whole_local(sk).contiguous(),
                             whole_local(v).contiguous(), right=right)
    return placed_like(out, sk)


def _cell_windows(grid: GridIndex, nk: torch.Tensor, b: int):
    """Each neighbor cell's first ``b`` slots of the sorted index: (slot
    (Q, 27, b), valid (Q, 27, b), cell_live (Q, 27), starts, ends)."""
    starts = _searchsorted(grid.sorted_keys, nk)
    ends = _searchsorted(grid.sorted_keys, nk, right=True)
    slot = starts[..., None] + torch.arange(b, device=nk.device)
    cell_live = first_occurrence_mask(nk)
    valid = (slot < ends[..., None]) & cell_live[..., None]
    return slot.clamp(0, grid.capacity - 1), valid, cell_live, starts, ends


def neighbor_candidates(grid: GridIndex, query_keys: torch.Tensor,
                        config: WorldConfig, per_cell_budget: int = 8):
    """Candidate entity ids near each query cell: ``(cand, valid)`` of shape
    (Q, 27 * per_cell_budget), up to the budget from each of the 27
    neighbor cells (a cell's overflow is dropped)."""
    nk = neighbor_cell_keys(query_keys, config)
    b = per_cell_budget
    slot, valid, _, _, _ = _cell_windows(grid, nk, b)
    q = query_keys.shape[0]
    return grid.perm[slot].reshape(q, 27 * b), valid.reshape(q, 27 * b)


def neighbor_candidate_rows(grid: GridIndex, query_keys: torch.Tensor,
                            config: WorldConfig, sorted_rows: torch.Tensor,
                            per_cell_budget: int = 8):
    """Packed attribute rows of up to ``per_cell_budget`` entities from each
    of the 27 cells around every query: (rows (Q, 27*b, C), valid
    (Q, 27*b), cell_dropped)."""
    nk = neighbor_cell_keys(query_keys, config)
    b = per_cell_budget
    slot, valid, cell_live, starts, ends = _cell_windows(grid, nk, b)
    q = query_keys.shape[0]
    rows = sorted_rows[slot.reshape(q, 27 * b)]
    cell_dropped = ((ends - starts - b).clamp(min=0)
                    * cell_live.to(torch.int64)).sum().to(torch.int32)
    return rows, valid.reshape(q, 27 * b), cell_dropped


def occupied_section_count(grid: GridIndex) -> torch.Tensor:
    """Number of distinct occupied sections (diagnostics / HUD)."""
    sk = grid.sorted_keys
    is_live = sk != _DEAD_KEY
    new_run = torch.cat([is_live[:1], is_live[1:] & (sk[1:] != sk[:-1])])
    return new_run.sum()
