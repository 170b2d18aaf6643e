"""Collision detection: grid candidate windows + vectorized AABB tests.

Port of ``render_engine_tpu/logic/collision.py``: compact query table over
the moved collidable entities near the camera, 27-cell candidate windows,
exact handling of entities larger than a grid cell, and ``hits_topk``'s
per-pair delivery of the first ``k`` contacts per entity.
"""

from __future__ import annotations

import dataclasses

import torch

from render_engine_tpu_torch.ecs import registry as R
from render_engine_tpu_torch.ecs.world import World
from render_engine_tpu_torch.world import grid as G

CAMERA_CUTOFF = 200.0


@dataclasses.dataclass(frozen=True)
class CollisionResult:
    query: torch.Tensor  # int64[Q]
    query_valid: torch.Tensor  # bool[Q]
    cand: torch.Tensor  # int64[Q, K]
    cand_type: torch.Tensor  # int32[Q, K]
    hit: torch.Tensor  # bool[Q, K]
    lquery: torch.Tensor  # int64[L]
    lquery_valid: torch.Tensor  # bool[L]
    lhit: torch.Tensor  # bool[L, CAP]
    query_dropped: torch.Tensor
    cell_dropped: torch.Tensor
    large_dropped: torch.Tensor

    def any_hit(self) -> torch.Tensor:
        """Not provided: the tables hold no capacity to scatter back to."""
        raise NotImplementedError("use first_hit_of_type")

    def first_hit_of_type(self, world: World, type_index: int):
        """(other_idx int32[CAP], mask bool[CAP]): each query entity's first
        colliding neighbor whose type is ``type_index`` (any type if
        ``type_index < 0``), scattered back to entity space."""
        cap = world.capacity
        dev = world.device
        other = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
        has = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
        for query, valid, cand, ctype, ok in self._tables(world):
            if type_index >= 0:
                ok = ok & (ctype == type_index)
            has_q = ok.any(dim=-1)
            first = ok.to(torch.int8).argmax(dim=-1, keepdim=True)
            other_q = torch.gather(cand, 1, first)[:, 0].to(torch.int32)
            dest = torch.where(valid, query, torch.full_like(query, cap))
            other[dest] = torch.where(has_q, other_q,
                                      torch.full_like(other_q, -1))
            has[dest] = has_q
        return other[:cap], has[:cap]

    def _tables(self, world: World):
        cap = world.capacity
        out = [(self.query, self.query_valid, self.cand, self.cand_type,
                self.hit & self.query_valid[:, None])]
        if self.lquery.shape[0] > 0:
            lcand = torch.arange(cap, device=world.device)[None, :].expand(
                self.lhit.shape)
            ltype = world["type_id"][None, :].expand(self.lhit.shape)
            out.append((self.lquery, self.lquery_valid, lcand, ltype,
                        self.lhit & self.lquery_valid[:, None]))
        return out

    def hits_topk(self, world: World, k: int):
        """(others int32[CAP, k], mask bool[CAP, k], other_type
        int32[CAP, k], dropped int32): the first ``k`` colliding neighbors
        of every query entity in candidate order, and the count of pairs
        beyond slot ``k``."""
        cap = world.capacity
        dev = world.device
        others = torch.full((cap + 1, k), -1, dtype=torch.int32, device=dev)
        masks = torch.zeros((cap + 1, k), dtype=torch.bool, device=dev)
        otypes = torch.full((cap + 1, k), -1, dtype=torch.int32, device=dev)
        dropped = torch.zeros((), dtype=torch.int64, device=dev)
        for query, valid, cand, ctype, ok in self._tables(world):
            rank = torch.cumsum(ok.to(torch.int32), dim=-1)
            oth, got, typ = [], [], []
            for j in range(k):
                hit_j = ok & (rank == j + 1)
                col = hit_j.to(torch.int8).argmax(dim=-1, keepdim=True)
                has_j = hit_j.any(dim=-1)
                other_j = torch.gather(cand, 1, col)[:, 0].to(torch.int32)
                type_j = torch.gather(ctype, 1, col)[:, 0].to(torch.int32)
                oth.append(torch.where(has_j, other_j,
                                       torch.full_like(other_j, -1)))
                got.append(has_j)
                typ.append(torch.where(has_j, type_j,
                                       torch.full_like(type_j, -1)))
            dest = torch.where(valid, query, torch.full_like(query, cap))
            others[dest] = torch.stack(oth, dim=-1)
            masks[dest] = torch.stack(got, dim=-1)
            otypes[dest] = torch.stack(typ, dim=-1)
            dropped = dropped + ((rank[:, -1] - k).clamp(min=0)
                                 * valid.to(torch.int32)).sum()
        return (others[:cap], masks[:cap], otypes[:cap],
                dropped.to(torch.int32))


def find_collisions(world: World, grid: G.GridIndex,
                    camera_position: torch.Tensor, query_mask: torch.Tensor,
                    per_cell_budget: int = 8, query_budget: int = 1024,
                    large_budget: int = 8) -> CollisionResult:
    """AABB-overlap candidates for the entities in ``query_mask`` near the
    camera, compacted (lowest index first) to ``query_budget`` queries."""
    cfg = world.config
    cap = world.capacity
    dev = world.device
    pos = world["position"]
    cut = torch.tensor(CAMERA_CUTOFF, dtype=torch.float32)
    near_cam = (((pos - camera_position[None]) ** 2).sum(dim=-1)
                <= float(cut * cut))
    q = query_mask & near_cam
    mn, mx = world["aabb_min"], world["aabb_max"]
    arange = torch.arange(cap, device=dev)

    lb = min(large_budget, cap)
    if lb > 0:
        halfspan = torch.maximum(pos - mn, mx - pos).amax(dim=-1)
        is_large = world.alive & (halfspan > cfg.section_length * 0.5)
        q = q & ~is_large
    else:
        is_large = torch.zeros(cap, dtype=torch.bool, device=dev)

    def compact(mask, budget):
        idx = torch.sort(torch.where(mask, arange,
                                     torch.full_like(arange, cap))).values
        idx = idx[:budget]
        return idx.clamp(0, cap - 1), idx < cap

    qb = min(query_budget, cap)
    qidx, qvalid = compact(q, qb)

    table = torch.cat([
        arange.to(torch.float32)[:, None],
        world.alive.to(torch.float32)[:, None],
        world["type_id"].to(torch.float32)[:, None],
        mn, mx, is_large.to(torch.float32)[:, None]], dim=1)
    rows, valid, cell_dropped = G.neighbor_candidate_rows(
        grid, grid.keys[qidx], cfg, table[grid.perm], per_cell_budget)
    ch = rows.movedim(-1, 0)
    cand = ch[0].to(torch.int64)
    ctype = ch[2].to(torch.int32)
    valid = valid & (cand != qidx[:, None]) & (ch[1] > 0.5) \
        & qvalid[:, None]
    if lb > 0:
        valid = valid & ~(ch[9] > 0.5)
    qmn, qmx = mn[qidx], mx[qidx]
    hit = valid
    for a in range(3):
        hit = hit & (qmn[:, a:a + 1] <= ch[6 + a]) \
            & (ch[3 + a] <= qmx[:, a:a + 1])
    query_dropped = (q.sum() - qb).clamp(min=0).to(torch.int32)

    large_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    if lb > 0:
        lidx, lvalid = compact(is_large, lb)
        large_dropped = (is_large.sum() - lb).clamp(min=0).to(torch.int32)
        lmn, lmx = mn[lidx], mx[lidx]
        ghit = qvalid[:, None] & lvalid[None, :] \
            & (lidx[None, :] != qidx[:, None])
        for a in range(3):
            ghit = ghit & (qmn[:, a:a + 1] <= lmx[None, :, a]) \
                & (lmn[None, :, a] <= qmx[:, a:a + 1])
        cand = torch.cat([cand, lidx[None, :].expand(ghit.shape)], dim=1)
        ctype = torch.cat(
            [ctype, world["type_id"][lidx][None, :].expand(ghit.shape)],
            dim=1)
        hit = torch.cat([hit, ghit], dim=1)

        lqidx, lqvalid = compact(query_mask & near_cam & is_large, lb)
        lq_mn, lq_mx = mn[lqidx], mx[lqidx]
        bhit = lqvalid[:, None] & world.alive[None, :] \
            & (arange[None, :] != lqidx[:, None])
        for a in range(3):
            bhit = bhit & (lq_mn[:, a:a + 1] <= mx[None, :, a]) \
                & (mn[None, :, a] <= lq_mx[:, a:a + 1])
        lquery, lquery_valid, lhit = lqidx, lqvalid, bhit
    else:
        lquery = torch.zeros(0, dtype=torch.int64, device=dev)
        lquery_valid = torch.zeros(0, dtype=torch.bool, device=dev)
        lhit = torch.zeros((0, cap), dtype=torch.bool, device=dev)

    return CollisionResult(query=qidx, query_valid=qvalid, cand=cand,
                           cand_type=ctype, hit=hit, lquery=lquery,
                           lquery_valid=lquery_valid, lhit=lhit,
                           query_dropped=query_dropped,
                           cell_dropped=cell_dropped,
                           large_dropped=large_dropped)


def collision_query_mask(world: World, moved: torch.Tensor) -> torch.Tensor:
    collidable = world.flag_set(R.FLAG_COLLIDABLE)
    always_user = world.flag_set(R.FLAG_USER_ALWAYS_COLLIDES)
    return (moved & collidable) | (always_user & collidable)
