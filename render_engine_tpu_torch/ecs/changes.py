"""Deferred-mutation protocol: dense masked ChangeSets.

Port of ``render_engine_tpu/ecs/changes.py``. Logic callbacks never mutate
the world; they return a ``ChangeSet`` of masked component writes, flag
set/clear masks, a despawn mask and a fixed-budget spawn queue, which
``apply_changeset`` applies once per frame.
"""

from __future__ import annotations

import dataclasses

import torch

from render_engine_tpu_torch.ecs import registry as R
from render_engine_tpu_torch.ecs.world import World, _default_column
from render_engine_tpu_torch.utils.indexing import whole

OWNED_CASCADE_ROUNDS = 5


def _expand(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class SpawnBatch:
    """Up to ``budget`` spawn rows; ``row_valid`` marks real requests."""

    count: torch.Tensor
    values: dict
    comp_bits: torch.Tensor
    row_valid: torch.Tensor
    budget: int


def empty_spawn_batch(config, budget: int, device) -> SpawnBatch:
    values = {s.name: _default_column(s, budget, device)
              for s in config.registry.specs}
    return SpawnBatch(
        count=torch.zeros((), dtype=torch.int32, device=device),
        values=values,
        comp_bits=torch.zeros(budget, dtype=torch.int32, device=device),
        row_valid=torch.zeros(budget, dtype=torch.bool, device=device),
        budget=budget)


@dataclasses.dataclass(frozen=True)
class ChangeSet:
    updates: dict  # name -> (values (CAP, ...), mask bool[CAP])
    set_flags: torch.Tensor
    clear_flags: torch.Tensor
    despawn_mask: torch.Tensor
    spawns: SpawnBatch | None


def empty_changeset(world: World, spawn_budget: int = 0) -> ChangeSet:
    cap, dev = world.capacity, world.device
    return ChangeSet(
        updates={},
        set_flags=torch.zeros(cap, dtype=torch.int32, device=dev),
        clear_flags=torch.zeros(cap, dtype=torch.int32, device=dev),
        despawn_mask=torch.zeros(cap, dtype=torch.bool, device=dev),
        spawns=(empty_spawn_batch(world.config, spawn_budget, dev)
                if spawn_budget else None))


def with_update(cs: ChangeSet, name: str, values, mask) -> ChangeSet:
    """Queue a masked component write (later writes win)."""
    updates = dict(cs.updates)
    if name in updates:
        old_v, old_m = updates[name]
        values = torch.where(_expand(mask, values.ndim), values, old_v)
        mask = mask | old_m
    updates[name] = (values, mask)
    return dataclasses.replace(cs, updates=updates)


def with_despawn(cs: ChangeSet, mask) -> ChangeSet:
    return dataclasses.replace(cs, despawn_mask=cs.despawn_mask | mask)


def with_flags(cs: ChangeSet, set_mask=None, set_bits=0, clear_mask=None,
               clear_bits=0) -> ChangeSet:
    """Queue flag bits to set on ``set_mask`` rows and to clear on
    ``clear_mask`` rows (make static, wake up, marker flags)."""
    sf, cf = cs.set_flags, cs.clear_flags
    if set_mask is not None:
        sf = torch.where(set_mask, sf | R.as_bits(set_bits), sf)
    if clear_mask is not None:
        cf = torch.where(clear_mask, cf | R.as_bits(clear_bits), cf)
    return dataclasses.replace(cs, set_flags=sf, clear_flags=cf)


def queue_spawn(cs: ChangeSet, registry: R.ComponentRegistry,
                row_mask: torch.Tensor, **values) -> ChangeSet:
    """Queue spawn rows; slots are assigned in ``apply_changeset``."""
    sp = cs.spawns
    if sp is None:
        raise ValueError("ChangeSet created without a spawn budget")
    bits = R.as_bits(registry.bits(*values.keys()))
    new_vals = dict(sp.values)
    for name, val in values.items():
        new_vals[name] = torch.where(_expand(row_mask, val.ndim), val,
                                     sp.values[name])
    new_bits = torch.where(row_mask, sp.comp_bits | bits, sp.comp_bits)
    new_valid = sp.row_valid | row_mask
    return dataclasses.replace(cs, spawns=dataclasses.replace(
        sp, values=new_vals, comp_bits=new_bits, row_valid=new_valid,
        count=new_valid.sum(dtype=torch.int32)))


def with_add_reference(cs: ChangeSet, world: World, owner_mask: torch.Tensor,
                       other: torch.Tensor) -> ChangeSet:
    """Add a referenced (non-owning) entity edge per owner in
    ``owner_mask``; ``other``: int32[CAP], the referenced id per owner row.
    Set semantics: a duplicate is a no-op, and an owner with no free slot
    among its ``MAX_REF_EDGES`` drops the add."""
    rows = world["ref_edges"]
    exists = (rows == other[:, None]).any(dim=1)
    free = rows == -1
    slot = torch.argmax(free.to(torch.int32), dim=1)
    can = owner_mask & free.any(dim=1) & ~exists & (other >= 0)
    cols = torch.arange(rows.shape[1], device=rows.device)
    new = torch.where((cols[None, :] == slot[:, None]) & can[:, None],
                      other[:, None].to(rows.dtype), rows)
    return with_update(cs, "ref_edges", new, can)


def with_remove_reference(cs: ChangeSet, world: World,
                          owner_mask: torch.Tensor,
                          other: torch.Tensor) -> ChangeSet:
    """Remove the edge to ``other`` from each owner in ``owner_mask``."""
    rows = world["ref_edges"]
    hit = (rows == other[:, None]) & owner_mask[:, None]
    new = torch.where(hit, torch.full_like(rows, -1), rows)
    return with_update(cs, "ref_edges", new, owner_mask)


def merge(a: ChangeSet, b: ChangeSet) -> ChangeSet:
    """Compose two ChangeSets; ``b`` wins on overlapping writes, as if it
    were applied after ``a``."""
    out = a
    for name, (v, m) in b.updates.items():
        out = with_update(out, name, v, m)
    out = dataclasses.replace(
        out, set_flags=out.set_flags | b.set_flags,
        clear_flags=out.clear_flags | b.clear_flags,
        despawn_mask=out.despawn_mask | b.despawn_mask)
    if b.spawns is not None and a.spawns is not None:
        raise ValueError("merging two ChangeSets that both carry spawns is "
                         "not supported; queue spawns into one set")
    if b.spawns is not None:
        out = dataclasses.replace(out, spawns=b.spawns)
    return out


def apply_changeset(world: World, cs: ChangeSet) -> World:
    """Masked writes, flags, owned-entity despawn cascade, then spawns."""
    reg = world.config.registry
    comps = dict(world.comps)
    comp_mask = world.comp_mask
    for name, (values, mask) in cs.updates.items():
        old = comps[name]
        comps[name] = torch.where(_expand(mask, old.ndim), values, old)
        comp_mask = torch.where(mask, comp_mask | R.as_bits(reg.bit(name)),
                                comp_mask)
    comps["flags"] = (comps["flags"] | cs.set_flags) & ~cs.clear_flags

    # owned-entity cascade by pointer doubling: after OWNED_CASCADE_ROUNDS
    # rounds chains up to 2^ROUNDS deep have propagated their deaths. A
    # parent may live on another rank of a partitioned world: the chains
    # run over whole columns (``whole``)
    cap = world.capacity
    dead = whole(cs.despawn_mask)
    anc = whole(comps["parent"])
    for _ in range(OWNED_CASCADE_ROUNDS):
        valid = anc >= 0
        anc_c = anc.clamp(0, cap - 1).long()
        dead = dead | (valid & dead[anc_c])
        anc = torch.where(valid, anc[anc_c], torch.full_like(anc, -1))
    despawn = dead & (world.alive | cs.despawn_mask)
    alive = world.alive & ~despawn
    comp_mask = torch.where(despawn, torch.zeros_like(comp_mask), comp_mask)
    world = dataclasses.replace(world, alive=alive, comp_mask=comp_mask,
                                comps=comps)
    if cs.spawns is not None:
        # an empty queue leaves every slot as it is, so the drain runs
        # unconditionally (branching on the count would wait for the device)
        world = _drain_spawns(world, cs.spawns)
    return world


def _drain_spawns(world: World, sp: SpawnBatch) -> World:
    """Assign valid spawn rows, in row order, to the first free slots.
    The free slots are numbered over the whole world (a spawn may land on
    any rank of a partitioned world)."""
    alive = world.alive
    cap = world.capacity
    free = ~alive
    rank = torch.cumsum(whole(free).to(torch.int32), 0) - 1
    perm = torch.argsort((~sp.row_valid).to(torch.int32), stable=True)
    landing_row = torch.where(free, rank, torch.full_like(rank, cap))
    takes = free & (landing_row < sp.count)
    src = perm[landing_row.clamp(0, sp.budget - 1).long()]
    comps = dict(world.comps)
    for spec in world.config.registry.specs:
        gathered = sp.values[spec.name][src]
        comps[spec.name] = torch.where(_expand(takes, gathered.ndim),
                                       gathered, comps[spec.name])
    return dataclasses.replace(
        world, alive=alive | takes,
        comp_mask=torch.where(takes, sp.comp_bits[src], world.comp_mask),
        comps=comps)
