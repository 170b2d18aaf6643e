"""The world tick on a world sharded by entity: each rank steps its rows.

Port of what the JAX package gets from
``jax.jit(step, in_shardings=(world_sharding(...), rep, rep, rep))``: the
unchanged step body (``logic/step.py``) runs partitioned over the entity
axis, and the collectives sit where the data crosses ranks.

The design is XLA's (GSPMD): every per-entity column of this rank's rows
becomes a ``torch.distributed.tensor.DTensor`` placed ``Shard(0)`` on a
``DeviceMesh`` over the ``Mesh``'s group, and the step body runs on them
as it is, the user's callbacks included. Their reductions keep their
global meaning: a callback's ``mask.any()`` or ``argmax`` reduces over
every rank's rows, and a row number indexes the whole world. Plain
tensors (constants, the camera, the inputs, ``dt``, the bank's boxes, the
threefry keys) count as replicated (``implicit_replication``).

Element-wise stages (flags, culling, ``K.integrate``, out of bounds,
``K.refresh_transforms``, the per-type updates and the masked writes of
the change set) run on this rank's ``capacity / n`` rows. Where the step
reads rows by global row number, the shared code makes those columns
whole first (``utils/indexing.py`` ``whole``; on plain tensors it returns
its argument, so the single-device step is the same code):

* the grid: one all-gather of the section keys for the sort and the
  neighbour windows (``world/grid.py``; ``torch.searchsorted`` has no
  DTensor rule and runs on each rank's copy);
* the collision compaction: the query tables count rows globally, so the
  boxes they read and the packed candidate table are gathered
  (``logic/collision.py``);
* the owned-entity cascade: a parent may live on another rank
  (``ecs/changes.py``);
* the spawn drain: free slots are numbered by a global ``cumsum`` and a
  spawn may land on any rank (``ecs/changes.py``);
* a single row read by index (``gather_row``: the camera's user entity,
  the mine producer's position).

A callback's write by global row numbers into a per-entity column
(``col[rows] = v``, JAX's ``col.at[rows].set(v)``) lands on the ranks that
own those rows (``_GlobalRows``), with no host traffic and no
data-dependent shape, so the step stays capturable.

After the step every per-entity column is placed back on ``Shard(0)``
(a slice where propagation replicated it, no traffic) and each rank keeps
its rows. A world whose capacity the rank count does not divide stays
whole on every rank and is stepped whole, as ``world_sharding`` says.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.overrides import TorchFunctionMode

from render_engine_tpu_torch.ecs.world import World
from render_engine_tpu_torch.parallel.mesh import Mesh, _rebuild, columns
from render_engine_tpu_torch.utils.indexing import placed_like, whole_local


def _is_spec(a) -> bool:
    return hasattr(a, "placements") and hasattr(a, "shape")


@functools.cache
def _register_rules():
    """Sharding rules for the step's operations that DTensor lacks or gets
    wrong in PyTorch 2.11: no rule for ``linalg_cross``, ``ne.Tensor`` or
    ``index_put_``, and ``stack`` on a negative dimension places its
    output on the wrong dimension. Each is computed where its operands
    lie. DTensor keeps its rules for the whole process, so these stand
    for every DTensor user in it. Where a version has a single-dimension
    rule of its own for an operation (2.13: ``linalg_cross``,
    ``ne.Tensor``, ``index_put_``), DTensor uses that one and not this;
    ``stack``'s replaces the version's own."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten
    rep = Replicate()

    @register_sharding(aten.linalg_cross.default)
    def cross(a, b, dim=-1):
        crossed = dim % len(a.shape)
        return [([rep], [rep, rep])] + [
            ([Shard(d)], [Shard(d), Shard(d)])
            for d in range(len(a.shape)) if d != crossed]

    @register_sharding(aten.ne.Tensor)
    def pointwise(*args):
        """Split the output on any dimension; an operand splits on its own
        dimension there, or stays whole where it broadcasts."""
        shapes = [tuple(a.shape) for a in args if _is_spec(a)]
        out = torch.broadcast_shapes(*shapes)

        def operand(a, d):
            if not _is_spec(a):
                return None
            own = d - (len(out) - len(a.shape))
            return Shard(own) if own >= 0 and a.shape[own] == out[d] \
                else rep

        return [([rep], [rep if _is_spec(a) else None for a in args])] + [
            ([Shard(d)], [operand(a, d) for a in args])
            for d in range(len(out)) if out[d] > 1]

    @register_sharding(aten.stack.default)
    def stack(tensors, dim=0):
        rank = len(tensors[0].shape)
        at = dim % (rank + 1)
        return [([rep], [rep] * len(tensors))] + [
            ([Shard(d if d < at else d + 1)], [Shard(d)] * len(tensors))
            for d in range(rank)]

    @register_sharding(aten.index_put_.default)
    def index_put(self, indices, values, accumulate=False):
        """The collision tables' writes: every operand whole. A write by
        integer row numbers into a column split on dim 0 never gets here
        (``_GlobalRows`` writes it on the owning rank); any other write
        into a split tensor has indices no rank's rows can take."""
        if not all(p.is_replicate() for p in self.placements):
            raise NotImplementedError(
                "index_put_ into a tensor split over the ranks (placements "
                f"{tuple(self.placements)}) by other than integer row "
                "numbers: write a per-entity column with torch.where over a "
                "mask, or index utils.indexing.whole(column).")
        return [([rep], [rep] * (2 + sum(i is not None for i in indices)))]


def _split_rows(t) -> bool:
    """``t`` is a DTensor whose rows are split over the ranks."""
    from torch.distributed.tensor import DTensor, Shard

    return isinstance(t, DTensor) and tuple(t.placements) == (Shard(0),)


def _row_numbers(key) -> bool:
    """An index whose first part is an integer tensor (of row numbers)."""
    first = key[0] if isinstance(key, tuple) and key else key
    return isinstance(first, torch.Tensor) and first.dtype in (
        torch.int64, torch.int32, torch.int16, torch.int8)


def _put_rows(col, key, value, accumulate=None):
    """``col[key] = value`` (``accumulate`` None) or ``col.index_put_(key,
    value, accumulate)`` on a column split on dim 0, ``key``'s first part
    being global row numbers: each rank writes the rows it owns. Its rows
    ``[rank * m, (rank + 1) * m)`` take the row numbers less ``rank * m``;
    every other row number is sent to a scratch row past the rank's rows
    and dropped with it, so the write reads nothing back to the host and
    has the same shapes on every frame (a CUDA graph captures it). The
    row numbers, the rest of ``key`` and ``value`` are taken whole. Where a
    row number repeats, which write lands is unspecified, as in
    ``index_put_`` and JAX's ``.at[].set``."""
    local = col.to_local()
    m = local.shape[0]
    key = key if isinstance(key, tuple) else (key,)
    rows = whole_local(key[0]) - col.device_mesh.get_local_rank() * m
    rows = torch.where((rows >= 0) & (rows < m), rows, m)
    key = (rows,) + tuple(whole_local(k) if isinstance(k, torch.Tensor)
                          else k for k in key[1:])
    if isinstance(value, torch.Tensor):
        value = whole_local(value)
    padded = torch.cat([local, local[:1]])  # row m: the scratch row
    if accumulate is None:
        padded[key] = value
    else:
        padded.index_put_(key, value, accumulate)
    local.copy_(padded[:m])
    return col


def _dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _argmax(func, t, *args, **kwargs):
    """``argmax`` of a DTensor without DTensor's handler, which reads an
    index on the host in PyTorch 2.11 (so no graph can capture it) and
    gathers 0-dim tensors, which gloo refuses. Over the entity axis (or
    the whole tensor) it reduces ``t``'s whole rows on every rank, alike,
    into a replicated DTensor; along another dimension
    of a column split on dim 0 each rank reduces its own rows, which stay
    split."""
    from torch.distributed.tensor import DTensor

    dim = args[0] if args else kwargs.get("dim")
    if _split_rows(t) and dim is not None and dim % t.ndim != 0:
        return DTensor.from_local(func(t.to_local(), *args, **kwargs),
                                  t.device_mesh, t.placements,
                                  run_check=False)
    return placed_like(func(whole_local(t), *args, **kwargs), t)


class _GlobalRows(TorchFunctionMode):
    """Where a row number is global on a partitioned world.

    * An ``argmax`` over the entity axis takes its operand whole
      (``utils/indexing.py``): the first row of a mask over every rank
      (the user entity, the firing producer) is found in the gathered mask
      on each rank. An ``argmax`` over another dimension (a row's first
      free slot, ``with_add_reference``) needs no other rank's rows: each
      rank reduces its own. DTensor's own handler is never used
      (``_argmax``).
    * A write by integer row numbers into a column split on dim 0
      (``col[rows] = v`` in a callback, ``col.index_put_((rows,), v)``;
      JAX's ``col.at[rows].set(v)`` on a world sharded by entity) lands on
      the rank that owns each row (``_put_rows``). Other writes, the
      collision tables' replicated ones among them, are left to DTensor.
    """

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.argmax or func is torch.Tensor.argmax) \
                and _dtensor(args[0]):
            return _argmax(func, *args, **kwargs)
        if func is torch.Tensor.__setitem__ and _split_rows(args[0]) \
                and _row_numbers(args[1]):
            return _put_rows(*args)
        elif func in (torch.Tensor.index_put_, torch.index_put_) \
                and _split_rows(args[0]):
            col, key, value, *rest = args
            accumulate = rest[0] if rest else kwargs.get("accumulate", False)
            if _row_numbers(tuple(key)):
                return _put_rows(col, tuple(key), value, accumulate)
        return func(*args, **kwargs)


def _device_mesh(mesh: Mesh):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh.from_group(mesh.group, mesh.device.type)


def _plain(t):
    """A replicated or partial DTensor as this rank's whole tensor."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def shard_step(step, mesh: Mesh):
    """The partitioned form of ``step`` (``logic/step.py`` ``make_step``'s
    tick) over ``mesh``. The returned ``stepped(rows, camera, inputs, dt,
    aabb_min, aabb_max)`` takes this rank's rows of the world, in the form
    ``shard_world`` gives and ``gather_world`` takes, and the replicated
    rest as ``step`` does, and returns ``(rows, camera, stats)``: this
    rank's rows of the stepped world, the camera and the drop counters,
    all equal to what ``step`` gives on the whole world.

    Two things reach beyond the step:

    * The DTensor sharding rules of ``_register_rules`` are registered on
      the first call and hold for the whole process, for every DTensor
      user in it. On PyTorch 2.11 (the card's machine) all four apply; on
      2.13 DTensor prefers its own single-dimension rules for
      ``linalg_cross``, ``ne.Tensor`` and ``index_put_``, so there only
      ``stack``'s is ours.
    * The mode ``_GlobalRows`` (``argmax`` without DTensor's handler,
      writes by global row number into a split column) holds while
      ``stepped`` runs, for every operation in the process until it
      returns, the user's callbacks included. It acts before DTensor's
      dispatch, so it is the one that applies on every version: without
      it such a write raises (2.11: this module's ``index_put_`` rule;
      2.13: DTensor's in-place placement error)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    _register_rules()
    dmesh = _device_mesh(mesh)
    shard = [Shard(0)]

    def stepped(rows: World, camera, inputs, dt, aabb_min, aabb_max):
        cap, n = rows.capacity, mesh.size
        if cap % n:  # the JAX rule: such a world is stepped whole
            return step(rows, camera, inputs, dt, aabb_min, aabb_max)
        if rows.alive.shape[0] * n != cap:
            raise ValueError(f"{rows.alive.shape[0]} rows are no shard of "
                             f"capacity {cap} over {n} ranks")
        world = _rebuild(rows, {
            k: DTensor.from_local(v, dmesh, shard, run_check=False)
            for k, v in columns(rows).items()})
        with implicit_replication(), _GlobalRows():
            world, camera, stats = step(world, camera, inputs, dt, aabb_min,
                                        aabb_max)
        out = _rebuild(world, {k: v.redistribute(dmesh, shard).to_local()
                               for k, v in columns(world).items()})
        camera = dataclasses.replace(camera, **{
            f.name: _plain(getattr(camera, f.name))
            for f in dataclasses.fields(camera)
            if isinstance(getattr(camera, f.name), torch.Tensor)})
        return out, camera, {k: _plain(v) for k, v in stats.items()}

    return stepped
