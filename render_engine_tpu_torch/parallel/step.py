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
from render_engine_tpu_torch.utils.indexing import whole


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
        """The collision tables' writes: every operand whole. The indices
        are global row numbers, which a rank's rows cannot take."""
        if not all(p.is_replicate() for p in self.placements):
            raise NotImplementedError(
                "index_put_ into a tensor split over the ranks (placements "
                f"{tuple(self.placements)}): its indices are global row "
                "numbers. Write a per-entity column with torch.where over a "
                "mask, or index utils.indexing.whole(column).")
        return [([rep], [rep] * (2 + sum(i is not None for i in indices)))]


class _WholeArgmax(TorchFunctionMode):
    """An ``argmax`` over the entity axis takes its operand whole
    (``utils/indexing.py``): the first row of a mask over every rank (the
    user entity, the firing producer) is found in the gathered mask on
    each rank. DTensor's own handler for ``argmax`` (no sharding rule
    applies to it) gathers each rank's maximum and index instead, as
    0-dim tensors in PyTorch 2.11, which gloo refuses. An ``argmax`` over
    another dimension (a row's first free slot, ``with_add_reference``)
    needs no other rank's rows and is left to DTensor."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.argmax or func is torch.Tensor.argmax:
            t = args[0]
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            if dim is None or dim % max(t.ndim, 1) == 0:
                args = (whole(t),) + tuple(args[1:])
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

    It registers DTensor sharding rules for the whole process
    (``_register_rules``)."""
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
        with implicit_replication(), _WholeArgmax():
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
