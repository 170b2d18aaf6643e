"""The mesh of ranks and the sharding of the world and the frame.

Port of ``render_engine_tpu/parallel/mesh.py``. The JAX package shards
over a ``jax.sharding.Mesh`` inside one process and lets XLA place the
collectives. The port runs one process per card, as ``torchrun`` starts
them, joined by a ``torch.distributed`` process group (NCCL between cards,
gloo between CPU processes): a ``Mesh`` is this process's place in it.

The two shardable axes are the JAX package's: the world's entity rows
(every per-entity column splits on dim 0 into ``capacity / size`` rows a
rank) and the rendered image's rows (each rank renders a band of tile
rows, ``parallel/render.py``). A world whose capacity the rank count does
not divide stays whole on every rank, as in JAX. The port's frame shards
only the image: every rank steps the whole world, and ``shard_world`` /
``gather_world`` split a world into its ranks' rows and join them again
for a caller that keeps it sharded.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from render_engine_tpu_torch.ecs.world import World


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_name: str
    size: int  # ranks in the group
    rank: int  # this process's rank
    device: torch.device  # this rank's card (or the CPU under gloo)
    group: object  # the torch.distributed process group


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on ``mesh``: ``spec`` ``(axis_name,)`` splits
    dim 0 over the ranks, ``()`` gives every rank all of it (the JAX
    package's ``PartitionSpec``)."""
    mesh: Mesh
    spec: tuple = ()


def make_mesh(n_devices: int | None = None, axis_name: str = "world"
              ) -> Mesh:
    """The mesh of the initialized default process group. Under NCCL this
    rank's device is ``cuda:{LOCAL_RANK}``, under gloo the CPU. Raises when
    no group is initialized, when ``n_devices`` is not the group's size, or
    when a NCCL rank finds no card."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh: no torch.distributed process group; "
                           "call init_process_group first")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"need {n_devices} devices, the group has {size}")
    if dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if not torch.cuda.is_available() or \
                local >= torch.cuda.device_count():
            raise RuntimeError(f"make_mesh: NCCL rank {rank} finds no card "
                               f"cuda:{local}")
        device = torch.device("cuda", local)
    else:
        device = torch.device("cpu")
    return Mesh(axis_name=axis_name, size=size, rank=rank, device=device,
                group=dist.group.WORLD)


def columns(world: World) -> dict:
    """Every per-entity column by name: ``alive``, ``comp_mask``, then the
    components in name order."""
    return {"alive": world.alive, "comp_mask": world.comp_mask,
            **{k: world.comps[k] for k in sorted(world.comps)}}


def _rebuild(world: World, cols: dict) -> World:
    return dataclasses.replace(
        world, alive=cols["alive"], comp_mask=cols["comp_mask"],
        comps={k: cols[k] for k in world.comps})


def world_sharding(world: World, mesh: Mesh) -> World:
    """A World of ``Sharding`` markers in place of ``world``'s columns:
    every per-entity column shards on dim 0 when the rank count divides
    the capacity; anything else is replicated."""
    cap, n = world.capacity, mesh.size

    def spec(leaf):
        if leaf.dim() >= 1 and leaf.shape[0] == cap and cap % n == 0:
            return Sharding(mesh, (mesh.axis_name,))
        return replicated(mesh)

    return _rebuild(world, {k: spec(v) for k, v in columns(world).items()})


def shard_world(world: World, mesh: Mesh) -> World:
    """This rank's rows ``[r * cap / n, (r + 1) * cap / n)`` of every
    sharded column, on ``mesh.device``. The config stays the global one
    (``World.capacity`` reads it); replicated columns stay whole."""
    specs = world_sharding(world, mesh)
    rows = world.capacity // mesh.size
    lo = mesh.rank * rows

    def place(leaf, sh):
        if sh.spec:
            leaf = leaf[lo:lo + rows]
        return leaf.to(mesh.device).contiguous()

    specs = columns(specs)
    return _rebuild(world, {k: place(v, specs[k])
                            for k, v in columns(world).items()})


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each), concatenated on dim 0
    in rank order. Moves bytes only: a bool tensor travels as uint8."""
    send = t.contiguous()
    if send.dtype == torch.bool:
        send = send.view(torch.uint8)
    out = send.new_empty((mesh.size * send.shape[0],) + send.shape[1:])
    dist.all_gather_into_tensor(out, send, group=mesh.group)
    return out.view(torch.bool) if t.dtype == torch.bool else out


def gather_world(sharded: World, mesh: Mesh) -> World:
    """The whole world on every rank from each rank's rows
    (``shard_world``'s inverse; columns that are already whole stay)."""
    cap = sharded.capacity

    def whole(leaf):
        if leaf.shape[0] == cap:
            return leaf
        if leaf.shape[0] * mesh.size != cap:
            raise ValueError(f"a column of {leaf.shape[0]} rows is no "
                             f"shard of capacity {cap} over {mesh.size}")
        return all_gather_rows(leaf, mesh)

    return _rebuild(sharded, {k: whole(v)
                              for k, v in columns(sharded).items()})


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def image_sharding(mesh: Mesh) -> Sharding:
    """Rendered frames shard across rows."""
    return Sharding(mesh, (mesh.axis_name,))
