"""Bodies of spawned CPU ranks for tests/test_torch_parallel.py. They live
apart from the test module so that a spawned process imports torch and the
port only (spawn pickles a target by module and name)."""

import numpy as np
import torch
import torch.distributed as dist


def seeded_world(capacity, seed):
    """A world of the port's default registry whose every column is drawn
    from ``seed`` (bools, ints and floats alike)."""
    from render_engine_tpu_torch.ecs import world as W

    rng = np.random.default_rng(seed)
    w = W.create_world(W.WorldConfig(capacity=capacity))

    def draw(t):
        if t.dtype == torch.bool:
            return torch.from_numpy(rng.random(t.shape) < 0.5)
        if t.dtype.is_floating_point:
            return torch.from_numpy(rng.normal(size=t.shape)).to(t.dtype)
        return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, t.shape,
                                             dtype=np.int64)).to(t.dtype)

    return w.replace(alive=draw(w.alive), comp_mask=draw(w.comp_mask),
                     **{k: draw(v) for k, v in w.comps.items()})


def round_trip(rank, n_ranks, store, capacity, seed, out):
    """Shard a seeded world over a gloo group and gather it back; rank 0
    saves (rows it held, every column equal, the two world hashes)."""
    from render_engine_tpu_torch.parallel import (gather_world, make_mesh,
                                                  shard_world)
    from render_engine_tpu_torch.utils.hashing import world_hash

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n_ranks, rank=rank)
    try:
        mesh = make_mesh(n_ranks)
        world = seeded_world(capacity, seed)
        rows = shard_world(world, mesh)
        back = gather_world(rows, mesh)
        equal = torch.equal(back.alive, world.alive) and \
            torch.equal(back.comp_mask, world.comp_mask) and all(
                torch.equal(back.comps[k], v) for k, v in world.comps.items())
        if rank == 0:
            torch.save(dict(rows=int(rows.alive.shape[0]), equal=equal,
                            hashes=(world_hash(world), world_hash(back))),
                       out)
    finally:
        dist.destroy_process_group()
