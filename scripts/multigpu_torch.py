"""Step the demo frame partitioned by entity and render it in bands of tile
rows, one band a rank, and hold it to one device: the PyTorch port's
counterpart of the JAX package's multichip dry run
(``__graft_entry__.dryrun_multichip``).

    torchrun --nproc-per-node N scripts/multigpu_torch.py     # NCCL, N cards
    python3 scripts/multigpu_torch.py --device cpu --ranks N  # gloo, N CPU
                                                              # processes

Every rank builds the demo engine (the same seed everywhere), keeps its
``capacity / N`` rows of the world (``shard_world``) and runs ``--frames``
frames: the partitioned step of its rows (``shard_step``), the world
gathered (``gather_world``, the counterpart of the JAX render pass's
all-gather of the triangle batch) for the shadow-map update and its band
of the image (``render_frame_sharded``). The image is gathered
(``gather_image``) and rank 0 replays the same frames on one device
through ``Engine.frame`` and prints the parity line: the max abs diff of
the images, the share of pixels differing by more than 1e-6, the images'
u8 hashes sharded / single, the world hashes of every rank (after the
gather) and of one device, the world rows a rank and the image rows a
rank. It exits non-zero when a rank's world hash differs from one
device's or the images differ at all: at tile budgets of 1.0 a band is
the whole frame's rows, since shifting the triangles by a whole number of
tile rows changes no K1 edge test.

Then the scale phase, the dry run's: the 10k-entity world at capacity
16384 stepped over the mesh. Every rank must hold ``16384 / N`` rows of
every per-entity column after the step, and the gathered world, the
camera and the step counters must equal the unsharded step's; the wall
time of both is printed as a record, not a claim.

On cards the engine has the headline's size (1920x1080, 10,000 asteroids);
on the CPU the dry run's toy size. Both runs render with texture and
shadow tile budgets of 1.0: a band's budgets are fractions of its own
tiles, so at the demo's 0.04 and 0.28 a band may leave tiles untextured or
unshadowed that the whole frame covers. The gloo group meets in a
``file://`` store in a temporary directory; ``torchrun`` gives NCCL its
own.
"""

import argparse
import hashlib
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DT = 1.0 / 60.0
CARD_KW = dict(width=1920, height=1080, capacity=16384, num_asteroids=10000,
               max_tris=16384)
PARITY_BUDGETS = dict(texture_tile_budget=1.0, shadow_tile_budget=1.0)


def cpu_kw(n_ranks):
    """The dry run's toy engine for ``n_ranks`` ranks."""
    return dict(width=128, height=max(n_ranks * 8, 32),
                capacity=max(64, n_ranks * 16), num_asteroids=16,
                max_tris=2048)


def u8_hash(img):
    import numpy as np

    a = img.detach().cpu().numpy()
    return hashlib.sha256(np.clip(a * 255.0 + 0.5, 0, 255).astype(
        np.uint8).tobytes()).hexdigest()[:16]


def sharded_frame(eng, mesh, stepped, rows, inputs, dt=DT):
    """One frame of ``eng`` over ``mesh``: ``stepped`` (``shard_step`` of
    the Engine's tick, ``config_step``) on this rank's ``rows``, then the
    world gathered into the engine for the shadow-map update and this
    rank's band of the stepped state. ``inputs``: the host inputs with
    their ``prev_keys``. Returns ``(rows, band, stats)``."""
    import numpy as np
    import torch

    from render_engine_tpu_torch.parallel import (gather_world,
                                                  render_frame_sharded)

    dev_inputs = inputs.to_device(mesh.device)
    rows, camera, stats = stepped(
        rows, eng.camera, dev_inputs,
        torch.tensor(np.float32(dt), device=mesh.device),
        eng.bank.aabb_min, eng.bank.aabb_max)
    eng.world = gather_world(rows, mesh)
    eng.camera = camera
    eng.update_shadows()
    band = render_frame_sharded(
        eng.world, eng.camera, eng.bank, eng.config.render, mesh,
        cubemap=eng.cubemap, atlas=eng.atlas, shadow_state=eng.shadow_state,
        systems=eng.compiled_systems, inputs=dev_inputs)
    return rows, band, stats


def scale(mesh, height, log=print):
    """The dry run's scale phase over ``mesh``: the 10k-entity world at
    capacity 16384, stepped once partitioned and once whole on every rank
    (each after a warm-up). Raises unless every rank holds ``capacity / n``
    rows of every column and the gathered world, the camera and the
    counters equal the unsharded step's. Returns the record on rank 0."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.parallel import (columns, gather_world,
                                                  shard_step, shard_world)
    from render_engine_tpu_torch.runtime.engine import config_step

    eng = build_space_engine(device=mesh.device, width=128, height=height,
                             capacity=16384, num_asteroids=10000,
                             max_tris=2048)
    step = config_step(eng.config)
    stepped = shard_step(step, mesh)
    args = (eng.camera, InputState.idle(0).to_device(mesh.device),
            torch.tensor(np.float32(DT), device=mesh.device),
            eng.bank.aabb_min, eng.bank.aabb_max)
    rows = shard_world(eng.world, mesh)

    def timed(fn, world):
        for _ in range(2):  # the second call is timed
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            t0 = time.perf_counter()
            out = fn(world, *args)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
        return out, time.perf_counter() - t0

    (w1, c1, s1), t_single = timed(step, eng.world)
    (r8, c8, s8), t_mesh = timed(stepped, rows)
    cap = eng.config.capacity
    held = {int(v.shape[0]) for v in columns(r8).values()}
    whole = gather_world(r8, mesh)
    equal = all(torch.equal(v, columns(w1)[k])
                for k, v in columns(whole).items()) and \
        torch.equal(c8.serialize(), c1.serialize()) and \
        all(torch.equal(s8[k], s1[k]) for k in s1)
    per_rank = [None] * mesh.size
    dist.all_gather_object(per_rank, (held, equal), group=mesh.group)
    if mesh.rank != 0:
        return None
    rec = dict(capacity=cap, alive=int(whole.alive.sum()),
               rows_a_rank=sorted(set().union(*(h for h, _ in per_rank))),
               equal=all(e for _, e in per_rank), single_s=t_single,
               mesh_s=t_mesh)
    log(f"multigpu_torch scale({mesh.size} ranks, {mesh.device.type}): "
        f"{rec['alive']} entities / capacity {cap}, rows a rank "
        f"{rec['rows_a_rank']} (capacity/n = {cap // mesh.size}); "
        f"partitioned step equal to the unsharded step (every column, the "
        f"camera, the counters): {rec['equal']}; wall single="
        f"{t_single * 1e3:.1f} ms mesh={t_mesh * 1e3:.1f} ms (a record, "
        "not a speed claim)")
    if rec["rows_a_rank"] != [cap // mesh.size]:
        raise RuntimeError("the entity axis is not partitioned: rows a "
                           f"rank {rec['rows_a_rank']}")
    if not rec["equal"]:
        raise RuntimeError("the partitioned step differs from the "
                           "unsharded step at scale")
    return rec


def run(mesh, kw, frames=1, log=print):
    """Build, step and render ``frames`` frames sharded over ``mesh``;
    on rank 0 also on one device; then the scale phase. Returns, on rank
    0, the record (the gathered image under ``image``, the scale phase's
    under ``scale``), elsewhere None; raises past the limits."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.parallel import (columns, gather_image,
                                                  shard_step, shard_world)
    from render_engine_tpu_torch.runtime.engine import config_step
    from render_engine_tpu_torch.utils.hashing import world_hash

    t0 = time.perf_counter()
    eng = build_space_engine(device=mesh.device, **kw)
    eng.config.record_history = False
    parity = dataclasses.replace(eng.config.render, **PARITY_BUDGETS)
    eng.config.render = parity
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    stepped = shard_step(config_step(eng.config), mesh)
    rows = shard_world(eng.world, mesh)
    prev = np.zeros_like(InputState.idle(0).keys)
    for i in range(frames):
        inputs = InputState.idle(i).with_prev(prev)
        prev = np.asarray(inputs.keys, bool)
        rows, band, _ = sharded_frame(eng, mesh, stepped, rows, inputs)
    height = eng.config.render.height
    held = {int(v.shape[0]) for v in columns(rows).values()}
    img = gather_image(band, mesh, height)
    rank_hashes = [None] * mesh.size
    dist.all_gather_object(rank_hashes, world_hash(eng.world),
                           group=mesh.group)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t_frames = time.perf_counter() - t0
    rank_rows = [None] * mesh.size
    dist.all_gather_object(rank_rows, sorted(held), group=mesh.group)
    scale_rec = scale(mesh, height, log)
    if mesh.rank != 0:
        return None
    eng.reset()
    eng.config.render = parity
    for i in range(frames):
        ref = eng.frame(None, DT)
    single_hash = world_hash(eng.world)
    diff = (img - ref).abs().amax(dim=-1)
    rec = dict(ranks=mesh.size, band_rows=int(band.shape[0]), frames=frames,
               max_diff=float(diff.max()),
               share_differing=float((diff > 1e-6).double().mean()),
               u8_hash_sharded=u8_hash(img), u8_hash_single=u8_hash(ref),
               world_hashes_ranks=rank_hashes, world_hash_single=single_hash,
               alive=int(eng.world.alive.sum()),
               rows=sorted(set().union(*map(set, rank_rows))),
               build_s=t_build, sharded_s=t_frames)
    log(f"multigpu_torch({mesh.size} ranks, {mesh.device.type}): image "
        f"{tuple(img.shape)}, {rec['alive']} entities, world rows a rank "
        f"{rec['rows']} (capacity {eng.config.capacity} / {mesh.size}), "
        f"bands of {rec['band_rows']} rows; parity with one device: max "
        "diff "
        f"{rec['max_diff']:.2e}, {rec['share_differing']:.4%} pixels "
        f"differ; u8 hash sharded={rec['u8_hash_sharded']} single="
        f"{rec['u8_hash_single']}; world hash of every rank "
        f"{sorted({h[:16] for h in rank_hashes})} single={single_hash[:16]};"
        f" {frames} sharded frame(s) in {t_frames:.2f} s, the kernels' first "
        "build included")
    if set(rank_hashes) != {single_hash}:
        raise RuntimeError("a rank's world differs from one device's")
    cap = eng.config.capacity
    if rec["rows"] != [cap // mesh.size if cap % mesh.size == 0 else cap]:
        raise RuntimeError(f"world rows a rank {rec['rows']}")
    if not torch.equal(img, ref) or \
            rec["u8_hash_sharded"] != rec["u8_hash_single"]:
        raise RuntimeError("the sharded image differs from one device's")
    rec["image"] = img.cpu()
    rec["scale"] = scale_rec
    return rec


def _gloo_rank(rank, n_ranks, store, kw, frames, out):
    """One spawned CPU rank: join the gloo group, ``run``, and have rank 0
    save its record to ``out``."""
    import torch
    import torch.distributed as dist

    from render_engine_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n_ranks, rank=rank)
    try:
        rec = run(make_mesh(n_ranks), kw, frames)
        if rec is not None and out is not None:
            torch.save(rec, out)
    finally:
        dist.destroy_process_group()


def run_gloo(n_ranks, kw=None, frames=1, out=None):
    """``n_ranks`` spawned CPU processes in a gloo group; rank 0's record
    goes to ``out`` (a path) when given."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_gloo_rank, args=(n_ranks, os.path.join(tmp, "store"),
                                   kw or cpu_kw(n_ranks), frames, out),
                 nprocs=n_ranks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL, one card a rank, under "
                         "torchrun) or cpu (gloo, --ranks processes)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="CPU processes with --device cpu")
    ap.add_argument("--frames", type=int, default=1)
    args = ap.parse_args(argv)
    if args.device == "cpu":
        run_gloo(args.ranks, frames=args.frames)
        return 0

    import torch
    import torch.distributed as dist

    from render_engine_tpu_torch.parallel import make_mesh
    from render_engine_tpu_torch.runtime.profiling import require_device

    require_device("cuda")
    dist.init_process_group("nccl")
    try:
        mesh = make_mesh()
        torch.cuda.set_device(mesh.device)
        run(mesh, CARD_KW, args.frames)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
