"""Step the demo frame partitioned by entity and render it in bands of tile
rows, one band a rank, and hold it to one device: the PyTorch port's
counterpart of the JAX package's multichip dry run
(``__graft_entry__.dryrun_multichip``).

    torchrun --nproc-per-node N scripts/multigpu_torch.py     # NCCL, N cards
    python3 scripts/multigpu_torch.py --device cpu --ranks N  # gloo, N CPU
                                                              # processes

Every rank builds the demo engine (the same seed everywhere), keeps its
``capacity / N`` rows of the world (``shard_world``) and runs ``--frames``
frames (by default the shadow update interval x slots + 1, so that both
shadow decisions' programs are met, every slot is refreshed and the map
program is replayed) through
``ShardedPrograms`` (``render_engine_tpu_torch/parallel/program.py``):
the partitioned step of its rows (``shard_step``), the world gathered
(``gather_world``, the counterpart of the JAX render pass's all-gather of
the triangle batch) for the shadow-map update, its band of the image
(``render_frame_sharded``) and the bands joined (``gather_image``), one
program a frame, captured as a CUDA graph over NCCL on cards and run
eagerly on the CPU; ``--eager`` takes the same steps eagerly on cards
too (``sharded_frame``). Rank 0 replays the same frames on one device
through ``Engine.frame`` and prints the parity line: whether each
frame's u8 image hash and world hash equal one device's on every rank,
and for the last frame the max abs diff of the images, the share of
pixels differing by more than 1e-6, the u8 hashes sharded / single, the
world hashes of every rank and of one device, the world rows a rank and
the image rows a rank. It exits non-zero when any of them differ: at
tile budgets of 1.0 a band is the whole frame's rows, since shifting the
triangles by a whole number of tile rows changes no K1 edge test.

Then the scale phase, the dry run's: the 10k-entity world at capacity
16384 stepped twice over the mesh (``ShardedPrograms.step``; eagerly with
``--eager``). Every rank must hold ``16384 / N`` rows of every
per-entity column after the steps, and the gathered world, the camera
and the step counters must equal the unsharded steps' (``Engine.step``);
the wall time of the second step of both is printed as a record, not a
claim. On cards, last, the ms a frame in turns (captured N cards, one
card's captured ``Engine.frame``, eager N cards, twice each) with the
programs' capture seconds and graph pool MiB, as a record.

On cards the engine has the headline's size (1920x1080, 10,000 asteroids);
on the CPU the dry run's toy size. The demo engine renders with
``fused_shading=True``, the setting under which ``Engine.frame`` and the
bands (fused whatever the setting) take the same route, as the JAX dry
run sets it. Both runs render with texture and
shadow tile budgets of 1.0: a band's budgets are fractions of its own
tiles, so at the demo's 0.04 and 0.28 a band may leave tiles untextured or
unshadowed that the whole frame covers. The gloo group meets in a
``file://`` store in a temporary directory; ``torchrun`` gives NCCL its
own.
"""

import argparse
import dataclasses
import hashlib
import os
import sys
import tempfile
import time

import numpy as np

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
    a = img.detach().cpu().numpy()
    return hashlib.sha256(np.clip(a * 255.0 + 0.5, 0, 255).astype(
        np.uint8).tobytes()).hexdigest()[:16]


def sharded_frame(eng, mesh, stepped, rows, inputs, dt=DT):
    """One frame of ``eng`` over ``mesh``, eagerly: ``stepped``
    (``shard_step`` of the Engine's tick, ``config_step``) on this rank's
    ``rows``, then the world gathered into the engine for the shadow-map
    update and this rank's band of the stepped state. ``inputs``: the host
    inputs with their ``prev_keys``. Returns ``(rows, band, stats)``."""
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


def scale(mesh, height, eager=False, log=print):
    """The dry run's scale phase over ``mesh``: the 10k-entity world at
    capacity 16384, stepped twice partitioned (``ShardedPrograms.step``,
    captured on cards; ``shard_step`` eagerly with ``eager``) and twice
    whole on every rank (``Engine.step``, captured on cards), the second
    step of each timed. Raises unless every rank holds ``capacity / n``
    rows of every column and the gathered world, the camera and the
    counters equal the unsharded step's. Returns the record on rank 0."""
    import torch
    import torch.distributed as dist

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.step import pack_drop_stats
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.parallel import (ShardedPrograms, columns,
                                                  gather_world, shard_step,
                                                  shard_world)
    from render_engine_tpu_torch.runtime.engine import config_step
    from render_engine_tpu_torch.runtime.profiling import sync

    eng = build_space_engine(device=mesh.device, width=128, height=height,
                             capacity=16384, num_asteroids=10000,
                             max_tris=2048)
    eng.config.record_history = False
    inputs = InputState.idle(0)
    if eager:
        stepped = shard_step(config_step(eng.config), mesh)
        held = {"rows": shard_world(eng.world, mesh), "camera": eng.camera}
        dev_in = inputs.to_device(mesh.device)
        dt = torch.tensor(np.float32(DT), device=mesh.device)

        def partitioned():
            held["rows"], held["camera"], stats = stepped(
                held["rows"], held["camera"], dev_in, dt, eng.bank.aabb_min,
                eng.bank.aabb_max)
            held["drops"] = pack_drop_stats(stats)

        def result():
            return (gather_world(held["rows"], mesh), held["rows"],
                    held["camera"], held["drops"])
    else:
        progs = ShardedPrograms(eng, mesh)

        def partitioned():
            progs.step(inputs, DT)

        def result():
            return progs.world, progs.rows, progs.camera, progs.drops

    def timed(fn):
        for _ in range(2):  # the second call is timed
            sync(mesh.device)
            t0 = time.perf_counter()
            fn()
            sync(mesh.device)
        return time.perf_counter() - t0

    t_mesh = timed(partitioned)
    t_single = timed(lambda: eng.step(inputs, DT))
    whole, rows, camera, drops = result()
    cap = eng.config.capacity
    held = {int(v.shape[0]) for v in columns(rows).values()}
    equal = all(torch.equal(v, columns(eng.world)[k])
                for k, v in columns(whole).items()) and \
        torch.equal(camera.serialize(), eng.camera.serialize()) and \
        torch.equal(drops, eng._last_drops)
    per_rank = [None] * mesh.size
    dist.all_gather_object(per_rank, (held, equal), group=mesh.group)
    if mesh.rank != 0:
        return None
    rec = dict(capacity=cap, alive=int(whole.alive.sum()),
               rows_a_rank=sorted(set().union(*(h for h, _ in per_rank))),
               equal=all(e for _, e in per_rank), single_s=t_single,
               mesh_s=t_mesh, route="eager" if eager else "programs")
    log(f"multigpu_torch scale({mesh.size} ranks, {mesh.device.type}, "
        f"{rec['route']}): {rec['alive']} entities / capacity {cap}, rows a "
        f"rank {rec['rows_a_rank']} (capacity/n = {cap // mesh.size}); "
        f"partitioned step equal to the unsharded step after 2 steps "
        f"(every column, the camera, the counters): {rec['equal']}; wall "
        f"of the second step: single={t_single * 1e3:.2f} ms mesh="
        f"{t_mesh * 1e3:.2f} ms (a record, not a speed claim)")
    if rec["rows_a_rank"] != [cap // mesh.size]:
        raise RuntimeError("the entity axis is not partitioned: rows a "
                           f"rank {rec['rows_a_rank']}")
    if not rec["equal"]:
        raise RuntimeError("the partitioned step differs from the "
                           "unsharded step at scale")
    return rec


def frames_needed(eng):
    """Frames that meet both shadow decisions' programs, refresh every slot
    and replay the map program: ``shadow_update_interval x shadow_slots +
    1`` (1 without shadows)."""
    c = eng.config
    return c.shadow_update_interval * c.shadow_slots + 1 \
        if c.enable_shadows else 1


def run(mesh, kw, frames=None, eager=False, log=print):
    """Build the engine, then ``frames`` frames (``frames_needed`` by
    default) sharded over ``mesh``: through ``ShardedPrograms`` (captured
    on cards), or with ``eager`` through ``sharded_frame``; on rank 0 the
    same frames on one device through ``Engine.frame``; then the scale
    phase, and on cards the ms a frame in turns. Returns, on rank 0, the
    record (the last gathered image under ``image``, the scale phase's
    under ``scale``), elsewhere None; raises unless every frame's world
    hash and image equal one device's."""
    import torch
    import torch.distributed as dist

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.parallel import ShardedPrograms, columns
    from render_engine_tpu_torch.runtime.profiling import sync
    from render_engine_tpu_torch.utils.hashing import world_hash

    t0 = time.perf_counter()
    eng = build_space_engine(device=mesh.device, **kw)
    eng.config.record_history = False
    eng.config.render = dataclasses.replace(eng.config.render,
                                            **PARITY_BUDGETS)
    t_build = time.perf_counter() - t0
    frames = frames or frames_needed(eng)
    height = eng.config.render.height
    route = EagerRoute(eng, mesh) if eager else ShardedPrograms(eng, mesh)
    t0 = time.perf_counter()
    got = []
    for i in range(frames):
        img = route.frame(InputState.idle(i), DT)
        whole = route.world
        got.append((u8_hash(img), world_hash(whole)))
    held = {int(v.shape[0]) for v in columns(route.rows).values()}
    sync(mesh.device)
    t_frames = time.perf_counter() - t0
    per_rank = [None] * mesh.size
    dist.all_gather_object(per_rank, (got, sorted(held)), group=mesh.group)
    scale_rec = scale(mesh, height, eager, log)
    turns = frame_turns(mesh, eng, log) if mesh.device.type == "cuda" \
        else None
    if mesh.rank != 0:
        return None
    eng.reset()
    eng.config.render = dataclasses.replace(eng.config.render,
                                            **PARITY_BUDGETS)
    single = []
    for i in range(frames):
        ref = eng.frame(InputState.idle(i), DT)
        single.append((u8_hash(ref), world_hash(eng.world)))
    th = eng.config.render.raster.tile_h
    diff = (img - ref).abs().amax(dim=-1)
    rank_hashes = [g[-1][1] for g, _ in per_rank]
    rec = dict(ranks=mesh.size, route="eager" if eager else "programs",
               band_rows=-(-height // (mesh.size * th)) * th, frames=frames,
               max_diff=float(diff.max()),
               share_differing=float((diff > 1e-6).double().mean()),
               u8_hash_sharded=u8_hash(img), u8_hash_single=u8_hash(ref),
               frames_equal=[all(g[i] == single[i] for g, _ in per_rank)
                             for i in range(frames)],
               world_hashes_ranks=rank_hashes,
               world_hash_single=single[-1][1],
               alive=int(eng.world.alive.sum()),
               rows=sorted(set().union(*(set(r) for _, r in per_rank))),
               build_s=t_build, sharded_s=t_frames, turns=turns)
    log(f"multigpu_torch({mesh.size} ranks, {mesh.device.type}, "
        f"{rec['route']}): image {tuple(img.shape)}, {rec['alive']} "
        f"entities, world rows a rank {rec['rows']} (capacity "
        f"{eng.config.capacity} / {mesh.size}), bands of {rec['band_rows']} "
        f"rows; {frames} frames, each frame's u8 image hash and world hash "
        f"on every rank equal to one device's Engine.frame: "
        f"{rec['frames_equal']}; last frame: max diff "
        f"{rec['max_diff']:.2e}, {rec['share_differing']:.4%} pixels differ;"
        f" u8 hash sharded={rec['u8_hash_sharded']} single="
        f"{rec['u8_hash_single']}; world hash of every rank "
        f"{sorted({h[:16] for h in rank_hashes})} single="
        f"{rec['world_hash_single'][:16]}; {frames} sharded frames in "
        f"{t_frames:.2f} s, the kernels' first build and the captures "
        "included")
    if not all(rec["frames_equal"]):
        raise RuntimeError("a rank's frame differs from one device's: "
                           f"{rec['frames_equal']}")
    cap = eng.config.capacity
    if rec["rows"] != [cap // mesh.size if cap % mesh.size == 0 else cap]:
        raise RuntimeError(f"world rows a rank {rec['rows']}")
    if not torch.equal(img, ref):
        raise RuntimeError("the sharded image differs from one device's")
    rec["image"] = img.cpu()
    rec["scale"] = scale_rec
    return rec


class EagerRoute:
    """``sharded_frame`` frame by frame over this rank's rows, in the
    shape of ``ShardedPrograms``' frame API (the ``--eager`` route)."""

    def __init__(self, eng, mesh):
        from render_engine_tpu_torch.parallel import shard_step, shard_world
        from render_engine_tpu_torch.runtime.engine import config_step

        self.eng, self.mesh = eng, mesh
        self.stepped = shard_step(config_step(eng.config), mesh)
        self.rows = shard_world(eng.world, mesh)
        self._prev = np.zeros_like(eng._prev_keys)
        self.frame_index = 0

    def frame(self, inputs=None, dt=DT):
        from render_engine_tpu_torch.logic.types import InputState
        from render_engine_tpu_torch.parallel import gather_image

        if inputs is None:
            inputs = InputState.idle(self.frame_index)
        self.frame_index += 1
        inputs = inputs.with_prev(self._prev)
        self._prev = np.asarray(inputs.keys, bool)
        self.rows, band, _ = sharded_frame(self.eng, self.mesh, self.stepped,
                                           self.rows, inputs, dt)
        return gather_image(band, self.mesh, self.eng.config.render.height)

    @property
    def world(self):
        return self.eng.world


TURNS = ("captured", "single", "eager", "eager", "single", "captured")
TURN_FRAMES = 6


def frame_turns(mesh, eng, log=print):
    """ms a frame in turns (``TURNS``, ``TURN_FRAMES`` frames a turn) on
    every rank: the captured sharded frame (``ShardedPrograms``), one
    card's captured ``Engine.frame`` (each rank on its own card) and the
    eager sharded frame; then the programs' capture seconds and graph pool
    MiB. Every program is met before the turns begin. Returns rank 0's
    record."""
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.parallel import ShardedPrograms
    from render_engine_tpu_torch.runtime.profiling import (graph_pool_bytes,
                                                           turn_medians)

    eng.reset()
    eng.config.render = dataclasses.replace(eng.config.render,
                                            **PARITY_BUDGETS)
    progs = ShardedPrograms(eng, mesh)
    warm = frames_needed(eng)
    for i in range(warm):  # every program captured
        progs.frame(InputState.idle(i), DT)
        eng.frame(InputState.idle(i), DT)
    eager = EagerRoute(eng, mesh)
    routes = {"captured": progs.frame, "single": eng.frame,
              "eager": eager.frame}
    at = {"which": None}
    meds, _ = turn_medians(
        lambda: routes[at["which"]](None, DT), TURNS,
        lambda which: at.update(which=which), frames=TURN_FRAMES,
        device=mesh.device, log=log if mesh.rank == 0 else (lambda *a: None),
        label="multigpu_torch turns",
        what=f"{mesh.size} ranks, a frame of the headline's engine, ")
    secs = progs.capture_seconds()
    rec = dict(ms=meds, capture_s=sum(secs.values()), programs=len(secs),
               pool_mib=graph_pool_bytes(progs._pool) / 2 ** 20,
               single_pool_mib=graph_pool_bytes(eng._pool) / 2 ** 20,
               collectives={k[0]: collectives(progs, k)
                            for k in (("step",), ("frame", "map"))})
    if mesh.rank == 0:
        log(f"multigpu_torch turns: {len(secs)} sharded programs captured in "
            f"{rec['capture_s']:.2f} s (two warm-ups each included), graph "
            f"pool {rec['pool_mib']:.1f} MiB a rank (one card's Engine: "
            f"{rec['single_pool_mib']:.1f} MiB); collectives a rank in the "
            f"step and the frame programs: {rec['collectives']}")
    return rec


def collectives(progs, key):
    """The collectives one eager run of the program ``key``'s function
    issues on this rank (``CommDebugMode``, on a copy of the state): the
    count by operation."""
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as comms:
        progs.program_function(key)(progs._state.clone())
    return {str(k): v for k, v in comms.get_comm_counts().items()}


def _gloo_rank(rank, n_ranks, store, kw, frames, eager, out):
    """One spawned CPU rank: join the gloo group, ``run``, and have rank 0
    save its record to ``out``."""
    import torch
    import torch.distributed as dist

    from render_engine_tpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n_ranks, rank=rank)
    try:
        rec = run(make_mesh(n_ranks), kw, frames, eager)
        if rec is not None and out is not None:
            torch.save(rec, out)
    finally:
        dist.destroy_process_group()


def run_gloo(n_ranks, kw=None, frames=1, eager=False, out=None):
    """``n_ranks`` spawned CPU processes in a gloo group running ``run``
    for ``frames`` frames (None: ``frames_needed``); rank 0's record goes
    to ``out`` (a path) when given."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_gloo_rank, args=(n_ranks, os.path.join(tmp, "store"),
                                   kw or cpu_kw(n_ranks), frames, eager,
                                   out),
                 nprocs=n_ranks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL, one card a rank, under "
                         "torchrun) or cpu (gloo, --ranks processes)")
    ap.add_argument("--ranks", type=int, default=4,
                    help="CPU processes with --device cpu")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames to hold to one device (default: the "
                         "shadow update interval x slots + 1, so that "
                         "every program is met and one replayed)")
    ap.add_argument("--eager", action="store_true",
                    help="step and render eagerly (shard_step, "
                         "render_frame_sharded) instead of through the "
                         "captured programs (ShardedPrograms)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        run_gloo(args.ranks, frames=args.frames, eager=args.eager)
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
        run(mesh, CARD_KW, args.frames, args.eager)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
