"""Bodies of spawned CPU ranks for tests/test_torch_parallel.py. They live
apart from the test module so that a spawned process imports torch and the
port only (spawn pickles a target by module and name)."""

import dataclasses

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


# --- the partitioned step (tests/test_torch_partitioned_step.py) ---------

DT = 1.0 / 60.0
# tests/test_parallel.py's engine
PAR_KW = dict(width=128, height=64, capacity=64, num_asteroids=8,
              max_tris=1024)
CROSS_KW = dict(PAR_KW, capacity=2048)
# the crossing world's rows: every one of them sits on a rank of its own
# at 2, 4 and 8 ranks except where the comment says
CROSS = dict(free=1, wormhole=3, oob_mine=600, grandchild=100,
             great_grandchild=1300, producer=1500, station=1800,
             user=1792)  # the user: the last rank's first row at 8 ranks
SWARM = 1100  # moving collidable mines near the camera, past the query
#               budget of 1024


def frame_inputs(i):
    """Frame ``i``'s host inputs: idle, then W held, then W with mouse
    look (tests/test_torch_engine.py's sequence)."""
    from render_engine_tpu_torch.logic.types import KEY_W, InputState

    base = InputState.idle(i)
    if i == 0:
        return base
    keyed = base.with_keys(KEY_W)
    if i == 1:
        return keyed
    return dataclasses.replace(
        keyed, mouse_delta=np.array([0.02, -0.01], np.float32))


# the collectives each call of mine_reference_logic issued
REFERENCE_COMMS = []


def mine_reference_logic(world, dt, mask, cs):
    """Each mine with a parent adds a reference to it
    (``with_add_reference``: the first free slot of each row's
    ``ref_edges`` by an ``argmax`` along the row, which needs no other
    rank's rows). Counts its collectives into ``REFERENCE_COMMS``."""
    from torch.distributed.tensor.debug import CommDebugMode

    from render_engine_tpu_torch.ecs import changes as C

    parent = world["parent"]
    with CommDebugMode() as comms:
        cs = C.with_add_reference(cs, world, mask & (parent >= 0), parent)
    REFERENCE_COMMS.append(comms.get_total_counts())
    return cs


def crossing_types():
    """The demo's entity types, with mines deleted out of bounds (the
    demo never despawns; the owned-entity cascade needs a death) and
    referencing their parents (``mine_reference_logic``)."""
    from render_engine_tpu_torch.demo import space_scene as TS
    from render_engine_tpu_torch.logic.types import OOB_DELETE

    return tuple(dataclasses.replace(t, out_of_bounds=OOB_DELETE,
                                     logic=mine_reference_logic)
                 if t.index == TS.TYPE_MINE else t
                 for t in TS.ENTITY_TYPES)


# rows the writing callback sets by global row number: at 2, 4 and 8 ranks
# they lie on 2, 4 and 4 ranks (swarm mines, the producer, a swarm mine)
WRITTEN_ROWS = (20, 700, 1500, 1950)
WRITTEN_VELOCITY = ((0.0, 0.0, 5.0), (0.0, -2.5, 0.0), (1.5, 0.0, 0.0),
                    (-3.0, 0.0, 4.0))


def writing_asteroid_logic(world, dt, mask, cs):
    """The asteroids' orbit, and then a write by global row numbers into
    per-entity columns, JAX's ``col.at[rows].set(v)``: the velocity of
    the rows ``WRITTEN_ROWS`` and the mask that queues it."""
    from render_engine_tpu_torch.demo import space_scene as TS
    from render_engine_tpu_torch.ecs import changes as C

    cs = TS.asteroid_orbit_logic(world, dt, mask, cs)
    rows = torch.tensor(WRITTEN_ROWS)
    vel = world["velocity"].clone()
    vel[rows] = torch.tensor(WRITTEN_VELOCITY)
    hit = torch.zeros_like(mask)
    hit[rows] = True
    return C.with_update(cs, "velocity", vel, hit)


def writing_types():
    """``crossing_types`` with the asteroids' ``writing_asteroid_logic``."""
    from render_engine_tpu_torch.demo import space_scene as TS

    return tuple(dataclasses.replace(t, logic=writing_asteroid_logic)
                 if t.index == TS.TYPE_ASTEROID else t
                 for t in crossing_types())


def crossing_world(eng, seed=3):
    """The demo scene at capacity 2048 with its rows moved and entities
    added so that one step crosses ranks everywhere it can: the wormhole
    (row 3) overlaps the user (row 1792, the last rank); the producer
    (row 1500) fires this step and its mine lands in the first free slot
    (row 1); a mine out of the world (row 600) is deleted and the death
    runs down its owned chain station (1800) -> mine (100) -> mine
    (1300); and 1100 moving mines near the camera (numpy seed ``seed``)
    overflow the collision query budget, so the global order decides
    which queries stay. AABBs are refreshed as ``finalize_scene`` does."""
    from render_engine_tpu_torch.demo import space_scene as TS
    from render_engine_tpu_torch.ecs import registry as R
    from render_engine_tpu_torch.ecs import world as W
    from render_engine_tpu_torch.logic import kinematics as K

    demo = eng.world
    snap = W.snapshot(demo)
    cap = demo.capacity
    # the demo's rows: stars 0-1, asteroids 2-9, wormhole 10, producer 11,
    # station 12, user 13
    moved = {0: 0, 1: 2, **{2 + i: 4 + i for i in range(8)},
             10: CROSS["wormhole"], 11: CROSS["producer"],
             12: CROSS["station"], 13: CROSS["user"]}
    empty = W.snapshot(W.create_world(demo.config))
    out = {"alive": empty["alive"].copy(),
           "comp_mask": empty["comp_mask"].copy(),
           "comps": {k: v.copy() for k, v in empty["comps"].items()}}

    def put(dst, src_snap, src):
        out["alive"][dst] = src_snap["alive"][src]
        out["comp_mask"][dst] = src_snap["comp_mask"][src]
        for k, v in out["comps"].items():
            v[dst] = src_snap["comps"][k][src]

    for src, dst in moved.items():
        put(dst, snap, src)
    c = out["comps"]
    c["position"][CROSS["wormhole"]] = (1000.0, 1000.0, 1146.0)
    c["spawn_timer"][CROSS["producer"]] = 3.999
    c["parent"][CROSS["station"]] = CROSS["oob_mine"]

    reg = demo.config.registry
    rng = np.random.default_rng(seed)
    used = set(moved.values()) | {CROSS["free"], CROSS["oob_mine"],
                                  CROSS["grandchild"],
                                  CROSS["great_grandchild"]}
    # most of the swarm below the user's row, a tail above it: the user
    # stays among the 1024 queries kept, the tail's last rows are dropped
    swarm = [r for r in range(12, cap) if r not in used
             and not (1011 < r < 1900)][:SWARM]
    mine_bits = R.as_bits(reg.bits("position", "velocity", "scale",
                                   "type_id", "model_id", "flags"))
    mine_model = TS._MINE_MODEL[0]

    def mine(row, pos, vel, parent=-1):
        out["alive"][row] = True
        out["comp_mask"][row] = np.uint32(mine_bits & 0xFFFFFFFF)
        c["position"][row] = pos
        c["velocity"][row] = vel
        c["scale"][row] = (0.4, 0.4, 0.4)
        c["type_id"][row] = TS.TYPE_MINE
        c["model_id"][row] = mine_model
        c["flags"][row] = R.FLAG_COLLIDABLE
        c["parent"][row] = parent

    pos = (np.array([1000.0, 1000.0, 1060.0])
           + rng.uniform(-70.0, 70.0, (len(swarm), 3))).astype(np.float32)
    vel = rng.uniform(-3.0, 3.0, (len(swarm), 3)).astype(np.float32)
    for i, row in enumerate(swarm):
        mine(row, pos[i], vel[i])
    mine(CROSS["oob_mine"], (-50.0, 1000.0, 1000.0), (0.0, 0.0, 0.0))
    mine(CROSS["grandchild"], (500.0, 500.0, 500.0), (0.0, 0.0, 0.0),
         parent=CROSS["station"])
    mine(CROSS["great_grandchild"], (520.0, 500.0, 500.0), (0.0, 0.0, 0.0),
         parent=CROSS["grandchild"])
    w = W.restore(demo.config, out)
    return K.refresh_transforms(w, eng.bank.aabb_min, eng.bank.aabb_max,
                                w.alive)


def job(name):
    """(world, camera, bank boxes, step, frames) of a named case: the
    demo at PAR_KW (4 frames), the crossing world (2 steps; ``written``:
    the same with ``writing_types``), the bench's scale (10k asteroids at
    capacity 16384, 1 step) and the demo at a capacity 8 ranks do not
    divide (60, 2 frames)."""
    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.runtime.engine import config_step

    kw = {"demo": PAR_KW, "crossing": CROSS_KW, "written": CROSS_KW,
          "scale": dict(PAR_KW, capacity=16384, num_asteroids=10000,
                        max_tris=2048),
          "odd": dict(PAR_KW, capacity=60)}[name]
    eng = build_space_engine(device="cpu", **kw)
    world, cfg = eng.world, eng.config
    if name in ("crossing", "written"):
        world = crossing_world(eng)
        cfg = dataclasses.replace(cfg, entity_types=(
            crossing_types() if name == "crossing" else writing_types()))
    frames = {"demo": 4, "crossing": 2, "written": 2, "scale": 1,
              "odd": 2}[name]
    return (world, eng.camera, (eng.bank.aabb_min, eng.bank.aabb_max),
            config_step(cfg), frames)


def drive(world, camera, frames, stepper):
    """``frames`` steps of ``stepper(world, camera, inputs, dt)`` on
    ``frame_inputs``; per frame the world, the camera vector and the
    counters."""
    from render_engine_tpu_torch.logic.step import (pack_drop_stats,
                                                    unpack_drop_stats)

    out, prev = [], None
    for i in range(frames):
        inputs = frame_inputs(i)
        if prev is not None:
            inputs = inputs.with_prev(prev)
        prev = np.asarray(inputs.keys, bool)
        world, camera, stats = stepper(
            world, camera, inputs.to_device("cpu"),
            torch.tensor(np.float32(DT)))
        out.append((world, camera.serialize(),
                    unpack_drop_stats(pack_drop_stats(stats))))
    return out


def partitioned(rank, n_ranks, store, plan, out):
    """One of ``n_ranks`` spawned CPU ranks: for each rank count ``n`` of
    ``plan`` (``{n: job names}``), the first ``n`` ranks step the jobs
    partitioned over a gloo group of their own. Rank 0 saves, per rank
    count and job, each frame's gathered columns, world hash, camera
    vector and counters, and every rank's rows of every column after each
    frame, the rows ``K.integrate`` and ``K.refresh_transforms`` saw, the
    per-entity columns and change-set updates not placed ``Shard(0)``
    where ``apply_changeset`` begins, the columns not so placed where its
    spawn drain begins (after the masked writes and the owned cascade)
    and where it ends, and the collectives of ``mine_reference_logic``."""
    from torch.distributed.tensor import DTensor, Shard

    from render_engine_tpu_torch.ecs import changes as C
    from render_engine_tpu_torch.logic import kinematics as K
    from render_engine_tpu_torch.parallel import Mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n_ranks, rank=rank)
    seen, unsplit = [], []

    def counted(fn):
        def wrapped(world, *a, **kw):
            t = world["position"]
            seen.append(t.to_local().shape[0] if isinstance(t, DTensor)
                        else t.shape[0])
            return fn(world, *a, **kw)
        return wrapped

    def placed(fn, at):
        def wrapped(world, *a):
            split = isinstance(world.alive, DTensor)
            if split:
                unsplit.append((at, not_split(world)))
            if split and at == "entry":  # the per-type updates' values
                unsplit.append(("updates", sorted(
                    k for k, (v, m) in a[0].updates.items()
                    if (v.placements, m.placements) != ((Shard(0),),) * 2)))
            out = fn(world, *a)
            if split and at == "entry":
                unsplit.append(("exit", not_split(out)))
            return out
        return wrapped

    K.integrate = counted(K.integrate)
    K.refresh_transforms = counted(K.refresh_transforms)
    C.apply_changeset = placed(C.apply_changeset, "entry")
    C._drain_spawns = placed(C._drain_spawns, "drain")
    try:
        recs = {}
        for n, names in plan.items():
            group = dist.new_group(list(range(n)))
            if rank >= n:
                continue
            mesh = Mesh(axis_name="world", size=n, rank=rank,
                        device=torch.device("cpu"), group=group)
            recs[n] = {name: _partitioned_job(name, mesh, seen, unsplit)
                       for name in names}
            recs[n]["index_put"] = _index_put_writes(mesh)
        if rank == 0:
            torch.save(recs, out)
    finally:
        dist.destroy_process_group()


def _index_put_writes(mesh):
    """In-place writes by global row numbers into columns placed
    ``Shard(0)``, 4 rows a rank, under the partitioned step's mode
    (``parallel/step.py``): ``col[rows] = v`` into a vector, a row of a
    matrix's columns (``m[rows, 1] = v``) and ``index_put_`` with
    ``accumulate``; each rank's rows and the columns gathered whole, with
    the placements after the writes."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from render_engine_tpu_torch.parallel.step import (_device_mesh,
                                                       _GlobalRows,
                                                       _register_rules)

    _register_rules()
    dmesh = _device_mesh(mesh)
    base = torch.arange(4.0) + 10.0 * mesh.rank

    def split(t):
        return DTensor.from_local(t.clone(), dmesh, [Shard(0)],
                                  run_check=False)

    col, mat, acc = split(base), split(torch.stack([base, -base], 1)), \
        split(base)
    rows = torch.tensor([1, 4 * mesh.size - 1, 6])
    with implicit_replication(), _GlobalRows():
        col[rows] = torch.tensor([-1.0, -2.0, -3.0])
        mat[rows, 1] = 7.0
        acc.index_put_((rows,), torch.ones(3), accumulate=True)
    return {name: dict(local=t.to_local().clone(), whole=t.full_tensor(),
                       placements=tuple(map(str, t.placements)))
            for name, t in (("col", col), ("mat", mat), ("acc", acc))}


def not_split(world):
    """The per-entity columns of a partitioned ``world`` that are not
    placed ``Shard(0)``, by name."""
    from torch.distributed.tensor import Shard

    from render_engine_tpu_torch.parallel import columns

    return sorted(k for k, v in columns(world).items()
                  if tuple(v.placements) != (Shard(0),))


def _partitioned_job(name, mesh, seen, unsplit):
    """Job ``name`` stepped partitioned over ``mesh``; ``seen`` collects
    the rows the wrapped kinematics saw, ``unsplit`` the columns not
    placed ``Shard(0)`` in ``apply_changeset`` and at the end of the step
    body (before ``shard_step`` places every column back)."""
    from torch.distributed.tensor import DTensor

    from render_engine_tpu_torch.parallel import (columns, gather_world,
                                                  shard_step, shard_world)
    from render_engine_tpu_torch.utils.hashing import world_hash

    world, camera, (mn, mx), step, frames = job(name)

    def body(*args):
        out = step(*args)
        if isinstance(out[0].alive, DTensor):
            unsplit.append(("step", not_split(out[0])))
        return out

    stepped = shard_step(body, mesh)
    seen.clear()
    unsplit.clear()
    REFERENCE_COMMS.clear()
    out = drive(shard_world(world, mesh), camera, frames,
                lambda w, c, i, d: stepped(w, c, i, d, mn, mx))
    held = [{k: int(v.shape[0]) for k, v in columns(rows).items()}
            for rows, _, _ in out]
    frames_out = []
    for rows, camv, stats in out:
        whole = gather_world(rows, mesh)
        frames_out.append(dict(columns=columns(whole), hash=world_hash(whole),
                               camera=camv, stats=stats))
    per_rank = [None] * mesh.size
    dist.all_gather_object(per_rank, dict(held=held, seen=list(seen),
                                          unsplit=list(unsplit),
                                          comms=list(REFERENCE_COMMS)),
                           group=mesh.group)
    return dict(frames=frames_out, ranks=per_rank)


# --- the sharded programs (tests/test_torch_partitioned_programs.py) -----

def _state_record(st):
    """A ``ProgramState``'s buffers, cloned: this rank's rows, the camera
    vector, the shadow tables, the counters and the image."""
    from render_engine_tpu_torch.parallel import columns

    return dict(rows={k: v.clone() for k, v in columns(st.world).items()},
                camv=st.camv.clone(), drops=st.drops.clone(),
                shadow=None if st.shadow is None
                else tuple(t.clone() for t in st.shadow),
                image=st.image.clone())


def _same_record(a, b):
    return all(torch.equal(a["rows"][k], b["rows"][k]) for k in a["rows"]) \
        and all(torch.equal(a[k], b[k]) for k in ("camv", "drops", "image")) \
        and (a["shadow"] is None) == (b["shadow"] is None) and (
            a["shadow"] is None or all(torch.equal(x, y) for x, y in
                                       zip(a["shadow"], b["shadow"])))


def _without_host_traffic(fn, st):
    """``fn(st)`` under ``host_traffic.no_host_traffic``: None, or the
    refusal's message."""
    from host_traffic import no_host_traffic

    try:
        with no_host_traffic():
            fn(st)
    except AssertionError as e:
        return str(e)
    return None


def sharded_programs(rank, n_ranks, store, plan, frames, steps, out):
    """One of ``n_ranks`` spawned CPU ranks: for each rank count ``n`` of
    ``plan``, the first ``n`` ranks form a gloo group and run
    ``ShardedPrograms`` of the demo at ``multigpu_torch.cpu_kw(n)`` with
    ``multigpu_torch.PARITY_BUDGETS``: ``frames`` frames on
    ``frame_inputs``, then ``steps`` steps on the same inputs. Then, on a
    copy of the state, each program's function runs eagerly twice, the
    second time under ``no_host_traffic`` (a capture's warm-ups), and
    once more from the same copy. Rank 0 saves, per rank count, each
    frame's image, gathered columns, world hash, camera vector, counters
    and shadow state, each step's, the programs held, every rank's rows a
    column, and the eager runs' refusals and agreement."""
    import multigpu_torch as MG

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.step import unpack_drop_stats
    from render_engine_tpu_torch.parallel import (Mesh, ShardedPrograms,
                                                  columns)
    from render_engine_tpu_torch.utils.hashing import world_hash

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=n_ranks, rank=rank)
    try:
        recs = {}
        for n in plan:
            group = dist.new_group(list(range(n)))
            if rank >= n:
                continue
            mesh = Mesh(axis_name="world", size=n, rank=rank,
                        device=torch.device("cpu"), group=group)
            eng = build_space_engine(device="cpu", **MG.cpu_kw(n))
            eng.config.record_history = False
            eng.config.render = dataclasses.replace(eng.config.render,
                                                    **MG.PARITY_BUDGETS)
            progs = ShardedPrograms(eng, mesh)

            def record(img):
                whole, sh = progs.world, progs.shadow_state
                return dict(image=img, columns=columns(whole),
                            hash=world_hash(whole),
                            camera=progs.camera.serialize(),
                            stats=unpack_drop_stats(progs.drops),
                            shadow=(sh.maps, sh.light_mats, sh.slot_entity,
                                    sh.slot_face, sh.cursor, sh.tick))

            rec = dict(frames=[], steps=[])
            for i in range(frames):
                rec["frames"].append(record(progs.frame(frame_inputs(i),
                                                        DT)))
            for i in range(steps):
                progs.step(frame_inputs(i), DT)
                rec["steps"].append(record(None))
            rec["programs"] = sorted(progs.captured_programs, key=str)
            rec["rows"] = {k: int(v.shape[0])
                           for k, v in columns(progs.rows).items()}
            eager = {}
            for key in (("frame", "map"), ("step",)):
                fn = progs.program_function(key)
                st = progs._state.clone()
                first, second = st.clone(), st.clone()
                fn(first)
                refused = _without_host_traffic(fn, second)
                again = st.clone()
                fn(again)
                eager[key] = dict(
                    refused=refused,
                    same=_same_record(_state_record(first),
                                      _state_record(second))
                    and _same_record(_state_record(first),
                                     _state_record(again)),
                    changed=not _same_record(_state_record(first),
                                             _state_record(st)))
            rec["eager"] = eager
            per_rank = [None] * n
            dist.all_gather_object(per_rank, dict(rows=rec["rows"],
                                                  eager=eager), group=group)
            rec["ranks"] = per_rank
            recs[n] = rec
        if rank == 0:
            torch.save(recs, out)
    finally:
        dist.destroy_process_group()
