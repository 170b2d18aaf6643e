"""The partitioned step (``render_engine_tpu_torch.parallel.shard_step``)
over gloo groups of spawned CPU processes, mirroring
``tests/test_parallel.py``'s sharded step: each rank steps its
``capacity / n`` rows of the world, the demo's callbacks unchanged.

The ranks run once for the module (``tests/torch_ranks.py``
``partitioned``): at 2, 4 and 8 ranks the demo at tests/test_parallel.py's
size for 4 frames and the crossing world for 2 steps (a spawn landing on
another rank, a collision pair across ranks, the user on the last rank, an
owned-entity despawn running across ranks, the collision query budget
overflowing, mines referencing their parents), the same world with an
asteroid callback that writes ``col[rows] = v`` by global row numbers
(``written``), and writes by row number straight into split columns; at
8 ranks also the bench's scale (10k asteroids at capacity 16384) and a
capacity 8 ranks do not divide.

Tolerances:
* against the port's unsharded step (``make_step`` in this process): bit
  for bit, ``torch.equal`` on every column, the camera vector and the six
  counters, and equal world hashes;
* against the JAX package's sharded step on its 8-device CPU mesh
  (``jax.jit(step, in_shardings=(world_sharding, rep, rep, rep))``):
  integer columns, ``alive`` and the counters exact, float columns rtol
  1e-5 / atol 1e-4 (tests/test_torch_programs.py: XLA's and PyTorch's
  sin and cos differ by one ulp).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

from render_engine_tpu.demo import space_scene as JS
from render_engine_tpu.ecs import changes as JC
from render_engine_tpu.ecs import world as JW
from render_engine_tpu.logic.step import make_step as make_jax_step
from render_engine_tpu.logic.types import InputState as JInput
from render_engine_tpu.logic.types import OOB_DELETE as J_OOB_DELETE
from render_engine_tpu.parallel.mesh import make_mesh as make_jax_mesh
from render_engine_tpu.parallel.mesh import world_sharding as jax_sharding
from render_engine_tpu_torch.ecs import world as W
from render_engine_tpu_torch.parallel import columns
from render_engine_tpu_torch.utils.hashing import world_hash

import torch_ranks as TR
from torch_threads import one_torch_thread  # noqa: F401

RANKS = (2, 4, 8)
JOBS = {2: ("demo", "crossing", "written"),
        4: ("demo", "crossing", "written"),
        8: ("demo", "crossing", "written", "scale", "odd")}


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory):
    """Every rank count's record: one spawn of 8 CPU processes, whose
    first 2, first 4 and all 8 form a gloo group each
    (``torch_ranks.partitioned``)."""
    tmp = tmp_path_factory.mktemp("partitioned")
    out = str(tmp / "rec.pt")
    mp.spawn(TR.partitioned, args=(8, str(tmp / "store"), JOBS, out),
             nprocs=8)
    return torch.load(out)


@pytest.fixture(scope="module")
def unsharded():
    """Each job through the port's unsharded step in this process."""
    out = {}
    for name in ("demo", "crossing", "written", "scale", "odd"):
        world, camera, (mn, mx), step, frames = TR.job(name)
        out[name] = TR.drive(world, camera, frames,
                             lambda w, c, i, d, step=step, mn=mn, mx=mx:
                             step(w, c, i, d, mn, mx))
    return out


def assert_equal_to_unsharded(rec, ref):
    assert len(rec["frames"]) == len(ref)
    for f, (got, (world, camv, stats)) in enumerate(zip(rec["frames"], ref)):
        want = columns(world)
        assert got["columns"].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got["columns"][k], v), (f, k)
        assert got["hash"] == world_hash(world), f
        assert torch.equal(got["camera"], camv), f
        assert got["stats"] == stats, f


def assert_split(rec, frames):
    """No hidden replication: on every rank, each per-entity column is
    placed ``Shard(0)`` where ``apply_changeset`` begins, where its spawn
    drain begins (after the masked writes and the owned cascade), where
    it ends, and where the step body returns, before ``shard_step``
    places the columns back; the per-type updates' values and masks are
    ``Shard(0)`` too; in each of ``frames`` steps."""
    for r in rec["ranks"]:
        assert r["unsplit"] == [("entry", []), ("updates", []),
                                ("drain", []), ("exit", []),
                                ("step", [])] * frames


@pytest.mark.parametrize("n_ranks", RANKS)
def test_partitioned_demo_equals_unsharded(partitioned, unsharded, n_ranks):
    """tests/test_parallel.py's ``test_sharded_step_runs`` and
    ``test_sharded_matches_single_device``: the demo at its size over 4
    frames (idle, W held, W with mouse look), every rank holding
    ``capacity / n`` rows after each frame."""
    rec = partitioned[n_ranks]["demo"]
    assert_equal_to_unsharded(rec, unsharded["demo"])
    rows = TR.PAR_KW["capacity"] // n_ranks
    for r in rec["ranks"]:
        assert all(set(h.values()) == {rows} for h in r["held"])
        # K.integrate once and K.refresh_transforms twice a frame
        assert r["seen"] == [rows] * 4 * 3
    assert_split(rec, 4)


CROSSING_CASES = ("spawn_lands_on_another_rank", "pair_across_ranks",
                  "user_on_the_last_rank", "cascade_across_ranks",
                  "query_budget_overflows", "reference_added_along_rows")


@pytest.mark.parametrize("case", CROSSING_CASES)
@pytest.mark.parametrize("n_ranks", RANKS)
def test_crossing_world_equals_unsharded(partitioned, unsharded, n_ranks,
                                         case):
    """The crossing world (``torch_ranks.crossing_world``): the case's
    event happens in the unsharded step with its rows on different ranks,
    and the partitioned step equals the unsharded one bit for bit, every
    column staying ``Shard(0)`` through the change set."""
    C = TR.CROSS
    rows = TR.CROSS_KW["capacity"] // n_ranks

    def rank_of(row):
        return row // rows

    world, camv, stats = unsharded["crossing"][0]
    if case == "spawn_lands_on_another_rank":
        assert bool(world.alive[C["free"]])
        assert int(world["type_id"][C["free"]]) == 4  # a mine
        assert rank_of(C["free"]) != rank_of(C["producer"])
    elif case == "pair_across_ranks":
        # the wormhole's impulse on the user, (0, 0, -1) * 120
        assert world["velocity"][C["user"]].tolist() == [0.0, 0.0, -120.0]
        assert rank_of(C["wormhole"]) != rank_of(C["user"])
    elif case == "user_on_the_last_rank":
        assert rank_of(C["user"]) == n_ranks - 1 or n_ranks < 8
        assert rank_of(C["user"]) != 0
        after = unsharded["crossing"][1]
        assert torch.equal(after[1][:3], after[0]["position"][C["user"]])
    elif case == "cascade_across_ranks":
        chain = ("oob_mine", "station", "grandchild", "great_grandchild")
        assert stats["oob_killed"] == 1
        assert not any(bool(world.alive[C[k]]) for k in chain)
        assert len({rank_of(C[k]) for k in chain}) > 1
    elif case == "query_budget_overflows":
        assert stats["collision_query_dropped"] == 77
    else:
        # mines reference their parents (torch_ranks.mine_reference_logic):
        # an argmax along each row of ref_edges, with no collective, and
        # ref_edges stays Shard(0) (assert_split)
        for child, parent in (("grandchild", "station"),
                              ("great_grandchild", "grandchild")):
            assert world["ref_edges"][C[child]].tolist() == \
                [C[parent], -1, -1, -1]
        for r in partitioned[n_ranks]["crossing"]["ranks"]:
            assert r["comms"] == [0, 0]
    assert_equal_to_unsharded(partitioned[n_ranks]["crossing"],
                              unsharded["crossing"])
    assert_split(partitioned[n_ranks]["crossing"], 2)


def test_scale_partitions_the_entity_axis(partitioned, unsharded):
    """tests/test_parallel.py's ``test_sharded_step_scale_partitions_
    entity_axis``: 10k asteroids at capacity 16384 over 8 ranks. Every
    rank holds 2048 rows of every column after the step, ``K.integrate``
    and both ``K.refresh_transforms`` saw 2048 local rows, and the world
    equals the unsharded step."""
    rec = partitioned[8]["scale"]
    assert len(rec["ranks"]) == 8
    for r in rec["ranks"]:
        assert set(r["held"][0].values()) == {2048}
        assert r["seen"] == [2048, 2048, 2048]
    assert_split(rec, 1)
    assert_equal_to_unsharded(rec, unsharded["scale"])
    assert int(rec["frames"][0]["columns"]["alive"].sum()) == 10006


@pytest.mark.parametrize("n_ranks", RANKS)
def test_index_put_into_a_split_column(partitioned, unsharded, jax_written,
                                       n_ranks):
    """A write by global row numbers into a column placed ``Shard(0)``
    lands on the rank that owns each row, as JAX's ``col.at[rows].set(v)``
    on a world sharded by entity. Directly (``torch_ranks.
    _index_put_writes``): ``col[rows] = v``, ``m[rows, 1] = v`` and
    ``index_put_`` with ``accumulate``, rows on two ranks, each rank
    keeping its rows and the placement. In the step: the crossing world
    with ``torch_ranks.writing_asteroid_logic`` (``vel[rows] = v``,
    ``hit[rows] = True``, rows on several ranks) equals the unsharded step
    bit for bit, every column staying ``Shard(0)``, and the JAX package's
    sharded step with the same callback written with ``.at[].set``."""
    from torch.distributed.tensor import Shard

    rec = partitioned[n_ranks]["index_put"]
    n = 4 * n_ranks
    base = torch.cat([torch.arange(4.0) + 10.0 * r for r in range(n_ranks)])
    rows = torch.tensor([1, n - 1, 6])
    col, mat, acc = base.clone(), torch.stack([base, -base], 1), base.clone()
    col[rows] = torch.tensor([-1.0, -2.0, -3.0])
    mat[rows, 1] = 7.0
    acc.index_put_((rows,), torch.ones(3), accumulate=True)
    for name, want in (("col", col), ("mat", mat), ("acc", acc)):
        assert torch.equal(rec[name]["whole"], want), name
        assert torch.equal(rec[name]["local"], want[:4]), name
        assert rec[name]["placements"] == (str(Shard(0)),), name

    world, _, _ = unsharded["written"][0]
    assert torch.equal(world["velocity"][list(TR.WRITTEN_ROWS)],
                       torch.tensor(TR.WRITTEN_VELOCITY))
    row_ranks = {r // (TR.CROSS_KW["capacity"] // n_ranks)
                 for r in TR.WRITTEN_ROWS}
    assert len(row_ranks) == min(n_ranks, 4)
    assert_equal_to_unsharded(partitioned[n_ranks]["written"],
                              unsharded["written"])
    assert_split(partitioned[n_ranks]["written"], 2)
    assert_close_to_jax(partitioned[n_ranks]["written"]["frames"],
                        jax_written, TR.CROSS_KW["capacity"] // 8)


def test_capacity_the_ranks_do_not_divide(partitioned, unsharded):
    """Capacity 60 over 8 ranks: the world stays whole on every rank and
    is stepped whole, equal to the unsharded step."""
    rec = partitioned[8]["odd"]
    for r in rec["ranks"]:
        assert all(set(h.values()) == {60} for h in r["held"])
        assert set(r["seen"]) == {60}
    assert_equal_to_unsharded(rec, unsharded["odd"])


def jax_sharded_crossing(logic):
    """The crossing world, from the same numpy snapshot as the ranks',
    through the JAX package's step with the mines' reference callback and
    ``logic`` (type index -> callback) jitted with ``in_shardings=(
    world_sharding, rep, rep, rep)`` on its 8-device CPU mesh, 2 steps:
    per step the world, the camera, the counters and a shard's rows."""
    if len(jax.devices()) < 8:
        pytest.fail(f"the JAX CPU mesh has {len(jax.devices())} devices")
    world_t, _, _, _, frames = TR.job("crossing")
    jeng = JS.build_space_engine(**TR.CROSS_KW)

    def mine_reference_logic(world, dt, mask, cs):
        parent = world["parent"]
        return JC.with_add_reference(cs, world, mask & (parent >= 0), parent)

    logic = {JS.TYPE_MINE: mine_reference_logic, **logic}
    types = tuple(dataclasses.replace(
        t, logic=logic[t.index], out_of_bounds=(
            J_OOB_DELETE if t.index == JS.TYPE_MINE else t.out_of_bounds))
        if t.index in logic else t for t in JS.ENTITY_TYPES)
    cfg = jeng.config
    step = make_jax_step(types, logic_radius=cfg.logic_radius,
                         spawn_budget=cfg.spawn_budget,
                         collision_budget=cfg.collision_budget,
                         collision_pairs=cfg.collision_pairs,
                         collision_large_budget=cfg.collision_large_budget,
                         with_stats=True)
    bank = jeng.bank
    mesh = make_jax_mesh(8)
    world = JW.restore(jeng.world.config, W.snapshot(world_t))
    wsh = jax_sharding(world, mesh)
    rep = NamedSharding(mesh, P())
    fn = jax.jit(lambda w, c, i, d: step(w, c, i, d, bank.aabb_min,
                                         bank.aabb_max),
                 in_shardings=(wsh, rep, rep, rep))
    world, camera = jax.device_put(world, wsh), jeng.camera
    prev, out = None, []
    for f in range(frames):
        inputs = JInput.deserialize(TR.frame_inputs(f).serialize())
        if prev is not None:
            inputs = inputs.with_prev(prev)
        prev = np.asarray(inputs.keys, bool)
        with mesh:
            world, camera, stats = fn(world, camera, inputs,
                                      jnp.float32(TR.DT))
        out.append((world, camera, stats, world.comps["position"]
                    .addressable_shards[0].data.shape[0]))
    return out


def assert_close_to_jax(rec, jax_steps, shard_rows):
    """Each step of a rank record against the JAX package's: integer
    columns, ``alive`` and the counters exact, floats rtol 1e-5 / atol
    1e-4, the camera rtol / atol 1e-5; the JAX world split into
    ``shard_rows`` rows a device."""
    reg = TR.job("crossing")[0].config.registry
    assert len(rec) == len(jax_steps)
    for f, (world, camera, stats, rows) in enumerate(jax_steps):
        assert rows == shard_rows
        got = rec[f]["columns"]
        np.testing.assert_array_equal(got["alive"].numpy(),
                                      np.asarray(world.alive))
        np.testing.assert_array_equal(
            got["comp_mask"].numpy().view(np.uint32),
            np.asarray(world.comp_mask))
        for k, v in world.comps.items():
            want = np.asarray(v)
            have = got[k].numpy()
            if reg.specs[reg.slot(k)].dtype == "float32":
                np.testing.assert_allclose(have, want, rtol=1e-5,
                                           atol=1e-4, err_msg=k)
            else:
                np.testing.assert_array_equal(have.view(want.dtype), want,
                                              err_msg=k)
        np.testing.assert_allclose(rec[f]["camera"].numpy(),
                                   np.asarray(camera.serialize()),
                                   rtol=1e-5, atol=1e-5)
        assert rec[f]["stats"] == {k: int(v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def jax_written():
    """``jax_sharded_crossing`` with the asteroids' orbit followed by the
    write ``torch_ranks.writing_asteroid_logic`` makes, as ``.at[].set``."""
    rows = jnp.asarray(TR.WRITTEN_ROWS)

    def writing_asteroid_logic(world, dt, mask, cs):
        cs = JS.asteroid_orbit_logic(world, dt, mask, cs)
        vel = world["velocity"].at[rows].set(
            jnp.asarray(TR.WRITTEN_VELOCITY, jnp.float32))
        hit = jnp.zeros_like(mask).at[rows].set(True)
        return JC.with_update(cs, "velocity", vel, hit)

    return jax_sharded_crossing({JS.TYPE_ASTEROID: writing_asteroid_logic})


def test_partitioned_step_matches_the_jax_sharded_step(partitioned):
    """The crossing world, from the same numpy snapshot, through the JAX
    package's step jitted with ``in_shardings=(world_sharding, rep, rep,
    rep)`` on its 8-device CPU mesh and through the port's 8 gloo ranks,
    2 steps."""
    assert_close_to_jax(partitioned[8]["crossing"]["frames"],
                        jax_sharded_crossing({}),
                        TR.CROSS_KW["capacity"] // 8)
