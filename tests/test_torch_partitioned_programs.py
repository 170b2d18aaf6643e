"""The multi-card frame as programs (``render_engine_tpu_torch.parallel.
ShardedPrograms``) over gloo groups of spawned CPU processes, at
``scripts/multigpu_torch.cpu_kw`` sizes with 2 and 4 ranks: the
partitioned step, the world gathered, the shadow update, this rank's band
and the bands joined, one program per shadow decision. On a CPU mesh the
programs' functions run eagerly; on cards the same functions are captured
(``chip_smoke.py`` phase 15).

The ranks run once for the module (``tests/torch_ranks.py``
``sharded_programs``): ``FRAMES`` frames, enough to meet every shadow
decision's program and run one of them again, then ``STEPS`` steps.

Tolerances:
* against the port's ``Engine.frame`` and ``Engine.step`` in this process
  at tile budgets 1.0: bit for bit (``torch.equal`` images, columns,
  camera vectors and counters, equal world hashes);
* against the JAX package's full frame (its step, shadow update and
  ``render_frame_sharded``, jitted with ``in_shardings=(world_sharding,
  rep, rep, rep, rep)`` on a CPU mesh of as many devices as ranks, the
  Pallas kernels interpreted): the image within the JAX package's limits
  (max abs diff < 0.03, at most 0.5% of the pixels beyond 1e-6); integer
  columns, ``alive`` and the counters exact, floats rtol 1e-5 / atol 1e-4
  (XLA's and PyTorch's sin and cos differ by one ulp); the shadow state
  as ``tests/test_torch_shadows.py`` holds it (schedule exact, light
  matrices 1e-5, maps within 1e-5 where both cover, coverage differing at
  no more than 0.5% of texels);
* a program's function run twice from one copy of the state: equal.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

from render_engine_tpu.demo import space_scene as JS
from render_engine_tpu.logic.step import make_step as make_jax_step
from render_engine_tpu.logic.types import InputState as JInput
from render_engine_tpu.parallel.mesh import make_mesh as make_jax_mesh
from render_engine_tpu.parallel.mesh import world_sharding as jax_sharding
from render_engine_tpu.parallel.render import (
    render_frame_sharded as render_jax_sharded)
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu.render import shadows as SHJ
from render_engine_tpu_torch.demo.space_scene import build_space_engine
from render_engine_tpu_torch.logic.step import unpack_drop_stats
from render_engine_tpu_torch.parallel import (GLOO_CUDA_REFUSED, Mesh,
                                              ShardedPrograms, columns)
from render_engine_tpu_torch.render import shadows as SHT
from render_engine_tpu_torch.utils.hashing import world_hash

import torch_ranks as TR
from test_torch_shadows import assert_state_close
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import multigpu_torch as MG  # noqa: E402

RANKS = (2, 4)
FRAMES = 7  # the demo's interval 1 x 6 slots + 1
STEPS = 2
# frames held to the JAX package (its Pallas kernels interpreted take
# about 5 s a frame): two decisions, slot 0 and slot 1
JAX_FRAMES = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank count's record: one spawn of 4 CPU processes, whose
    first 2 and all 4 form a gloo group each."""
    tmp = tmp_path_factory.mktemp("programs")
    out = str(tmp / "rec.pt")
    mp.spawn(TR.sharded_programs, args=(4, str(tmp / "store"), RANKS,
                                        FRAMES, STEPS, out), nprocs=4)
    return torch.load(out)


def engine(n_ranks):
    eng = build_space_engine(device="cpu", **MG.cpu_kw(n_ranks))
    eng.config.record_history = False
    eng.config.render = dataclasses.replace(eng.config.render,
                                            **MG.PARITY_BUDGETS)
    return eng


def same_shadow(got, sh):
    return all(torch.equal(a, b) for a, b in zip(
        got[:4], (sh.maps, sh.light_mats, sh.slot_entity, sh.slot_face))) \
        and got[4:] == (sh.cursor, sh.tick)


@pytest.mark.parametrize("n_ranks", RANKS)
def test_frames_equal_engine_frame(ranks, n_ranks):
    """Each frame's gathered image, world, camera, counters and shadow
    state equal one process's ``Engine.frame`` bit for bit; then the step
    program equals ``Engine.step``. Every shadow decision met has its
    program (slots 0 to 5), and every rank holds ``capacity / n`` rows of
    every column."""
    rec = ranks[n_ranks]
    eng = engine(n_ranks)
    for i, got in enumerate(rec["frames"]):
        img = eng.frame(TR.frame_inputs(i), TR.DT)
        assert torch.equal(got["image"], img), i
        assert got["hash"] == world_hash(eng.world), i
        for k, v in columns(eng.world).items():
            assert torch.equal(got["columns"][k], v), (i, k)
        assert torch.equal(got["camera"], eng.camera.serialize()), i
        assert got["stats"] == unpack_drop_stats(eng._last_drops), i
        assert same_shadow(got["shadow"], eng.shadow_state), i
    assert float(rec["frames"][-1]["image"].max()) > 0.5
    for i, got in enumerate(rec["steps"]):
        eng.step(TR.frame_inputs(i), TR.DT)
        assert got["hash"] == world_hash(eng.world), i
        assert torch.equal(got["camera"], eng.camera.serialize()), i
        assert got["stats"] == unpack_drop_stats(eng._last_drops), i
    assert rec["programs"] == sorted([("frame", "map"), ("step",)], key=str)
    cap = eng.config.capacity
    for r in rec["ranks"]:
        assert set(r["rows"].values()) == {cap // n_ranks}


@pytest.mark.parametrize("n_ranks", RANKS)
def test_program_functions_without_host_traffic(ranks, n_ranks):
    """The frame and step programs' functions, run eagerly on every rank
    from a copy of the state: the second run (as a capture's second
    warm-up) reads no tensor on the host and uploads nothing
    (``host_traffic.no_host_traffic``), and two runs from one copy give
    the same state, which the capture's warm-ups rely on."""
    for r in ranks[n_ranks]["ranks"]:
        for key, e in r["eager"].items():
            assert e["refused"] is None, (key, e["refused"])
            assert e["same"] and e["changed"], key


def jax_full_frames(n_ranks, frames):
    """The JAX package's full frame on a CPU mesh of ``n_ranks`` devices:
    its step, its shadow update and ``render_frame_sharded``, jitted with
    ``in_shardings=(world_sharding, rep, rep, rep, rep)``, ``frames``
    times on ``torch_ranks.frame_inputs``; per frame the world, the
    camera, the counters, the shadow state and the image."""
    if len(jax.devices()) < n_ranks:
        pytest.fail(f"the JAX CPU mesh has {len(jax.devices())} devices")
    ej = JS.build_space_engine(**MG.cpu_kw(n_ranks))
    cfg = ej.config
    settings = dataclasses.replace(cfg.render, backend="pallas",
                                   fused_shading=True, **MG.PARITY_BUDGETS)
    step = make_jax_step(tuple(cfg.entity_types),
                         logic_radius=cfg.logic_radius,
                         spawn_budget=cfg.spawn_budget,
                         collision_budget=cfg.collision_budget,
                         collision_pairs=cfg.collision_pairs,
                         collision_large_budget=cfg.collision_large_budget,
                         with_stats=True)
    bank, mesh = ej.bank, make_jax_mesh(n_ranks)

    def full_frame(world, camera, inputs, dt, shadow):
        world, camera, stats = step(world, camera, inputs, dt,
                                    bank.aabb_min, bank.aabb_max)
        shadow = SHJ.render_shadow_map(
            shadow, world, camera, bank, max_tris=cfg.shadow_max_tris,
            interval=cfg.shadow_update_interval,
            lov_bias=cfg.shadow_lov_bias,
            caster_mask=cfg.shadow_caster_mask)
        img = render_jax_sharded(
            world, camera, bank, settings, mesh, cubemap=ej.cubemap,
            atlas=ej.atlas, shadow_state=shadow, systems=ej.compiled_systems,
            inputs=inputs, interpret=True)
        return world, camera, stats, shadow, img

    wsh = jax_sharding(ej.world, mesh)
    rep = NamedSharding(mesh, P())
    fn = jax.jit(full_frame, in_shardings=(wsh, rep, rep, rep, rep))
    world, camera, shadow = (jax.device_put(ej.world, wsh), ej.camera,
                             ej.shadow_state)
    prev, out = np.zeros_like(TR.frame_inputs(0).keys), []
    for i in range(frames):
        inputs = TR.frame_inputs(i).with_prev(prev)
        prev = np.asarray(inputs.keys, bool)
        with mesh:
            world, camera, stats, shadow, img = fn(
                world, camera, JInput.deserialize(inputs.serialize()),
                jnp.float32(TR.DT), shadow)
        out.append((world, camera, stats, shadow, np.asarray(img)))
    return out


@pytest.mark.parametrize("n_ranks", RANKS)
def test_frames_match_the_jax_full_frame(ranks, n_ranks, monkeypatch):
    """The first ``JAX_FRAMES`` frames against the JAX package's jitted
    sharded frame from the same scene (its shadow raster through its
    Pallas route, as the port always rasterizes shadows through K1)."""
    monkeypatch.setattr(FJ, "pick_rasterizer",
                        lambda backend="auto":
                        RPJ.rasterize_depth_winner_pallas)
    rec = ranks[n_ranks]["frames"]
    reg = engine(n_ranks).world.config.registry
    for i, (world, camera, stats, shadow, img) in enumerate(
            jax_full_frames(n_ranks, JAX_FRAMES)):
        got = rec[i]
        diff = np.abs(got["image"].numpy() - img).max(axis=-1)
        assert diff.max() < 0.03, (i, diff.max())
        assert (diff > 1e-6).mean() <= 0.005, (i, (diff > 1e-6).mean())
        np.testing.assert_array_equal(got["columns"]["alive"].numpy(),
                                      np.asarray(world.alive))
        np.testing.assert_array_equal(
            got["columns"]["comp_mask"].numpy().view(np.uint32),
            np.asarray(world.comp_mask))
        for k, v in world.comps.items():
            want, have = np.asarray(v), got["columns"][k].numpy()
            if reg.specs[reg.slot(k)].dtype == "float32":
                np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-4,
                                           err_msg=f"{i} {k}")
            else:
                np.testing.assert_array_equal(have.view(want.dtype), want,
                                              err_msg=f"{i} {k}")
        np.testing.assert_allclose(got["camera"].numpy(),
                                   np.asarray(camera.serialize()),
                                   rtol=1e-5, atol=1e-5)
        assert got["stats"] == {k: int(v) for k, v in stats.items()}, i
        maps, mats, ent, face, cursor, tick = got["shadow"]
        assert_state_close(SHT.ShadowState(
            maps, mats, ent, face, cursor=cursor, tick=tick,
            resolution=shadow.resolution, pcf_scale=shadow.pcf_scale),
            shadow)


def test_a_cuda_mesh_over_gloo_is_refused(tmp_path):
    """A mesh whose rank lies on a card but whose group is gloo: DTensor's
    functional all-gather crashes there, so the programs refuse it."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = Mesh(axis_name="world", size=1, rank=0,
                    device=torch.device("cuda", 0), group=dist.group.WORLD)
        with pytest.raises(RuntimeError, match="needs NCCL") as err:
            ShardedPrograms(engine(1), mesh)
        assert GLOO_CUDA_REFUSED in str(err.value)
    finally:
        dist.destroy_process_group()
