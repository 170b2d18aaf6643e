"""The port's multi-device package (``render_engine_tpu_torch.parallel``)
on the CPU, mirroring ``tests/test_parallel.py``: the mesh, the world's
sharding by entity, and the frame in bands of tile rows over gloo groups
of spawned CPU processes, each stepping its rows of the world
(``scripts/multigpu_torch.py``; the partitioned step itself is
tests/test_torch_partitioned_step.py's).

Tolerances:
* the round trip ``shard_world`` -> ``gather_world``: bit for bit (equal
  tensors, equal world hashes); each rank holds ``capacity / ranks`` rows;
  every rank's stepped world: the world hash of one process's step;
* bands concatenated against the port's ``render_frame`` and against the
  JAX package's ``render_frame_sharded`` on its 8-device CPU mesh: the
  JAX package's limits, max abs diff < 0.03 (tests/test_parallel.py) and
  at most 0.5% of the pixels differing by more than 1e-6 (the dry run's,
  ``__graft_entry__.py:198-203``);
* the gathered image of a gloo group against the bands rendered in one
  process and against one process's frame: bit for bit (at tile budgets
  1.0 the shift by whole tile rows changes no edge test).
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

from render_engine_tpu.demo.space_scene import (
    build_space_engine as build_jax_engine)
from render_engine_tpu.parallel.mesh import make_mesh as make_jax_mesh
from render_engine_tpu.parallel.mesh import shard_world as shard_jax_world
from render_engine_tpu.parallel.render import (
    render_frame_sharded as render_jax_sharded)
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu.utils.hashing import world_hash as jax_world_hash
from render_engine_tpu_torch.demo.space_scene import build_space_engine
from render_engine_tpu_torch.ecs import world as W
from render_engine_tpu_torch.logic.types import InputState
from render_engine_tpu_torch.parallel import (Mesh, gather_image,
                                              gather_world, image_sharding,
                                              make_mesh, render_frame_band,
                                              render_frame_sharded,
                                              replicated, shard_world,
                                              world_sharding)
from render_engine_tpu_torch.render import render_system as RS
from render_engine_tpu_torch.render.frame import render_frame
from render_engine_tpu_torch.utils.hashing import world_hash

import test_torch_render_systems as TRS
import torch_ranks
from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import multigpu_torch  # noqa: E402

# tests/test_parallel.py's engine
PAR_KW = dict(width=128, height=64, capacity=64, num_asteroids=8,
              max_tris=1024)
N_BANDS = 8
DT = 1.0 / 60.0


def fake_mesh(size, rank=0):
    """A mesh without a process group, for what needs none."""
    return Mesh(axis_name="world", size=size, rank=rank,
                device=torch.device("cpu"), group=None)


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def spawn(fn, n_ranks, tmp_path, *args):
    """``fn(rank, n_ranks, store, *args)`` in ``n_ranks`` spawned
    processes."""
    mp.spawn(fn, args=(n_ranks, str(tmp_path / "store"), *args),
             nprocs=n_ranks)


class TestMesh:
    def test_make_mesh_needs_a_process_group(self):
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="no torch.distributed"):
            make_mesh()

    def test_make_mesh_checks_the_size(self, one_rank_group):
        mesh = make_mesh()
        assert (mesh.size, mesh.rank, mesh.axis_name) == (1, 0, "world")
        assert mesh.device == torch.device("cpu")
        assert make_mesh(1) == mesh
        with pytest.raises(ValueError, match="need 8 devices"):
            make_mesh(8)

    def test_nccl_rank_needs_a_card(self, one_rank_group, monkeypatch):
        monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="finds no card"):
            make_mesh()

    def test_world_sharding_specs(self):
        w = W.create_world(W.WorldConfig(capacity=64))
        sh = world_sharding(w, fake_mesh(8))
        assert sh.comps["position"].spec == ("world",)
        assert sh.alive.spec == sh.comp_mask.spec == ("world",)
        assert all(s.spec == ("world",) for s in sh.comps.values())
        # a capacity the ranks do not divide stays whole, as in JAX
        odd = world_sharding(W.create_world(W.WorldConfig(capacity=60)),
                             fake_mesh(8))
        assert all(s.spec == () for s in odd.comps.values())
        assert replicated(fake_mesh(8)).spec == ()
        assert image_sharding(fake_mesh(8)).spec == ("world",)

    def test_shard_world_takes_each_ranks_rows(self):
        world = torch_ranks.seeded_world(64, 5)
        parts = [shard_world(world, fake_mesh(4, r)) for r in range(4)]
        assert all(p.capacity == 64 and p.alive.shape == (16,)
                   for p in parts)
        for k, v in world.comps.items():
            assert torch.equal(torch.cat([p.comps[k] for p in parts]), v)
        whole = shard_world(torch_ranks.seeded_world(62, 5), fake_mesh(4, 3))
        assert whole.alive.shape == (62,)

    def test_round_trip_is_bit_identical(self, tmp_path):
        out = str(tmp_path / "rec.pt")
        spawn(torch_ranks.round_trip, 4, tmp_path, 64, 7, out)
        rec = torch.load(out)
        assert rec["rows"] == 16 and rec["equal"]
        assert rec["hashes"][0] == rec["hashes"][1]


@pytest.fixture(scope="module")
def engine():
    """The port's PAR_KW engine after 3 frames (its shadow maps hold both
    slots)."""
    eng = build_space_engine(device="cpu", **PAR_KW)
    eng.config.record_history = False
    for _ in range(3):
        eng.frame(None, DT)
    assert int((eng.shadow_state.slot_entity >= 0).sum()) >= 1
    return eng


def bands(eng, settings, n, **kw):
    """``n`` bands rendered one after another, joined and cropped."""
    return torch.cat([render_frame_band(
        eng.world, eng.camera, eng.bank, settings, rank=r, n_ranks=n,
        cubemap=eng.cubemap, **kw) for r in range(n)])[:settings.height]


def assert_within_jax_limits(img, ref):
    img, ref = np.asarray(img), np.asarray(ref)
    assert img.shape == ref.shape
    diff = np.abs(img - ref).max(axis=-1)
    assert diff.max() < 0.03, f"max diff {diff.max():.4f}"
    assert (diff > 1e-6).mean() < 0.005, (diff > 1e-6).sum()


def draw_systems(eng):
    star = eng.bank.model_index("star")

    def draw(dp):
        dp.draw_models(star)  # only the star draws this frame
        dp.write_uniform("albedo_tint", torch.tensor([1.0, 0.5, 0.5]))

    return RS.compile_systems(
        (RS.RenderSystemBuilder("cb")
         .with_models(*range(eng.bank.num_models))
         .with_draw_function(draw).build(),), eng.bank)


def shade_systems(eng):
    return RS.compile_systems(
        (RS.RenderSystemBuilder("cs")
         .with_models(*range(eng.bank.num_models))
         .write_uniform("tone", 0.8)
         .with_fragment_shading(TRS.fancy).build(),), eng.bank)


@pytest.mark.parametrize("case", ["shadows", "tile_lights", "draw_callbacks",
                                  "custom_shading", "atlas"])
def test_bands_match_the_whole_frame(engine, case):
    """tests/test_parallel.py's five sharded renders, as 8 bands rendered
    one after another against ``render_frame``."""
    eng = engine
    s = eng.config.render
    kw = dict(shadow_state=eng.shadow_state, systems=eng.compiled_systems)
    if case == "tile_lights":
        s = dataclasses.replace(s, light_tile_budget=8)
    elif case == "draw_callbacks":
        kw = dict(systems=draw_systems(eng))
    elif case == "custom_shading":
        kw = dict(systems=shade_systems(eng))
    elif case == "atlas":
        s = dataclasses.replace(s, texture_tile_budget=1.0)
        kw["atlas"] = eng.atlas
        assert eng.atlas is not None
    single = render_frame(eng.world, eng.camera, eng.bank, s,
                          cubemap=eng.cubemap, **kw)
    img = bands(eng, s, N_BANDS, **kw)
    assert_within_jax_limits(img, single)
    assert float(single.max()) > 0.5
    if case == "tile_lights":
        full = render_frame(eng.world, eng.camera, eng.bank,
                            dataclasses.replace(s, light_tile_budget=0),
                            cubemap=eng.cubemap, **kw)
        assert torch.equal(single, full)


def test_padded_last_band(engine):
    """60 rows over 8 bands of 8: the last band holds 4 image rows and 4
    pad rows. The background is the whole image's (the JAX package samples
    it at the padded height of 64, which moves every star), so the bands
    still give the whole frame."""
    eng = engine
    s = dataclasses.replace(eng.config.render, height=60)
    kw = dict(shadow_state=eng.shadow_state, systems=eng.compiled_systems,
              atlas=eng.atlas)
    last = render_frame_band(eng.world, eng.camera, eng.bank, s, rank=7,
                             n_ranks=N_BANDS, cubemap=eng.cubemap, **kw)
    assert tuple(last.shape) == (8, 128, 3)
    single = render_frame(eng.world, eng.camera, eng.bank, s,
                          cubemap=eng.cubemap, **kw)
    assert_within_jax_limits(bands(eng, s, N_BANDS, **kw), single)


def test_band_needs_the_fused_path(engine):
    eng = engine
    s = dataclasses.replace(eng.config.render, backend="jnp")
    with pytest.raises(ValueError, match="fused tiled path"):
        render_frame_band(eng.world, eng.camera, eng.bank, s, rank=0,
                          n_ranks=2)


def test_bands_match_the_jax_sharded_frame(monkeypatch):
    """The JAX package's render_frame_sharded on its 8-device CPU mesh
    (interpret mode) against the port's 8 bands, from the same engine
    state: the demo scene at frame 0 with its starfield, atlas, systems
    and shadow state."""
    monkeypatch.setattr(FJ, "pick_rasterizer",
                        lambda backend="auto":
                        RPJ.rasterize_depth_winner_pallas)
    if len(jax.devices()) < N_BANDS:
        pytest.fail(f"the JAX CPU mesh has {len(jax.devices())} devices")
    ej = build_jax_engine(**PAR_KW)
    et = build_space_engine(device="cpu", **PAR_KW)
    assert world_hash(et.world) == jax_world_hash(ej.world)
    sj = dataclasses.replace(ej.config.render, backend="pallas",
                             fused_shading=True)
    mesh = make_jax_mesh(N_BANDS)
    cam = jax.device_put(ej.camera, NamedSharding(mesh, P()))
    fn = jax.jit(lambda w, c: render_jax_sharded(
        w, c, ej.bank, sj, mesh, cubemap=ej.cubemap, atlas=ej.atlas,
        shadow_state=ej.shadow_state, systems=ej.compiled_systems,
        interpret=True))
    with mesh:
        img_j = np.asarray(fn(shard_jax_world(ej.world, mesh), cam))
    img_t = bands(et, et.config.render, N_BANDS, atlas=et.atlas,
                  shadow_state=et.shadow_state, systems=et.compiled_systems)
    assert_within_jax_limits(img_t, img_j)
    assert img_j.max() > 0.5


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_gloo_banded_frame(tmp_path, n_ranks):
    """``scripts/multigpu_torch.py`` over a gloo group of spawned CPU
    processes: every rank steps its ``capacity / n`` rows of the world
    (``shard_step``), gathers the world, renders its band
    (``render_frame_sharded``) and the bands are gathered
    (``gather_image``). Every rank's world hash equals one process's step,
    and the image equals the bands of that step rendered in one process,
    and its whole frame, bit for bit. The scale phase holds ``16384 / n``
    rows a rank and equals the unsharded step."""
    out = str(tmp_path / "rec.pt")
    kw = multigpu_torch.cpu_kw(n_ranks)
    multigpu_torch.run_gloo(n_ranks, kw, out=out)
    rec = torch.load(out)
    assert rec["ranks"] == n_ranks
    assert rec["band_rows"] * n_ranks == kw["height"]
    assert rec["rows"] == [kw["capacity"] // n_ranks]
    assert rec["scale"]["rows_a_rank"] == [16384 // n_ranks]
    assert rec["scale"]["equal"] and rec["scale"]["alive"] == 10006

    eng = build_space_engine(device="cpu", **kw)
    eng.config.record_history = False
    eng.config.render = dataclasses.replace(eng.config.render,
                                            **multigpu_torch.PARITY_BUDGETS)
    inputs = InputState.idle(0).to_device("cpu")
    eng.step(InputState.idle(0), DT)
    assert rec["world_hashes_ranks"] == [world_hash(eng.world)] * n_ranks
    eng.update_shadows()
    want = bands(eng, eng.config.render, n_ranks, atlas=eng.atlas,
                 shadow_state=eng.shadow_state, systems=eng.compiled_systems,
                 inputs=inputs)
    assert torch.equal(rec["image"], want)
    assert torch.equal(want, eng.render(inputs=inputs))
    assert float(want.max()) > 0.5


def test_render_frame_sharded_on_one_rank(one_rank_group):
    """On a one-rank group the band is the whole frame; a world of
    ``shard_world``'s rows is refused, since the geometry needs every
    entity."""
    eng = build_space_engine(device="cpu", **PAR_KW)
    mesh = make_mesh(1)
    eng.step(InputState.idle(0), DT)
    band = render_frame_sharded(eng.world, eng.camera, eng.bank,
                                eng.config.render, mesh, cubemap=eng.cubemap)
    assert torch.equal(gather_image(band, mesh, PAR_KW["height"]),
                       render_frame(eng.world, eng.camera, eng.bank,
                                    eng.config.render, cubemap=eng.cubemap))
    rows = shard_world(eng.world, fake_mesh(2))
    assert rows.alive.shape == (PAR_KW["capacity"] // 2,)
    with pytest.raises(ValueError, match="needs the whole world"):
        render_frame_sharded(rows, eng.camera, eng.bank, eng.config.render,
                             mesh)
    assert world_hash(gather_world(shard_world(eng.world, mesh), mesh)) == \
        world_hash(eng.world)
