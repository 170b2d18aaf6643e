"""The port's binning, tile raster (K1) and attribute resolve (K2) against
the JAX package's, on the CPU (the JAX kernels in Pallas interpret mode,
the port's kernels through their plain PyTorch versions).

Everything here must match exactly: candidate tables, counts and drop
counts are integers, and the plain K1 forms the same fused multiply-adds
that XLA contracts the reference's edge functions and depth sum into, so
depths, winners and slots agree bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from render_engine_tpu.render import raster_jnp as RJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu_torch import convert
from render_engine_tpu_torch.render import raster_jnp as RT
from render_engine_tpu_torch.render import raster_pallas as RPT
from tests.test_render import H, WIDTH, manual_batch

CFG_KW = dict(tile_budget=16, max_tiles_per_tri=8, global_budget=8)
CFG_J = RJ.RasterConfig(chunk=4, **CFG_KW)  # chunk: the jnp path's loop
CFG_T = RT.RasterConfig(**CFG_KW)
TILES_X, TILES_Y = -(-WIDTH // CFG_J.tile_w), -(-H // CFG_J.tile_h)


def to_torch(batch):
    return convert.triangle_batch_from_numpy(
        {f.name: np.asarray(getattr(batch, f.name))
         for f in dataclasses.fields(batch)})


def random_batch(seed, n, budget=None, transparent_every=0, lo=-10.0,
                 hi=140.0):
    rng = np.random.default_rng(seed)
    tris = rng.uniform(lo, hi, (n, 3, 2)).astype(np.float32)
    zs = rng.uniform(-0.95, 0.95, (n, 3)).astype(np.float32)
    b = manual_batch(tris, z=zs, budget=budget or max(8, n))
    if transparent_every:
        tr = np.zeros(b.budget, bool)
        tr[::transparent_every] = True
        b = dataclasses.replace(b, transparent=jnp.asarray(tr))
    return b


def tri_class_np(batch):
    valid = np.asarray(batch.valid)
    trans = np.asarray(batch.transparent)
    return np.where(valid, np.where(trans, 2.0, 1.0), 0.0).astype(np.float32)


def assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


SCENES = {
    "single": lambda: manual_batch([[[0.0, 0.0], [16.0, 0.0], [0.0, 16.0]]]),
    "random": lambda: random_batch(11, 7),
    "overlap": lambda: manual_batch(
        [[[0.0, 0.0], [40.0, 0.0], [0.0, 40.0]]] * 3,
        z=[[0.3] * 3, [-0.7] * 3, [0.0] * 3]),
    "big_global": lambda: manual_batch(
        [[[-10.0, -10.0], [300.0, -10.0], [-10.0, 80.0]],
         [[4.0, 4.0], [12.0, 4.0], [4.0, 12.0]]],
        z=[[0.5] * 3, [-0.5] * 3]),
    "dense_transparent": lambda: random_batch(3, 40, budget=48,
                                              transparent_every=3),
}


@pytest.mark.parametrize("classed", [False, True])
@pytest.mark.parametrize("pair_budget", [None, 2, 400])
@pytest.mark.parametrize("scene", ["random", "big_global",
                                   "dense_transparent"])
def test_binning_and_candidate_table_exact(scene, pair_budget, classed):
    bj = SCENES[scene]()
    bt = to_torch(bj)
    cj = dataclasses.replace(CFG_J, pair_budget=pair_budget)
    ct = dataclasses.replace(CFG_T, pair_budget=pair_budget)
    cls = tri_class_np(bj) if classed else None
    outs_j = RJ._bin_triangles(bj, cj, TILES_X, TILES_Y,
                               *([jnp.asarray(cls)] if classed else []))
    outs_t = RT._bin_triangles(bt, ct, TILES_X, TILES_Y,
                               *([torch.as_tensor(cls)] if classed else []))
    assert len(outs_j) == len(outs_t)
    for a, b in zip(outs_j, outs_t):
        assert_same(a, b)
    cand_j, counts_j = RPJ._candidate_table(
        bj, cj, TILES_X, TILES_Y, jnp.asarray(cls) if classed else None)
    cand_t, counts_t = RPT._candidate_table(
        bt, ct, TILES_X, TILES_Y, torch.as_tensor(cls) if classed else None)
    assert_same(cand_j, cand_t)
    assert_same(counts_j, counts_t)


def test_starved_pair_budget_drops_and_counts():
    bj = random_batch(5, 9, budget=16, lo=-10.0, hi=140.0)
    bt = to_torch(bj)
    full = RT._bin_triangles(bt, CFG_T, TILES_X, TILES_Y)[-1]
    starved_cfg = dataclasses.replace(CFG_T, pair_budget=2)
    starved = RT._bin_triangles(bt, starved_cfg, TILES_X, TILES_Y)[-1]
    assert int(starved) > int(full)
    starved_j = RJ._bin_triangles(
        bj, dataclasses.replace(CFG_J, pair_budget=2), TILES_X, TILES_Y)[-1]
    assert int(starved) == int(starved_j)
    dj, wj = RPJ.rasterize_depth_winner_pallas(
        bj, H, WIDTH, dataclasses.replace(CFG_J, pair_budget=2),
        interpret=True)
    dt, wt = RPT.rasterize_depth_winner_pallas(bt, H, WIDTH, starved_cfg)
    assert_same(dj, dt)
    assert_same(wj, wt)


@pytest.mark.parametrize("scene", ["single", "random", "overlap",
                                   "big_global", "dense_transparent"])
def test_one_pass_raster_exact(scene):
    bj = SCENES[scene]()
    dj, wj = RPJ.rasterize_depth_winner_pallas(bj, H, WIDTH, CFG_J,
                                               interpret=True)
    dt, wt = RPT.rasterize_depth_winner_pallas(to_torch(bj), H, WIDTH, CFG_T)
    assert_same(dj, dt)
    assert_same(wj, wt)
    if scene == "overlap":
        assert int(wt[3, 3]) == 1  # nearest of three coplanar copies
    if scene == "big_global":
        assert int(wt[5, 5]) == 1 and int(wt[20, 60]) == 0


@pytest.mark.parametrize("seed", [3, 11])
def test_two_pass_kernel_outputs_exact(seed):
    """All six tiled outputs of one two-pass launch, slots included."""
    bj = random_batch(seed, 40, budget=48, transparent_every=3)
    bt = to_torch(bj)
    cls = tri_class_np(bj)
    outs_j = RPJ._launch(bj, H, WIDTH, CFG_J, jnp.asarray(cls), True, True,
                         classed=True)
    outs_t = RPT._launch(bt, H, WIDTH, CFG_T, torch.as_tensor(cls), True,
                         classed=True)
    assert len(outs_j) == len(outs_t) == 6
    for a, b in zip(outs_j, outs_t):
        assert_same(a, b)


def test_two_pass_matches_separate_calls():
    rng = np.random.default_rng(3)
    tris = rng.uniform(0, 120, (6, 3, 2)).astype(np.float32)
    zs = rng.uniform(-0.9, 0.9, (6, 3)).astype(np.float32)
    bj = dataclasses.replace(
        manual_batch(tris, z=zs),
        transparent=jnp.asarray(np.array([0, 1, 0, 1, 0, 0, 0, 0], bool)))
    bt = to_torch(bj)
    got_j = RPJ.rasterize_two_pass_pallas(bj, H, WIDTH, CFG_J, interpret=True)
    got_t = RPT.rasterize_two_pass_pallas(bt, H, WIDTH, CFG_T)
    for a, b in zip(got_j, got_t):
        assert_same(a, b)
    d, w, td, tw_ = got_t
    d1, w1 = RPT.rasterize_depth_winner_pallas(bt, H, WIDTH, CFG_T,
                                               ~bt.transparent)
    d2, w2 = RPT.rasterize_depth_winner_pallas(bt, H, WIDTH, CFG_T,
                                               bt.transparent)
    torch.testing.assert_close(w, w1, rtol=0, atol=0)
    torch.testing.assert_close(tw_, w2, rtol=0, atol=0)
    torch.testing.assert_close(d, d1, rtol=0, atol=1e-6)
    torch.testing.assert_close(td, d2, rtol=0, atol=1e-6)


def test_generous_pair_budget_identical():
    bj = random_batch(5, 9, budget=16)
    bt = to_torch(bj)
    base = RPT.rasterize_depth_winner_pallas(bt, H, WIDTH, CFG_T)
    cfg = dataclasses.replace(CFG_T, pair_budget=bt.budget * 4)
    roomy = RPT.rasterize_depth_winner_pallas(bt, H, WIDTH, cfg)
    for a, b in zip(base, roomy):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    dj, wj = RPJ.rasterize_depth_winner_pallas(
        bj, H, WIDTH, dataclasses.replace(CFG_J, pair_budget=bt.budget * 4),
        interpret=True)
    assert_same(dj, roomy[0])
    assert_same(wj, roomy[1])


@pytest.mark.parametrize("a_width", [48, 64])
def test_resolve_exact(a_width):
    rng = np.random.default_rng(a_width)
    tb, k, th, tw = 3, 12, 8, 128
    rows = rng.standard_normal((tb, k, a_width)).astype(np.float32)
    slot = rng.integers(-1, k, (tb, th, tw)).astype(np.int32)
    slot[1] = -1  # an empty tile
    want = RPJ.resolve_attributes_pallas(jnp.asarray(slot),
                                         jnp.asarray(rows), CFG_J,
                                         interpret=True)
    got = RPT.resolve_attributes_pallas(torch.as_tensor(slot),
                                        torch.as_tensor(rows))
    assert got.shape == (a_width, tb, th, tw)
    assert_same(want, got)
    assert not got[:, 1].any()
