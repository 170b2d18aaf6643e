"""The CPU side of the port's kernel designs (render_engine_tpu_torch):

(a) K1's per-warp skip rule (``k1_skip_boxes``, mirrored from
    csrc/tile_raster.cu) never skips a pixel centre that the plain
    version's fused edge test calls inside: random triangles, slivers,
    coordinates up to 1e6 and beyond 2^24, vertices on pixel centres,
    centres just outside the vertex box, and NaN;
(b) the bound arithmetic (``kernel_bounds``) on hand-built tables;
(c) K3's work list (``shade_work_list``, mirrored from
    csrc/fused_shade.cu): items per layer in order, t_front, and a tile
    with nothing covered;
(d) K3's split of a tile over blocks (``shade_block_items``) and the light
    rows a block stages (``staged_light_rows``), and the critical-path
    counts of the bound.
"""

import numpy as np
import pytest
import torch

from render_engine_tpu_torch import kernel_bounds as KB
from render_engine_tpu_torch.render import raster_pallas as RP
from render_engine_tpu_torch.render import shade_pallas as SP

TILES_X, TILE_H, TILE_W = 2, 8, 128
NT = 4  # 2 x 2 tiles of 8 x 128


def _candidates(rng, k):
    """(NT, 10, K) float32 candidates around each tile, one kind per
    candidate: small, on pixel centres, slivers, huge, beyond 2^24, NaN,
    just outside the centres, covering, long slivers."""
    t = np.arange(NT)
    ox = ((t % TILES_X) * TILE_W)[:, None].astype(np.float64)
    oy = ((t // TILES_X) * TILE_H)[:, None].astype(np.float64)
    cx = ox + rng.uniform(-8, TILE_W + 8, (NT, k))
    cy = oy + rng.uniform(-8, TILE_H + 8, (NT, k))
    v = np.stack([cx, cy] * 3, axis=1) + rng.uniform(-6, 6, (NT, 6, k))
    kind = np.arange(k)[None].repeat(NT, 0) % 9
    # 1: vertices on pixel centres, edges along rows, columns, diagonals
    on = np.floor(np.stack([cx, cy] * 3, axis=1)) + 0.5
    on[:, 2] += rng.integers(1, 5, (NT, k))
    on[:, 5] += rng.integers(1, 4, (NT, k))
    v = np.where((kind == 1)[:, None], on, v)
    # 2: slivers, the third vertex on the line or 1e-3 / 1e-6 off it
    length = rng.uniform(2, 300, (NT, k))
    ang = rng.uniform(0, 2 * np.pi, (NT, k))
    off = rng.choice([0.0, 1e-3, 1e-6], (NT, k))
    ex, ey = np.cos(ang), np.sin(ang)
    bx, by = v[:, 0] + length * ex, v[:, 1] + length * ey
    sliver = np.stack([v[:, 0], v[:, 1], bx, by,
                       0.5 * (v[:, 0] + bx) - off * ey,
                       0.5 * (v[:, 1] + by) + off * ex], axis=1)
    v = np.where((kind == 2)[:, None], sliver, v)
    # 3 and 4: one vertex far away, up to 1e6 or beyond 2^24
    for kd, scale in ((3, 1e6), (4, 4e7)):
        m = kind == kd
        v[:, 0] = np.where(m, rng.uniform(-scale, scale, (NT, k)), v[:, 0])
        v[:, 1] = np.where(m, rng.uniform(-scale, scale, (NT, k)), v[:, 1])
    # 6: the vertex box ends just past a column / row of pixel centres
    eps = rng.choice([1e-5, 2.0 ** -20, 2.0 ** -12], (NT, k))
    near = np.floor(v) + 0.5 + eps[:, None] * np.where(
        rng.random((NT, 6, k)) < 0.5, 1.0, -1.0)
    v = np.where((kind == 6)[:, None], near, v)
    # 7: huge triangles covering the tile, with coordinates up to 1e6
    big = rng.uniform(-1e6, 1e6, (NT, 6, k))
    v = np.where((kind == 7)[:, None], big, v)
    # 8: long slivers (10 to 1e6 px) on a line through a pixel centre,
    # starting just past it: rounding makes the fused edge test accept
    # centres on the line beyond the vertex box
    cpx = ox + np.floor(rng.uniform(0, TILE_W, (NT, k))) + 0.5
    cpy = oy + np.floor(rng.uniform(0, TILE_H, (NT, k))) + 0.5
    start = rng.uniform(0.5, 20, (NT, k))
    length = 10.0 ** rng.uniform(1, 6, (NT, k))
    ax, ay = cpx + start * ex, cpy + start * ey
    bx, by = ax + length * ex, ay + length * ey
    mid = rng.uniform(0.1, 0.9, (NT, k))
    off = rng.choice([0.0, 1e-7, 1e-6], (NT, k)) * length
    long_sliver = np.stack([ax, ay, bx, by,
                            ax + mid * (bx - ax) - off * ey,
                            ay + mid * (by - ay) + off * ex], axis=1)
    v = np.where((kind == 8)[:, None], long_sliver, v)
    z = rng.uniform(-1.2, 1.2, (NT, 3, k))
    cls = rng.integers(0, 3, (NT, 1, k)).astype(np.float64)
    data = np.concatenate([v, z, cls], axis=1).astype(np.float32)
    data[:, 0][kind == 5] = np.nan
    return torch.from_numpy(data), kind


def _centres():
    t = torch.arange(NT)
    ox = ((t % TILES_X) * TILE_W).float()
    oy = (torch.div(t, TILES_X, rounding_mode="floor") * TILE_H).float()
    py = (torch.arange(TILE_H).float()[None, :, None]
          + oy[:, None, None]) + 0.5
    px = (torch.arange(TILE_W).float()[None, None, :]
          + ox[:, None, None]) + 0.5
    return px, py  # (NT, 1, TILE_W), (NT, TILE_H, 1)


@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_k1_skip_rule_keeps_every_inside_centre(seed, two_pass):
    """Every (candidate, pixel centre) pair that K1 skips holds no centre
    that the plain version's edge test (with class > 0) calls inside."""
    rng = np.random.default_rng(seed)
    k = 144
    data, kind = _candidates(rng, k)
    if not two_pass:  # the shadow raster's classes are 0 and 1
        data[:, 9] = (data[:, 9] > 0).float()
    box = RP.k1_skip_boxes(data, tiles_x=TILES_X, tile_h=TILE_H,
                           tile_w=TILE_W)
    assert box.shape == (NT, 4, k) and box.dtype == torch.float32
    px, py = _centres()
    small = torch.from_numpy(np.isin(kind, (0, 1, 6)))  # (NT, K)
    skipped_small = inside_kept = beyond_vertex_box = 0
    xs, ys = data[:, 0:6:2], data[:, 1:6:2]
    vbox = torch.stack([xs.amin(1), xs.amax(1), ys.amin(1), ys.amax(1)], 1)
    for kk in range(k):
        c = [data[:, i, kk][:, None, None] for i in range(10)]
        *_, inside = RP._edge_test(*c[:6], px, py)
        inside = inside & (c[9] > 0.0)
        out = RP.k1_outside(box[:, :, kk][:, :, None, None].unbind(1),
                            px, py)
        assert not bool((inside & out).any()), (kk, kind[:, kk])
        skipped_small += int((out & small[:, kk, None, None]).sum())
        inside_kept += int(inside.sum())
        beyond_vertex_box += int((inside & RP.k1_outside(
            vbox[:, :, kk][:, :, None, None].unbind(1), px, py)).sum())
    assert inside_kept > 0
    # the cases reach what the margin is for: centres accepted outside the
    # plain vertex box
    assert beyond_vertex_box > 0
    # the rule is not vacuous: a small triangle skips most of its tile
    assert skipped_small > 0.9 * int(small.sum()) * TILE_H * TILE_W


def test_k1_skip_rule_never_bounds_what_it_cannot_prove():
    """NaN, coordinates beyond 2^24 and exactly collinear triangles get an
    unbounded box; a small triangle gets its vertex box, barely grown."""
    inf = float("inf")
    rows = [[np.nan, 1, 2, 1, 1, 3],  # NaN
            [2.0 ** 25, 1, 2, 1, 1, 3],  # beyond 2^24
            [0.5, 0.5, 100.5, 3.5, 50.5, 2.0],  # exactly collinear
            [10.2, 2.2, 13.8, 2.3, 11.0, 4.9]]  # small
    data = torch.zeros((NT, 10, len(rows)))
    data[:, :6] = torch.tensor(rows, dtype=torch.float32).T[None]
    box = RP.k1_skip_boxes(data, tiles_x=TILES_X, tile_h=TILE_H,
                           tile_w=TILE_W)
    for kk in range(3):
        assert box[:, :, kk].tolist() == [[-inf, inf, -inf, inf]] * NT
    small = box[0, :, 3]
    assert 10.19 < small[0] <= 10.2 and 13.8 <= small[1] < 13.81
    assert 2.19 < small[2] <= 2.2 and 4.9 <= small[3] < 4.91


def _one_triangle_table():
    """Two tiles of 8 x 128; tile 0 holds one live triangle whose box
    covers pixel centres x 10.5-13.5, y 2.5-4.5 (12 pairs)."""
    k = 4
    data = torch.zeros((2, 10, k))
    data[0, :6, 0] = torch.tensor([10.2, 2.2, 13.8, 2.3, 11.0, 4.9])
    data[0, 9, 0] = 1.0
    ids = torch.full((2, 1, k), -1, dtype=torch.int32)
    ids[0, 0, 0] = 7
    counts = torch.zeros((2, 1, 3), dtype=torch.int32)
    counts[0, 0, 0] = 1
    kw = dict(tiles_x=2, tile_h=8, tile_w=128, tile_budget=2,
              trans_budget=1)
    return data, ids, counts, kw


@pytest.mark.parametrize("two_pass", [False, True])
def test_bound_of_one_triangle_and_of_an_empty_frame(two_pass):
    data, ids, counts, kw = _one_triangle_table()
    out_bytes = 2 * 1024 * (24 if two_pass else 12)
    w = KB.tile_raster_work(data, ids, counts, two_pass=two_pass, **kw)
    assert w["pairs"] == 12 and w["live_candidates"] == 1
    assert w["ops"] == 12 * KB.K1_OPS_PER_PAIR
    assert w["bytes"] == 44 + 2 * 3 * 4 + out_bytes
    empty = KB.tile_raster_work(data, ids, torch.zeros_like(counts),
                                two_pass=two_pass, **kw)
    assert empty["ops"] == 0 and empty["bytes"] == 2 * 3 * 4 + out_bytes
    ms, by = KB.bound(empty["bytes"], empty["ops"])
    assert by == "bytes" and ms == pytest.approx(
        empty["bytes"] / KB.H100_BYTES_PER_S * 1e3)


def test_bound_rates_and_which_binds():
    assert KB.bound(3.35e12, 0) == (pytest.approx(1e3), "bytes")
    assert KB.bound(0, 67e12) == (pytest.approx(1e3), "operations")
    assert KB.bound(1.0, 67e12)[1] == "operations"


def test_resolve_bound_counts_distinct_rows():
    slot = torch.full((2, 8, 128), -1, dtype=torch.int32)
    slot[0, :2, :3] = 1  # six pixels, one row
    slot[1, 0, 0] = 0
    slot[1, 0, 1] = 5  # beyond K: empty, like the kernel
    rows = torch.zeros((2, 4, 48))
    w = KB.resolve_work(slot, rows)
    assert w["rows"] == 2 and w["ops"] == 0
    assert w["bytes"] == (48 * 2 * 1024 + 2 * 1024) * 4 + 2 * 48 * 4


def _planes(nt=2, covered=()):
    """Slot / depth planes (nt, 8, 128): nothing covered but ``covered``,
    a list of (tile, y, x, layer, slot, depth)."""
    s = [torch.full((nt, 8, 128), -1, dtype=torch.int32) for _ in range(2)]
    d = [torch.ones((nt, 8, 128)) for _ in range(2)]
    for t, y, x, layer, slot, depth in covered:
        s[layer][t, y, x] = slot
        d[layer][t, y, x] = depth
    return s[0], s[1], d[0], d[1]


COVERED = [(0, 0, 5, 0, 1, 0.5), (0, 3, 2, 0, 2, 0.25),
           (0, 0, 5, 1, 0, 0.4),  # transparent in front of opaque
           (0, 1, 0, 1, 3, 0.9),  # transparent alone
           (0, 3, 2, 1, 1, 0.3)]  # transparent behind opaque


def test_k3_work_list_order_layers_and_flags():
    s_o, s_t, d_o, d_t = _planes(covered=COVERED)
    flags, items, n = SP.shade_work_list(s_o, s_t, d_o, d_t)
    npx = 1024
    # opaque items first, each layer in pixel order (p = y * 128 + x)
    assert n.tolist() == [5, 0]
    assert items[0, :5].tolist() == [5, 3 * 128 + 2, npx + 5,
                                     npx + 128, npx + 3 * 128 + 2]
    assert bool((items[0, 5:] == -1).all())
    assert bool((items[1] == -1).all())  # the tile with nothing covered
    assert flags[0, 0, 5] == 3.0  # opaque covered, transparent in front
    assert flags[0, 3, 2] == 1.0  # transparent behind
    assert flags[0, 1, 0] == 2.0  # transparent alone
    assert float(flags[1].abs().sum()) == 0.0


def test_k3_work_list_flags_equal_the_plain_shade():
    """The mirror's flags plane is the plain version's plane 7; its item
    count is what the bound counts."""
    s_o, s_t, d_o, d_t = _planes(covered=COVERED)
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.uniform(0.1, 1.0, (2, 4, 48))).float()
    ltab = torch.zeros((2, SP.N_LCOL))
    lcount = torch.tensor([1], dtype=torch.int32)
    cam = torch.tensor([0.0, 0.0, 5.0])
    out = SP.fused_shade_reference(
        rows, s_o, s_t, d_o, d_t, ltab, lcount, cam, torch.eye(4),
        torch.zeros(2), tiles_x=2, width=256.0, height=8.0)
    flags, _, n = SP.shade_work_list(s_o, s_t, d_o, d_t)
    torch.testing.assert_close(out[7], flags, rtol=0, atol=0)
    w = KB.fused_shade_work(rows, s_o, s_t, d_o, d_t, ltab, lcount, cam,
                            torch.eye(4), torch.zeros(2))
    assert w["items"] == int(n.sum()) == 5
    assert (w["items_opaque"], w["items_transparent"]) == (2, 3)
    assert w["ops"] == KB.K3_OPS_PER_LIGHT * 5 * 1
    # rows: (0, 1), (0, 2), (0, 0), (0, 3); (0, 1) again on the other layer
    assert w["rows"] == 4
    assert w["bytes"] == (2 * 1024 * 48 + 4 * KB.K3_ROW_FLOATS * 4
                          + ltab.numel() * 4)
    # rows 0-1 (block 0) hold (0, 5) on both layers and (1, 0); rows 2-3
    # (block 1) hold (3, 2) on both; one light, one round of 256 threads
    assert (w["items_max_tile"], w["items_max_block"]) == (5, 3)
    assert (w["light_iters_max_tile"], w["critical_path"]) == (5, 1)
    w = KB.fused_shade_work(rows, s_o, s_t, d_o, d_t, ltab, lcount, cam,
                            torch.eye(4), torch.zeros(2),
                            tlist=torch.zeros((2, 2), dtype=torch.int32),
                            tcount=torch.tensor([7, 1], dtype=torch.int32))
    # tile 0's list runs clamped to its 2 entries
    assert (w["light_iters_max_tile"], w["critical_path"]) == (10, 2)


def _random_planes(rng, shape, p_o, p_t):
    """Slot / depth planes of the given (NT, th, tw) shape, each pixel
    covered with probability p_o / p_t (a scalar or one per tile)."""
    def cov(pr):
        pr = np.broadcast_to(np.asarray(pr, np.float64).reshape(-1, 1, 1),
                             (shape[0], 1, 1))
        return rng.random(shape) < pr

    s_o = np.where(cov(p_o), rng.integers(0, 8, shape), -1)
    s_t = np.where(cov(p_t), rng.integers(0, 8, shape), -1)
    d = rng.uniform(-1, 1, (2, *shape)).astype(np.float32)
    return (torch.from_numpy(s_o.astype(np.int32)),
            torch.from_numpy(s_t.astype(np.int32)),
            torch.from_numpy(d[0]), torch.from_numpy(d[1]))


@pytest.mark.parametrize("shape", [(5, 8, 128), (3, 4, 100), (3, 16, 64)])
def test_k3_blocks_shade_every_item_once_in_pixel_order(shape):
    """Across a tile's blocks, each covered item of the tile's work list
    is shaded exactly once, and block after block each layer's items come
    in pixel order: the tile's list split at the blocks' pixel ranges."""
    rng = np.random.default_rng(11)
    s_o, s_t, d_o, d_t = _random_planes(rng, shape,
                                        [0.3, 0.0, 1.0, 0.05, 0.6][
                                            :shape[0]], 0.2)
    _, tile_items, tile_n = SP.shade_work_list(s_o, s_t, d_o, d_t)
    items, n = SP.shade_block_items(s_o, s_t)
    npx = shape[1] * shape[2]
    nb = -(-npx // SP.BLOCK_PIXELS)
    assert tuple(items.shape) == (shape[0], nb, 2 * SP.BLOCK_PIXELS)
    assert torch.equal(n.sum(dim=1), tile_n)
    for t in range(shape[0]):
        got = [items[t, b, :n[t, b]] for b in range(nb)]
        for b in range(nb):
            assert bool((items[t, b, n[t, b]:] == -1).all())
            lo, hi = b * SP.BLOCK_PIXELS, (b + 1) * SP.BLOCK_PIXELS
            pix = got[b] % npx
            assert bool(((pix >= lo) & (pix < hi)).all())
            layer = got[b] >= npx  # opaque items first
            assert bool((layer[1:].int() >= layer[:-1].int()).all())
        merged = torch.cat(got)
        want = tile_items[t, :tile_n[t]]
        for opaque in (True, False):
            sel = lambda x: x[(x < npx) == opaque]  # noqa: E731
            assert torch.equal(sel(merged), sel(want))
        assert merged.unique().numel() == merged.numel() == int(tile_n[t])


def test_k3_block_holds_at_most_two_rows_of_items_on_both_layers():
    """With everything covered a block of an 8x128 tile holds
    2 * R * tw = 512 items (R = 2 rows), the most it has room for; a
    partial last block holds its pixels' share."""
    assert SP.BLOCK_PIXELS == 2 * 128 == 2 * SP.BLOCK_THREADS
    for shape, want in (((2, 8, 128), [512] * 4),
                        ((2, 4, 100), [512, 2 * 144])):
        full = torch.zeros(shape, dtype=torch.int32)
        items, n = SP.shade_block_items(full, full)
        assert n.tolist() == [want] * shape[0]
        assert int(items.max()) == 2 * shape[1] * shape[2] - 1


def test_k3_empty_rows_and_tiles_give_no_items():
    """A tile with nothing covered and a tile whose last two rows are
    empty: their blocks hold no item."""
    s_o, s_t, d_o, d_t = _random_planes(np.random.default_rng(4),
                                        (3, 8, 128), [0.0, 0.5, 0.5], 0.5)
    s_o[1, 6:] = -1
    s_t[1, 6:] = -1
    s_t[0] = -1
    items, n = SP.shade_block_items(s_o, s_t)
    assert n[0].tolist() == [0] * 4 and bool((items[0] == -1).all())
    assert int(n[1, 3]) == 0 and bool((items[1, 3] == -1).all())
    assert bool((n[1, :3] > 0).all()) and bool((n[2] > 0).all())


def test_k3_staged_rows_on_the_list_route():
    """Row i of tile t's block is ltab[clamp(tlist[t, i], 0, nl - 1)] for
    i < clamp(tcount[t], 0, lb), zero past it: counts above lb, negative
    counts and entries out of range."""
    rng = np.random.default_rng(2)
    nl, lb = 12, 5
    ltab = torch.from_numpy(rng.uniform(-1, 1, (nl, SP.N_LCOL))).float()
    tlist = torch.from_numpy(rng.integers(-4, nl + 4, (6, lb)).astype(
        np.int32))
    tcount = torch.tensor([0, 3, lb, lb + 9, -2, 1], dtype=torch.int32)
    rows, n_iter = SP.staged_light_rows(ltab, torch.tensor([nl]), 6, tlist,
                                        tcount)
    assert n_iter.tolist() == [0, 3, lb, lb, 0, 1]
    assert tuple(rows.shape) == (6, lb, SP.N_LCOL)
    for t in range(6):
        n = int(n_iter[t])
        idx = tlist[t, :n].long().clamp(0, nl - 1)
        assert torch.equal(rows[t, :n], ltab[idx])
        assert not bool(rows[t, n:].any())
    assert bool((tlist < 0).any()) and bool((tlist >= nl).any())


def test_k3_staged_rows_on_the_dense_route():
    """Without lists every block stages ltab[:clamp(lcount, 0, nl)]."""
    ltab = torch.arange(4 * SP.N_LCOL, dtype=torch.float32).reshape(
        4, SP.N_LCOL) + 1.0
    for lcount, n in ((2, 2), (9, 4), (-1, 0)):
        rows, n_iter = SP.staged_light_rows(
            ltab, torch.tensor([lcount], dtype=torch.int32), 3)
        assert n_iter.tolist() == [n] * 3
        assert torch.equal(rows[:, :n], ltab[:n].expand(3, n, SP.N_LCOL))
        assert not bool(rows[:, n:].any())


def _one_item_a_tile(rng, nt, scale, albedo, spec_k):
    """K3's plain-version inputs with one covered opaque pixel, (3, 7), in
    each of nt tiles of one row: a triangle that encloses the tile, one
    unit normal at its three vertices, the given (nt, 3) albedo and (nt,)
    spec strength; ipv = diag(scale, scale, scale, 1). Returns the inputs
    and the items' world positions, as the plain version unprojects them."""
    th, tw = 8, 128
    rows = np.zeros((nt, 1, 48), np.float32)
    ox = np.arange(nt) * tw
    rows[:, 0, 0:6] = np.stack([ox - 200, -200 + 0 * ox, ox + 800,
                                -200 + 0 * ox, ox - 200, 430 + 0 * ox], 1)
    n = rng.normal(size=(nt, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    rows[:, 0, 10:19] = np.tile(n, 3)
    rows[:, 0, 25:28] = 1.0
    rows[:, 0, 29:32] = albedo
    rows[:, 0, 33] = 1.0
    rows[:, 0, 34] = spec_k
    s_o = torch.full((nt, th, tw), -1, dtype=torch.int32)
    s_o[:, 3, 7] = 0
    d_o = torch.ones((nt, th, tw))
    d_o[:, 3, 7] = torch.from_numpy(rng.uniform(-0.9, 0.9, nt)).float()
    ipv = torch.diag(torch.tensor([scale, scale, scale, 1.0]))
    width = float(nt * tw)
    px = torch.from_numpy(ox + 7.0).float() + 0.5
    w = torch.stack([(px / width * 2.0 - 1.0) * scale,
                     (1.0 - torch.full((nt,), 3.5) / 8.0 * 2.0) * scale,
                     d_o[:, 3, 7] * scale], dim=1)
    args = [torch.from_numpy(rows), s_o, torch.full_like(s_o, -1), d_o,
            torch.ones_like(d_o)]
    kw = dict(tiles_x=nt, width=width, height=8.0)
    return args, ipv, kw, w


def _skip_lights(rng, n_lights, w, scale, color):
    """Point and spot rows around the items, half of them with a radius
    that cuts some items off; colours up to ``color``."""
    L = np.zeros((n_lights, SP.N_LCOL), np.float32)
    L[:, 0] = rng.choice([1.0, 2.0], n_lights)
    centre = w.numpy()[rng.integers(0, len(w), n_lights)]
    L[:, 1:4] = centre + rng.uniform(-0.3, 0.3, (n_lights, 3)) * scale
    dvec = rng.normal(size=(n_lights, 3))
    L[:, 4:7] = dvec / np.linalg.norm(dvec, axis=1, keepdims=True)
    L[:, 7:16] = rng.uniform(-color, color, (n_lights, 9))
    L[:, 16:18] = rng.uniform(0.0, 1.0 / scale, (n_lights, 2))
    L[:, 18] = rng.uniform(0.5, 1.0, n_lights)
    L[:, 19] = L[:, 18] - rng.uniform(0.0, 0.5, n_lights)
    L[:, 20] = rng.uniform(0.05, 0.4, n_lights) * scale
    return torch.from_numpy(L)


def _kept_lists(ltab, w, cam, item_ok):
    """Each tile's list of the lights K3 does not skip for its one item,
    ascending, with the counts, and the number skipped."""
    t = ltab[None, :, 1:4] - w[:, None, :]
    d = torch.sqrt(torch.clamp(t[..., 0] * t[..., 0] + t[..., 1] * t[..., 1]
                               + t[..., 2] * t[..., 2], min=1e-18))
    skip = item_ok[:, None] & (d > SP.shade_skip_cut(ltab)[None, :])
    idx = torch.arange(ltab.shape[0])
    key = torch.where(skip, ltab.shape[0], idx[None, :])
    tlist = torch.sort(key, dim=1).values
    tlist = torch.where(tlist < ltab.shape[0], tlist, 0).to(torch.int32)
    return tlist, (~skip).sum(1).to(torch.int32), int(skip.sum())


@pytest.mark.parametrize("scale", [1e3, 2.0 ** 57])
def test_k3_skipped_lights_add_nothing(scale):
    """The plain version over every light equals it over the lights K3
    does not skip (shade_skip_cut / shade_skip_item, mirrored from
    csrc/fused_shade.cu), bit for bit, with values at the rule's bounds:
    positions near 2^57, colours, albedo and spec strength near 2^40, the
    exponent 2^16."""
    rng = np.random.default_rng(int(scale) % 1000)
    nt = 24
    albedo = rng.uniform(-1, 1, (nt, 3)) * SP.SKIP_COLOR * 0.99
    spec_k = rng.uniform(0, 1, nt) * SP.SKIP_COLOR * 0.99
    args, ipv, kw, w = _one_item_a_tile(rng, nt, scale, albedo, spec_k)
    ltab = _skip_lights(rng, 48, w, scale, SP.SKIP_COLOR * 0.99)
    cam = torch.tensor([0.0, 0.0, 2.0 * scale])
    v = cam[None] - w
    v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    n = args[0][:, 0, 10:13]
    item_ok = SP.shade_skip_item(w, v, n, torch.from_numpy(albedo).float(),
                                 torch.from_numpy(spec_k).float(),
                                 torch.full((nt,), SP.SKIP_SHIN))
    assert bool(item_ok.all())
    tlist, tcount, n_skipped = _kept_lists(ltab, w, cam, item_ok)
    assert n_skipped > nt * 4
    lcount = torch.tensor([ltab.shape[0]], dtype=torch.int32)
    common = (*args, ltab, lcount, cam, ipv, torch.zeros(2))
    opts = dict(kw, shin_const=SP.SKIP_SHIN)
    dense = SP.fused_shade_reference(*common, **opts)
    kept = SP.fused_shade_reference(*common, tlist=tlist, tcount=tcount,
                                    **opts)
    assert bool(torch.isfinite(dense).all())
    assert torch.equal(dense, kept)


def test_k3_lights_beyond_the_bounds_are_not_skipped():
    """A light whose colour exceeds the bound adds NaN where its radius
    cuts an item off (0 x inf): the rule keeps it, so the sums keep the
    NaN, where dropping every cut-off light would not."""
    rng = np.random.default_rng(5)
    nt, scale = 8, 1e3
    albedo = np.full((nt, 3), 1e10)
    args, ipv, kw, w = _one_item_a_tile(rng, nt, scale, albedo,
                                        np.ones(nt))
    ltab = _skip_lights(rng, 16, w, scale, 1.0)
    ltab[:, 13] = 1e30  # ambient x albedo overflows
    ltab[:, 20] = 1e-3 * scale  # every light cuts every item off
    cam = torch.tensor([0.0, 0.0, 2.0 * scale])
    assert bool(torch.isinf(SP.shade_skip_cut(ltab)).all())
    lcount = torch.tensor([16], dtype=torch.int32)
    common = (*args, ltab, lcount, cam, ipv, torch.zeros(2))
    dense = SP.fused_shade_reference(*common, **kw)
    assert bool(torch.isnan(dense[0, :, 3, 7]).all())
    none = torch.zeros((nt, 16), dtype=torch.int32)
    dropped = SP.fused_shade_reference(
        *common, tlist=none, tcount=torch.zeros(nt, dtype=torch.int32), **kw)
    assert bool(torch.isfinite(dropped).all())
