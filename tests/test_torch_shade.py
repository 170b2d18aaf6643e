"""The port's fused shade (K3, through its plain PyTorch version on the CPU)
against the JAX package's ``fused_shade`` in Pallas interpret mode.

The inputs are made with numpy from a seed: candidate rows of large
triangles over a 2x2-tile screen, random winner slots (some empty) and
depths, a light table with dir, point and spot lights (some slots unused),
and, per case, texture overrides, shadow-slot factors or tile light lists.

Tolerance atol = rtol = 1e-5: the reference normalises with rsqrt and the
port with 1 / sqrt, pow differs in its last bits between the two, and XLA
contracts the barycentric edge functions and the unprojection into fused
multiply-adds. The camera (near 1, far 40) and the depths (NDC -0.95 to
0.6) keep the unprojection well conditioned: near the far plane of a
near-0.1 camera its cancellation amplifies those last-bit differences to
about 3e-4 in both packages alike (measured against a float64 evaluation).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from render_engine_tpu.math import transforms as TJ
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.models.bank import pack_spec_shin
from render_engine_tpu.render import lighting as LJ
from render_engine_tpu.render import shade_pallas as SPJ
from render_engine_tpu_torch.render import lighting as LT
from render_engine_tpu_torch.render import shade_pallas as SPT

TILES_X, TILES_Y, TH, TW = 2, 2, 8, 128
NT = TILES_X * TILES_Y
W, H = TILES_X * TW, TILES_Y * TH
K, A = 10, 64
TOL = dict(rtol=1e-5, atol=1e-5)


def make_rows(rng, spec_packed):
    """(NT, K, A) candidate rows: big triangles around each tile."""
    rows = rng.uniform(-1.0, 1.0, (NT, K, A)).astype(np.float32)
    for t in range(NT):
        oy, ox = (t // TILES_X) * TH, (t % TILES_X) * TW
        corner = np.array([[ox - 20.0, oy - 10.0], [ox + TW + 60.0, oy - 6.0],
                           [ox - 8.0, oy + TH + 40.0]], np.float32)
        xy = corner[None] + rng.uniform(-5, 5, (K, 3, 2))
        rows[t, :, 0:6] = xy.reshape(K, 6)
    rows[..., 6:9] = rng.uniform(-0.9, 0.9, (NT, K, 3))
    rows[..., 9] = 1.0
    # smooth-shading vertex normals: one facing per candidate, perturbed
    # per vertex (unrelated vertex normals can interpolate to a near-zero
    # vector whose normalisation amplifies every rounding difference)
    nrm = (rng.standard_normal((NT, K, 1, 3))
           + 0.3 * rng.standard_normal((NT, K, 3, 3)))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    rows[..., 10:19] = nrm.reshape(NT, K, 9)
    rows[..., 25:28] = rng.uniform(0.5, 2.0, (NT, K, 3))
    rows[..., 29:32] = rng.uniform(0.0, 1.0, (NT, K, 3))
    rows[..., 32] = np.where(rng.random((NT, K)) < 0.2, 2.5, 0.0)
    rows[..., 33] = rng.uniform(0.2, 1.0, (NT, K))
    spec = rng.uniform(0.0, 2.0, (NT, K)).astype(np.float32)
    if spec_packed:
        # exponents up to 32: pow multiplies the relative rounding
        # difference of ndh (a few ulp, from rsqrt) by the exponent
        shin = rng.choice([8.0, 16.0, 32.0], (NT, K)).astype(np.float32)
        spec = np.asarray(pack_spec_shin(jnp.asarray(spec), jnp.asarray(shin)))
    rows[..., 34] = spec
    return rows


def make_lights(rng):
    """Light arrays as numpy: 2 dir (1 live), 3 point (2 live, one with a
    radius cutoff), 2 spot (1 live)."""
    def unit(n):
        v = rng.standard_normal((n, 3))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)

    def col(n, lo=0.2, hi=1.0):
        return rng.uniform(lo, hi, (n, 3)).astype(np.float32)

    center = np.array([64.0, 64.0, 58.0], np.float32)
    return dict(
        dir_direction=unit(2), dir_diffuse=col(2), dir_specular=col(2),
        dir_ambient=col(2, 0.0, 0.1), dir_count=np.int32(1),
        dir_entity=np.array([3, -1], np.int32),
        pt_position=(center + rng.uniform(-6, 6, (3, 3))).astype(np.float32),
        pt_diffuse=col(3), pt_specular=col(3), pt_ambient=col(3, 0.0, 0.1),
        pt_atten=np.array([[0.05, 0.01], [0.02, 0.002], [0.0, 0.0]],
                          np.float32),
        pt_radius=np.array([0.0, 7.0, 0.0], np.float32),
        pt_count=np.int32(2), pt_entity=np.array([5, 6, -1], np.int32),
        sp_position=(center + rng.uniform(-6, 6, (2, 3))).astype(np.float32),
        sp_direction=unit(2), sp_diffuse=col(2), sp_specular=col(2),
        sp_ambient=col(2, 0.0, 0.1),
        sp_atten=np.array([[0.01, 0.001], [0.0, 0.0]], np.float32),
        sp_cutoff=np.array([[np.cos(0.4), np.cos(0.9)], [1.0, 0.5]],
                           np.float32),
        sp_count=np.int32(1), sp_entity=np.array([9, -1], np.int32))


def make_override(rng, n_ovr, with_norm):
    """(2 * n_ovr, NT, TH, TW): [rgb | flag | deltas.. | normal | flag] for
    the opaque and then the transparent layer."""
    ovr = np.zeros((2 * n_ovr, NT, TH, TW), np.float32)
    base = n_ovr - (4 if with_norm else 0)
    for lb in (0, n_ovr):
        ovr[lb:lb + 3] = rng.uniform(0, 1, (3, NT, TH, TW))
        ovr[lb + 3] = rng.random((NT, TH, TW)) < 0.5
        ovr[lb + 4:lb + base] = rng.uniform(-0.5, 0.5,
                                            (base - 4, NT, TH, TW))
        if with_norm:
            n = rng.standard_normal((3, NT, TH, TW))
            ovr[lb + base:lb + base + 3] = n / np.linalg.norm(n, axis=0)
            ovr[lb + base + 3] = rng.random((NT, TH, TW)) < 0.5
    return ovr


def camera_inputs():
    cam = (CameraBuilder().with_position(64.0, 64.0, 64.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(W / H).with_near_far(1.0, 40.0).build())
    inv_pv = np.array(TJ.inv44(cam.proj_view()))  # a writable copy
    return np.array(cam.position, np.float32), inv_pv


CASES = {
    "untextured": dict(),
    "spec_packed": dict(spec_packed=True),
    "textured_norm": dict(n_ovr=8, with_norm=True),
    "textured_all_roles": dict(n_ovr=11, with_norm=True, with_diss=True),
    "textured_spec_delta": dict(n_ovr=5),
    "slot_factors": dict(slots=True),
    "tile_lists": dict(tile_lists=True, pixel_origin=(0.0, 8.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_shade_matches_reference(case):
    opt = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 1)
    spec_packed = opt.get("spec_packed", False)
    rows = make_rows(rng, spec_packed)
    s_o = rng.integers(-1, K, (NT, TH, TW)).astype(np.int32)
    s_t = np.where(rng.random((NT, TH, TW)) < 0.3,
                   rng.integers(0, K, (NT, TH, TW)), -1).astype(np.int32)
    s_t[2] = -1  # a tile with no transparent winner
    d_o = rng.uniform(-0.95, 0.6, (NT, TH, TW)).astype(np.float32)
    d_t = rng.uniform(-0.95, 0.6, (NT, TH, TW)).astype(np.float32)
    lights = make_lights(rng)
    cam_pos, inv_pv = camera_inputs()
    kw = dict(spec_packed=spec_packed, shin_const=32.0,
              pixel_origin=opt.get("pixel_origin", (0.0, 0.0)))
    kw_j, kw_t = dict(kw), dict(kw)
    if "n_ovr" in opt:
        ovr = make_override(rng, opt["n_ovr"], opt.get("with_norm", False))
        for d_, f in ((kw_j, jnp.asarray), (kw_t, torch.as_tensor)):
            d_.update(albedo_override=f(ovr),
                      with_norm=opt.get("with_norm", False),
                      with_diss=opt.get("with_diss", False))
    if opt.get("slots"):
        sf = rng.uniform(0.0, 1.0, (2, 2, TH, TW)).astype(np.float32)
        sfi = np.array([[0, -1, 1, -1], [-1, 0, -1, -1]], np.int32)
        ent = np.array([5, 9], np.int32)  # a point and a spot light own one
        for d_, f in ((kw_j, jnp.asarray), (kw_t, torch.as_tensor)):
            d_.update(slot_factor_tiles=f(sf), slot_factor_inv=f(sfi),
                      slot_entity=f(ent))
    if opt.get("tile_lists"):
        tlist = np.array([[0, 2, 0], [1, 2, 3], [3, 0, 0], [0, 0, 0]],
                         np.int32)
        tcount = np.array([2, 3, 1, 0], np.int32)
        kw_j["tile_lights"] = (jnp.asarray(tlist), jnp.asarray(tcount))
        kw_t["tile_lights"] = (torch.as_tensor(tlist),
                               torch.as_tensor(tcount))

    want = SPJ.fused_shade(
        jnp.asarray(rows), jnp.asarray(s_o), jnp.asarray(s_t),
        jnp.asarray(d_o), jnp.asarray(d_t),
        LJ.LightArrays(**{k: jnp.asarray(v) for k, v in lights.items()}),
        jnp.asarray(cam_pos), jnp.asarray(inv_pv), TILES_X, W, H,
        interpret=True, **kw_j)
    got = SPT.fused_shade(
        torch.as_tensor(rows), torch.as_tensor(s_o), torch.as_tensor(s_t),
        torch.as_tensor(d_o), torch.as_tensor(d_t),
        LT.LightArrays(**{k: torch.as_tensor(v) for k, v in lights.items()}),
        torch.as_tensor(cam_pos), torch.as_tensor(inv_pv), TILES_X, W, H,
        **kw_t)
    want = np.asarray(want)
    assert got.shape == want.shape == (8, NT, TH, TW)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the case exercised what it names: lit pixels, both layers, flags
    assert (got[7] == 3.0).any() and (got[7] == 0.0).any()
    assert float(got[0:3].max()) > 0.0 and float(got[3:6].max()) > 0.0


def test_pack_lights_matches_reference():
    lights = make_lights(np.random.default_rng(0))
    ent = np.array([5, 9, -1], np.int32)
    tj, nj = SPJ.pack_lights(
        LJ.LightArrays(**{k: jnp.asarray(v) for k, v in lights.items()}),
        12, slot_entity=jnp.asarray(ent))
    tt, nt_ = SPT.pack_lights(
        LT.LightArrays(**{k: torch.as_tensor(v) for k, v in lights.items()}),
        12, slot_entity=torch.as_tensor(ent))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-6,
                               atol=1e-7)
    assert int(nt_) == int(nj) == 4
