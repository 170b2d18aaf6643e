"""The exact codecs and the coordinate math of the port against the JAX
package (CPU): the spec/Ns channel packing, the 8-float camera vector, the
InputState wire, the level-of-view band selection and full-f32 matrix
composition."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from render_engine_tpu.logic.types import InputState as IJ
from render_engine_tpu.math import transforms as TJ
from render_engine_tpu.math.camera import CameraBuilder as CBJ
from render_engine_tpu.models import bank as BJ
from render_engine_tpu.models import primitives as PJ
from render_engine_tpu_torch.logic.types import InputState as IT
from render_engine_tpu_torch.math import transforms as TT
from render_engine_tpu_torch.math.camera import CameraBuilder as CBT
from render_engine_tpu_torch.models import bank as BT
from render_engine_tpu_torch.models import primitives as PT


def test_spec_shin_codec_exact():
    spec = np.concatenate([np.linspace(-0.5, 4.5, 601),
                           [0.0, 1.0, 3.999, 4.0]]).astype(np.float32)
    shin = np.concatenate([np.linspace(0.0, 2100.0, 601),
                           [1.0, 64.0, 2047.0, 2047.4]]).astype(np.float32)
    pj = np.asarray(BJ.pack_spec_shin(jnp.asarray(spec), jnp.asarray(shin)))
    pt = BT.pack_spec_shin(torch.as_tensor(spec), torch.as_tensor(shin))
    np.testing.assert_array_equal(pt.numpy(), pj)
    for a, b in zip(BJ.unpack_spec_shin(jnp.asarray(pj)),
                    BT.unpack_spec_shin(pt)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("moves", [0, 3])
def test_camera_vector_exact(moves):
    def build(cb):
        return (cb().with_position(1000.0, 1000.0, 1150.0)
                .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
                .with_aspect(1920 / 1080).with_near_far(0.5, 1500.0)
                .with_draw_distance(1500.0).build())

    cj, ct = build(CBJ), build(CBT)
    for i in range(moves):
        d = np.float32(0.37 * (i + 1))
        cj = cj.rotated(d, np.float32(-0.9 * d))
        ct = ct.rotated(float(d), float(-0.9 * d))
    np.testing.assert_array_equal(ct.serialize().numpy(),
                                  np.asarray(cj.serialize()))
    vec = np.arange(8, dtype=np.float32) * np.float32(1.25)
    np.testing.assert_array_equal(
        ct.apply_serialized(torch.as_tensor(vec)).serialize().numpy(),
        np.asarray(cj.apply_serialized(jnp.asarray(vec)).serialize()))
    np.testing.assert_allclose(ct.proj_view().numpy(),
                               np.asarray(cj.proj_view()), rtol=1e-6,
                               atol=1e-5)


def test_input_wire_exact():
    mouse = np.array([0.02, -0.01], np.float32)
    ij = dataclasses.replace(IJ.idle(0xFFFFFFFE).with_keys(1, 4),
                             mouse_delta=mouse)
    ij = ij.with_prev(np.eye(ij.keys.shape[0], dtype=bool)[2])
    it = dataclasses.replace(IT.idle(0xFFFFFFFE).with_keys(1, 4),
                             mouse_delta=mouse)
    it = it.with_prev(np.eye(it.keys.shape[0], dtype=bool)[2])
    pj, pt = ij.pack_with_dt(1 / 60), it.pack_with_dt(1 / 60)
    np.testing.assert_array_equal(pt, pj)
    back, dt = IT.unpack_with_dt(pt)
    assert back.rng_seed == 0xFFFFFFFE and dt == np.float32(1 / 60)
    np.testing.assert_array_equal(back.keys, it.keys)
    np.testing.assert_array_equal(back.prev_keys, it.prev_keys)
    np.testing.assert_array_equal(it.serialize(), ij.serialize())
    row = IT.deserialize(it.serialize())
    want = IJ.deserialize(ij.serialize())
    assert row.rng_seed == want.rng_seed == 0xFFFFFFFE
    np.testing.assert_array_equal(row.keys, want.keys)
    np.testing.assert_array_equal(row.mouse_delta, want.mouse_delta)


def lov_bank(mb, pr):
    """Models 0 (full), 1 (mid) and 2 (far) are one LoV chain; 3 stands
    alone."""
    bb = mb.ModelBankBuilder()
    full = bb.add_model("full", pr.uv_sphere(1.0, 8, 12))
    mid = bb.add_model("mid", pr.icosahedron(1.0))
    far = bb.add_model("far", pr.tetrahedron(1.0))
    bb.add_model("box", pr.cube(1.0))
    bb.set_levels_of_view(full, [full, mid, mid, far, far, far])
    return bb.finalize()


def test_lov_band_selection_matches():
    bj, bt = lov_bank(BJ, PJ), lov_bank(BT, PT)
    model = np.array([0, 0, 0, 0, 0, 0, 1, -1, 2], np.int32)
    dist = np.array([0.0, 100.0, 149.9, 150.0, 400.0, 1499.0, 50.0, 10.0,
                     2000.0], np.float32)
    for bias in (0, 1):
        want = np.asarray(bj.lov_model_id(jnp.asarray(model),
                                          jnp.asarray(dist), 1500.0, bias))
        got = bt.lov_model_id(torch.as_tensor(model), torch.as_tensor(dist),
                              1500.0, bias)
        np.testing.assert_array_equal(got.numpy(), want)


def test_far_plane_full_f32():
    """proj @ view composes in full f32 (TF32 off): the far plane, whose
    extraction cancels, matches a float64 reference like the JAX
    package's does (tests/test_math.py::TestMatmulPrecision)."""
    pos = np.array([1000.0, 1000.0, 880.0], np.float32)
    d = np.array([0.0, -0.3, 1.0])
    d = (d / np.linalg.norm(d)).astype(np.float32)
    persp = TT.perspective(2.1, 1.0, 1.0, 400.0)
    view = TT.look_at(torch.as_tensor(pos), torch.as_tensor(pos + d),
                      torch.tensor([0.0, 1.0, 0.0]))
    planes = TT.frustum_planes(TT.mm44(persp, view)).numpy()
    r = persp.double().numpy() @ view.double().numpy()
    pl64 = np.stack([r[3] + r[0], r[3] - r[0], r[3] + r[1], r[3] - r[1],
                     r[3] + r[2], r[3] - r[2]])
    pl64 /= np.linalg.norm(pl64[:, :3], axis=-1, keepdims=True)
    np.testing.assert_allclose(planes[5, 3], pl64[5, 3], atol=1e-2)
    np.testing.assert_allclose(planes, pl64, rtol=1e-4, atol=1e-2)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    pj = np.asarray(TJ.perspective(jnp.float32(2.1), 1.0, 1.0,
                                   jnp.float32(400.0)))
    np.testing.assert_allclose(persp.numpy(), pj, rtol=1e-6)


def systems(rs):
    lit = (rs.RenderSystemBuilder("tinted").with_models(0)
           .write_uniform("albedo_tint", (0.5, 0.25, 1.0))
           .write_uniform("alpha_scale", 0.5).build())
    glow = (rs.RenderSystemBuilder("glow").with_models(3)
            .with_lighting(False).with_emissive_boost(3.0)
            .write_uniform("emissive_boost", 2.0)
            .with_levels_of_view(False).build())
    return lit, glow


@pytest.mark.parametrize("case", ["routing", "unknown_uniform",
                                  "bound_twice"])
def test_compile_systems_matches(case):
    """Per-model routing (LoV variants inherit their base's system), the
    per-system shading rows from the uniforms, and the same rejections."""
    from render_engine_tpu.render import render_system as RSJ
    from render_engine_tpu_torch.render import render_system as RST

    bj, bt = lov_bank(BJ, PJ), lov_bank(BT, PT)
    sj, st = systems(RSJ), systems(RST)
    if case == "unknown_uniform":
        sj = sj + (RSJ.RenderSystemBuilder("x").with_models(1)
                   .write_uniform("roughness", 0.3).build(),)
        st = st + (RST.RenderSystemBuilder("x").with_models(1)
                   .write_uniform("roughness", 0.3).build(),)
    elif case == "bound_twice":  # model 1 is already a variant of model 0
        sj = sj + (RSJ.RenderSystemBuilder("x").with_models(1).build(),)
        st = st + (RST.RenderSystemBuilder("x").with_models(1).build(),)
    if case != "routing":
        with pytest.raises(ValueError):
            RSJ.compile_systems(sj, bj)
        with pytest.raises(ValueError):
            RST.compile_systems(st, bt)
        return
    cj, ct = RSJ.compile_systems(sj, bj), RST.compile_systems(st, bt)
    for f in ("model_system", "sys_table", "sys_lov"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(),
                                      np.asarray(getattr(cj, f)), err_msg=f)
    assert ct.names == cj.names == ("tinted", "glow")
    np.testing.assert_array_equal(ct.model_system.numpy(), [0, 0, 0, 1])
