"""Render systems with per-frame draw callbacks and custom fragment shading
in the port, on the fused tiled path and on the golden path, mirroring
``tests/test_render_systems.py``; and against the JAX package where a
callback can be written once per package (in jnp and in torch).

Tolerances: inside the port, pixels that a callback does not touch must be
equal bit for bit (``torch.equal``); a per-frame uniform write equals the
static one within 1e-6; the fused path against the golden path within 2e-3
(as the JAX tests hold theirs). Against JAX: images within 2/255 on all but
0.5% of pixels (an edge pixel may flip between the rasters).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from render_engine_tpu.ecs import world as WJ
from render_engine_tpu.logic import kinematics as KJ
from render_engine_tpu.math.camera import CameraBuilder as CBJ
from render_engine_tpu.models import primitives as PJ
from render_engine_tpu.models.bank import ModelBankBuilder as MBJ
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import render_system as RSJ
from render_engine_tpu.render.raster_jnp import RasterConfig as RCJ
from render_engine_tpu_torch import convert
from render_engine_tpu_torch.ecs import world as WT
from render_engine_tpu_torch.logic import kinematics as KT
from render_engine_tpu_torch.logic.types import KEY_W
from render_engine_tpu_torch.logic.types import InputState as InputT
from render_engine_tpu_torch.math.camera import CameraBuilder as CBT
from render_engine_tpu_torch.models import primitives as PT
from render_engine_tpu_torch.models.bank import ModelBankBuilder as MBT
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import render_system as RST
from render_engine_tpu_torch.render import textures as TXT
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT

H, WIDTH = 32, 128
RASTER = dict(tile_budget=16, max_tiles_per_tri=8, global_budget=8)
JAX_PK = (MBJ, PJ, WJ, KJ, CBJ)
TORCH_PK = (MBT, PT, WT, KT, CBT)
BACKENDS = ["auto", "jnp"]
Builder = RST.RenderSystemBuilder


def camera(cb):
    return (cb().with_position(64.0, 64.0, 64.0)
            .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
            .with_aspect(WIDTH / H).with_near_far(0.1, 100.0)
            .with_draw_distance(100.0).build())


def scene(pk=TORCH_PK, texture=-1):
    """A red cube left of centre (model ``cube``) and a gray one right of
    it (model ``star``)."""
    MB, P, W, K, CB = pk
    bb = MB()
    red = bb.add_material(albedo=(1.0, 0.0, 0.0), texture=texture)
    glow = bb.add_material(albedo=(0.5, 0.5, 0.5))
    cube = bb.add_model("cube", P.cube(1.5), material=red)
    star = bb.add_model("star", P.cube(1.5), material=glow)
    bank = bb.finalize()
    w = W.create_world(W.WorldConfig(capacity=8, world_length=128.0,
                                     section_length=16.0))
    w, _ = W.spawn_host(
        w, 2, position=np.array([[62.0, 64.0, 59.0], [66.0, 64.0, 59.0]],
                                np.float32),
        model_id=np.array([cube, star], np.int32))
    w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max, w.alive)
    return w, bank, camera(CB), cube, star


def glass_scene(pk=TORCH_PK):
    """A gray cube behind a half-transparent green pane at the centre."""
    MB, P, W, K, CB = pk
    bb = MB()
    solid = bb.add_material(albedo=(0.3, 0.3, 0.3))
    glass = bb.add_material(albedo=(0.2, 0.9, 0.4), alpha=0.5)
    cube = bb.add_model("cube", P.cube(1.5), material=solid)
    pane = bb.add_model("pane", P.quad(2.5), material=glass)
    bank = bb.finalize()
    w = W.create_world(W.WorldConfig(capacity=8, world_length=128.0,
                                     section_length=16.0))
    w, _ = W.spawn_host(
        w, 2, position=np.array([[64.0, 64.0, 57.0], [64.0, 64.0, 60.0]],
                                np.float32),
        model_id=np.array([cube, pane], np.int32))
    w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max, w.alive)
    return w, bank, camera(CB), cube, pane


def settings(backend="auto", **kw):
    return FT.RenderSettings(width=WIDTH, height=H, max_tris=64,
                             backend=backend, fused_shading=True,
                             raster=RCT(**RASTER), **kw)


def jax_settings(backend):
    return FJ.RenderSettings(width=WIDTH, height=H, max_tris=64,
                             backend=backend, fused_shading=True,
                             raster=RCJ(chunk=4, **RASTER))


def compiled(bank, *builders):
    return RST.compile_systems(tuple(b.build() for b in builders), bank)


def render(w, cam, bank, backend, systems, **kw):
    return FT.render_frame(w, cam, bank, settings(backend), systems=systems,
                           **kw)


LEFT, RIGHT = slice(0, WIDTH // 2), slice(WIDTH // 2, WIDTH)


class TestBuilder:
    def test_callbacks_must_be_callable(self):
        b = Builder("x").with_models(0)
        with pytest.raises(TypeError):
            b.with_draw_function("draw")
        with pytest.raises(TypeError):
            b.with_fragment_shading(3)

    def test_compiled_systems_know_their_callbacks(self):
        w, bank, cam, cube, star = scene()
        plain = compiled(bank, Builder("a").with_models(cube, star))
        assert not plain.has_draw_callbacks()
        assert not plain.has_shade_callbacks()
        both = compiled(
            bank, Builder("a").with_models(cube).with_draw_function(print),
            Builder("b").with_models(star).with_fragment_shading(print))
        assert both.has_draw_callbacks() and both.has_shade_callbacks()
        assert [s.name for s in both.src] == ["a", "b"]
        assert both.src[0].shade is None and both.src[1].draw is None
        # converted tables carry no callbacks unless given the records
        conv = convert.systems_from_numpy(
            both.model_system.numpy(), both.sys_table.numpy(),
            both.sys_lov.numpy(), both.names)
        assert conv.src == () and not conv.has_draw_callbacks()
        conv = convert.systems_from_numpy(
            both.model_system.numpy(), both.sys_table.numpy(),
            both.sys_lov.numpy(), both.names, src=both.src)
        assert conv.has_shade_callbacks()

    def test_unknown_uniform_needs_a_shading_function(self):
        w, bank, cam, cube, star = scene()
        with pytest.raises(ValueError, match="unknown uniform"):
            compiled(bank, Builder("x").with_models(cube)
                     .write_uniform("brightness", 6.0))
        ok = compiled(bank, Builder("x").with_models(cube)
                      .write_uniform("brightness", 6.0)
                      .with_fragment_shading(lambda sp: sp.base_color))
        torch.testing.assert_close(
            ok.sys_table[0], torch.tensor([0.0, 1, 1, 1, 1, 1]))


@pytest.mark.parametrize("backend", BACKENDS)
class TestDrawCallbacks:
    def test_callback_gates_instances(self, backend):
        """A system with a draw callback renders only what the callback
        draws that frame."""
        w, bank, cam, cube, star = scene()
        systems = compiled(bank, Builder("all").with_models(cube, star)
                           .with_draw_function(lambda dp:
                                               dp.draw_models(cube)))
        img = render(w, cam, bank, backend, systems)
        assert (img[:, LEFT, 0] > 0.0).any()  # the cube drew
        assert float(img[:, RIGHT].sum()) == 0.0  # the star was not drawn
        # a system without a callback stays statically routed
        mixed = compiled(
            bank, Builder("c").with_models(cube)
            .with_draw_function(lambda dp: None),
            Builder("s").with_models(star))
        img = render(w, cam, bank, backend, mixed)
        assert float(img[:, LEFT].sum()) == 0.0
        assert (img[:, RIGHT] > 0.0).any()

    def test_when_takes_a_tensor(self, backend):
        w, bank, cam, cube, star = scene()
        seen = {}

        def draw(dp):
            x = dp.get_camera().position[0]  # 64 for the scene camera
            seen["when"] = x > 100.0
            dp.draw_models(cube, when=x > 100.0)
            dp.draw_models(star, when=x > 0.0)
            assert dp.get_ecs() is w

        systems = compiled(bank, Builder("all").with_models(cube, star)
                           .with_draw_function(draw))
        img = render(w, cam, bank, backend, systems)
        assert isinstance(seen["when"], torch.Tensor)
        assert float(img[:, LEFT].sum()) == 0.0  # the cube is gated off
        assert (img[:, RIGHT] > 0.0).any()

    def test_sortable_filter(self, backend):
        w, bank, cam, cube, star = scene()
        col = torch.zeros(w.capacity, dtype=torch.int32)
        col[0], col[1] = 3, 7
        w = w.replace(sortable=col)
        for sortable in (3, (3, 5)):
            systems = compiled(
                bank, Builder("all").with_models(cube, star)
                .with_draw_function(lambda dp, s=sortable: dp.draw_models(
                    cube, star, sortable=s)))
            img = render(w, cam, bank, backend, systems)
            assert (img[:, LEFT, 0] > 0.0).any()  # bucket 3: the cube
            assert float(img[:, RIGHT].sum()) == 0.0  # bucket 7 filtered

    def test_per_frame_uniform_write_matches_static(self, backend):
        w, bank, cam, cube, star = scene()

        def tint_blue(dp):
            dp.draw_models(cube, star)
            one = (dp.get_ecs()["position"][0, 0] / 62.0).clamp(max=1.0)
            dp.write_uniform("albedo_tint",
                             torch.stack([one * 0.0, one * 0.0, one]))

        dyn = compiled(bank, Builder("all").with_models(cube, star)
                       .with_draw_function(tint_blue))
        static = compiled(bank, Builder("all").with_models(cube, star)
                          .write_uniform("albedo_tint", (0.0, 0.0, 1.0)))
        a = render(w, cam, bank, backend, dyn)
        b = render(w, cam, bank, backend, static)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        untinted = render(w, cam, bank, backend, compiled(
            bank, Builder("all").with_models(cube, star)))
        assert (untinted[:, LEFT, 0] > a[:, LEFT, 0] + 0.01).any()

    def test_alpha_scale_write_scales_the_transparent_blend(self, backend):
        """``alpha_scale`` written per frame multiplies the pane's alpha
        (0.5 -> 0.25): the blend moves halfway back to the opaque frame.
        (Routing to the transparent class reads the compiled table, as in
        the JAX package, so the opaque cube stays opaque.)"""
        w, bank, cam, cube, pane = glass_scene()

        def draw(models, scale=None):
            def fn(dp):
                dp.draw_models(*models)
                if scale is not None:
                    dp.write_uniform("alpha_scale", torch.tensor(scale))
            return compiled(bank, Builder("g").with_models(cube, pane)
                            .with_draw_function(fn))

        plain = render(w, cam, bank, backend, draw((cube, pane)))
        scaled = render(w, cam, bank, backend, draw((cube, pane), 0.5))
        opaque = render(w, cam, bank, backend, draw((cube,)))
        cy, cx = H // 2, WIDTH // 2
        assert not torch.allclose(plain[cy, cx], opaque[cy, cx], atol=0.01)
        torch.testing.assert_close(scaled[cy, cx],
                                   0.5 * plain[cy, cx] + 0.5 * opaque[cy, cx],
                                   rtol=0, atol=1e-6)

    def test_emissive_boost_write_replaces_the_buildtime_uniform(self,
                                                                 backend):
        """A system compiled with uniform 4.0 and written 0.5 per frame
        renders like one compiled with 0.5, on ``render_frame`` and on
        ``render_frame_systems``, which agree with each other."""
        w, bank, cam, cube, star = scene()

        def mk(build_uniform, write):
            def draw(dp):
                dp.draw_models(cube, star)
                if write is not None:
                    dp.write_uniform("emissive_boost", torch.tensor(write))
            b = (Builder("glow").with_models(cube, star).with_lighting(False)
                 .with_emissive_boost(2.0).with_draw_function(draw))
            if build_uniform is not None:
                b = b.write_uniform("emissive_boost", build_uniform)
            return compiled(bank, b)

        overwritten, direct = mk(4.0, 0.5), mk(0.5, None)
        a = render(w, cam, bank, backend, overwritten)
        b = render(w, cam, bank, backend, direct)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        ga = RST.render_frame_systems(w, cam, bank, overwritten.src,
                                      settings("jnp"))
        gb = RST.render_frame_systems(w, cam, bank, direct.src,
                                      settings("jnp"))
        torch.testing.assert_close(ga, gb, rtol=0, atol=1e-6)
        if backend == "jnp":
            torch.testing.assert_close(a, ga, rtol=0, atol=1e-5)
        # unlit: albedo * 2.0 * 0.5 where covered
        assert float(a[H // 2, 50, 0]) == pytest.approx(1.0, abs=1e-5)
        # without the write the build-time uniform stands: boost 8
        c = render(w, cam, bank, backend, mk(4.0, None))
        assert float(c[H // 2, 75, 0]) == pytest.approx(1.0, abs=1e-5)
        assert float(a[H // 2, 75, 0]) == pytest.approx(0.5, abs=1e-5)

    def test_skybox_toggle(self, backend):
        w, bank, cam, cube, star = scene()
        white_sky = torch.ones((6, 4, 4, 3))

        def build(on):
            def draw(dp):
                dp.draw_models(cube, star)
                dp.draw_skybox(on)
            return compiled(bank, Builder("all").with_models(cube, star)
                            .with_draw_function(draw))

        for on, off in ((True, False),
                        (torch.tensor(True), cam.position[0] > 100.0)):
            img_on = render(w, cam, bank, backend, build(on),
                            cubemap=white_sky)
            img_off = render(w, cam, bank, backend, build(off),
                             cubemap=white_sky)
            assert float(img_on[0, 0].sum()) > 2.9  # the white sky
            assert float(img_off[0, 0].sum()) == 0.0  # the clear color
            assert torch.equal(img_on[H // 2, 48:56], img_off[H // 2, 48:56])

    def test_input_gating(self, backend):
        """Draw callbacks read the frame's inputs: a held key draws the
        system, a released one hides it."""
        w, bank, cam, cube, star = scene()

        def draw_on_w(dp):
            dp.draw_models(cube, star,
                           when=dp.get_input_history().keys[KEY_W])

        systems = compiled(bank, Builder("all").with_models(cube, star)
                           .with_draw_function(draw_on_w))
        held = render(w, cam, bank, backend, systems,
                      inputs=InputT.idle(0).with_keys(KEY_W).to_device("cpu"))
        released = render(w, cam, bank, backend, systems,
                          inputs=InputT.idle(1).to_device("cpu"))
        assert (held > 0.0).any()
        assert float(released.sum()) == 0.0

    @pytest.mark.parametrize("fault,match", [
        ("unbound", "not bound"), ("uniform", "unknown uniform"),
        ("empty", "at least one model")])
    def test_rejections(self, backend, fault, match):
        w, bank, cam, cube, star = scene()

        def draw(dp):
            if fault == "unbound":
                dp.draw_models(star)
            elif fault == "empty":
                dp.draw_models()
            else:
                dp.draw_models(cube)
                dp.write_uniform("nonsense", 1.0)

        systems = compiled(bank, Builder("c").with_models(cube)
                           .with_draw_function(draw))
        with pytest.raises(ValueError, match=match):
            render(w, cam, bank, backend, systems)


def two_systems(bank, cube, star, shade):
    return compiled(bank,
                    Builder("n").with_models(cube)
                    .with_fragment_shading(shade),
                    Builder("s").with_models(star))


@pytest.mark.parametrize("backend", BACKENDS)
class TestCustomShading:
    def test_applies_to_own_pixels_only(self, backend):
        w, bank, cam, cube, star = scene()
        shapes = []

        def show_normals(sp):
            shapes.append(tuple(sp.base_color.shape))
            assert sp.normal.shape == sp.albedo.shape == sp.position.shape
            assert sp.depth.shape == sp.material.shape == sp.covered.shape
            assert sp.camera is cam and sp.lights.pt_position.shape[1] == 3
            return 0.5 * (sp.normal + 1.0)

        img = render(w, cam, bank, backend,
                     two_systems(bank, cube, star, show_normals))
        ref = render(w, cam, bank, backend, compiled(
            bank, Builder("n").with_models(cube),
            Builder("s").with_models(star)))
        # the cube faces the camera: normal (0, 0, 1) -> (0.5, 0.5, 1)
        torch.testing.assert_close(img[H // 2, 50],
                                   torch.tensor([0.5, 0.5, 1.0]), rtol=0,
                                   atol=1e-3)
        assert torch.equal(img[:, RIGHT], ref[:, RIGHT])
        assert torch.equal(img[0], ref[0])  # the background too
        # both layers, in the path's pixel layout
        want = (H, WIDTH, 3) if backend == "jnp" else (H // 8 * 8, 128, 3)
        assert shapes == [want, want]

    def test_reads_uniforms_static_and_per_frame(self, backend):
        w, bank, cam, cube, star = scene()

        def flat_color(sp):
            c = torch.as_tensor(sp.uniforms["flat_rgb"], dtype=torch.float32)
            return c.expand(sp.base_color.shape)

        b = (Builder("f").with_models(cube, star)
             .write_uniform("flat_rgb", (0.0, 1.0, 0.0))
             .with_fragment_shading(flat_color))
        img = render(w, cam, bank, backend, compiled(bank, b))
        covered = img.sum(dim=-1) > 0
        assert covered.any()
        green = torch.tensor([0.0, 1.0, 0.0])
        torch.testing.assert_close(img[covered],
                                   green.expand(int(covered.sum()), 3),
                                   rtol=0, atol=1e-6)

        def draw(dp):
            dp.draw_models(cube, star)
            dp.write_uniform("flat_rgb", torch.stack(
                [dp.get_camera().position[0] * 0.0, torch.tensor(0.0),
                 torch.tensor(1.0)]))

        img2 = render(w, cam, bank, backend,
                      compiled(bank, b.with_draw_function(draw)))
        blue = torch.tensor([0.0, 0.0, 1.0])
        torch.testing.assert_close(img2[covered],
                                   blue.expand(int(covered.sum()), 3),
                                   rtol=0, atol=1e-6)

    def test_wrong_shape_is_rejected(self, backend):
        w, bank, cam, cube, star = scene()
        with pytest.raises(ValueError, match="returned shape"):
            render(w, cam, bank, backend, two_systems(
                bank, cube, star, lambda sp: sp.base_color[..., 0]))

    def test_transparent_layer_is_shaded_too(self, backend):
        w, bank, cam, cube, pane = glass_scene()
        magenta = torch.tensor([1.0, 0.0, 1.0])
        shaded = compiled(bank, Builder("g").with_models(cube, pane)
                          .with_fragment_shading(
                              lambda sp: magenta.expand(sp.base_color.shape)))
        plain = compiled(bank, Builder("g").with_models(cube, pane))
        img = render(w, cam, bank, backend, shaded)
        ref = render(w, cam, bank, backend, plain)
        # cube and pane both magenta: the blend at the centre is magenta
        cy, cx = H // 2, WIDTH // 2
        torch.testing.assert_close(img[cy, cx], magenta, rtol=0, atol=1e-5)
        assert not torch.allclose(ref[cy, cx], magenta, atol=0.1)


def fancy(sp):
    tone = torch.as_tensor(sp.uniforms["tone"], dtype=torch.float32)
    n = 0.5 * (sp.normal + 1.0)
    return (sp.base_color * tone + 0.2 * sp.albedo * n).clamp(0.0, 1.0)


def fancy_jnp(sp):
    tone = jnp.asarray(sp.uniforms["tone"], jnp.float32)
    n = 0.5 * (sp.normal + 1.0)
    return jnp.clip(sp.base_color * tone + 0.2 * sp.albedo * n, 0.0, 1.0)


def test_custom_shading_fused_matches_golden():
    w, bank, cam, cube, star = scene()
    systems = compiled(bank, Builder("w").with_models(cube, star)
                       .write_uniform("tone", 0.8)
                       .with_fragment_shading(fancy))
    a = render(w, cam, bank, "jnp", systems)
    b = render(w, cam, bank, "auto", systems)
    torch.testing.assert_close(a, b, rtol=0, atol=2e-3)
    plain = render(w, cam, bank, "auto", compiled(
        bank, Builder("w").with_models(cube, star)))
    assert not torch.allclose(b, plain, atol=1e-2)


def test_custom_shading_fused_sees_the_textured_albedo():
    """On a textured scene ``ShadeParam.albedo`` is the texel the lighting
    consumed: the fused hook samples the atlas like the golden resolve."""
    ab = TXT.TextureAtlasBuilder(layer_size=64)
    tex = ab.add_checkerboard(a=(1.0, 0.8, 0.2), b=(0.1, 0.2, 0.9), cells=4)
    atlas = ab.finalize()
    w, bank, cam, cube, star = scene(texture=tex)
    systems = two_systems(bank, cube, star, lambda sp: sp.albedo)
    imgs = {b: FT.render_frame(w, cam, bank, settings(b), atlas=atlas,
                               systems=systems) for b in BACKENDS}
    diff = (imgs["auto"] - imgs["jnp"]).abs().amax(dim=-1)
    assert float((diff < 2e-3).double().mean()) > 0.99, float(diff.max())
    left = imgs["auto"][:, LEFT]
    # both checker colors show, and no plain red material albedo
    assert (left[..., 2] > 0.8).any() and (left[..., 1] > 0.7).any()
    assert not ((left[..., 0] == 1.0) & (left[..., 1] == 0.0)).any()


def _both_scenes(scene_fn):
    wj, bj, cj, m0, m1 = scene_fn(JAX_PK)
    wt, bt, ct, _, _ = scene_fn(TORCH_PK)
    return (wj, bj, cj), (wt, bt, ct), m0, m1


def _assert_images_close(img_t, img_j):
    diff = np.abs(img_t.numpy() - np.asarray(img_j)).max(axis=-1)
    assert (diff > 2.0 / 255.0).mean() <= 5e-3, diff.max()
    assert np.median(diff) <= 1e-5


@pytest.mark.parametrize("jax_backend,backend", [("jnp", "jnp"),
                                                 ("pallas", "auto")])
def test_callback_frame_matches_reference(jax_backend, backend):
    """One system with a draw callback (a gate on a tensor, a tint written
    per frame, the skybox off) and one with a shading function, through
    ``render_frame`` of both packages."""
    (wj, bj, cj), (wt, bt, ct), cube, star = _both_scenes(scene)

    def draw_j(dp):
        dp.draw_models(cube, when=dp.get_camera().position[0] > 0.0)
        dp.write_uniform("albedo_tint", jnp.asarray([1.0, 0.5, 0.25]))
        dp.draw_skybox(dp.get_camera().position[0] > 100.0)

    def draw_t(dp):
        dp.draw_models(cube, when=dp.get_camera().position[0] > 0.0)
        dp.write_uniform("albedo_tint", torch.tensor([1.0, 0.5, 0.25]))
        dp.draw_skybox(dp.get_camera().position[0] > 100.0)

    def systems(rs, bank, draw, shade):
        return rs.compile_systems((
            rs.RenderSystemBuilder("c").with_models(cube)
            .with_draw_function(draw).build(),
            rs.RenderSystemBuilder("s").with_models(star)
            .write_uniform("tone", 0.8).with_fragment_shading(shade)
            .build()), bank)

    sky = np.full((6, 4, 4, 3), 0.7, np.float32)
    img_j = FJ.render_frame(wj, cj, bj, jax_settings(jax_backend),
                            cubemap=jnp.asarray(sky),
                            systems=systems(RSJ, bj, draw_j, fancy_jnp))
    img_t = FT.render_frame(wt, ct, bt, settings(backend),
                            cubemap=torch.tensor(sky),
                            systems=systems(RST, bt, draw_t, fancy))
    _assert_images_close(img_t, img_j)
    assert float(img_t[0, 0].sum()) == 0.0  # the skybox is off
    assert (img_t[:, LEFT, 0] > 0).any() and (img_t[:, RIGHT] > 0).any()


@pytest.mark.parametrize("case", ["two_systems", "draw_callback",
                                  "custom_shading", "glass"])
def test_render_frame_systems_matches_reference(case):
    """The golden multi-system renderer against the JAX package's."""
    sc = glass_scene if case == "glass" else scene
    (wj, bj, cj), (wt, bt, ct), m0, m1 = _both_scenes(sc)
    sky = np.full((6, 4, 4, 3), 0.6, np.float32)

    def build(rs, draw, shade):
        B = rs.RenderSystemBuilder
        if case == "two_systems":
            return (B("default").with_models(m0)
                    .write_uniform("albedo_tint", (1.0, 0.6, 0.3)).build(),
                    B("stars").with_models(m1).with_lighting(False)
                    .with_emissive_boost(6.0).build())
        if case == "draw_callback":
            return (B("all").with_models(m0, m1).with_draw_function(draw)
                    .build(),)
        if case == "custom_shading":
            return (B("n").with_models(m0).write_uniform("tone", 0.8)
                    .with_fragment_shading(shade).build(),
                    B("s").with_models(m1).build())
        return (B("g").with_models(m0, m1).write_uniform("tone", 0.5)
                .write_uniform("alpha_scale", 0.8)
                .with_fragment_shading(shade).build(),)

    def draw(dp):
        dp.draw_models(m0)  # m1 is bound but not submitted
        dp.draw_skybox(False)

    img_j = RSJ.render_frame_systems(wj, cj, bj, build(RSJ, draw, fancy_jnp),
                                     jax_settings("jnp"),
                                     cubemap=jnp.asarray(sky))
    img_t = RST.render_frame_systems(wt, ct, bt, build(RST, draw, fancy),
                                     settings("jnp"),
                                     cubemap=torch.tensor(sky))
    _assert_images_close(img_t, img_j)
    if case == "two_systems":
        # the unlit boosted star: gray * 6 clipped to 1
        torch.testing.assert_close(img_t[H // 2, 75], torch.ones(3), rtol=0,
                                   atol=1e-5)
    if case == "draw_callback":
        assert float(img_t[0, 0].sum()) == 0.0
        assert float(img_t[:, RIGHT].sum()) == 0.0


def test_render_frame_systems_routes_models():
    """A system only draws its own models; one system over every model is
    the plain frame."""
    w, bank, cam, cube, star = scene()
    only_cube = RST.render_frame_systems(
        w, cam, bank, (Builder("c").with_models(cube).build(),),
        settings("jnp"))
    assert float(only_cube[H // 2, 75].sum()) == 0.0
    assert float(only_cube[H // 2, 50, 0]) > 0.0
    both = RST.render_frame_systems(
        w, cam, bank, (Builder("all").with_models(cube, star).build(),),
        settings("jnp"))
    plain = FT.render_frame(w, cam, bank, settings("jnp"))
    torch.testing.assert_close(both, plain, rtol=0, atol=1e-6)


def test_entity_shade_attrs_takes_this_frames_rows():
    w, bank, cam, cube, star = scene()
    systems = compiled(bank, Builder("a").with_models(cube),
                       Builder("b").with_models(star))
    base = RST.entity_shade_attrs(w, systems)
    rows = systems.sys_table.clone()
    rows[1, 2:5] = torch.tensor([0.1, 0.2, 0.3])
    got = RST.entity_shade_attrs(w, systems, sys_table=rows)
    assert torch.equal(got[0], base[0])
    torch.testing.assert_close(got[1, 2:5], torch.tensor([0.1, 0.2, 0.3]))
    assert torch.equal(got[2], torch.tensor([0.0, 1, 1, 1, 1, 1]))  # dead row
    tri = RST.triangle_system_ids(
        FT.build_triangle_batch(w, bank, cam, max_tris=64, systems=systems),
        w, systems)
    assert set(tri.tolist()) <= {0, 1} and (tri == 1).any()
