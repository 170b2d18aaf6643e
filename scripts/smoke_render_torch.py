"""Quick end-to-end render smoke of the PyTorch + CUDA port: a cube, a
sphere, an emissive star, a glass pane and a point light, one frame, a PNG.
The counterpart of ``scripts/smoke_render.py``: a render alone, with no
Engine and no step.

    python3 scripts/smoke_render_torch.py [--device cuda|cpu] [--out DIR]

Builds the JAX script's scene (a 64-row world of five entities, their
AABBs refreshed), renders one 320x240 frame with ``max_tris=4096`` and a
``starfield_cubemap(64)`` sky twice (the first call builds the kernels)
through the JAX script's settings, so through the default non-fused
tiled route (``fused_shading=False``: K1, the tall G-buffers of both
layers and the shading stage), as ``smoke_render.py`` renders on a TPU,
prints the image's statistics and writes ``<DIR>/smoke_torch.png``. It
runs on the card and raises where there is none; ``--device cpu`` runs
the kernels' plain versions. ``--out`` defaults to ``debug_out``.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTH, HEIGHT = 320, 240


def scene(device):
    """``(world, camera, bank, settings, cubemap)`` of the smoke scene on
    ``device``: ``scripts/smoke_render.py``'s, value for value."""
    import numpy as np

    from render_engine_tpu_torch.ecs import registry as R
    from render_engine_tpu_torch.ecs import world as W
    from render_engine_tpu_torch.logic import kinematics as K
    from render_engine_tpu_torch.math.camera import CameraBuilder
    from render_engine_tpu_torch.models import primitives
    from render_engine_tpu_torch.models.bank import ModelBankBuilder
    from render_engine_tpu_torch.render import skybox as SB
    from render_engine_tpu_torch.render.frame import RenderSettings

    bb = ModelBankBuilder()
    red = bb.add_material(albedo=(0.8, 0.2, 0.2))
    blue = bb.add_material(albedo=(0.2, 0.3, 0.9))
    glow = bb.add_material(albedo=(1.0, 0.9, 0.6), emissive=4.0)
    glass = bb.add_material(albedo=(0.3, 0.9, 0.6), alpha=0.4)
    cube_id = bb.add_model("cube", primitives.cube(1.0), material=red)
    sph_id = bb.add_model("sphere", primitives.uv_sphere(0.5, 12, 18),
                          material=blue)
    star_id = bb.add_model("star", primitives.uv_sphere(0.5, 8, 12),
                           material=glow)
    pane_id = bb.add_model("pane", primitives.quad(2.0), material=glass)
    bank = bb.finalize(device)

    cfg = W.WorldConfig(capacity=64, world_length=256.0, section_length=16.0)
    w, _ = W.spawn_host(
        W.create_world(cfg, device), 5,
        # the JAX script's positions, shifted into the world cube
        position=np.array(
            [[0.0, 0.0, -5.0], [1.6, 0.5, -4.0], [-2.0, 1.0, -6.0],
             [0.5, 0.2, -3.0], [0.0, 3.0, -5.0]], np.float32)
        + np.float32(128.0),
        model_id=np.array([cube_id, sph_id, star_id, pane_id, star_id],
                          np.int32),
        scale=np.array([[1, 1, 1]] * 4 + [[0.3, 0.3, 0.3]], np.float32),
        sortable=np.array([0, 0, 0, 0, R.SORTABLE_POINT], np.int32),
        light_diffuse=np.array([[0, 0, 0]] * 4 + [[1.0, 0.95, 0.8]],
                               np.float32),
        light_specular=np.array([[0, 0, 0]] * 4 + [[1.0, 1.0, 1.0]],
                                np.float32),
        light_ambient=np.array([[0, 0, 0]] * 4 + [[0.05, 0.05, 0.05]],
                               np.float32),
        light_atten=np.array([[0, 0]] * 4 + [[0.05, 0.01]], np.float32))
    w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max, w.alive)
    cam = (CameraBuilder()
           .with_position(128.0, 129.0, 131.0)
           .with_yaw_pitch_degrees(-90.0, -10.0)
           .with_fov_degrees(60.0)
           .with_aspect(WIDTH / HEIGHT)
           .with_near_far(0.1, 200.0)
           .with_draw_distance(200.0)
           .build().to(device))
    settings = RenderSettings(width=WIDTH, height=HEIGHT, max_tris=4096)
    return w, cam, bank, settings, SB.starfield_cubemap(64, device=device)


def main(argv=None) -> int:
    from render_engine_tpu_torch.render.frame import render_frame, to_srgb_u8
    from render_engine_tpu_torch.runtime.profiling import (device_info,
                                                           require_device,
                                                           sync)
    from render_engine_tpu_torch.utils.png import write_png

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "debug_out"))
    args = ap.parse_args(argv)
    device = require_device(args.device)

    w, cam, bank, settings, cubemap = scene(device)
    for which in ("first frame (kernels built on first launch)",
                  "second frame"):
        t0 = time.time()
        img = render_frame(w, cam, bank, settings, cubemap=cubemap)
        sync(device)
        print(f"{which}: {time.time() - t0:.3f}s on "
              f"{device_info(device)['device']}")
    arr = to_srgb_u8(img).cpu().numpy()
    print("image stats: mean", arr.mean(), "max", arr.max(),
          "nonzero px", (arr.sum(-1) > 0).mean())
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "smoke_torch.png")
    write_png(path, arr)
    print(f"wrote {os.path.relpath(path)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
