"""Hold the JAX package's two shading routes' PCF factors to the PyTorch
port's on one captured frame.

The fused path takes each pixel's camera NDC and depth to light clip space
through one composed matrix (``frame._per_slot_factor_tiles``); the
non-fused path unprojects the G-buffer's world position and projects it
into each light (``shadows.slot_factors``). For a far pixel both are
differences of terms near 1e3 (the inverse projection's), so the two
routes may put it on different texels or sides of the light's frustum, and
that pixel's shadow factor then differs between the fused and the
non-fused frame.

    python3 chip_smoke.py --shadow-routes profile_out/shadow_routes.npz
    JAX_PLATFORMS=cpu python3 scripts/shadow_routes_jax.py \\
        profile_out/shadow_routes.npz

The archive (written by the port's ``chip_smoke.py``, phase 12) holds the
frame's depth and winner tiles from K1, the shadow maps, the camera, the
pixels where the port's non-fused frame differs from its fused one by 0.05
or more, the port's two routes' factors of every active slot there (on the
card and on the host's CPU) and the masks of the pixels where the port's
routes differ. This script computes both JAX routes from the same depth
and maps on the CPU and prints: at how many pixels JAX's two routes differ,
by how many ninths, and how many of those the port's routes share; then, at
each of the port's flipped pixels, its depth and the factors of both
routes in both packages.
"""

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def jax_routes(z):
    """JAX's fused and non-fused factors of the active slots, each
    (S_active, H, W) numpy float32."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from render_engine_tpu.math import transforms as T
    from render_engine_tpu.render import frame as F
    from render_engine_tpu.render import raster_pallas as RP
    from render_engine_tpu.render import shadows as SH

    h, w = int(z["height"]), int(z["width"])
    th, tw = int(z["tile_h"]), int(z["tile_w"])
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    nt = tiles_x * tiles_y
    maps = jnp.asarray(z["maps"])
    budget = maps.shape[0]
    sh = dataclasses.replace(
        SH.create_shadow_state(resolution=int(z["resolution"]),
                               budget=budget, pcf_scale=1),
        maps=maps,
        maps_pcf=jnp.stack([SH.neighborhood_stack(maps[s])
                            for s in range(budget)]),
        light_mats=jnp.asarray(z["light_mats"]),
        slot_entity=jnp.asarray(z["slot_entity"]),
        slot_face=jnp.asarray(z["slot_face"]))
    d, wn = jnp.asarray(z["depth"]), jnp.asarray(z["winner"])
    inv_pv = T.inv44(jnp.asarray(z["proj_view"]))

    @jax.jit
    def fused(sh, d, wn, inv_pv):
        sft, sfi = F._per_slot_factor_tiles(sh, d, wn, tiles_x, th, tw, w, h,
                                            inv_pv, 0.0, 1.0)
        rows = sft[jnp.arange(budget)[:, None], jnp.maximum(sfi, 0)]
        return jnp.where((sfi >= 0)[..., None, None], rows, 1.0)

    @jax.jit
    def nonfused(sh, d, wn, inv_pv):
        # the tall layout's pixel centers, as the non-fused frame builds
        # them; the G-buffer's position depends on no attribute channel
        tids = jnp.arange(nt, dtype=jnp.int32)
        oy = ((tids // tiles_x) * th).astype(jnp.float32)
        ox = ((tids % tiles_x) * tw).astype(jnp.float32)
        py = jnp.broadcast_to(
            oy[:, None, None] + jnp.arange(th, dtype=jnp.float32)[
                None, :, None] + 0.5, (nt, th, tw)).reshape(nt * th, tw)
        px = jnp.broadcast_to(
            ox[:, None, None] + jnp.arange(tw, dtype=jnp.float32)[
                None, None, :] + 0.5, (nt, th, tw)).reshape(nt * th, tw)
        ch = jnp.zeros((35, nt * th, tw), jnp.float32)
        g, _ = RP._gbuffer_from_channels(
            ch, d.reshape(nt * th, tw), wn.reshape(nt * th, tw), h, w,
            inv_pv, px=px, py=py)
        return SH.slot_factors(sh, g.position)

    def image(f):  # (S, NT * th, tw) or (S, NT, th, tw) -> (S, H, W)
        f = np.asarray(f).reshape(budget, tiles_y, tiles_x, th, tw)
        f = f.transpose(0, 1, 3, 2, 4).reshape(budget, tiles_y * th,
                                               tiles_x * tw)
        return f[:, :h, :w]

    active = np.asarray(z["slot_entity"]) >= 0
    return (image(fused(sh, d, wn, inv_pv))[active],
            image(nonfused(sh, d, wn, inv_pv))[active])


def main(argv=None) -> int:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archive", help="chip_smoke.py --shadow-routes output")
    args = ap.parse_args(argv)
    z = np.load(args.archive)
    fused, tall = jax_routes(z)
    jax_differ = (fused != tall).any(axis=0)
    ninths, count = np.unique(
        np.rint(np.abs(fused - tall).max(axis=0)[jax_differ] * 9),
        return_counts=True)
    print(f"JAX routes differ at {int(jax_differ.sum())} pixels, by "
          f"{dict(zip(ninths.tolist(), count.tolist()))} ninths (the "
          "largest slot difference: pixels)")
    for where in ("", "_cpu"):
        port = z["routes_differ" + where]
        print(f"the port's routes on the {'CPU' if where else 'card'} "
              f"differ at {int(port.sum())} pixels, "
              f"{int((jax_differ & port).sum())} of them JAX's too")
    th, tw = int(z["tile_h"]), int(z["tile_w"])
    tiles_x = -(-int(z["width"]) // tw)
    rows = []
    for i, (y, x) in enumerate(z["flips"].tolist()):
        rec = dict(
            y=y, x=x, depth=float(z["depth"][(y // th) * tiles_x + x // tw,
                                             y % th, x % tw]),
            color_diff_port=float(np.abs(
                z["color_fused"][i] - z["color_nonfused"][i]).max()),
            **{f"port_{k}": z[f"factors_{k}"][:, i].tolist()
               for k in ("fused", "nonfused", "fused_cpu", "nonfused_cpu")},
            jax_fused=fused[:, y, x].tolist(),
            jax_nonfused=tall[:, y, x].tolist(),
            jax_routes_differ=bool(jax_differ[y, x]))
        rows.append(rec)
        print(json.dumps(rec))
    flipped = sum(r["jax_routes_differ"] for r in rows)
    print(f"JAX's two routes differ at {flipped} of the port's {len(rows)} "
          "flipped pixels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
