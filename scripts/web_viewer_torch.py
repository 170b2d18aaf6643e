"""Fly the demo scene of the PyTorch + CUDA port from a browser.

Serves frames over HTTP and folds the browser's keyboard and mouse state
into each frame's InputState (render_engine_tpu_torch/runtime/web_viewer.py).
Run on the GPU host, then open the printed URL (forward the port if the
host is remote):

    python3 scripts/web_viewer_torch.py [--width 640 --height 360]
                                        [--port 8000] [--device cuda|cpu]

WASD + Space/Shift fly, click the image for pointer-lock mouse look.
``--frames N`` stops after N frames (0: until interrupted).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1",
                    help="bind address; the viewer has no auth, so bind "
                         "0.0.0.0 only on a trusted network (prefer "
                         "forwarding the port to the default loopback)")
    ap.add_argument("--asteroids", type=int, default=200)
    ap.add_argument("--max-fps", type=float, default=None)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.render.frame import to_srgb_u8
    from render_engine_tpu_torch.runtime.host_loop import FpsLimiter
    from render_engine_tpu_torch.runtime.profiling import require_device
    from render_engine_tpu_torch.runtime.web_viewer import WebViewer

    device = require_device(args.device)
    print("building engine ...", flush=True)
    eng = build_space_engine(
        device=device, width=args.width, height=args.height,
        capacity=1 << (args.asteroids + 64).bit_length(),
        num_asteroids=args.asteroids, max_tris=16384)
    eng.config.record_history = False

    viewer = WebViewer(host=args.host, port=args.port)
    print(f"serving on {viewer.url}", flush=True)
    limiter = FpsLimiter(args.max_fps or eng.config.max_fps)
    frame = 0
    last = time.perf_counter()
    try:
        while not args.frames or frame < args.frames:
            limiter.wait()
            # the frame's dt is the time since the last frame began, clamped
            # so that a stall cannot teleport entities
            now = time.perf_counter()
            dt, last = min(now - last, 0.1), now
            keys, mouse = viewer.poll_input()
            img = eng.frame(InputState(keys=keys, mouse_delta=mouse,
                                       rng_seed=frame), dt=dt)
            viewer.publish(to_srgb_u8(img))
            frame += 1
            if frame % 120 == 0:
                print(f"frame {frame}: "
                      f"{eng.fps_stats().get('fps', 0):.1f} fps", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        viewer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
