"""Space-scene smoke of the PyTorch + CUDA port: build the demo engine, run
frames, dump a PNG, record and replay, and compare world hashes.

    python3 scripts/smoke_space_torch.py [--device cuda|cpu] [--out DIR]

Passes when it prints ``DETERMINISTIC REPLAY OK`` and ``wrote
<DIR>/space_torch.png`` (a starfield, a bright star, asteroids) and exits 0.
It runs on the card and raises where there is none; ``--device cpu`` runs
the kernels' plain versions. ``--out`` defaults to ``debug_out``; the
history log goes to a temporary directory.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KW = dict(width=320, height=240, capacity=128, num_asteroids=40,
          max_tris=8192)


def main(argv=None) -> int:
    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import KEY_W, InputState
    from render_engine_tpu_torch.render.frame import to_srgb_u8
    from render_engine_tpu_torch.runtime.history import HistoryLog
    from render_engine_tpu_torch.runtime.profiling import (device_info,
                                                           require_device,
                                                           sync)
    from render_engine_tpu_torch.runtime.replay import Player
    from render_engine_tpu_torch.utils.hashing import world_hash
    from render_engine_tpu_torch.utils.png import write_png

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "debug_out"))
    args = ap.parse_args(argv)
    device = require_device(args.device)

    t0 = time.time()
    eng = build_space_engine(device=device, **KW)
    print(f"engine built in {time.time() - t0:.1f}s on "
          f"{device_info(device)['device']}, "
          f"{int(eng.world.alive.sum())} entities")

    t0 = time.time()
    img = eng.frame(InputState.idle(0).with_keys(KEY_W), dt=1 / 30)
    sync(device)
    print(f"first frame (kernels built on first launch): "
          f"{time.time() - t0:.1f}s")

    t0 = time.time()
    n = 5
    for i in range(1, n + 1):
        img = eng.frame(InputState.idle(i).with_keys(KEY_W), dt=1 / 30)
    sync(device)
    print(f"{n} frames: {(time.time() - t0) / n * 1e3:.0f} ms/frame")
    print("stats:", eng.fps_stats())

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "space_torch.png")
    write_png(path, to_srgb_u8(img).cpu().numpy())
    print(f"wrote {os.path.relpath(path)}")
    h_live = world_hash(eng.world)

    with tempfile.TemporaryDirectory() as d:
        eng.config.history_dir = d
        flushed = eng.flush_history()
        print("history flushed:", os.path.basename(flushed),
              f"({eng.history.num_frames} frames)")
        hist = HistoryLog.load(d)
    eng2 = build_space_engine(device=device, **KW)
    hashes = Player(eng2, hist).replay_all(render=False)
    print("live   hash:", h_live[:16])
    print("replay hash:", hashes[-1][:16])
    if h_live != hashes[-1]:
        raise SystemExit("REPLAY DIVERGED")
    print("DETERMINISTIC REPLAY OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
