"""Interactive terminal viewer of the PyTorch + CUDA port: fly the demo
scene with WASD and the arrow keys.

The engine renders offscreen, so the interactive path is a host loop that
feeds keys into the InputState and paints frames as ANSI half-block
characters. Run in any truecolor terminal:

    python3 scripts/terminal_viewer_torch.py [--width 160] [--height 88]
                                             [--device cuda|cpu]

Controls: w/a/s/d thrust, space/c up/down, arrow keys look, q quits.
Needs a TTY; exits with a note when stdin is not interactive.
"""

import argparse
import dataclasses
import os
import select
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def paint(rgb: np.ndarray) -> str:
    """(H, W, 3) uint8 -> ANSI half-block string (two rows a character)."""
    h, w = rgb.shape[:2]
    out = ["\x1b[H"]
    for y in range(0, h - 1, 2):
        row = []
        for x in range(w):
            tr, tg, tb = rgb[y, x]
            br, bg, bb = rgb[y + 1, x]
            row.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        out.append("".join(row) + "\x1b[0m\n")
    return "".join(out)


def read_keys(stream, keymap):
    """Drain ``stream``: (quit, held key indices, [yaw, pitch] look)."""
    keys, look = set(), [0.0, 0.0]
    arrows = {"[A": (1, 0.05), "[B": (1, -0.05), "[C": (0, 0.05),
              "[D": (0, -0.05)}
    while select.select([stream], [], [], 0)[0]:
        c = stream.read(1)
        if c == "q" or c == "":
            return True, keys, look
        if c in keymap:
            keys.add(keymap[c])
        elif c == "\x1b":  # arrow escape sequences
            axis, step = arrows.get(stream.read(2), (0, 0.0))
            look[axis] += step
    return False, keys, look


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=88)
    ap.add_argument("--max-fps", type=float, default=None,
                    help="FPS cap (default: EngineConfig.max_fps)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    if not sys.stdin.isatty():
        print("terminal_viewer_torch needs an interactive TTY")
        return 0

    import termios
    import tty

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import (KEY_A, KEY_D, KEY_S,
                                                     KEY_SHIFT, KEY_SPACE,
                                                     KEY_W, InputState)
    from render_engine_tpu_torch.render.frame import to_srgb_u8
    from render_engine_tpu_torch.runtime.host_loop import FpsLimiter
    from render_engine_tpu_torch.runtime.profiling import require_device

    device = require_device(args.device)
    print("building engine ...")
    eng = build_space_engine(device=device, width=args.width,
                             height=args.height, capacity=256,
                             num_asteroids=40, max_tris=16384)
    max_fps = args.max_fps if args.max_fps is not None else eng.config.max_fps
    limiter = FpsLimiter(max_fps)
    keymap = {"w": KEY_W, "a": KEY_A, "s": KEY_S, "d": KEY_D,
              " ": KEY_SPACE, "c": KEY_SHIFT}

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J")
    frame = 0
    last = time.perf_counter()
    try:
        while True:
            quit_, keys, look = read_keys(sys.stdin, keymap)
            if quit_:
                return 0
            inp = dataclasses.replace(
                InputState.idle(frame).with_keys(*keys),
                mouse_delta=np.asarray(look, np.float32))
            now = time.perf_counter()
            dt, last = min(now - last, 0.1), now
            img = eng.frame(inp, dt=dt)
            sys.stdout.write(paint(to_srgb_u8(img).cpu().numpy()))
            sys.stdout.write(
                f"\x1b[0m{1.0 / max(dt, 1e-6):5.1f} fps  "
                f"cap {max_fps:.0f}  frame {frame}  (q quits)\n")
            sys.stdout.flush()
            limiter.wait()
            frame += 1
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
        sys.stdout.write("\x1b[0m\n")


if __name__ == "__main__":
    sys.exit(main())
