"""The port's scripts (``scripts/*_torch.py``) on the CPU at their small
sizes: the smoke run ends in ``DETERMINISTIC REPLAY OK`` and a decodable
PNG, the replay tool finds no divergence on either scene and names the
first differing frame and cells of a doctored replay, the viewers' host
loops run. Host behaviour only; nothing numeric is compared beyond exact
equality of replayed state.
"""

import io
import os
import sys
import urllib.request

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import replay_torch  # noqa: E402
import smoke_space_torch  # noqa: E402
import terminal_viewer_torch  # noqa: E402
import web_viewer_torch  # noqa: E402

from render_engine_tpu.render.textures import _load_png  # noqa: E402
from render_engine_tpu_torch.logic.types import KEY_D, KEY_W  # noqa: E402
from render_engine_tpu_torch.runtime import web_viewer as WV  # noqa: E402

from torch_threads import one_torch_thread  # noqa: E402,F401


def test_smoke_space(tmp_path, capsys, monkeypatch):
    # the script's flow at a size one CPU thread renders in seconds
    monkeypatch.setattr(smoke_space_torch, "KW", dict(
        width=160, height=72, capacity=128, num_asteroids=24, max_tris=4096))
    assert smoke_space_torch.main(["--device", "cpu", "--out",
                                   str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "DETERMINISTIC REPLAY OK" in out and "space_torch.png" in out
    img = _load_png((tmp_path / "space_torch.png").read_bytes())
    assert img.shape == (72, 160, 3) and img.max() > 128


@pytest.mark.parametrize("scene,frames", [("space", 4), ("features", 5)])
def test_replay_tool_finds_no_divergence(scene, frames):
    lines = []
    found = replay_torch.run(scene, frames, "cpu",
                             log=lambda *a: lines.append(" ".join(map(str,
                                                                      a))))
    assert found is None
    assert lines[-1].startswith(f"REPLAY OK: no divergence over {frames}")
    live, replay = (ln.split()[-1] for ln in lines[-3:-1])
    assert live == replay and len(live) == 16


def test_replay_tool_names_the_first_divergence():
    a = [{"position": np.zeros((4, 3), np.float32),
          "alive": np.ones(4, bool)} for _ in range(3)]
    b = [{k: v.copy() for k, v in f.items()} for f in a]
    assert replay_torch.first_divergence(a, b) is None
    b[1]["position"][2, 1] = 5.0
    b[2]["alive"][0] = False
    frame, report = replay_torch.first_divergence(a, b)
    assert frame == 1 and len(report) == 1
    name, count, cells = report[0]
    assert (name, count) == ("position", 1)
    assert cells == [([2, 1], 0.0, 5.0)]


def test_replay_tool_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay_torch.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smoke_space_torch.main([])


def test_terminal_viewer_paint_and_keys(monkeypatch):
    rgb = np.zeros((4, 3, 3), np.uint8)
    rgb[0, 0] = [255, 1, 2]
    rgb[1, 0] = [3, 4, 5]
    text = terminal_viewer_torch.paint(rgb)
    assert text.startswith("\x1b[H")
    assert "\x1b[38;2;255;1;2m\x1b[48;2;3;4;5m▀" in text
    assert text.count("\n") == 2  # two image rows a character row

    stream = io.StringIO("wd\x1b[A\x1b[Cx")
    monkeypatch.setattr(
        terminal_viewer_torch.select, "select",
        lambda r, w, x, t: ([stream] if stream.tell() < 9 else [], [], []))
    quit_, keys, look = terminal_viewer_torch.read_keys(
        stream, {"w": KEY_W, "d": KEY_D})
    assert not quit_ and keys == {KEY_W, KEY_D}
    assert look == pytest.approx([0.05, 0.05])
    stream = io.StringIO("q")
    monkeypatch.setattr(terminal_viewer_torch.select, "select",
                        lambda r, w, x, t: ([stream], [], []))
    assert terminal_viewer_torch.read_keys(stream, {})[0] is True
    # without a TTY the viewer says so and returns
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    assert terminal_viewer_torch.main(["--device", "cpu"]) == 0


def test_web_viewer_script_serves_frames(monkeypatch, capsys):
    """Three frames of the script's loop on a free port; the last frame is
    fetched from the server before the loop closes it."""
    served = {}
    close = WV.WebViewer.close

    def fetch_then_close(self):
        with urllib.request.urlopen(self.url + "frame.png", timeout=10) as r:
            served["png"] = r.read()
        close(self)

    monkeypatch.setattr(WV.WebViewer, "close", fetch_then_close)
    assert web_viewer_torch.main(
        ["--device", "cpu", "--width", "128", "--height", "32",
         "--asteroids", "8", "--port", "0", "--frames", "3",
         "--max-fps", "1000"]) == 0
    assert "serving on http://127.0.0.1:" in capsys.readouterr().out
    img = _load_png(served["png"])
    assert img.shape == (32, 128, 3) and img.max() > 0
