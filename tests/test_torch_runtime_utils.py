"""The port's runtime tools (``runtime/profiling.py``, ``runtime/host_loop.py``,
``utils/png.py``, ``runtime/web_viewer.py``) on the CPU, mirroring
tests/test_runtime_utils.py and tests/test_web_viewer.py.

PNG bytes must equal the JAX package's for the same array; everything else
here is host behaviour with no numeric tolerance (the served frame equals
the engine's sRGB bytes exactly).
"""

import json
import os
import socket
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from render_engine_tpu.render.textures import _load_png
from render_engine_tpu.utils import png as PNGJ
from render_engine_tpu_torch.demo.space_scene import build_space_engine
from render_engine_tpu_torch.logic.types import (KEY_SPACE, KEY_W, NUM_KEYS,
                                                 InputState)
from render_engine_tpu_torch.render.frame import to_srgb_u8
from render_engine_tpu_torch.runtime import profiling as PT
from render_engine_tpu_torch.runtime.host_loop import FpsLimiter
from render_engine_tpu_torch.runtime.web_viewer import WebViewer
from render_engine_tpu_torch.utils import png as PNGT
from torch_threads import one_torch_thread  # noqa: F401


class TestStageTimer:
    """``runtime/profiling.py``'s ``trace`` and ``device_activity`` (its
    spans: tests/test_torch_spans.py)."""

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with PT.trace(str(tmp_path / "tr")) as prof:
            torch.ones(64).sum()
        path = tmp_path / "tr" / "trace.json"
        assert path.exists() and os.path.getsize(path) > 0
        assert "traceEvents" in json.loads(path.read_text())
        assert any("sum" in e.key for e in prof.key_averages())

    @pytest.mark.parametrize("rows, want", [
        # two rows that overlap, one inside another, a gap, a host row
        ([(0, 100, "cuda"), (50, 150, "cuda"), (60, 70, "cuda"),
          (300, 400, "cuda"), (0, 1000, "cpu")],
         {"rows": 4, "sum_ms": 0.31, "busy_ms": 0.25, "span_ms": 0.4}),
        # back to back: busy for the whole span, the sum equal to the union
        ([(10, 20, "cuda"), (20, 30, "cuda")],
         {"rows": 2, "sum_ms": 0.02, "busy_ms": 0.02, "span_ms": 0.02}),
        ([(0, 5, "cpu")],
         {"rows": 0, "sum_ms": 0.0, "busy_ms": 0.0, "span_ms": 0.0})],
        ids=["overlap_and_gap", "back_to_back", "no_device_rows"])
    def test_device_activity(self, rows, want):
        """The device's busy time is the union of its rows' intervals (us
        in the trace, ms out); host rows do not count."""
        from types import SimpleNamespace

        kinds = {"cuda": torch.autograd.DeviceType.CUDA,
                 "cpu": torch.autograd.DeviceType.CPU}
        events = [SimpleNamespace(
            time_range=SimpleNamespace(start=float(a), end=float(b)),
            device_type=kinds[k]) for a, b, k in rows]
        got = PT.device_activity(events)
        assert got["rows"] == want["rows"]
        for key in ("sum_ms", "busy_ms", "span_ms"):
            assert got[key] == pytest.approx(want[key], abs=1e-12), key


class TestFpsLimiter:
    def test_cap_sleeps_to_budget(self):
        lim = FpsLimiter(50.0)  # 20 ms budget
        t0 = time.perf_counter()
        for _ in range(5):
            lim.wait()
        assert time.perf_counter() - t0 >= 0.08

    def test_over_budget_frames_do_not_sleep(self):
        lim = FpsLimiter(1000.0)
        time.sleep(0.01)
        assert lim.wait() == 0.0

    def test_uncapped(self):
        assert FpsLimiter(None).wait() == 0.0

    def test_delta_time_is_clamped(self):
        lim = FpsLimiter(None)
        lim._instant -= 5.0
        assert lim.delta_time() == 0.1


class TestPng:
    @pytest.mark.parametrize("shape,level", [((8, 16, 3), 6), ((33, 7, 3), 1),
                                             ((1, 1, 3), 9)])
    def test_bytes_equal_the_jax_packages(self, shape, level):
        rgb = np.random.default_rng(sum(shape)).integers(
            0, 256, shape).astype(np.uint8)
        mine = PNGT.encode_png(rgb, compress_level=level)
        assert mine == PNGJ.encode_png(rgb, compress_level=level)
        np.testing.assert_array_equal(_load_png(mine), rgb)

    def test_write_png(self, tmp_path):
        rgb = np.arange(4 * 5 * 3, dtype=np.uint8).reshape(4, 5, 3)
        a, b = tmp_path / "a.png", tmp_path / "b.png"
        PNGT.write_png(str(a), rgb)
        PNGJ.write_png(str(b), rgb)
        assert a.read_bytes() == b.read_bytes()


class TestWebViewer:
    def _get(self, url):
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()

    def _post(self, base, msg):
        req = urllib.request.Request(base + "input",
                                     data=json.dumps(msg).encode(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status

    def test_frame_and_input_roundtrip(self):
        viewer = WebViewer()
        try:
            base = viewer.url
            assert base.startswith("http://127.0.0.1:")
            status, page = self._get(base)
            assert status == 200 and b"render_engine_tpu_torch" in page
            rgb = np.zeros((8, 16, 3), np.uint8)
            rgb[:, :8] = [255, 0, 0]
            for frame in (rgb, torch.from_numpy(rgb)):  # numpy and tensor
                viewer.publish(frame)
                status, png = self._get(base + "frame.png")
                assert status == 200
                np.testing.assert_array_equal(_load_png(png), rgb)
            assert self._post(base, {"keys": ["KeyW", "Space", "KeyQ"],
                                     "dx": 10.0, "dy": -4.0}) == 200
            keys, mouse = viewer.poll_input()
            assert keys[KEY_W] and keys[KEY_SPACE]
            assert keys.sum() == 2  # the unknown KeyQ is ignored
            np.testing.assert_allclose(
                mouse, [10.0 * viewer.mouse_sensitivity,
                        4.0 * viewer.mouse_sensitivity], atol=1e-7)
            keys2, mouse2 = viewer.poll_input()
            assert keys2[KEY_W]  # held keys persist, deltas drain
            assert (mouse2 == 0).all()
            with pytest.raises(urllib.error.HTTPError):
                self._get(base + "nope")
        finally:
            viewer.close()

    def test_multipart_stream_delivers_published_frames(self):
        viewer = WebViewer()
        try:
            host, port = viewer._server.server_address[:2]
            frames = [np.full((4, 8, 3), v, np.uint8) for v in (10, 200)]
            viewer.publish(frames[0])
            sock = socket.create_connection((host, port), timeout=10)
            sock.sendall(b"GET /stream HTTP/1.1\r\nHost: x\r\n\r\n")
            sock.settimeout(10)

            def read_until(buf, marker):
                while marker not in buf:
                    chunk = sock.recv(65536)
                    assert chunk, "stream closed early"
                    buf += chunk
                return buf

            buf = read_until(b"", b"multipart/x-mixed-replace")

            def read_part(buf):
                buf = read_until(buf, b"--frame\r\n")
                buf = buf[buf.index(b"--frame\r\n") + len(b"--frame\r\n"):]
                buf = read_until(buf, b"\r\n\r\n")
                head_end = buf.index(b"\r\n\r\n")
                n = int(buf[:head_end].split(b"Content-Length: ")[1]
                        .split(b"\r\n")[0])
                buf = buf[head_end + 4:]
                while len(buf) < n:
                    chunk = sock.recv(65536)
                    assert chunk, "stream closed mid-part"
                    buf += chunk
                return buf[:n], buf[n:]

            png1, rest = read_part(buf)
            np.testing.assert_array_equal(_load_png(png1), frames[0])
            timer = threading.Timer(0.1, viewer.publish, (frames[1],))
            timer.start()
            png2, _ = read_part(rest)
            np.testing.assert_array_equal(_load_png(png2), frames[1])
            timer.join(timeout=5.0)
            assert not timer.is_alive()
            sock.close()
        finally:
            viewer.close()

    def test_drives_live_engine_end_to_end(self):
        """The window loop against the port's engine: the browser posts a
        held W and a pointer turn, the loop folds ``poll_input`` into the
        InputState, the engine renders, ``publish`` serves the frame."""
        eng = build_space_engine(device="cpu", width=128, height=32,
                                 capacity=64, num_asteroids=4, max_tris=2048)
        eng.config.record_history = False
        viewer = WebViewer()
        try:
            base = viewer.url
            assert self._post(base, {"keys": ["KeyW"], "dx": 30.0,
                                     "dy": 0.0}) == 200
            pos0 = eng.camera.position.clone()
            yaw0 = float(eng.camera.yaw)
            for frame in range(3):
                keys, mouse = viewer.poll_input()
                img = eng.frame(InputState(keys=keys, mouse_delta=mouse,
                                           rng_seed=frame), dt=1 / 60)
                viewer.publish(to_srgb_u8(img))
            assert not torch.allclose(eng.camera.position, pos0)
            assert float(eng.camera.yaw) != yaw0
            status, png = self._get(base + "frame.png")
            assert status == 200
            np.testing.assert_array_equal(_load_png(png),
                                          to_srgb_u8(img).numpy())
            assert NUM_KEYS == keys.shape[0]
        finally:
            viewer.close()
