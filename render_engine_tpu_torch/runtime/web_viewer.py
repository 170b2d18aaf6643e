"""Browser window for the headless engine: HTTP frame stream + input.

Port of ``render_engine_tpu/runtime/web_viewer.py`` (standard library and
numpy). A GPU server has no display, so the "window" is a small HTTP
server: the browser paints the latest rendered frame (PNG poll or multipart
stream) and posts keyboard / mouse state back, which the host loop folds
into each frame's InputState.

Usage (see scripts/web_viewer_torch.py for the demo wiring):

    viewer = WebViewer(port=8000)
    while True:
        keys, mouse = viewer.poll_input()
        img = eng.frame(InputState(...), dt)
        viewer.publish(to_srgb_u8(img))

``publish`` takes a CUDA or CPU tensor or a numpy image.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from render_engine_tpu_torch.logic.types import (
    KEY_A,
    KEY_D,
    KEY_DOWN,
    KEY_ESC,
    KEY_INSERT,
    KEY_LEFT,
    KEY_RIGHT,
    KEY_S,
    KEY_SHIFT,
    KEY_SPACE,
    KEY_UP,
    KEY_W,
    NUM_KEYS,
)
from render_engine_tpu_torch.utils.png import encode_png

# JS KeyboardEvent.code -> InputState key index
KEY_CODES = {
    "KeyW": KEY_W, "KeyA": KEY_A, "KeyS": KEY_S, "KeyD": KEY_D,
    "Space": KEY_SPACE, "ShiftLeft": KEY_SHIFT, "ShiftRight": KEY_SHIFT,
    "ArrowUp": KEY_UP, "ArrowDown": KEY_DOWN,
    "ArrowLeft": KEY_LEFT, "ArrowRight": KEY_RIGHT,
    "Escape": KEY_ESC, "Insert": KEY_INSERT,
}

_PAGE = """<!doctype html>
<html><head><title>render_engine_tpu_torch</title><style>
body { margin: 0; background: #000; display: flex; align-items: center;
       justify-content: center; height: 100vh; }
img { image-rendering: pixelated; width: 90vw; }
#hud { position: fixed; top: 8px; left: 8px; color: #8f8;
       font: 12px monospace; }
</style></head><body>
<div id="hud">WASD fly &middot; drag to look &middot; click for pointer
lock</div>
<img id="view" src="/frame.png">
<script>
const view = document.getElementById('view');
const held = new Set();
let dx = 0, dy = 0;
function send() {
  fetch('/input', {method: 'POST', body: JSON.stringify(
    {keys: Array.from(held), dx: dx, dy: dy})});
  dx = 0; dy = 0;
}
document.addEventListener('keydown', e => { held.add(e.code); send(); });
document.addEventListener('keyup', e => { held.delete(e.code); send(); });
document.addEventListener('mousemove', e => {
  if (document.pointerLockElement) { dx += e.movementX; dy += e.movementY; }
});
view.addEventListener('click', () => view.requestPointerLock());
setInterval(send, 50);
function refresh() {
  const img = new Image();
  img.onload = () => { view.src = img.src; requestAnimationFrame(refresh); };
  img.onerror = () => setTimeout(refresh, 250);
  img.src = '/frame.png?' + Date.now();
}
refresh();
</script></body></html>"""


class WebViewer:
    """Serve frames to a browser and collect its input.

    Thread-safe: ``publish`` runs on the engine loop's thread; the HTTP
    server threads only read the latest encoded frame and write the input
    accumulator. ``mouse_sensitivity`` converts browser pixels of pointer
    movement to radians of yaw/pitch."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 mouse_sensitivity: float = 0.003):
        self._lock = threading.Lock()
        self._frame_ready = threading.Condition(self._lock)
        self._png: bytes = encode_png(np.zeros((2, 2, 3), np.uint8))
        self._frame_id = 0
        self._keys = np.zeros(NUM_KEYS, bool)
        self._mouse = np.zeros(2, np.float32)
        self.mouse_sensitivity = float(mouse_sensitivity)
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/frame.png":
                    with viewer._lock:
                        png = viewer._png
                    self._send(200, "image/png", png)
                elif path == "/stream":
                    # multipart PNG stream (one part per published frame)
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    last = -1
                    try:
                        while True:
                            with viewer._frame_ready:
                                viewer._frame_ready.wait_for(
                                    lambda: viewer._frame_id != last,
                                    timeout=5.0)
                                png, last = viewer._png, viewer._frame_id
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(png)}\r\n\r\n"
                                .encode() + png + b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self._send(404, "text/plain", b"not found")

            def do_POST(self):
                if self.path.split("?")[0] != "/input":
                    self._send(404, "text/plain", b"not found")
                    return
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    self._send(400, "text/plain", b"bad json")
                    return
                keys = np.zeros(NUM_KEYS, bool)
                for code in msg.get("keys", []):
                    idx = KEY_CODES.get(code)
                    if idx is not None:
                        keys[idx] = True
                s = viewer.mouse_sensitivity
                with viewer._lock:
                    viewer._keys = keys
                    viewer._mouse[0] += float(msg.get("dx", 0.0)) * s
                    viewer._mouse[1] += -float(msg.get("dy", 0.0)) * s
                self._send(200, "application/json", b"{}")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="web-viewer")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/"

    def publish(self, rgb_u8):
        """Publish the next frame: (H, W, 3) uint8, a tensor on any device
        or a numpy array."""
        if hasattr(rgb_u8, "detach"):
            rgb_u8 = rgb_u8.detach().cpu().numpy()
        png = encode_png(np.asarray(rgb_u8, np.uint8), compress_level=1)
        with self._frame_ready:
            self._png = png
            self._frame_id += 1
            self._frame_ready.notify_all()

    def poll_input(self):
        """(keys bool[NUM_KEYS], mouse_delta f32[2]) for the next frame;
        held keys persist, mouse deltas drain (accumulated since the last
        poll)."""
        with self._lock:
            keys = self._keys.copy()
            mouse = self._mouse.copy()
            self._mouse[:] = 0.0
        return keys, mouse

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)
