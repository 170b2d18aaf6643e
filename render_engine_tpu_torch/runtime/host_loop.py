"""Host-side frame pacing: the interactive loop's FPS limiter.

Port of ``render_engine_tpu/runtime/host_loop.py``: after presenting a
frame, sleep for the remainder of the frame budget; frames that ran over
budget do not sleep and accrue no catch-up debt.
scripts/terminal_viewer_torch.py drives the demo with it.
"""

from __future__ import annotations

import time


class FpsLimiter:
    """wait() returns the seconds slept (0 when over budget)."""

    def __init__(self, max_fps: float | None):
        self.time_per_frame = (1.0 / max_fps) if max_fps else None
        self._instant = time.perf_counter()

    def wait(self) -> float:
        if self.time_per_frame is None:
            self._instant = time.perf_counter()
            return 0.0
        elapsed = time.perf_counter() - self._instant
        to_wait = max(0.0, self.time_per_frame - elapsed)
        if to_wait > 0.0:
            time.sleep(to_wait)
        self._instant = time.perf_counter()
        return to_wait

    def delta_time(self) -> float:
        """Seconds since the last wait(): the measured frame dt, clamped so
        a long stall cannot teleport entities."""
        return min(time.perf_counter() - self._instant, 0.1)
