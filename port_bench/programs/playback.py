"""The program of a playback configuration: a recorded session replayed
frame by frame with a detached camera, as a debugging session opens a log.

``build`` records the session first: the demo's Engine as
``programs/space.py`` builds it from the file and the seed, with
``record_history`` on, runs frames 0 to ``recording.frames - 1`` of the
``recording.traffic`` mix under the seed through ``Engine.frame`` (the
``step`` mix: headless); ``Engine.flush_history`` writes the log to a
temporary directory and ``HistoryLog.load`` reads it back; the recording
engine is dropped. A fresh Engine, built from the same file and seed, then
replays the log through ``runtime/replay.py``'s ``Player``, put in
DEBUG_CUSTOM_MOVEMENT (Esc) before the first frame: its detached camera
starts at the recording's baseline camera and flies on each frame's
controls.

``build`` returns a ``Playback``, driven as the harness drives an Engine
(README.md, "A program file"): ``frame(inputs, dt, render)`` is one
``Player.step(inputs, render=render)``, the inputs the user's controls, and
returns the detached camera's image; a replayed frame runs at the recorded
``dt``. Past the recording's end it continues live as a user does: Up for
one live frame, then Right (RUN), each later frame the traffic's inputs.
``world``, ``camera`` (the recorded camera, which drives the step),
``shadow_state``, ``config``, ``captured_programs``, ``capture_seconds()``,
``program_function(key)``, ``set_tracing`` (below), ``trace_report`` and
``frame_index`` are the replaying Engine's, and so are the traced run's
direct probes ``step()`` and ``update_shadows()``; its ``render()`` probe
is ``Engine.render`` through the detached camera, the program the detached
frames run. The probes move the Engine's state outside the Player.

The live frames past the end run the Engine's frame programs, which a
replayed frame never does: set-up captures them (``Engine.capture``), and
so does ``set_tracing`` after it drops every program, so that no frame
captures a program after warm-up, however far a run gets. A port without
``Engine.capture`` cannot run this program: ``build`` fails at once."""

from __future__ import annotations

import gc
import importlib
import tempfile

from port_bench import manifest
from port_bench.programs import space
from port_bench.traffic import Traffic

PROGRAM = space.PROGRAM
# the Engine's own, which a harness probe or a check reads through it
ENGINE = ("world", "camera", "shadow_state", "config", "captured_programs",
          "capture_seconds", "program_function", "trace_report",
          "frame_index", "step", "update_shadows")


def record(cfg: dict, seed: int, device, overrides=None):
    """The session of ``cfg``'s ``recording`` under ``seed``, recorded on a
    demo Engine, written to disk and read back: a ``HistoryLog``."""
    H = importlib.import_module(f"{PROGRAM}.runtime.history")
    L = importlib.import_module(f"{PROGRAM}.logic.types")
    rec = cfg["recording"]
    traffic = Traffic(manifest.traffic(rec["traffic"]), seed)
    eng = space.build(dict(cfg, record_history=True), seed, device,
                      overrides)
    for i in range(int(rec["frames"])):
        fr = traffic.frame(i)
        eng.frame(L.InputState(keys=fr.keys, mouse_delta=fr.mouse_delta,
                               rng_seed=fr.rng_seed), fr.dt, render=fr.render)
    with tempfile.TemporaryDirectory() as d:
        eng.config.history_dir = d
        eng.flush_history()
        log = H.HistoryLog.load(d)
    return log


class Playback:
    """A ``Player`` over its Engine, as the harness drives an Engine (the
    module docstring)."""

    def __init__(self, eng, player):
        L = importlib.import_module(f"{PROGRAM}.logic.types")
        R = importlib.import_module(f"{PROGRAM}.runtime.replay")
        self.eng, self.player, self._modes = eng, player, R.PlaybackMode
        self._up = L.InputState.idle().with_keys(L.KEY_UP)
        self._right = L.InputState.idle().with_keys(L.KEY_RIGHT)
        player.handle_controls(L.InputState.idle().with_keys(L.KEY_ESC))

    def capture_live(self):
        """Captures the programs of the frames past the recording's end:
        the frame program of each shadow decision the Engine can take."""
        cfg = self.eng.config
        decisions = [None] if not cfg.enable_shadows else (
            ["map", "skip"] if cfg.shadow_update_interval > 1 else ["map"])
        for decision in decisions:
            self.eng.capture(("frame", decision))

    def set_tracing(self, on: bool):
        """``Engine.set_tracing``, then the live frames' programs again."""
        self.eng.set_tracing(on)
        self.capture_live()

    def __getattr__(self, name):
        if name in ENGINE:
            return getattr(self.eng, name)
        raise AttributeError(name)

    @property
    def detached_camera(self):
        return self.player.detached_camera

    def frame(self, inputs, dt=None, render: bool = True):
        """One playback frame on the controls ``inputs``; returns its image
        (None without ``render``). ``dt`` is unused: a replayed frame runs
        at its recorded one, a live frame at the Engine's default."""
        p, modes = self.player, self._modes
        if p.mode is modes.ONE_PAST_LAST_PAUSE:
            p.handle_controls(self._right)  # Right: live running resumes
        img, _ = p.step(inputs, render=render)
        if p.mode is modes.ONE_PAST_LAST_FRAME:
            # the recording's end ran no frame: Up runs one live frame
            img, _ = p.step(self._up, render=render)
        return img

    def render(self, camera=None, inputs=None):
        """``Engine.render`` through ``camera``, the detached camera by
        default."""
        return self.eng.render(camera or self.player.detached_camera,
                               inputs)


def build(cfg: dict, seed: int, device, overrides=None):
    """The playback of the configuration ``cfg`` with the scene drawn from
    ``seed``; ``overrides`` changes ``space_config`` arguments (the tests'
    small sizes)."""
    R = importlib.import_module(f"{PROGRAM}.runtime.replay")
    E = importlib.import_module(f"{PROGRAM}.runtime.engine")
    if not hasattr(E.Engine, "capture"):
        raise RuntimeError("this port's Engine has no capture(): the "
                           "playback program cannot warm its live frames")
    log = record(cfg, seed, device, overrides)
    gc.collect()
    eng = space.build(dict(cfg, record_history=False), seed, device,
                      overrides)
    playback = Playback(eng, R.Player(eng, log))
    playback.capture_live()
    return playback
