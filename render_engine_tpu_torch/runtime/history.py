"""Record and replay history: a baseline snapshot and the per-frame inputs.

Port of ``render_engine_tpu/runtime/history.py``, numpy only. The step is
a function of the state and the frame's inputs (its random draws come from
the recorded seed through the bit-exact threefry, logic/random.py), so the
baseline world and camera plus every frame's ``(InputState, dt)`` rebuild
every later state by running the step again.

On disk: ``gameplay_history.npz`` and ``history_meta.json``, format v2,
byte-compatible with the JAX package's, so either package reads the
other's logs. The npz holds ``version`` (int32), ``camera`` ((8,) f32),
``inputs`` ((N, 19) f32; ``(0, 19)`` when empty), ``dt`` ((N,) f32),
``fused`` ((N,) uint8, the frame's advance flag), ``alive``,
``comp_mask`` and one ``comp_<name>`` per column, in the JAX package's
dtypes (uint32 bit sets). v1 logs have no ``fused``: every frame read as
a step.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from render_engine_tpu_torch.ecs import world as W
from render_engine_tpu_torch.logic.types import InputState

FORMAT_VERSION = 2  # v2 adds the per-frame advance flag
INPUT_WIDTH = 19  # InputState.serialize: 16 keys, 2 mouse, 1 seed


class HistoryLog:
    """Host-side accumulation of the frame input stream."""

    def __init__(self):
        self.baseline_world: dict | None = None
        self.baseline_camera: np.ndarray | None = None
        self.frames_inputs: list[np.ndarray] = []
        self.frames_dt: list[float] = []
        # per frame: True where it advanced as a "fused" frame (step, shadow
        # update, render), False for a step; replay passes it back
        self.frames_fused: list[bool] = []
        self.meta: dict = {}
        # config-change events, keyed by the index of the frame they precede
        self.events: dict = {}

    # -- recording -----------------------------------------------------------
    def set_baseline(self, world, camera, meta: dict | None = None):
        self.baseline_world = W.snapshot(world)
        self.baseline_camera = camera.serialize().cpu().numpy()
        self.meta = dict(meta or {})

    def record_frame(self, inputs: InputState, dt: float,
                     fused: bool = False):
        self.frames_inputs.append(np.asarray(inputs.serialize()))
        self.frames_dt.append(float(dt))
        self.frames_fused.append(bool(fused))

    def record_event(self, event: dict):
        """A config change to apply before the NEXT recorded frame."""
        self.events.setdefault(self.num_frames, {}).update(event)

    @property
    def num_frames(self) -> int:
        return len(self.frames_dt)

    # -- disk ----------------------------------------------------------------
    def write_to_disk(self, directory: str) -> str:
        """Write the log; a failed write of the npz is tried once more."""
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, "gameplay_history.npz")
        payload = {
            "version": np.int32(FORMAT_VERSION),
            "camera": self.baseline_camera,
            "inputs": (np.stack(self.frames_inputs) if self.frames_inputs
                       else np.zeros((0, INPUT_WIDTH), np.float32)),
            "dt": np.asarray(self.frames_dt, np.float32),
            "fused": np.asarray(self.frames_fused, np.uint8),
            "alive": self.baseline_world["alive"],
            "comp_mask": self.baseline_world["comp_mask"],
        }
        for k, v in self.baseline_world["comps"].items():
            payload[f"comp_{k}"] = v
        for attempt in range(2):
            try:
                with open(path, "wb") as f:
                    np.savez_compressed(f, **payload)
                break
            except OSError:
                if attempt == 1:
                    raise
        with open(os.path.join(directory, "history_meta.json"), "w") as f:
            json.dump({"version": FORMAT_VERSION,
                       "num_frames": self.num_frames,
                       "events": {str(k): v for k, v in self.events.items()},
                       **self.meta}, f)
        return path

    @staticmethod
    def load(directory: str) -> "HistoryLog":
        log = HistoryLog()
        with np.load(os.path.join(directory, "gameplay_history.npz")) as data:
            comps = {k[len("comp_"):]: data[k] for k in data.files
                     if k.startswith("comp_") and k != "comp_mask"}
            log.baseline_world = {"alive": data["alive"],
                                  "comp_mask": data["comp_mask"],
                                  "comps": comps}
            log.baseline_camera = data["camera"]
            log.frames_inputs = list(data["inputs"])
            log.frames_dt = list(data["dt"])
            log.frames_fused = ([bool(x) for x in data["fused"]]
                                if "fused" in data.files
                                else [False] * len(log.frames_dt))
        meta_path = os.path.join(directory, "history_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                log.meta = json.load(f)
            log.events = {int(k): v
                          for k, v in log.meta.pop("events", {}).items()}
        return log

    # -- reconstruction -------------------------------------------------------
    def restore_world(self, config: W.WorldConfig, device="cpu") -> W.World:
        return W.restore(config, self.baseline_world, device)

    def restore_camera(self, template):
        """The baseline camera's dynamic state on ``template``'s device,
        with ``template``'s static configuration."""
        return template.apply_serialized(torch.tensor(
            np.asarray(self.baseline_camera, np.float32),
            device=template.device))

    def frame(self, i: int) -> tuple[InputState, float]:
        return (InputState.deserialize(self.frames_inputs[i]),
                float(self.frames_dt[i]))

    def advance_fused(self, i: int) -> bool:
        """Whether recorded frame ``i`` advanced as a fused frame."""
        return i < len(self.frames_fused) and bool(self.frames_fused[i])
