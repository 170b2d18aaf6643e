"""Whether what the timed path produced is correct.

The program's set-up and frames are held to the plain reference
(``reference/``), which builds the scene from the same seed itself and
computes frames with its own code:

* the scene: the world the program's set-up derived from the seed;
* the run from the start: the reference follows its own state from the
  initial one through the first ``FOLLOW`` frames (two shadow cycles and
  more, and the first mine's spawn at 4 s of game time); the program's
  records of frames in that stretch (its first frames, taken in set-up,
  and frames of the window at fixed indices) are held to the reference's
  frames of the same index;
* the window: frames sampled from the window by the seed, each computed
  by the reference from the program's state before it (the reference
  cannot follow thousands of frames in the time of a run); the run from
  the start checks the stage this skips.

Three numbers are compared, each the largest over the checked frames,
each held to the limit the configuration file gives it:

* ``world_err``: the set-up's world, and the world's columns, the camera
  vector and the shadow slot tables after each checked frame; for a float
  tensor its largest absolute difference over the larger of 1 and its
  largest reference magnitude, for an integer or bool tensor 1 where any
  element differs (a tensor missing or of another shape: infinity);
* ``shadow_err``: the share of shadow-map texels whose depth differs by
  more than ``MAP_TOL``, and of light-matrix entries differing by more
  than ``MAP_TOL`` relative, after each checked frame that renders;
* ``image_err``: the share of each checked frame's pixels with a channel
  that differs by more than ``PIXEL_TOL`` (two steps of an 8-bit
  channel)."""

from __future__ import annotations

import dataclasses
import math

import torch

from port_bench import manifest

NUMBERS = ("world_err", "shadow_err", "image_err")
FOLLOW = 250
MAP_TOL = 1e-5
PIXEL_TOL = 2.0 / 255.0


def compare(prog: dict, ref: dict, worst: list | None = None) -> float:
    """The ``world_err`` of the program's dict of tensors against the
    reference's, by name; ``worst`` gets the name of the tensor that sets
    it."""
    err, at = 0.0, None
    for name, r in ref.items():
        p = prog.get(name)
        if p is None or tuple(p.shape) != tuple(r.shape):
            if worst is not None:
                worst.append(name)
            return math.inf
        p = p.to(r.device)
        if r.numel() == 0:
            continue
        if r.is_floating_point():
            rd, pd = r.double(), p.double()
            both_nan = torch.isnan(rd) & torch.isnan(pd)
            d = torch.where(both_nan, torch.zeros_like(rd), (pd - rd).abs())
            d = torch.nan_to_num(d, nan=math.inf)
            scale = torch.nan_to_num(rd.abs(), nan=0.0, posinf=0.0,
                                     neginf=0.0).max().clamp(min=1.0)
            e = float(d.max() / scale)
        else:
            e = 1.0 if bool((p.to(r.dtype) != r).any()) else 0.0
        if e > err:
            err, at = e, name
    if worst is not None and at is not None:
        worst.append(at)
    return err


def map_share(prog: dict | None, ref: dict | None) -> float:
    """The share of shadow-map texels and light-matrix entries of the
    program that differ from the reference's (see the module)."""
    if ref is None:
        return 0.0
    if prog is None:
        return math.inf
    n, bad = 0, 0
    for name in ("maps", "light_mats"):
        r, p = ref[name], prog[name]
        if tuple(p.shape) != tuple(r.shape):
            return math.inf
        p = p.to(r.device)
        tol = MAP_TOL * (r.abs().clamp(min=1.0) if name == "light_mats"
                         else 1.0)
        off = ~((p - r).abs() <= tol)
        n, bad = n + r.numel(), bad + int(off.sum())
    return bad / max(n, 1)


def pixel_share(img, ref_img) -> float:
    if img is None or ref_img is None:
        return math.inf
    if tuple(img.shape) != tuple(ref_img.shape):
        return math.inf
    d = (img.to(ref_img.device) - ref_img).abs().amax(-1)
    return float((~(d <= PIXEL_TOL)).float().mean())


def split_state(state: dict) -> tuple[dict, dict | None]:
    """A state's world columns, camera vector and shadow slot tables, and
    its shadow maps and light matrices."""
    world = dict(state["world"])
    world["camv"] = state["camv"]
    sh = state["shadow"]
    maps = None
    if sh is not None:
        maps = {"maps": sh["maps"], "light_mats": sh["light_mats"]}
        world["slot_entity"] = sh["slot_entity"]
        world["slot_face"] = sh["slot_face"]
    return world, maps


@dataclasses.dataclass
class Checked:
    """One checked frame: traffic frame index ``i``, the state before it
    (None: a frame of the run from the start), the state after it and its
    image, as the side under test produced them."""

    i: int
    pre: dict | None
    post: dict
    image: torch.Tensor | None


class Readings:
    def __init__(self):
        self.values: dict = {}
        self.where: dict = {}  # the tensor or frame that set each number

    def add(self, name: str, value, where=None):
        if name not in self.values or value > self.values[name]:
            self.values[name] = value
            self.where[name] = where

    def frame(self, i, post, image, ref_post, ref_image, renders: bool):
        pw, pm = split_state(post)
        rw, rm = split_state(ref_post)
        ww = []
        vals = {"world_err": compare(pw, rw, ww)}
        if renders:
            vals["shadow_err"] = map_share(pm, rm)
            if image is not None or ref_image is not None:
                vals["image_err"] = pixel_share(image, ref_image)
        for k, v in vals.items():
            self.add(k, v, f"frame {i}" + (f" {ww[-1]}" if k == "world_err"
                                           and ww else ""))
        return vals


def judge(values: dict, limits: dict) -> tuple[bool, list]:
    """Every number against its limit: ``(all within, [(name, value,
    limit)])``. A number without a limit fails."""
    rows = [(k, values[k], limits.get(k)) for k in NUMBERS if k in values]
    ok = all(lim is not None and v <= lim for _, v, lim in rows)
    return ok, rows


def run_reference(cfg, seed, device, traffic, program_scene, records,
                  overrides=None, control_cls=None):
    """The readings of the program's set-up world ``program_scene`` and
    its ``records`` (``Checked``) against the reference, with the
    per-frame values. The reference is the ``Reference`` of the
    configuration's program (``reference/programs/<program>.py``). With
    ``control_cls`` (that file's ``Control``) also the control's readings:
    its own scene and frames, computed as the reference's are, in the
    program's place."""
    renders = traffic.renders
    ref = manifest.reference(cfg).Reference(cfg, seed, device, overrides)
    ctl = control_cls(cfg, seed, device, overrides) if control_cls else None
    rd, rd_ctl, per_frame = Readings(), Readings(), []
    ref_world = ref.state()["world"]
    w = []
    rd.add("world_err", compare(program_scene, ref_world, w),
           f"scene {w[-1] if w else ''}")
    if ctl is not None:
        w = []
        rd_ctl.add("world_err", compare(ctl.state()["world"], ref_world, w),
                   f"scene {w[-1] if w else ''}")
    follow = {r.i: r for r in records if r.pre is None}
    sampled = [r for r in records if r.pre is not None]
    last = max(follow) if follow else -1
    for i in range(last + 1):
        fr = traffic.frame(i)
        rec = follow.get(i)
        want = rec is not None and rec.image is not None
        ref_img = ref.frame(fr, render_image=want)
        ctl_img = ctl.frame(fr, render_image=want) if ctl else None
        if rec is None:
            continue
        ref_post = ref.state()
        per_frame.append((i, rd.frame(i, rec.post, rec.image, ref_post,
                                      ref_img, renders)))
        if ctl is not None:
            rd_ctl.frame(i, ctl.state(), ctl_img, ref_post, ref_img, renders)
    for rec in sampled:
        fr = traffic.frame(rec.i)
        ref.load(rec.pre)
        ref_img = ref.frame(fr)
        ref_post = ref.state()
        per_frame.append((rec.i, rd.frame(rec.i, rec.post, rec.image,
                                          ref_post, ref_img, renders)))
        if ctl is not None:
            ctl.load(rec.pre)
            ctl_img = ctl.frame(fr)
            rd_ctl.frame(rec.i, ctl.state(), ctl_img, ref_post, ref_img,
                         renders)
    return rd, per_frame, (rd_ctl if ctl is not None else None)
