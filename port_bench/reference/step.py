"""The world tick of the demo, written out for its own entity types.

The stages and their order are the engine's specification (the JAX
package's ``logic/step.py``, not imported): clear the per-frame markers;
the entities that take logic (inside the camera's frustum or within its
draw distance, or always-logic, and not static); the user's input; motion
(only entities holding both a position and a velocity move, and only
those holding an orientation and an angular velocity turn); out-of-bounds
clamping; bounds of the moved; the user's contacts; the asteroids' orbits
and the mine producer's spawns; every queued change applied at once, new
entities landing in the first free rows; bounds of the changed; the
camera at the user.

One simplification, exact for the demo: of the types only the user
reacts to a contact (a wormhole's impulse), so contacts are found for
the user alone, against every live entity, where the engine searches a
grid of cells for every mover."""

from __future__ import annotations

import torch

from port_bench.reference import demo as D
from port_bench.reference import rng as RNG
from port_bench.reference import xform as X

SHIP_ACCEL = 40.0
SHIP_DECAY = 0.96
WORMHOLE_IMPULSE = 120.0
MINE_PERIOD = 4.0
CAMERA_CUTOFF = 200.0


def has(w, *names):
    bits = 0
    for nm in names:
        bits |= D.BIT[nm]
    return w["alive"] & ((w["comp_mask"] & bits) == bits)


def flagged(w, flag):
    return w["alive"] & ((w["comps.flags"] & flag) != 0)


def refresh_bounds(w, bank, dirty):
    """World boxes of the entities in ``dirty``: the model's box turned by
    the orientation and scaled (a unit box where there is no model)."""
    mid = w["comps.model_id"]
    safe = mid.clamp(0, bank["aabb_min"].shape[0] - 1)
    none = (mid < 0)[:, None]
    lo = torch.where(none, torch.full_like(bank["aabb_min"][safe], -0.5),
                     bank["aabb_min"][safe])
    hi = torch.where(none, torch.full_like(bank["aabb_max"][safe], 0.5),
                     bank["aabb_max"][safe])
    q, s = w["comps.orientation"], w["comps.scale"]
    c, h = 0.5 * (lo + hi), 0.5 * (hi - lo)
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    r = [X.quat_rotate(q, eye[i].expand_as(s)).abs() for i in range(3)]
    sh = s.abs() * h
    half = r[0] * sh[:, 0:1] + r[1] * sh[:, 1:2] + r[2] * sh[:, 2:3]
    center = X.quat_rotate(q, s * c) + w["comps.position"]
    d = dirty[:, None]
    w["comps.aabb_min"] = torch.where(d, center - half, w["comps.aabb_min"])
    w["comps.aabb_max"] = torch.where(d, center + half, w["comps.aabb_max"])


def step(w: dict, camv: torch.Tensor, sc, fr) -> tuple[dict, torch.Tensor]:
    """One tick of the world ``w`` (a dict of columns, changed in place and
    returned) from the camera vector ``camv`` and the traffic frame ``fr``."""
    st, bank, cam = sc.settings, sc.bank, sc.cam
    dev = camv.device
    dt = torch.tensor(fr.dt, dtype=torch.float32, device=dev)
    cap = w["alive"].shape[0]
    w["comps.flags"] = w["comps.flags"] & ~(D.FLAG_HAS_MOVED
                                            | D.FLAG_HAS_ROTATED)
    # the entities that take logic
    pv = X.proj_view(camv, cam)
    vis = X.aabb_in_frustum(X.frustum_planes(pv), w["comps.aabb_min"],
                            w["comps.aabb_max"])
    eye = camv[0:3]
    near = ((torch.minimum(torch.maximum(eye[None], w["comps.aabb_min"]),
                           w["comps.aabb_max"]) - eye[None]) ** 2).sum(-1)
    vis = vis | (near <= torch.tensor(st.logic_radius, device=dev) ** 2)
    active = ((w["alive"] & vis) | flagged(w, D.FLAG_ALWAYS_LOGIC)) \
        & ~flagged(w, D.FLAG_STATIC)
    updates = []  # (column, values, mask) in the order they are queued

    # the user's input: mouse look, then thrust along the camera's axes
    camv = camv.clone()
    limit = torch.tensor(89.0 * 3.141592653589793 / 180.0,
                         dtype=torch.float32)
    mouse = torch.as_tensor(fr.mouse_delta, dtype=torch.float32)
    camv[3] = camv[3] + mouse[0].to(dev)
    camv[4] = torch.clamp(camv[4] + mouse[1].to(dev), -limit.to(dev),
                          limit.to(dev))
    k = torch.as_tensor(fr.keys, dtype=torch.float32, device=dev)
    fwd = X.direction(camv[3], camv[4])
    up = torch.tensor([0.0, 1.0, 0.0], device=dev)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    accel = (fwd * (k[0] - k[2]) + right * (k[3] - k[1])
             + up * (k[4] - k[5])) * SHIP_ACCEL
    user = flagged(w, D.FLAG_USER)
    updates.append(("velocity",
                    (w["comps.velocity"] + accel[None] * dt) * SHIP_DECAY,
                    user))

    # motion
    kin = active & has(w, "position", "velocity")
    acc = has(w, "acceleration")
    vel = torch.where((kin & acc)[:, None],
                      w["comps.velocity"] + w["comps.acceleration"] * dt,
                      w["comps.velocity"])
    w["comps.position"] = torch.where(kin[:, None],
                                      w["comps.position"] + vel * dt,
                                      w["comps.position"])
    moved = kin & (vel != 0.0).any(-1)
    rot = active & has(w, "orientation", "ang_vel")
    aacc = has(w, "ang_acc")
    avel = torch.where((rot & aacc)[:, None],
                       w["comps.ang_vel"] + w["comps.ang_acc"] * dt,
                       w["comps.ang_vel"])
    dq = X.quat_from_rotvec(avel * dt)
    w["comps.orientation"] = torch.where(
        rot[:, None], X.quat_normalize(X.quat_mul(dq, w["comps.orientation"])),
        w["comps.orientation"])
    turned = rot & (avel != 0.0).any(-1)
    w["comps.velocity"], w["comps.ang_vel"] = vel, avel
    w["comps.flags"] = torch.where(moved, w["comps.flags"] | D.FLAG_HAS_MOVED,
                                   w["comps.flags"])
    w["comps.flags"] = torch.where(turned,
                                   w["comps.flags"] | D.FLAG_HAS_ROTATED,
                                   w["comps.flags"])
    # out of bounds: every demo type clamps into the world
    p = w["comps.position"]
    oob = w["alive"] & ((p < 0.0) | (p > st.world_length)).any(-1)
    w["comps.position"] = torch.where(oob[:, None],
                                      p.clamp(0.0, st.world_length), p)
    refresh_bounds(w, bank, moved | turned)

    # the user's contacts: a wormhole among them gives an impulse along
    # the flight direction
    coll = flagged(w, D.FLAG_COLLIDABLE)
    query = ((moved & coll) | (flagged(w, D.FLAG_USER_ALWAYS_COLLIDES) & coll)) \
        & (((w["comps.position"] - eye[None]) ** 2).sum(-1)
           <= CAMERA_CUTOFF ** 2) & user
    lo, hi = w["comps.aabb_min"], w["comps.aabb_max"]
    ids = torch.arange(cap, device=dev)
    hit_worm = torch.zeros(cap, dtype=torch.bool, device=dev)
    for u in torch.nonzero(query).flatten().tolist():
        touch = (w["alive"] & (ids != u) & (lo[u] <= hi).all(-1)
                 & (lo <= hi[u]).all(-1))
        hit_worm[u] = bool((touch & (w["comps.type_id"] == D.TYPE_WORMHOLE))
                           .any())
    v = w["comps.velocity"]
    speed = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    heading = torch.where(speed > 1e-6, v / speed.clamp(min=1e-6),
                          torch.tensor([0.0, 0.0, -1.0], device=dev))
    updates.append(("velocity", heading * WORMHOLE_IMPULSE, hit_worm))

    # the asteroids orbit
    orb = active & (w["comps.type_id"] == D.TYPE_ASTEROID) & w["alive"]
    a = w["comps.orbit_angle"] + w["comps.orbit_speed"] * dt
    r = w["comps.orbit_radius"]
    ring = torch.stack([r * torch.cos(a), torch.zeros_like(a),
                        r * torch.sin(a)], -1)
    updates.append(("orbit_angle", a, orb))
    updates.append(("position", w["comps.orbit_center"] + ring, orb))
    # the mine producer
    prod = active & (w["comps.type_id"] == D.TYPE_MINE_PRODUCER) & w["alive"]
    timer = w["comps.spawn_timer"] + torch.where(prod, dt, torch.zeros_like(dt))
    fire = prod & (timer >= MINE_PERIOD)
    timer = torch.where(fire, torch.zeros_like(timer), timer)
    updates.append(("spawn_timer", timer, prod))
    spawn = None
    if bool(fire.any()):
        src = int(torch.nonzero(fire)[0])
        sub = RNG.split(RNG.key(fr.rng_seed))[1]
        offset = RNG.uniform(sub, 3, -8.0, 8.0).to(dev)
        svel = RNG.uniform(sub, 3, -2.0, 2.0).to(dev)
        spawn = {"position": w["comps.position"][src] + offset,
                 "velocity": svel,
                 "scale": torch.full((3,), 0.4, device=dev),
                 "type_id": D.TYPE_MINE, "model_id": sc.mine_model,
                 "flags": D.FLAG_COLLIDABLE}

    # every change at once, later writes of a column winning
    dirty = torch.zeros(cap, dtype=torch.bool, device=dev)
    for name, values, mask in updates:
        col = w[f"comps.{name}"]
        m = mask.reshape(mask.shape + (1,) * (col.dim() - 1))
        w[f"comps.{name}"] = torch.where(m, values.to(col.dtype), col)
        w["comp_mask"] = torch.where(mask, w["comp_mask"] | D.BIT[name],
                                     w["comp_mask"])
        if name in ("position", "orientation", "scale"):
            dirty = dirty | mask
    if spawn is not None:
        free = torch.nonzero(~w["alive"]).flatten()
        if len(free):
            row = int(free[0])
            for name, _, _, default in D.COMPONENTS:
                col = w[f"comps.{name}"]
                val = torch.full(col.shape[1:], default, dtype=col.dtype,
                                 device=dev)
                if name == "orientation":
                    val[0] = 1.0
                if name == "transform":
                    val = torch.eye(4, device=dev)
                if name in spawn:
                    val = torch.as_tensor(spawn[name], dtype=col.dtype,
                                          device=dev).expand(col.shape[1:])
                col[row] = val
            w["alive"][row] = True
            bits = 0
            for name in spawn:
                bits |= D.BIT[name]
            w["comp_mask"][row] = bits
            dirty[row] = True
    refresh_bounds(w, bank, dirty)
    users = torch.nonzero(flagged(w, D.FLAG_USER)).flatten()
    if len(users):
        camv[0:3] = w["comps.position"][int(users[0])]
    return w, camv
