"""The demo scene as set-up derives it from the seed, worked out afresh:
the meshes, materials and levels of view, the texture atlas, the render
systems' per-model rows, the starfield, the world's columns after
spawning, the camera and every setting of a configuration file.

It follows the specification of the reference engine's demo
(``space_scene.build_scene`` and ``space_config`` of the JAX package,
which this file does not import): the same draws from the same seeded
generators in the same order, the same meshes, the same spawn order."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")

# the component table: (name, per-entity shape, dtype, default); the bit
# of a component in ``comp_mask`` is its index here
COMPONENTS = (
    ("position", (3,), "f", 0.0), ("velocity", (3,), "f", 0.0),
    ("acceleration", (3,), "f", 0.0), ("orientation", (4,), "f", 0.0),
    ("ang_vel", (3,), "f", 0.0), ("ang_acc", (3,), "f", 0.0),
    ("scale", (3,), "f", 1.0), ("transform", (4, 4), "f", 0.0),
    ("aabb_min", (3,), "f", 0.0), ("aabb_max", (3,), "f", 0.0),
    ("model_id", (), "i", -1), ("type_id", (), "i", -1),
    ("sortable", (), "i", 0), ("flags", (), "i", 0),
    ("light_diffuse", (3,), "f", 0.0), ("light_specular", (3,), "f", 0.0),
    ("light_ambient", (3,), "f", 0.0), ("light_atten", (2,), "f", 0.0),
    ("light_cutoff", (2,), "f", 0.0), ("light_direction", (3,), "f", 0.0),
    ("light_radius", (), "f", 0.0), ("light_fov", (), "f", 0.0),
    ("parent", (), "i", -1), ("ref_edges", (4,), "i", -1),
    # the demo's own components
    ("orbit_angle", (), "f", 0.0), ("orbit_radius", (), "f", 0.0),
    ("orbit_speed", (), "f", 0.0), ("orbit_center", (3,), "f", 0.0),
    ("spawn_timer", (), "f", 0.0),
)
BIT = {c[0]: 1 << i for i, c in enumerate(COMPONENTS)}

FLAG_STATIC, FLAG_COLLIDABLE, FLAG_ALWAYS_LOGIC = 1, 2, 4
FLAG_HAS_MOVED, FLAG_HAS_ROTATED, FLAG_USER = 16, 32, 64
FLAG_TRANSPARENT, FLAG_USER_ALWAYS_COLLIDES = 256, 1024
SORTABLE_SPOT = 3

TYPE_STAR, TYPE_ASTEROID, TYPE_WORMHOLE = 0, 1, 2
TYPE_MINE_PRODUCER, TYPE_MINE, TYPE_USER, TYPE_STATION = 3, 4, 5, 6

LOV_BANDS = 5
LOV_FRACTIONS = (0.10, 0.15, 0.20, 0.25, 0.30)
EMISSIVE_BOOST = 6.0
STARFIELD = (2400, 7)  # stars, seed


def _f32(x):
    return np.asarray(x, np.float32)


# ---- meshes: (vertices, normals, uvs, triangles), counter-clockwise -----
def _mesh(v, n, uv, f):
    return (_f32(v), _f32(n), _f32(uv), np.asarray(f, np.int32))


def cube(size):
    s = size * 0.5
    faces = [
        ([0, 0, 1], [[-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]]),
        ([0, 0, -1], [[s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]]),
        ([1, 0, 0], [[s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]]),
        ([-1, 0, 0], [[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]]),
        ([0, 1, 0], [[-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]]),
        ([0, -1, 0], [[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]]),
    ]
    v, n, uv, f = [], [], [], []
    for normal, corners in faces:
        b = len(v)
        v += corners
        n += [normal] * 4
        uv += [[0, 0], [1, 0], [1, 1], [0, 1]]
        f += [[b, b + 1, b + 2], [b, b + 2, b + 3]]
    return _mesh(v, n, uv, f)


def uv_sphere(radius, lat, lon):
    vs, ns, uvs = [], [], []
    for i in range(lat + 1):
        th = np.pi * i / lat
        for j in range(lon + 1):
            ph = 2 * np.pi * j / lon
            d = np.array([np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)])
            vs.append(radius * d)
            ns.append(d)
            uvs.append([j / lon, 1.0 - i / lat])
    fs, stride = [], lon + 1
    for i in range(lat):
        for j in range(lon):
            a = i * stride + j
            b = a + stride
            if i != 0:
                fs.append([a, a + 1, b])
            if i != lat - 1:
                fs.append([a + 1, b + 1, b])
    return _mesh(vs, ns, uvs, fs)


def rock(radius, lat, lon, seed, roughness=0.35):
    """A sphere whose vertices move in and out by a seeded factor, one per
    distinct position (the seams share theirs); normals stay spherical."""
    v, n, uv, f = uv_sphere(radius, lat, lon)
    rng = np.random.default_rng(seed)
    factor, scale = {}, np.empty(len(v), np.float32)
    for i, p in enumerate(v):
        k = tuple(np.round(p / max(radius, 1e-6), 4))
        if k not in factor:
            factor[k] = 1.0 + roughness * (rng.random() * 2.0 - 1.0)
        scale[i] = factor[k]
    return _mesh(v * scale[:, None], n, uv, f)


def icosahedron(radius):
    t = (1.0 + 5 ** 0.5) / 2.0
    v = _f32([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t],
              [0, 1, t], [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1],
              [-t, 0, -1], [-t, 0, 1]])
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9], [4, 9, 5],
         [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    n = v / np.linalg.norm(v, axis=1, keepdims=True)
    return _mesh(v, n, np.zeros((12, 2)), f)


def tetrahedron(radius):
    a = radius
    v = _f32([[a, a, a], [a, -a, -a], [-a, a, -a], [-a, -a, a]])
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius
    n = v / np.linalg.norm(v, axis=1, keepdims=True)
    return _mesh(v, n, np.zeros((4, 2)),
                 [[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]])


# ---- the station: OBJ, MTL and PPM files --------------------------------
def read_ppm(path):
    data = open(path, "rb").read()
    fields, i = [], 2
    while len(fields) < 3:
        while data[i:i + 1].isspace():
            i += 1
        if data[i:i + 1] == b"#":
            while data[i:i + 1] != b"\n":
                i += 1
            continue
        j = i
        while not data[j:j + 1].isspace():
            j += 1
        fields.append(int(data[i:j]))
        i = j
    w, h, _ = fields
    img = np.frombuffer(data, np.uint8, w * h * 3, i + 1).reshape(h, w, 3)
    return img.astype(np.float32) / 255.0


def read_station(path):
    """The OBJ's corners (one vertex per distinct ``v/vt/vn`` token, in
    order of first use), its triangles and per-triangle materials, and the
    MTL's materials (a default one first)."""
    pos, tex, nrm, tok = [], [], [], {}
    v, n, uv, tris, tri_mat = [], [], [], [], []
    names, mats, cur = ["__default__"], {}, 0
    base = os.path.dirname(path)
    for line in open(path):
        p = line.split()
        if not p:
            continue
        if p[0] == "v":
            pos.append([float(x) for x in p[1:4]])
        elif p[0] == "vt":
            tex.append([float(x) for x in p[1:3]])
        elif p[0] == "vn":
            nrm.append([float(x) for x in p[1:4]])
        elif p[0] == "mtllib":
            mats = read_mtl(os.path.join(base, p[1]))
        elif p[0] == "usemtl":
            if p[1] not in names:
                names.append(p[1])
            cur = names.index(p[1])
        elif p[0] == "f":
            ids = []
            for t in p[1:]:
                if t not in tok:
                    a = [int(x) for x in t.split("/")]
                    tok[t] = len(v)
                    v.append(pos[a[0] - 1])
                    uv.append(tex[a[1] - 1])
                    n.append(nrm[a[2] - 1])
                ids.append(tok[t])
            for k in range(1, len(ids) - 1):
                tris.append([ids[0], ids[k], ids[k + 1]])
                tri_mat.append(cur)
    default = {"kd": (1.0, 1.0, 1.0), "ks": 1.0, "map_kd": None,
               "map_bump": None}
    table = [default] + [dict(default, **mats.get(nm, {}))
                         for nm in names[1:]]
    return _mesh(v, n, uv, tris), np.asarray(tri_mat), table, base


def read_mtl(path):
    out, cur = {}, None
    for line in open(path):
        p = line.split()
        if not p:
            continue
        if p[0] == "newmtl":
            cur = out.setdefault(p[1], {})
        elif p[0] == "Kd":
            cur["kd"] = tuple(float(x) for x in p[1:4])
        elif p[0] == "Ks":
            cur["ks"] = float(np.mean(_f32(p[1:4])))
        elif p[0] == "map_Kd":
            cur["map_kd"] = p[-1]
        elif p[0] == "map_Bump":
            cur["map_bump"] = p[-1]
    return out


def pack_atlas(images, size):
    """Shelf-pack (h, w, 3) images into (size, size) layers, tallest
    first, first fit: ``(layers (L, S, S, 3), layer of each image,
    [w - 1, h - 1, x, y] of each image)``."""
    order = sorted(range(len(images)), key=lambda i: -images[i].shape[0])
    layers, shelves = [], []
    tex_layer = np.zeros(len(images), np.int64)
    rect = np.zeros((len(images), 4), np.float32)
    for i in order:
        img = images[i]
        h, w = img.shape[:2]
        spot = None
        for li, rows in enumerate(shelves):
            for row in rows:
                if row[1] >= h and row[2] + w <= size:
                    spot = (li, row[2], row[0])
                    row[2] += w
                    break
            if spot:
                break
            y = rows[-1][0] + rows[-1][1]
            if y + h <= size:
                rows.append([y, h, w])
                spot = (li, 0, y)
                break
        if spot is None:
            layers.append(np.zeros((size, size, 3), np.float32))
            shelves.append([[0, h, w]])
            spot = (len(layers) - 1, 0, 0)
        li, x, y = spot
        layers[li][y:y + h, x:x + w] = img
        tex_layer[i] = li
        rect[i] = [w - 1, h - 1, x, y]
    return np.stack(layers), tex_layer, rect


# ---- settings ------------------------------------------------------------
@dataclasses.dataclass
class Settings:
    width: int
    height: int
    capacity: int
    max_tris: int
    tile_budget: int
    trans_budget: int
    global_budget: int
    pair_budget: int
    texture_tile_budget: float
    shadow_tile_budget: float
    fused: bool
    shadows: bool
    shadow_res: int
    shadow_slots: int
    shadow_interval: int
    shadow_max_tris: int
    shadow_lov_bias: int
    pcf_scale: int
    spawn_budget: int = 4
    tile_h: int = 8
    tile_w: int = 128
    max_tiles_per_tri: int = 8
    shadow_tile_budget_tiles: int = 160  # the shadow raster's bins
    shadow_global_budget: int = 16
    max_spot: int = 8
    world_length: float = 16384.0
    logic_radius: float = 1500.0


def settings_of(cfg: dict, overrides=None) -> Settings:
    """A configuration file's settings with the demo's defaults for what
    it leaves out (``space_config``)."""
    kw = dict(cfg["space_config"], **(overrides or {}))
    h = kw["height"]
    big = h >= 240
    max_tris = kw.get("max_tris", 32768)
    sres = kw.get("shadow_resolution") or (1024 if big else 128)
    smax = kw.get("shadow_max_tris") or (8192 if big else 1024)
    return Settings(
        width=kw["width"], height=h, capacity=kw["capacity"],
        max_tris=max_tris,
        tile_budget=kw.get("raster_tile_budget") or 112,
        trans_budget=kw.get("trans_tile_budget") or 64,
        global_budget=32, pair_budget=3 * max_tris,
        texture_tile_budget=0.04 if big else 0.5,
        shadow_tile_budget=kw.get("shadow_tile_budget", 0.28),
        fused=bool(cfg["fused_shading"]),
        shadows=kw.get("enable_shadows", True),
        shadow_res=sres,
        shadow_slots=kw.get("shadow_slots") or (2 if big else 6),
        shadow_interval=kw.get("shadow_update_interval") or (3 if big else 1),
        shadow_max_tris=smax,
        shadow_lov_bias=(2 if kw.get("shadow_lov_bias") is None
                         else kw["shadow_lov_bias"]),
        pcf_scale=kw.get("shadow_pcf_scale") or 3)


# ---- the scene -----------------------------------------------------------
@dataclasses.dataclass
class Scene:
    settings: Settings
    bank: dict  # tensors, see ``build``
    atlas: dict  # layers (L, S, S, 3), tex_layer (T,), rect (T, 4)
    stars: dict  # dirs (N, 3), colors (N, 3)
    world: dict  # "alive", "comp_mask", "comps.<name>"
    camv: torch.Tensor  # (8,) position, yaw, pitch, velocity
    cam: dict  # fov_y, aspect, near, far, draw_distance
    mine_model: int


class _Bank:
    def __init__(self):
        self.v, self.n, self.uv, self.tri, self.tri_mat = [], [], [], [], []
        self.models, self.mats, self.lov = [], [], {}
        self.material((1.0, 0.0, 1.0))

    def material(self, albedo, emissive=0.0, alpha=1.0, texture=-1,
                 specular=1.0, normal_map=-1):
        self.mats.append((albedo, emissive, alpha, specular, texture,
                          normal_map))
        return len(self.mats) - 1

    def model(self, mesh, material=None, tri_material=None):
        v, n, uv, f = mesh
        voff = sum(len(x) for x in self.v)
        toff = sum(len(x) for x in self.tri)
        self.v.append(v)
        self.n.append(n)
        self.uv.append(uv)
        self.tri.append(f + voff)
        self.tri_mat.append(np.full(len(f), material, np.int32)
                            if tri_material is None else tri_material)
        self.models.append((toff, len(f), v.min(0), v.max(0)))
        return len(self.models) - 1

    def tensors(self, device):
        m = len(self.models)
        lov = np.array([self.lov.get(i, [i] * (LOV_BANDS + 1))
                        for i in range(m)], np.int64)
        t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(a), dtype=dt, device=device)
        return {
            "vertices": t(np.concatenate(self.v)),
            "normals": t(np.concatenate(self.n)),
            "uvs": t(np.concatenate(self.uv)),
            "tri_v": t(np.concatenate(self.tri), torch.int64),
            "tri_material": t(np.concatenate(self.tri_mat), torch.int64),
            "tri_offset": t([x[0] for x in self.models], torch.int64),
            "tri_count": t([x[1] for x in self.models], torch.int64),
            "aabb_min": t(np.stack([x[2] for x in self.models])),
            "aabb_max": t(np.stack([x[3] for x in self.models])),
            "albedo": t(np.stack([_f32(x[0]) for x in self.mats])),
            "emissive": t([x[1] for x in self.mats]),
            "alpha": t([x[2] for x in self.mats]),
            "specular": t([x[3] for x in self.mats]),
            "texture": t([x[4] for x in self.mats], torch.int64),
            "normal_map": t([x[5] for x in self.mats], torch.int64),
            "lov_table": t(lov, torch.int64),
            "lov_fractions": t(LOV_FRACTIONS),
        }


def _spawn(world, count, **values):
    alive = world["alive"]
    idx = np.flatnonzero(~alive)[:count]
    alive[idx] = True
    bits = 0
    for name, val in values.items():
        col = world[f"comps.{name}"]
        col[idx] = np.broadcast_to(np.asarray(val, col.dtype),
                                   (count,) + col.shape[1:])
        bits |= BIT[name]
    world["comp_mask"][idx] = bits


def empty_world(capacity):
    w = {"alive": np.zeros(capacity, bool),
         "comp_mask": np.zeros(capacity, np.int32)}
    for name, shape, kind, default in COMPONENTS:
        col = np.full((capacity,) + shape, default,
                      np.float32 if kind == "f" else np.int32)
        if name == "orientation":
            col[:, 0] = 1.0
        if name == "transform":
            col[:] = np.eye(4, dtype=np.float32)
        w[f"comps.{name}"] = col
    return w


def build(cfg: dict, seed: int, device, overrides=None) -> Scene:
    """The scene of a configuration file with the asteroids drawn from
    ``seed`` (the demo's ``build_scene(num_asteroids, seed)``)."""
    st = settings_of(cfg, overrides)
    sc = dict(cfg["scene"], **{k: v for k, v in (overrides or {}).items()
                               if k in cfg["scene"]})
    n, normal_maps = int(sc["num_asteroids"]), bool(sc["normal_maps"])
    seed = int(seed) % (1 << 32)
    bb = _Bank()
    star_mat = bb.material((1.0, 0.85, 0.5), emissive=1.0)
    rock_mat = bb.material((0.45, 0.38, 0.33))
    worm_mat = bb.material((0.4, 0.2, 0.9), alpha=0.45)
    mine_mat = bb.material((0.7, 0.1, 0.1))
    prod_mat = bb.material((0.2, 0.7, 0.4), alpha=0.7)
    star_model = bb.model(uv_sphere(14.0, 12, 18), star_mat)
    rock_full = bb.model(rock(2.0, 8, 12, seed=seed), rock_mat)
    rock_lod = bb.model(icosahedron(2.0), rock_mat)
    rock_far = bb.model(tetrahedron(2.0), rock_mat)
    bb.lov[rock_full] = [rock_full, rock_lod, rock_lod, rock_far, rock_far,
                         rock_far]
    worm_model = bb.model(uv_sphere(6.0, 8, 12), worm_mat)
    mine_model = bb.model(cube(1.0), mine_mat)
    prod_model = bb.model(cube(4.0), prod_mat)
    mesh, tri_mat, table, base = read_station(
        os.path.join(ASSETS, "station.obj"))
    images, ids = [], []
    for m in table:
        tex = nmap = -1
        if m["map_kd"]:
            images.append(read_ppm(os.path.join(base, m["map_kd"])))
            tex = len(images) - 1
        if m["map_bump"]:
            images.append(read_ppm(os.path.join(base, m["map_bump"])))
            nmap = len(images) - 1
        ids.append(bb.material(m["kd"], specular=m["ks"], texture=tex,
                               normal_map=nmap if normal_maps else -1))
    station_model = bb.model(mesh, tri_material=np.asarray(ids)[tri_mat])
    layers, tex_layer, rect = pack_atlas(images, 64)
    bank = bb.tensors(device)
    # the render systems: the stars' unlit system at 6x, every other
    # model lit (levels of view draw with their base model's system)
    unlit = torch.zeros(len(bb.models), dtype=torch.bool, device=device)
    unlit[star_model] = True
    bank["unlit"] = unlit
    atlas = {"layers": torch.as_tensor(layers, device=device),
             "tex_layer": torch.as_tensor(tex_layer, device=device),
             "rect": torch.as_tensor(rect, device=device)}

    world = empty_world(st.capacity)
    rng = np.random.default_rng(seed)
    b = np.array([1000.0, 1000.0, 1000.0], np.float32)
    star_pos = np.stack([b + [0, 0, -120], b + [180, 30, -260]])
    _spawn(world, 2, position=star_pos, model_id=np.full(2, star_model),
           type_id=np.full(2, TYPE_STAR),
           ang_vel=_f32([[0.0, 0.15, 0.0], [0.0, -0.1, 0.0]]),
           sortable=np.full(2, SORTABLE_SPOT),
           light_diffuse=_f32([[1.0, 0.9, 0.7], [0.9, 0.8, 1.0]]),
           light_specular=np.full((2, 3), 0.8, np.float32),
           light_ambient=np.full((2, 3), 0.04, np.float32),
           light_atten=np.full((2, 2), [0.004, 0.00005], np.float32),
           light_direction=_f32([[0.0, -0.3, 1.0], [-0.5, 0.0, 1.0]]),
           light_cutoff=np.full((2, 2), [np.cos(0.6), np.cos(1.0)],
                                np.float32),
           light_radius=np.full(2, 400.0, np.float32),
           light_fov=np.full(2, 1.2, np.float32),
           flags=np.full(2, FLAG_ALWAYS_LOGIC))
    if n <= 500:
        centers = star_pos[rng.integers(0, 2, n)]
    else:
        dirs = rng.normal(size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        shell = rng.uniform(200.0, 1400.0, (n, 1)) ** 1.0
        centers = np.clip((b + dirs * shell).astype(np.float32), 100.0,
                          16284.0)
    radii = rng.uniform(40.0, 160.0, n).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    speeds = rng.uniform(0.05, 0.3, n).astype(np.float32) * np.where(
        rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    pos = centers + np.stack(
        [radii * np.cos(angles), rng.uniform(-20, 20, n).astype(np.float32),
         radii * np.sin(angles)], axis=-1)
    centers_y = centers.copy()
    centers_y[:, 1] = pos[:, 1]
    _spawn(world, n, position=pos.astype(np.float32),
           model_id=np.full(n, rock_full), type_id=np.full(n, TYPE_ASTEROID),
           scale=rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32).repeat(3, 1),
           ang_vel=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
           orbit_angle=angles, orbit_radius=radii, orbit_speed=speeds,
           orbit_center=centers_y.astype(np.float32),
           flags=np.full(n, FLAG_COLLIDABLE))
    _spawn(world, 1, position=(b + np.array([60.0, 0.0, -60.0]))[None],
           model_id=[worm_model], type_id=[TYPE_WORMHOLE],
           flags=[FLAG_COLLIDABLE | FLAG_TRANSPARENT])
    _spawn(world, 1, position=(b + np.array([-80.0, 10.0, -100.0]))[None],
           model_id=[prod_model], type_id=[TYPE_MINE_PRODUCER],
           flags=[FLAG_TRANSPARENT | FLAG_ALWAYS_LOGIC],
           spawn_timer=np.zeros(1, np.float32))
    _spawn(world, 1, position=(b + np.array([-40.0, -15.0, -80.0]))[None],
           model_id=[station_model], type_id=[TYPE_STATION],
           ang_vel=_f32([[0.0, 0.05, 0.0]]))
    _spawn(world, 1, position=_f32([[1000.0, 1000.0, 1150.0]]),
           velocity=np.zeros((1, 3), np.float32), type_id=[TYPE_USER],
           flags=[FLAG_USER | FLAG_ALWAYS_LOGIC | FLAG_COLLIDABLE
                  | FLAG_USER_ALWAYS_COLLIDES])
    srng = np.random.default_rng(STARFIELD[1])
    d = srng.normal(size=(STARFIELD[0], 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bright = srng.uniform(0.25, 1.0, (STARFIELD[0], 1)).astype(np.float32)
    tint = srng.uniform(0.85, 1.0, (STARFIELD[0], 3)).astype(np.float32)
    stars = {"dirs": torch.as_tensor(d, dtype=torch.float32, device=device),
             "colors": torch.as_tensor(bright * tint, device=device)}
    to_rad = 3.14159265358979 / 180.0
    cam = {"fov_y": 60.0 * to_rad, "aspect": st.width / st.height,
           "near": 0.5, "far": 1500.0, "draw_distance": 1500.0}
    camv = torch.tensor([1000.0, 1000.0, 1150.0, np.float32(-90.0 * to_rad),
                         0.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                        device=device)
    world = {k: torch.as_tensor(v, device=device) for k, v in world.items()}
    return Scene(settings=st, bank=bank, atlas=atlas, stars=stars,
                 world=world, camv=camv, cam=cam, mine_model=mine_model)

