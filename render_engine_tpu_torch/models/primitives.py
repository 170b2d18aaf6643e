"""Procedural mesh primitives (numpy, host-side).

A numpy copy of ``render_engine_tpu/models/primitives.py`` (the port does
not import the JAX package). Every generator returns ``(vertices (V,3) f32,
normals (V,3) f32, uvs (V,2) f32, triangles (F,3) i32)`` with CCW winding
viewed from outside.
"""

from __future__ import annotations

import numpy as np


def _as_mesh(v, n, uv, f):
    return (
        np.asarray(v, np.float32),
        np.asarray(n, np.float32),
        np.asarray(uv, np.float32),
        np.asarray(f, np.int32),
    )


def quad(size: float = 1.0):
    """Unit XY quad facing +Z, centered at origin."""
    s = size * 0.5
    v = [[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]]
    n = [[0, 0, 1]] * 4
    uv = [[0, 0], [1, 0], [1, 1], [0, 1]]
    f = [[0, 1, 2], [0, 2, 3]]
    return _as_mesh(v, n, uv, f)


def cube(size: float = 1.0):
    """Axis-aligned cube with per-face normals (24 verts, 12 tris)."""
    s = size * 0.5
    faces = [
        # (normal, 4 corners CCW from outside)
        ([0, 0, 1], [[-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]]),
        ([0, 0, -1], [[s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]]),
        ([1, 0, 0], [[s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]]),
        ([-1, 0, 0], [[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]]),
        ([0, 1, 0], [[-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]]),
        ([0, -1, 0], [[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]]),
    ]
    v, n, uv, f = [], [], [], []
    for normal, corners in faces:
        base = len(v)
        v.extend(corners)
        n.extend([normal] * 4)
        uv.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
        f.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return _as_mesh(v, n, uv, f)


def uv_sphere(radius: float = 0.5, lat: int = 8, lon: int = 12):
    """Latitude/longitude sphere."""
    vs, ns, uvs = [], [], []
    for i in range(lat + 1):
        theta = np.pi * i / lat
        for j in range(lon + 1):
            phi = 2 * np.pi * j / lon
            d = np.array([
                np.sin(theta) * np.cos(phi),
                np.cos(theta),
                np.sin(theta) * np.sin(phi),
            ])
            vs.append(radius * d)
            ns.append(d)
            uvs.append([j / lon, 1.0 - i / lat])
    fs = []
    stride = lon + 1
    for i in range(lat):
        for j in range(lon):
            a = i * stride + j
            b = a + stride
            # CCW viewed from outside (y-down latitude sweep)
            if i != 0:
                fs.append([a, a + 1, b])
            if i != lat - 1:
                fs.append([a + 1, b + 1, b])
    return _as_mesh(vs, ns, uvs, fs)


def asteroid(radius: float = 0.5, lat: int = 6, lon: int = 9,
             roughness: float = 0.35, seed: int = 0):
    """Randomly perturbed sphere — the demo's asteroid stand-in."""
    v, n, uv, f = uv_sphere(radius, lat, lon)
    rng = np.random.default_rng(seed)
    # perturb radially, consistent for coincident seam vertices via rounding
    keys = {}
    scale = np.empty(len(v), np.float32)
    for i, p in enumerate(v):
        k = tuple(np.round(p / max(radius, 1e-6), 4))
        if k not in keys:
            keys[k] = 1.0 + roughness * (rng.random() * 2.0 - 1.0)
        scale[i] = keys[k]
    v = v * scale[:, None]
    return _as_mesh(v, n, uv, f)  # normals kept spherical (close enough)


def icosahedron(radius: float = 0.5):
    """12-vertex icosahedron (flat-shaded, 20 tris) — cheap LoV level."""
    t = (1.0 + 5 ** 0.5) / 2.0
    raw = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float32)
    raw = raw / np.linalg.norm(raw, axis=1, keepdims=True) * radius
    fs = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int32)
    n = raw / np.linalg.norm(raw, axis=1, keepdims=True)
    uv = np.zeros((len(raw), 2), np.float32)
    return _as_mesh(raw, n, uv, fs)


def tetrahedron(radius: float = 0.5):
    """4-triangle far-distance LoV stand-in."""
    a = radius
    v = np.array([[a, a, a], [a, -a, -a], [-a, a, -a], [-a, -a, a]],
                 np.float32)
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * radius
    f = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]], np.int32)
    n = v / np.linalg.norm(v, axis=1, keepdims=True)
    uv = np.zeros((4, 2), np.float32)
    return _as_mesh(v, n, uv, f)
