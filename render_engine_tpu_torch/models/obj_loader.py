"""Wavefront OBJ (+ MTL) loading, host-side numpy.

Port of ``render_engine_tpu/models/obj_loader.py`` (triangulated faces,
per-corner vertex unification, MTL diffuse/specular/emissive colors,
texture-map names, fan triangulation). ``load_obj`` parses through the
native core first (``native/obj_loader.cpp``, ``_load_obj_native``) and
through the Python parser, its specification, where the core is off
(``RE_TPU_NATIVE=0``), did not build, or rejects the file.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np


def _default_material(name: str, info: dict | None = None) -> dict:
    info = info or {}
    return {
        "name": name,
        "kd": np.asarray(info.get("kd", [1.0, 1.0, 1.0]), np.float32),
        "map_kd": info.get("map_kd"),
        "ks": float(info.get("ks", 1.0)),
        "map_ks": info.get("map_ks"),
        "ke": float(info.get("ke", 0.0)),
        "map_ke": info.get("map_ke"),
        "map_bump": info.get("map_bump"),
        "map_d": info.get("map_d"),
        "d": float(info.get("d", 1.0)),
        "ns": float(info.get("ns", 64.0)),
        "map_ns": info.get("map_ns"),
    }


def load_mtl(path: str) -> dict:
    """Parse an MTL file into {name: fields} (see the JAX package's
    ``load_mtl`` for the field list)."""
    mats = {}
    cur = None
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "newmtl":
                cur = parts[1]
                mats[cur] = {"kd": np.array([1.0, 1.0, 1.0], np.float32),
                             "map_kd": None, "ks": 1.0, "map_ks": None,
                             "ke": 0.0, "map_ke": None, "map_bump": None,
                             "map_d": None, "d": 1.0,
                             "ns": 64.0, "map_ns": None}
            elif cur is None:
                continue
            elif tag == "Kd":
                mats[cur]["kd"] = np.array(parts[1:4], np.float32)
            elif tag == "Ks":
                mats[cur]["ks"] = float(np.mean(np.array(parts[1:4],
                                                         np.float32)))
            elif tag == "Ke":
                mats[cur]["ke"] = float(np.mean(np.array(parts[1:4],
                                                         np.float32)))
            elif tag == "Ns":
                mats[cur]["ns"] = float(parts[1])
            elif tag == "map_Kd":
                mats[cur]["map_kd"] = parts[-1]
            elif tag == "map_Ks":
                mats[cur]["map_ks"] = parts[-1]
            elif tag == "map_Ke":
                mats[cur]["map_ke"] = parts[-1]
            elif tag == "map_Ns":
                mats[cur]["map_ns"] = parts[-1]
            elif tag in ("map_Bump", "map_bump", "bump", "norm"):
                mats[cur]["map_bump"] = parts[-1]
            elif tag == "map_d":
                mats[cur]["map_d"] = parts[-1]
            elif tag == "d":
                mats[cur]["d"] = float(parts[1])
    return mats


def _load_obj_native(path: str):
    """``load_obj``'s parse through the C++ core: the same tuple before
    the normal fill, or None when the library is off or did not build, or
    the file trips one of the core's guards (a malformed number or an
    index out of range). Materials replay the Python parser's timing over
    the returned usemtl / mtllib records: each name resolves, at its first
    use, against the latest mtllib that existed at that point."""
    from render_engine_tpu_torch.native.build import obj_native

    lib = obj_native()
    if lib is None:
        return None
    handle = lib.obj_parse(os.fsencode(path))
    if not handle:
        return None
    c = ctypes
    try:
        nv, nf = c.c_int64(), c.c_int64()
        n_names, n_libs = c.c_int32(), c.c_int32()
        names_len, libs_len = c.c_int64(), c.c_int64()
        lib.obj_counts(handle, c.byref(nv), c.byref(nf), c.byref(n_names),
                       c.byref(n_libs), c.byref(names_len),
                       c.byref(libs_len))
        v = np.empty((nv.value, 3), np.float32)
        n = np.empty((nv.value, 3), np.float32)
        uv = np.empty((nv.value, 2), np.float32)
        tris = np.empty((nf.value, 3), np.int32)
        tri_slot = np.empty(nf.value, np.int32)
        names_buf = c.create_string_buffer(max(names_len.value, 1))
        libs_buf = c.create_string_buffer(max(libs_len.value, 1))
        name_lib = np.empty(max(n_names.value, 1), np.int32)
        fp, ip = c.POINTER(c.c_float), c.POINTER(c.c_int32)
        lib.obj_copy(handle, v.ctypes.data_as(fp), n.ctypes.data_as(fp),
                     uv.ctypes.data_as(fp), tris.ctypes.data_as(ip),
                     tri_slot.ctypes.data_as(ip), names_buf,
                     name_lib.ctypes.data_as(ip), libs_buf)
    finally:
        lib.obj_free(handle)

    def tokens(buf, length):
        return buf.raw[:length].decode().split("\0")[:-1] if length else []

    # the table in effect after each mtllib record
    mtl_at, eff = [], {}
    for tok in tokens(libs_buf, libs_len.value):
        mpath = os.path.join(os.path.dirname(path), tok)
        if os.path.exists(mpath):
            eff = load_mtl(mpath)
        mtl_at.append(eff)
    materials = [_default_material("__default__")]
    for i, name in enumerate(tokens(names_buf, names_len.value)):
        k = int(name_lib[i])
        materials.append(_default_material(
            name, (mtl_at[k] if 0 <= k < len(mtl_at) else {}).get(name, {})))
    return v, n, uv, tris, tri_slot, materials


def _fill_missing_normals(v, n, tris):
    """Area-weighted face-normal fill for corners without a vn record."""
    if len(tris) and (np.linalg.norm(n, axis=1) < 1e-8).any():
        f = np.asarray(tris, np.int32)
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
        acc = np.zeros_like(n)
        for c in range(3):
            np.add.at(acc, f[:, c], fn)
        missing = np.linalg.norm(n, axis=1) < 1e-8
        lens = np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-12)
        n[missing] = (acc / lens)[missing]
    return n


def load_obj(path: str):
    """Returns ``(vertices, normals, uvs, triangles, tri_material,
    materials)``; ``materials[0]`` is a default white material. The
    native core parses when it can (``_load_obj_native``), else the
    Python parser below."""
    native = _load_obj_native(path)
    if native is not None:
        v, n, uv, tris, tri_mat, materials = native
        return (v, _fill_missing_normals(v, n, tris), uv, tris, tri_mat,
                materials)
    positions, normals_raw, uvs_raw = [], [], []
    corner_map: dict = {}
    out_v, out_n, out_uv = [], [], []
    tris, tri_mat = [], []
    materials = [_default_material("__default__")]
    mat_index = {"__default__": 0}
    cur_mat = 0
    mtl: dict = {}

    def corner(token: str) -> int:
        if token in corner_map:
            return corner_map[token]
        f = token.split("/")
        vi = int(f[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = ni = None
        if len(f) > 1 and f[1]:
            t = int(f[1])
            ti = t - 1 if t > 0 else len(uvs_raw) + t
        if len(f) > 2 and f[2]:
            k = int(f[2])
            ni = k - 1 if k > 0 else len(normals_raw) + k
        idx = len(out_v)
        out_v.append(positions[vi])
        out_uv.append(uvs_raw[ti] if ti is not None else [0.0, 0.0])
        out_n.append(normals_raw[ni] if ni is not None else [0.0, 0.0, 0.0])
        corner_map[token] = idx
        return idx

    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals_raw.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs_raw.append([float(parts[1]), float(parts[2])])
            elif tag == "mtllib":
                mpath = os.path.join(os.path.dirname(path), parts[1])
                if os.path.exists(mpath):
                    mtl = load_mtl(mpath)
            elif tag == "usemtl":
                name = parts[1]
                if name not in mat_index:
                    materials.append(_default_material(name,
                                                       mtl.get(name, {})))
                    mat_index[name] = len(materials) - 1
                cur_mat = mat_index[name]
            elif tag == "f":
                ids = [corner(t) for t in parts[1:]]
                for k in range(1, len(ids) - 1):
                    tris.append([ids[0], ids[k], ids[k + 1]])
                    tri_mat.append(cur_mat)

    v = np.asarray(out_v, np.float32).reshape(-1, 3)
    n = _fill_missing_normals(
        v, np.asarray(out_n, np.float32).reshape(-1, 3), tris)
    return (v, n.astype(np.float32),
            np.asarray(out_uv, np.float32).reshape(-1, 2),
            np.asarray(tris, np.int32).reshape(-1, 3),
            np.asarray(tri_mat, np.int32), materials)
