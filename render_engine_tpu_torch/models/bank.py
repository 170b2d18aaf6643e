"""Model bank: all geometry and materials packed into one set of tensors.

Port of ``render_engine_tpu/models/bank.py``. ``ModelBankBuilder`` is the
same host-side numpy accumulation (a copy: the port does not import the JAX
package); ``finalize(device)`` freezes it into a ``ModelBank`` of tensors.
The spec/shininess packing is the same exact f32 codec.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

NUM_LOV_BANDS = 5
DEFAULT_LOV_FRACTIONS = (0.10, 0.25, 0.45, 0.70, 1.00)
DEFAULT_SHININESS = 64.0


def pack_spec_shin(spec, shin):
    """(strength in 1/1024 steps over [0, 4), exponent rounded to
    [1, 2047]) -> one f32 integer below 2^23, exact in f32."""
    sq = torch.round(torch.clamp(spec, 0.0, 4.0 - 1.0 / 1024.0) * 1024.0)
    hq = torch.round(torch.clamp(shin, 1.0, 2047.0))
    return hq * 4096.0 + sq


def unpack_spec_shin(packed):
    """Inverse of ``pack_spec_shin`` -> (strength, exponent), exact."""
    hq = torch.floor(packed * (1.0 / 4096.0))
    sq = packed - hq * 4096.0
    return sq * (1.0 / 1024.0), hq


@dataclasses.dataclass(frozen=True)
class ModelBank:
    vertices: torch.Tensor  # (V, 3)
    normals: torch.Tensor  # (V, 3)
    uvs: torch.Tensor  # (V, 2)
    tri_v: torch.Tensor  # (F, 3) int32 global vertex ids
    tri_material: torch.Tensor  # (F,) int32
    tri_offset: torch.Tensor  # (M,) int32
    tri_count: torch.Tensor  # (M,) int32
    vtx_offset: torch.Tensor  # (M,) int32
    aabb_min: torch.Tensor  # (M, 3)
    aabb_max: torch.Tensor  # (M, 3)
    mat_albedo: torch.Tensor  # (K, 3)
    mat_emissive: torch.Tensor  # (K,)
    mat_alpha: torch.Tensor  # (K,)
    mat_specular: torch.Tensor  # (K,)
    mat_shininess: torch.Tensor  # (K,)
    mat_textures: torch.Tensor  # (K, 6) int32 atlas texture ids, -1 unset
    lov_table: torch.Tensor  # (M, NUM_LOV_BANDS + 1) int32
    lov_fractions: torch.Tensor  # (NUM_LOV_BANDS,)
    names: tuple

    # host copies for the static gates below (reading a GPU tensor from
    # Python would wait for the device)
    def __post_init__(self):
        object.__setattr__(self, "_tex_np", self.mat_textures.cpu().numpy())
        object.__setattr__(self, "_shin_np",
                           self.mat_shininess.cpu().numpy())
        mat_safe = self.tri_material.clamp(0, self.mat_alpha.shape[0] - 1)
        mat_safe = mat_safe.long()
        transp = (self.mat_alpha[mat_safe] < 1.0) \
            | (self.mat_textures[mat_safe, 4] >= 0)
        # (F, 5) f32 [v0 v1 v2 material transparent] and (V, 8) f32
        # [pos | normal | uv]: the geometry stage's two row gathers
        object.__setattr__(self, "tri_packed", torch.cat(
            [self.tri_v.to(torch.float32),
             self.tri_material.to(torch.float32)[:, None],
             transp.to(torch.float32)[:, None]], dim=1))
        object.__setattr__(self, "vert_packed", torch.cat(
            [self.vertices, self.normals, self.uvs], dim=1))

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def mat_texture(self) -> torch.Tensor:
        return self.mat_textures[:, 0]

    @property
    def mat_texture_spec(self) -> torch.Tensor:
        return self.mat_textures[:, 1]

    @property
    def mat_texture_emis(self) -> torch.Tensor:
        return self.mat_textures[:, 2]

    @property
    def mat_texture_norm(self) -> torch.Tensor:
        return self.mat_textures[:, 3]

    @property
    def mat_texture_diss(self) -> torch.Tensor:
        return self.mat_textures[:, 4]

    @property
    def mat_texture_shin(self) -> torch.Tensor:
        """Per-material shininess (specular exponent) map id (column 5)."""
        return self.mat_textures[:, 5]

    def has_specular_maps(self) -> bool:
        return bool((self._tex_np[:, 1] >= 0).any())

    def has_emissive_maps(self) -> bool:
        return bool((self._tex_np[:, 2] >= 0).any())

    def has_normal_maps(self) -> bool:
        return bool((self._tex_np[:, 3] >= 0).any())

    def has_dissolve_maps(self) -> bool:
        return bool((self._tex_np[:, 4] >= 0).any())

    def has_shininess_maps(self) -> bool:
        return bool((self._tex_np[:, 5] >= 0).any())

    def uniform_shininess(self):
        """The one shared specular exponent, or None when materials vary."""
        s = self._shin_np
        if s.size == 0 or bool((s == s[0]).all()):
            return float(s[0]) if s.size else 64.0
        return None

    @property
    def mat_spec_shin_packed(self) -> torch.Tensor:
        return pack_spec_shin(self.mat_specular, self.mat_shininess)

    @property
    def mat_specular_eff(self) -> torch.Tensor:
        """Specular strengths as every shading path consumes them: raw when
        the exponent is uniform, else quantized like the packed channel."""
        if self.uniform_shininess() is not None:
            return self.mat_specular
        return unpack_spec_shin(self.mat_spec_shin_packed)[0]

    @property
    def mat_shininess_eff(self) -> torch.Tensor:
        """Exponents as consumed (integer-rounded when they vary)."""
        if self.uniform_shininess() is not None:
            return self.mat_shininess
        return unpack_spec_shin(self.mat_spec_shin_packed)[1]

    @property
    def num_models(self) -> int:
        return len(self.names)

    @property
    def num_triangles(self) -> int:
        return self.tri_v.shape[0]

    def model_index(self, name: str) -> int:
        return self.names.index(name)

    def lov_model_id(self, model_id, distance, draw_distance, band_bias=0):
        """(model, camera distance) -> bank entry of the distance band."""
        # a host scalar, as a 0-dim CPU tensor was: both divide alike
        frac = distance / float(np.float32(draw_distance))
        band = torch.searchsorted(self.lov_fractions, frac.contiguous(),
                                  right=True)
        band = (band + band_bias).clamp(0, NUM_LOV_BANDS)
        safe = model_id.clamp(0, self.lov_table.shape[0] - 1).long()
        return torch.where(model_id >= 0, self.lov_table[safe, band],
                           model_id)


class ModelBankBuilder:
    """Host-side accumulation of meshes and materials, then ``finalize``."""

    def __init__(self, lov_fractions=DEFAULT_LOV_FRACTIONS):
        self._v, self._n, self._uv = [], [], []
        self._tri, self._tri_mat = [], []
        self._models = []
        self._mats = []
        self._lov = {}
        self._lov_fractions = tuple(lov_fractions)
        self.add_material(albedo=(1.0, 0.0, 1.0))  # material 0: error

    def add_material(self, albedo=(1.0, 1.0, 1.0), emissive=0.0, alpha=1.0,
                     texture=-1, specular=1.0, texture_specular=-1,
                     texture_emissive=-1, texture_normal=-1,
                     texture_dissolve=-1, shininess=DEFAULT_SHININESS,
                     texture_shininess=-1) -> int:
        self._mats.append(dict(
            albedo=np.asarray(albedo, np.float32), emissive=float(emissive),
            alpha=float(alpha), texture=int(texture),
            specular=float(specular), texture_specular=int(texture_specular),
            texture_emissive=int(texture_emissive),
            texture_normal=int(texture_normal),
            texture_dissolve=int(texture_dissolve),
            shininess=float(shininess),
            texture_shininess=int(texture_shininess)))
        return len(self._mats) - 1

    def add_model(self, name, mesh, material: int | None = None,
                  tri_material=None) -> int:
        v, n, uv, f = mesh
        if material is None and tri_material is None:
            material = 0
        vtx_off = sum(len(x) for x in self._v)
        tri_off = sum(len(x) for x in self._tri)
        self._v.append(np.asarray(v, np.float32))
        self._n.append(np.asarray(n, np.float32))
        self._uv.append(np.asarray(uv, np.float32))
        self._tri.append(np.asarray(f, np.int32) + vtx_off)
        if tri_material is not None:
            self._tri_mat.append(np.asarray(tri_material, np.int32))
        else:
            self._tri_mat.append(np.full(len(f), material, np.int32))
        mn = v.min(axis=0) if len(v) else np.zeros(3, np.float32)
        mx = v.max(axis=0) if len(v) else np.zeros(3, np.float32)
        self._models.append((name, vtx_off, tri_off, len(f), mn, mx))
        return len(self._models) - 1

    def add_obj(self, name, path, atlas_builder=None) -> int:
        """Load an OBJ with its MTL materials; texture maps go into
        ``atlas_builder`` (render.textures.TextureAtlasBuilder)."""
        from render_engine_tpu_torch.models.obj_loader import load_obj

        v, n, uv, f, tri_mat, mats = load_obj(path)
        base = os.path.dirname(os.path.abspath(path))
        roles = (("map_kd", "diffuse"), ("map_ks", "specular"),
                 ("map_ke", "emissive"), ("map_bump", "normal"),
                 ("map_d", "dissolve"), ("map_ns", "shininess"))
        ids = []
        for m in mats:
            tex = {key: -1 for key, _ in roles}
            if atlas_builder is not None:
                for key, kind in roles:
                    if m.get(key):
                        tex[key] = atlas_builder.add_image_file(
                            os.path.join(base, m[key]), kind=kind)
            ids.append(self.add_material(
                albedo=m["kd"], specular=m.get("ks", 1.0),
                emissive=m.get("ke", 0.0), alpha=m.get("d", 1.0),
                shininess=m.get("ns", DEFAULT_SHININESS),
                texture=tex["map_kd"], texture_specular=tex["map_ks"],
                texture_emissive=tex["map_ke"],
                texture_normal=tex["map_bump"],
                texture_dissolve=tex["map_d"],
                texture_shininess=tex["map_ns"]))
        remap = np.asarray(ids, np.int32)[tri_mat]
        return self.add_model(name, (v, n, uv, f), tri_material=remap)

    def set_levels_of_view(self, model: int, band_models: list[int]):
        chain = list(band_models)
        while len(chain) < NUM_LOV_BANDS + 1:
            chain.append(chain[-1])
        self._lov[model] = chain[: NUM_LOV_BANDS + 1]

    def finalize(self, device="cpu") -> ModelBank:
        if not self._models:
            raise ValueError("empty model bank")
        m = len(self._models)
        lov = np.zeros((m, NUM_LOV_BANDS + 1), np.int32)
        for i in range(m):
            lov[i] = self._lov.get(i, [i] * (NUM_LOV_BANDS + 1))
        mats = self._mats

        def t(a, dtype=np.float32):
            return torch.as_tensor(np.ascontiguousarray(np.asarray(a, dtype)),
                                   device=device)

        return ModelBank(
            vertices=t(np.concatenate(self._v)),
            normals=t(np.concatenate(self._n)),
            uvs=t(np.concatenate(self._uv)),
            tri_v=t(np.concatenate(self._tri), np.int32),
            tri_material=t(np.concatenate(self._tri_mat), np.int32),
            tri_offset=t([x[2] for x in self._models], np.int32),
            tri_count=t([x[3] for x in self._models], np.int32),
            vtx_offset=t([x[1] for x in self._models], np.int32),
            aabb_min=t(np.stack([x[4] for x in self._models])),
            aabb_max=t(np.stack([x[5] for x in self._models])),
            mat_albedo=t(np.stack([d["albedo"] for d in mats])),
            mat_emissive=t([d["emissive"] for d in mats]),
            mat_alpha=t([d["alpha"] for d in mats]),
            mat_specular=t([d["specular"] for d in mats]),
            mat_shininess=t([d["shininess"] for d in mats]),
            mat_textures=t([[d["texture"], d["texture_specular"],
                             d["texture_emissive"], d["texture_normal"],
                             d["texture_dissolve"], d["texture_shininess"]]
                            for d in mats], np.int32),
            lov_table=t(lov, np.int32),
            lov_fractions=t(self._lov_fractions),
            names=tuple(x[0] for x in self._models))
