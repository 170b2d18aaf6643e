"""Light extraction and the golden deferred lighting pass.

Port of ``render_engine_tpu/render/lighting.py``: ``LightArrays``,
``extract_lights``, and ``shade``, Blinn-Phong over a G-buffer and the light
arrays (directional, point and spot lights; ambient, diffuse and specular
terms; attenuation 1 / (1 + linear d + quadratic d^2); the point lights'
radius cutoff; smooth spot cones; the diffuse floor; the emissive bypass).
The fused shade kernel (``shade_pallas.py``) computes the same function per
tile; ``shade`` is the yardstick it is held to and the path of
``RenderSettings(backend="jnp")``.
"""

from __future__ import annotations

import dataclasses

import torch

from render_engine_tpu_torch.ecs import registry as R
from render_engine_tpu_torch.ecs.world import World
from render_engine_tpu_torch.models.bank import DEFAULT_SHININESS
from render_engine_tpu_torch.render.gbuffer import GBuffer

SHININESS = DEFAULT_SHININESS
DIFFUSE_FLOOR = 0.08


@dataclasses.dataclass(frozen=True)
class LightArrays:
    dir_direction: torch.Tensor  # (ND, 3)
    dir_diffuse: torch.Tensor
    dir_specular: torch.Tensor
    dir_ambient: torch.Tensor
    dir_count: torch.Tensor  # () int32
    dir_entity: torch.Tensor  # (ND,) entity id, -1 empty
    pt_position: torch.Tensor  # (NP, 3)
    pt_diffuse: torch.Tensor
    pt_specular: torch.Tensor
    pt_ambient: torch.Tensor
    pt_atten: torch.Tensor  # (NP, 2)
    pt_radius: torch.Tensor  # (NP,)
    pt_count: torch.Tensor
    pt_entity: torch.Tensor
    sp_position: torch.Tensor  # (NS, 3)
    sp_direction: torch.Tensor
    sp_diffuse: torch.Tensor
    sp_specular: torch.Tensor
    sp_ambient: torch.Tensor
    sp_atten: torch.Tensor
    sp_cutoff: torch.Tensor  # (NS, 2) cos inner, cos outer
    sp_count: torch.Tensor
    sp_entity: torch.Tensor


def _select_bucket(world: World, bucket: int, budget: int):
    """Lowest entity indices of one sortable bucket, up to ``budget``."""
    m = world.sortable_mask(bucket)
    cap = world.capacity
    ar = torch.arange(cap, dtype=torch.int64, device=world.device)
    idx = torch.sort(torch.where(m, ar, torch.full_like(ar, cap))).values
    idx = idx[:budget]
    if idx.shape[0] < budget:  # a budget above capacity pads with empties
        idx = torch.cat([idx, idx.new_full((budget - idx.shape[0],), cap)])
    valid = idx < cap
    return (idx.clamp(0, cap - 1), valid,
            m.sum(dtype=torch.int32).clamp(0, budget))


def extract_lights(world: World, *, max_dir: int = 4, max_point: int = 256,
                   max_spot: int = 16) -> LightArrays:
    di, dv, dc = _select_bucket(world, R.SORTABLE_DIRECTIONAL, max_dir)
    pi, pv, pc = _select_bucket(world, R.SORTABLE_POINT, max_point)
    si, sv, sc = _select_bucket(world, R.SORTABLE_SPOT, max_spot)

    def g(name, idx, valid):
        a = world[name][idx]
        v = valid.reshape(valid.shape + (1,) * (a.ndim - 1))
        return torch.where(v, a, torch.zeros_like(a))

    def ent(idx, valid):
        return torch.where(valid, idx, torch.full_like(idx, -1)).to(
            torch.int32)

    return LightArrays(
        dir_direction=g("light_direction", di, dv),
        dir_diffuse=g("light_diffuse", di, dv),
        dir_specular=g("light_specular", di, dv),
        dir_ambient=g("light_ambient", di, dv),
        dir_count=dc, dir_entity=ent(di, dv),
        pt_position=g("position", pi, pv),
        pt_diffuse=g("light_diffuse", pi, pv),
        pt_specular=g("light_specular", pi, pv),
        pt_ambient=g("light_ambient", pi, pv),
        pt_atten=g("light_atten", pi, pv),
        pt_radius=g("light_radius", pi, pv),
        pt_count=pc, pt_entity=ent(pi, pv),
        sp_position=g("position", si, sv),
        sp_direction=g("light_direction", si, sv),
        sp_diffuse=g("light_diffuse", si, sv),
        sp_specular=g("light_specular", si, sv),
        sp_ambient=g("light_ambient", si, sv),
        sp_atten=g("light_atten", si, sv),
        sp_cutoff=g("light_cutoff", si, sv),
        sp_count=sc, sp_entity=ent(si, sv),
    )


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _unit(v):
    n = _norm(v)
    return v / torch.where(n > 1e-9, n, torch.ones_like(n))


def _blinn_phong(n, view_dir, light_dir, albedo, diffuse, specular, ambient,
                 spec_strength=1.0, shininess=SHININESS):
    """The BRDF terms; every input broadcasts to (..., 3). ``shininess``
    is a Python float or a broadcastable per-pixel tensor."""
    ndl = (n * light_dir).sum(dim=-1, keepdim=True).clamp(min=0.0)
    h = _unit(light_dir + view_dir)
    ndh = (n * h).sum(dim=-1, keepdim=True).clamp(min=0.0)
    spec = torch.where(ndl > 0.0, torch.pow(ndh, shininess),
                       torch.zeros_like(ndh)) * spec_strength
    return ambient * albedo + diffuse * ndl * albedo + specular * spec


def shade(gbuf: GBuffer, lights: LightArrays, bank, camera_position, *,
          background=None, shadow_factor=None, light_chunk: int = 8,
          emissive_image=None, specular_image=None,
          shininess_image=None) -> torch.Tensor:
    """Lit color (H, W, 3). ``background``: (H, W, 3) for empty pixels.
    ``shadow_factor``: optional callable (kind, index, world_pos (H, W, 3))
    -> (H, W, 1) in [0, 1]; with one, the first four point lights take it
    too. ``emissive_image`` / ``specular_image`` / ``shininess_image``:
    per-pixel (H, W) values replacing the material-table gathers."""
    h, w = gbuf.shape
    n, pos, albedo = gbuf.normal, gbuf.position, gbuf.albedo
    view_dir = _unit(camera_position[None, None, :] - pos)
    color = torch.zeros((h, w, 3), dtype=torch.float32, device=pos.device)

    uni_shin = bank.uniform_shininess() if bank is not None else SHININESS
    def material(table):
        return table[gbuf.material.clamp(0, table.shape[0] - 1).long()]

    if specular_image is not None:
        spec_k = specular_image[..., None]
    else:
        spec_k = material(bank.mat_specular_eff)[..., None]
    if shininess_image is not None:
        shin = shininess_image[..., None]
    elif uni_shin is not None:
        shin = uni_shin
    else:
        shin = material(bank.mat_shininess_eff)[..., None]

    def sf(kind, i):
        return 1.0 if shadow_factor is None else shadow_factor(kind, i, pos)

    def on(i, count):
        return (i < count).to(torch.float32)

    def attenuation(att, dist):
        return 1.0 / (1.0 + att[..., 0:1] * dist
                      + att[..., 1:2] * dist * dist)

    for i in range(lights.dir_direction.shape[0]):
        ld = _unit(-lights.dir_direction[i])
        c = _blinn_phong(n, view_dir, ld[None, None, :], albedo,
                         lights.dir_diffuse[i], lights.dir_specular[i],
                         lights.dir_ambient[i], spec_k, shin)
        color = color + on(i, lights.dir_count) * c * sf("dir", i)

    # point lights: the first few one by one, so that a shadow callback can
    # name them; the rest in chunks
    n_pt = lights.pt_position.shape[0]
    n_head = min(4, n_pt) if shadow_factor is not None else 0
    for i in range(n_head):
        lv = lights.pt_position[i][None, None, :] - pos
        dist = _norm(lv)
        ld = lv / torch.where(dist > 1e-9, dist, torch.ones_like(dist))
        atten = attenuation(lights.pt_atten[i], dist)
        rad = lights.pt_radius[i]
        atten = torch.where((rad > 0.0) & (dist > rad),
                            torch.zeros_like(atten), atten)
        c = _blinn_phong(n, view_dir, ld, albedo, lights.pt_diffuse[i],
                         lights.pt_specular[i], lights.pt_ambient[i], spec_k,
                         shin)
        color = color + on(i, lights.pt_count) * c * atten * sf("point", i)

    ids = torch.arange(n_pt, device=pos.device)
    shin_c = shin if isinstance(shin, float) else shin[:, :, None, :]
    color_pt = torch.zeros_like(color)
    for lo in range(n_head, n_pt, light_chunk):
        hi = min(lo + light_chunk, n_pt)
        lv = lights.pt_position[lo:hi][None, None] - pos[:, :, None, :]
        d = _norm(lv)  # (H, W, C, 1)
        ld = lv / torch.where(d > 1e-9, d, torch.ones_like(d))
        atten = attenuation(lights.pt_atten[lo:hi][None, None], d)
        rad = lights.pt_radius[lo:hi][None, None, :, None]
        atten = torch.where((rad > 0.0) & (d > rad), torch.zeros_like(atten),
                            atten)
        live = on(ids[lo:hi], lights.pt_count)[None, None, :, None]
        c = _blinn_phong(n[:, :, None, :], view_dir[:, :, None, :], ld,
                         albedo[:, :, None, :],
                         lights.pt_diffuse[lo:hi][None, None],
                         lights.pt_specular[lo:hi][None, None],
                         lights.pt_ambient[lo:hi][None, None],
                         spec_k[:, :, None, :], shin_c)
        color_pt = color_pt + (c * atten * live).sum(dim=2)
    color = color + color_pt

    for i in range(lights.sp_position.shape[0]):
        lv = lights.sp_position[i][None, None, :] - pos
        d = _norm(lv)
        ld = lv / torch.where(d > 1e-9, d, torch.ones_like(d))
        sd = _unit(lights.sp_direction[i])
        cos_theta = (ld * (-sd)[None, None, :]).sum(dim=-1, keepdim=True)
        inner, outer = lights.sp_cutoff[i, 0], lights.sp_cutoff[i, 1]
        eps = (inner - outer).clamp(min=1e-6)
        intensity = ((cos_theta - outer) / eps).clamp(0.0, 1.0)
        c = _blinn_phong(n, view_dir, ld, albedo, lights.sp_diffuse[i],
                         lights.sp_specular[i], lights.sp_ambient[i], spec_k,
                         shin)
        color = color + (on(i, lights.sp_count) * c * intensity
                         * attenuation(lights.sp_atten[i], d)
                         * sf("spot", i))

    color = torch.maximum(color, DIFFUSE_FLOOR * albedo)
    if emissive_image is not None:
        emissive = emissive_image[..., None]
    else:
        emissive = material(bank.mat_emissive)[..., None]
    color = torch.where(emissive > 0.0, albedo * emissive, color)
    if background is None:
        background = torch.zeros_like(color)
    return torch.where(gbuf.covered()[..., None], color, background)
