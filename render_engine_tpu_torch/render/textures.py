"""Texture atlas: shelf-packed layers, per-texture rects, bilinear rows.

Port of ``render_engine_tpu/render/textures.py``. The builder is the same
host-side numpy shelf packer (copied); ``finalize(device)`` returns a
``TextureAtlas`` of tensors. ``sample_atlas_rows`` samples through the
precomputed 2x2-footprint rows, one row gather per pixel; ``sample_atlas``
is the golden four-tap sampler by texture id, with the same values.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TextureAtlas:
    layers: torch.Tensor  # (L, S, S, 3) f32 linear color
    tex_layer: torch.Tensor  # (T,) int32
    uv_rect: torch.Tensor  # (T, 4) [u_scale, v_scale, u_off, v_off] px
    bilin_rows: torch.Tensor  # (L*S*S, 16) [c00 c01 c10 c11 | pad]

    @property
    def size(self) -> int:
        return self.layers.shape[1]

    @property
    def num_textures(self) -> int:
        return self.tex_layer.shape[0]

    def wasted_fraction(self) -> float:
        """Fraction of allocated layer texels no texture occupies."""
        total = self.layers.shape[0] * self.size * self.size
        rect = self.uv_rect.cpu().numpy()
        used = ((rect[:, 0] + 1.0) * (rect[:, 1] + 1.0)).sum()
        return float(1.0 - used / total)


class TextureAtlasBuilder:
    ERROR_COLORS = {
        "diffuse": (0.0, 0.0, 1.0),
        "dissolve": (0.0, 1.0, 0.0),
        "normal": (0.0, 1.0, 1.0),
        "shininess": (1.0, 0.0, 0.0),
        "specular": (1.0, 0.0, 1.0),
        "storage": (1.0, 1.0, 0.0),
        "emissive": (1.0, 0.5, 0.0),
    }

    def __init__(self, layer_size: int = 256):
        self.size = layer_size
        self._imgs: list[np.ndarray] = []
        self._error_layers: dict = {}

    def error_texture(self, kind: str = "diffuse") -> int:
        color = self.ERROR_COLORS.get(kind, (1.0, 0.0, 1.0))
        if kind not in self._error_layers:
            self._error_layers[kind] = self.add_checkerboard(
                a=color, b=(0.0, 0.0, 0.0), cells=8)
        return self._error_layers[kind]

    def add_image_file(self, path: str, kind: str = "diffuse") -> int:
        """Load ``path``; an unreadable file gets the role's error texture."""
        try:
            return self.add_image(load_image(path))
        except (OSError, ValueError) as exc:
            warnings.warn(f"texture {path!r} failed to load ({exc}); using "
                          f"the {kind!r} error texture", stacklevel=2)
            return self.error_texture(kind)

    def add_image(self, img: np.ndarray) -> int:
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        s = self.size
        h, w = img.shape[:2]
        sy = max(1, -(-h // s))
        sx = max(1, -(-w // s))
        self._imgs.append(np.ascontiguousarray(
            img[::sy, ::sx, :3].astype(np.float32)))
        return len(self._imgs) - 1

    def add_checkerboard(self, a=(1, 1, 1), b=(0, 0, 0), cells=8) -> int:
        s = self.size
        yy, xx = np.mgrid[0:s, 0:s]
        mask = ((yy * cells // s) + (xx * cells // s)) % 2
        img = np.where(mask[..., None] > 0, np.asarray(b, np.float32),
                       np.asarray(a, np.float32))
        return self.add_image(img)

    def finalize(self, device="cpu") -> TextureAtlas | None:
        """Shelf-pack (first-fit decreasing by height) into (S, S) layers
        and build the bilinear footprint rows."""
        if not self._imgs:
            return None
        s = self.size
        t = len(self._imgs)
        order = sorted(range(t), key=lambda i: -self._imgs[i].shape[0])
        layers: list[np.ndarray] = []
        shelves: list[list] = []
        tex_layer = np.zeros(t, np.int32)
        uv_rect = np.zeros((t, 4), np.float32)
        for i in order:
            img = self._imgs[i]
            h, w = img.shape[:2]
            placed = None
            for li, rows in enumerate(shelves):
                for row in rows:
                    if row[1] >= h and row[2] + w <= s:
                        placed = (li, row[2], row[0])
                        row[2] += w
                        break
                if placed:
                    break
                y_next = rows[-1][0] + rows[-1][1]
                if y_next + h <= s:
                    rows.append([y_next, h, w])
                    placed = (li, 0, y_next)
                    break
            if placed is None:
                layers.append(np.zeros((s, s, 3), np.float32))
                shelves.append([[0, h, w]])
                placed = (len(layers) - 1, 0, 0)
            li, x, y = placed
            layers[li][y:y + h, x:x + w] = img
            tex_layer[i] = li
            uv_rect[i] = [w - 1, h - 1, x, y]
        return atlas_from_layers(np.stack(layers), tex_layer, uv_rect,
                                 device)


def atlas_from_layers(stack: np.ndarray, tex_layer, uv_rect, device
                      ) -> TextureAtlas:
    """Build the atlas tensors (and the edge-clamped 2x2 rows) from packed
    (L, S, S, 3) layers."""
    stack = np.asarray(stack, np.float32)
    length, s = stack.shape[0], stack.shape[1]
    nxt = np.minimum(np.arange(s) + 1, s - 1)
    right = stack[:, :, nxt]
    down = stack[:, nxt]
    downright = down[:, :, nxt]
    rows = np.concatenate(
        [stack, right, down, downright,
         np.zeros(stack.shape[:3] + (4,), np.float32)],
        axis=-1).reshape(length * s * s, 16)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(np.asarray(a, dtype)),
                               device=device)

    return TextureAtlas(layers=t(stack, np.float32),
                        tex_layer=t(tex_layer, np.int32),
                        uv_rect=t(uv_rect, np.float32),
                        bilin_rows=t(rows, np.float32))


def sample_atlas(atlas: TextureAtlas, texture: torch.Tensor,
                 uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample by four taps. ``texture``: (...,) int texture ids
    (clipped); ``uv``: (..., 2) model-space coordinates (wrapped), mapped
    into the texture's packed rect. Returns (..., 3)."""
    s = atlas.size
    t = texture.clamp(0, atlas.num_textures - 1).long()
    lay = atlas.tex_layer[t].long()
    rect = atlas.uv_rect[t]
    u = rect[..., 2] + torch.remainder(uv[..., 0], 1.0) * rect[..., 0]
    v = rect[..., 3] + (1.0 - torch.remainder(uv[..., 1], 1.0)) * rect[..., 1]
    # bound the floats before the int cast
    u0 = torch.floor(u).clamp(0.0, s - 1.0).long()
    v0 = torch.floor(v).clamp(0.0, s - 1.0).long()
    u1 = (u0 + 1).clamp(max=s - 1)
    v1 = (v0 + 1).clamp(max=s - 1)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    return (atlas.layers[lay, v0, u0] * (1 - fu) * (1 - fv)
            + atlas.layers[lay, v0, u1] * fu * (1 - fv)
            + atlas.layers[lay, v1, u0] * (1 - fu) * fv
            + atlas.layers[lay, v1, u1] * fu * fv)


def sample_atlas_rows(atlas: TextureAtlas, layer_f: torch.Tensor,
                      uv: torch.Tensor, uv_rect: torch.Tensor
                      ) -> torch.Tensor:
    """Bilinear sample via the 2x2-footprint rows. ``layer_f``: (...,) f32
    absolute layer ids (clipped); ``uv``: (..., 2); ``uv_rect``: (..., 4)
    per-pixel packed rect. Returns (..., 3)."""
    s = atlas.size
    lay = layer_f.clamp(0.0, atlas.layers.shape[0] - 1.0)
    u = uv_rect[..., 2] + torch.remainder(uv[..., 0], 1.0) * uv_rect[..., 0]
    v = uv_rect[..., 3] + (1.0 - torch.remainder(uv[..., 1], 1.0)) \
        * uv_rect[..., 1]
    u0 = torch.floor(u).clamp(0.0, s - 1.0)
    v0 = torch.floor(v).clamp(0.0, s - 1.0)
    flat = (lay * float(s * s) + v0 * float(s) + u0).to(torch.int64)
    r = atlas.bilin_rows[flat]
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    return (r[..., 0:3] * (1 - fu) * (1 - fv) + r[..., 3:6] * fu * (1 - fv)
            + r[..., 6:9] * (1 - fu) * fv + r[..., 9:12] * fu * fv)


def load_image(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P6":
        return _load_ppm(data)
    raise ValueError(f"unsupported image format: {path}")


def _load_ppm(data: bytes) -> np.ndarray:
    parts = []
    idx = 2
    while len(parts) < 3:
        while idx < len(data) and data[idx:idx + 1].isspace():
            idx += 1
        if data[idx:idx + 1] == b"#":
            while data[idx:idx + 1] != b"\n":
                idx += 1
            continue
        start = idx
        while not data[idx:idx + 1].isspace():
            idx += 1
        parts.append(int(data[start:idx]))
    idx += 1
    w, h, _maxv = parts
    return np.frombuffer(data, np.uint8, w * h * 3, idx).reshape(h, w, 3)
