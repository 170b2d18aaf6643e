"""The port's asset loading held to the JAX package's, on the host:

* PNG textures: ``render/textures.load_image`` of PNGs this file writes
  (each row filter 0 to 4, in either colour type ``_load_png`` takes: 8-bit
  RGB and RGBA, several IDAT chunks, an ancillary chunk) equal to the JAX
  package's ``load_image`` and to the pixels written; the other colour
  types and bit depths raise in both. An MTL with ``map_Kd x.png`` through
  ``ModelBankBuilder.add_obj`` gives the JAX package's atlas and materials.
* The native OBJ parse core (``native/obj_loader.cpp``): built and loaded
  here (g++ is on every machine that builds the port's kernels, so a
  failing build fails these tests instead of falling back unseen);
  ``_load_obj_native`` equal to the port's Python parse and to the JAX
  package's ``_load_obj_native`` on ``tests/test_models.py``'s GNARLY
  file; a file the core rejects goes to the Python parse;
  ``RE_TPU_NATIVE=0`` forces the Python parse.

Every comparison is exact: both packages decode and parse on the host in
numpy.
"""

import struct
import zlib

import numpy as np
import pytest

from render_engine_tpu.models import obj_loader as OLJ
from render_engine_tpu.models.bank import ModelBankBuilder as MBJ
from render_engine_tpu.native import build as NBJ
from render_engine_tpu.render import textures as TXJ
from render_engine_tpu_torch.models import obj_loader as OLT
from render_engine_tpu_torch.models.bank import ModelBankBuilder as MBT
from render_engine_tpu_torch.native import build as NB
from render_engine_tpu_torch.render import textures as TXT

import test_models

GNARLY = test_models.TestNativeObjParser.GNARLY
MTL = test_models.TestNativeObjParser.MTL


def obj_native_jax():
    """The JAX package's parser library. Its build writes one temporary
    file for every process, so a test process building it while another
    does may find None once: try again."""
    lib = NBJ.obj_native()
    if lib is None:
        NBJ._CACHE.pop("obj_loader", None)
        lib = NBJ.obj_native()
    return lib


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(img, ft):
    """``img`` (H, W, C) uint8 as PNG scanlines, every row with filter
    ``ft``."""
    h, w, ch = img.shape
    rows = img.reshape(h, w * ch).astype(np.int32)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(ch, np.int32), x[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1,
                4: _paeth(left, up, ul)}[ft]
        out.append(bytes([ft]) + ((x - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
    return b"".join(out)


def _png(img, ft, color_type=None, bit_depth=8):
    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    ch = img.shape[-1]
    color_type = color_type if color_type is not None else \
        {3: 2, 4: 6}[ch]
    z = zlib.compress(_filtered(img, ft))
    half = len(z) // 2  # two IDAT chunks
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", img.shape[1],
                                         img.shape[0], bit_depth,
                                         color_type, 0, 0, 0))
            + chunk(b"tEXt", b"Comment\x00made by the test")
            + chunk(b"IDAT", z[:half]) + chunk(b"IDAT", z[half:])
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("ft", range(5))
def test_png_filters_match_reference(tmp_path, ft, channels):
    rng = np.random.default_rng(10 * ft + channels)
    img = rng.integers(0, 256, (7, 9, channels), dtype=np.uint8)
    img[2] = 255  # rows that wrap every filter's sums
    img[3, :, 0] = 0
    path = tmp_path / "x.png"
    path.write_bytes(_png(img, ft))
    got = TXT.load_image(str(path))
    assert got.dtype == np.uint8 and got.shape == (7, 9, 3)
    np.testing.assert_array_equal(got, img[..., :3])
    np.testing.assert_array_equal(got, TXJ.load_image(str(path)))


@pytest.mark.parametrize("color_type,bit_depth", [(0, 8), (4, 8), (2, 16),
                                                  (3, 8)])
def test_png_unsupported_kinds_raise_in_both(tmp_path, color_type,
                                             bit_depth):
    path = tmp_path / "x.png"
    path.write_bytes(_png(np.zeros((2, 2, 3), np.uint8), 0, color_type,
                          bit_depth))
    for load in (TXT.load_image, TXJ.load_image):
        with pytest.raises(ValueError, match="8-bit RGB/RGBA"):
            load(str(path))


def test_mtl_png_texture_through_add_obj(tmp_path):
    """``map_Kd`` and ``map_Ks`` PNGs (filters 4 and 1) on the GNARLY
    file's materials: the port's atlas and material tables equal the JAX
    package's, and no error texture stands in."""
    rng = np.random.default_rng(5)
    tex = rng.integers(0, 256, (16, 12, 3), dtype=np.uint8)
    spec = rng.integers(0, 256, (8, 8, 4), dtype=np.uint8)
    (tmp_path / "tex.png").write_bytes(_png(tex, 4))
    (tmp_path / "spec.png").write_bytes(_png(spec, 1))
    (tmp_path / "m.mtl").write_text(MTL)
    obj = tmp_path / "g.obj"
    obj.write_text(GNARLY)
    out = {}
    for name, mb, tx in (("t", MBT, TXT), ("j", MBJ, TXJ)):
        ab = tx.TextureAtlasBuilder(layer_size=32)
        bb = mb()
        bb.add_obj("g", str(obj), atlas_builder=ab)
        out[name] = (bb.finalize(), ab.finalize(), ab)
    (bt, at, abt), (bj, aj, abj) = out["t"], out["j"]
    assert not abt._error_layers and not abj._error_layers
    for f in ("layers", "tex_layer", "uv_rect", "bilin_rows"):
        np.testing.assert_array_equal(getattr(at, f).numpy(),
                                      np.asarray(getattr(aj, f)), err_msg=f)
    for f in ("mat_albedo", "mat_textures", "mat_specular", "tri_material",
              "vertices", "uvs"):
        np.testing.assert_array_equal(getattr(bt, f).cpu().numpy(),
                                      np.asarray(getattr(bj, f)), err_msg=f)
    # one diffuse and one specular map, neither the error texture
    assert (bt.mat_textures.cpu().numpy() >= 0).sum() == 2


def _gnarly(tmp_path):
    (tmp_path / "m.mtl").write_text(MTL)
    p = tmp_path / "g.obj"
    p.write_text(GNARLY)
    return str(p)


def _python_parse(monkeypatch, load, path):
    with monkeypatch.context() as m:
        m.setenv("RE_TPU_NATIVE", "0")
        return load(path)


def assert_same_obj(a, b):
    for x, y, what in zip(a[:5], b[:5], ("v", "n", "uv", "tris",
                                         "tri_mat")):
        assert x.dtype == y.dtype, what
        np.testing.assert_array_equal(x, y, err_msg=what)
    assert len(a[5]) == len(b[5])
    for ma, mb in zip(a[5], b[5]):
        assert ma.keys() == mb.keys()
        for k in ma:
            np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def test_native_parser_loads():
    lib = NB.obj_native()
    assert lib is not None, "the native OBJ parser did not build or load"
    assert lib is NB.obj_native()


def test_native_matches_python_and_reference(tmp_path, monkeypatch):
    path = _gnarly(tmp_path)
    native = OLT._load_obj_native(path)
    assert native is not None, "the native core rejected a valid file"
    py = _python_parse(monkeypatch, OLT.load_obj, path)
    got = OLT.load_obj(path)
    assert_same_obj(got, py)
    # before the normal fill, against the JAX package's native parse
    assert obj_native_jax() is not None
    assert_same_obj(native, OLJ._load_obj_native(path))
    assert_same_obj(got, _python_parse(monkeypatch, OLJ.load_obj, path))
    assert [m["map_kd"] for m in got[5]] == [None, "tex.png", None]


def test_native_rejects_malformed_and_falls_back(tmp_path, monkeypatch):
    bad = tmp_path / "bad.obj"
    bad.write_text("v 0 0 0\nf 1 2 9\n")  # an index out of range
    assert OLT._load_obj_native(str(bad)) is None
    assert obj_native_jax() is not None
    assert OLJ._load_obj_native(str(bad)) is None
    # a four-part corner token: the core refuses it, the Python parse
    # reads its first three parts
    odd = tmp_path / "odd.obj"
    odd.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.5 0.5\nvn 0 0 1\n"
                   "f 1/1/1/7 2//1 3\n")
    assert OLT._load_obj_native(str(odd)) is None
    got = OLT.load_obj(str(odd))
    assert_same_obj(got, _python_parse(monkeypatch, OLT.load_obj, str(odd)))
    assert_same_obj(got, OLJ.load_obj(str(odd)))
    np.testing.assert_array_equal(got[2][0], [0.5, 0.5])


def test_env_forces_python_parse(tmp_path, monkeypatch):
    path = _gnarly(tmp_path)
    native = OLT.load_obj(path)
    monkeypatch.setenv("RE_TPU_NATIVE", "0")
    assert NB.obj_native() is None
    assert OLT._load_obj_native(path) is None
    py = OLT.load_obj(path)
    assert_same_obj(py, native)
    assert_same_obj(py, OLJ.load_obj(path))
