"""Build at first use, and load through ctypes, the native host code.

Port of ``render_engine_tpu/native/build.py``. Each ``<name>.cpp`` of this
directory compiles with ``g++ -O3 -std=c++17 -shared -fPIC`` into
``render_engine_tpu_torch/_build/_<name>.so`` (rebuilt when the source is
newer) and is loaded with ``ctypes``. Nothing is built when the module is
imported. ``RE_TPU_NATIVE=0`` makes ``load`` return None, and callers take
their Python version; so does a failed build, with a warning that carries
the compiler's error (the tests and ``chip_smoke.py`` require the library
to load, so a failing build does not pass unseen).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(SRC_DIR), "_build")

_lock = threading.Lock()
_loaded: dict = {}


def _build(src: str, so: str):
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a file of this process's own, renamed into place: processes that
    # build at once never load a half-written library
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                           "-o", tmp, src], capture_output=True, text=True,
                          timeout=300, check=False)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-2000:])
    os.replace(tmp, so)


def load(name: str):
    """``native/<name>.cpp`` built (if stale) and loaded; None under
    ``RE_TPU_NATIVE=0`` or when the build or the load fails."""
    if os.environ.get("RE_TPU_NATIVE", "1") == "0":
        return None
    with _lock:
        if name not in _loaded:
            src = os.path.join(SRC_DIR, f"{name}.cpp")
            so = os.path.join(BUILD_DIR, f"_{name}.so")
            try:
                if (not os.path.exists(so)
                        or os.path.getmtime(so) < os.path.getmtime(src)):
                    _build(src, so)
                _loaded[name] = ctypes.CDLL(so)
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                warnings.warn(f"native {name}: the Python version runs "
                              f"instead; {e}")
                _loaded[name] = None
        return _loaded[name]


def obj_native():
    """The OBJ parser library with its C signatures declared, or None."""
    lib = load("obj_loader")
    if lib is None or getattr(lib, "_typed", False):
        return lib
    c = ctypes
    lib.obj_parse.restype = c.c_void_p
    lib.obj_parse.argtypes = [c.c_char_p]
    lib.obj_counts.restype = None
    lib.obj_counts.argtypes = [c.c_void_p, *[c.POINTER(c.c_int64)] * 2,
                               *[c.POINTER(c.c_int32)] * 2,
                               *[c.POINTER(c.c_int64)] * 2]
    lib.obj_copy.restype = None
    lib.obj_copy.argtypes = [c.c_void_p, *[c.POINTER(c.c_float)] * 3,
                             *[c.POINTER(c.c_int32)] * 2, c.c_char_p,
                             c.POINTER(c.c_int32), c.c_char_p]
    lib.obj_free.restype = None
    lib.obj_free.argtypes = [c.c_void_p]
    lib._typed = True
    return lib
