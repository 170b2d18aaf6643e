"""Build, load and count the port's CUDA kernels.

The kernels are CUDA C++ sources under ``csrc/`` with a plain C interface.
``library()`` compiles them on first use into
``_build/librender_kernels.so`` (sm_90a, ``-fmad=false`` so that the edge
functions and shading sums round exactly like the plain PyTorch versions:
one ``nvcc -c`` per source, all started together, then one link) and loads
it through ``ctypes``. Nothing is built or loaded at import time: the CPU
tests import every module on machines without ``nvcc``.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds one
where it launches its kernel and nowhere else. ``tile_raster``, ``resolve``
and ``fused_shade`` count every launch of K1, K2 and K3, ``deferred_shade``
every launch of the default route's shading kernel, ``tall_gbuffer``
every launch of the default route's G-buffer kernel, ``custom_gbuffer``
every launch of the custom-shading hook's G-buffer kernel; two more keys
also count the launches of one branch: ``tile_raster_one_pass`` (K1's
shadow-map mode) and ``fused_shade_tile_lists`` (K3 looping over per-tile
light lists). A wrapper runs when a program is captured, not when its
CUDA graph replays: the Engine records the counts of each capture and
adds them on every replay (``runtime/engine.py``), so the counts a frame
are the same either way.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
LIB_PATH = os.path.join(BUILD_DIR, "librender_kernels.so")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

LAUNCHES = {"tile_raster": 0, "tile_raster_one_pass": 0, "resolve": 0,
            "fused_shade": 0, "fused_shade_tile_lists": 0,
            "deferred_shade": 0, "tall_gbuffer": 0, "custom_gbuffer": 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream as void*, every int as int
_SIGNATURES = {
    "launch_tile_raster": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                           _I, _I, _I, _I, _I, _I, _I, _I, _VP],
    "launch_resolve": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "launch_fused_shade": [*[_VP] * 16, *[_I] * 10, _F, _F, *[_I] * 4,
                           _F, _F, _VP],
    "fused_shade_blocks_per_sm": [_I],
    # a pointer to render/deferred_shade.py's DeferredArgs, and the stream
    "launch_deferred_shade": [_VP, _VP],
    # a pointer to render/tall_gbuffer.py's TallArgs, and the stream
    "launch_tall_gbuffer": [_VP, _VP],
    # a pointer to render/custom_gbuffer.py's CustomArgs, and the stream
    "launch_custom_gbuffer": [_VP, _VP],
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin",
                                                     "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False, csrc: str = CSRC,
          lib_path: str = LIB_PATH) -> str:
    """Compile every ``*.cu`` of ``csrc`` (one ``nvcc -c`` each, in
    parallel) and link them into the shared library ``lib_path``; returns
    its path. ``verbose`` adds ``-Xptxas -v`` (registers, spills) and
    prints the compiler's output."""
    build_dir = os.path.dirname(lib_path)
    os.makedirs(build_dir, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    tag = f".{os.getpid()}"
    objs = [os.path.join(build_dir, os.path.basename(src)[:-3] + tag + ".o")
            for src in sources]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-I",
         csrc, "-c", "-o", obj, src], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    try:
        failed = [log for p, log in zip(procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = lib_path + tag + ".tmp"
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True,
                              check=False)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if verbose:
        print("".join(logs))
    os.replace(tmp, lib_path)
    return lib_path


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(f) > built
               for f in glob.glob(os.path.join(CSRC, "*.cu*")))


def load(lib_path: str = LIB_PATH) -> ctypes.CDLL:
    """Load a built kernel library and declare its C signatures."""
    lib = ctypes.CDLL(lib_path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library():
    """The loaded kernel library, built on first use (and rebuilt when a
    source is newer than the library)."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            _lib = load()
    return _lib


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
          device: torch.device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (the kernels take nothing else)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launch(name: str, count_key: str, *args):
    """Call a C launcher; raise on a nonzero ``cudaGetLastError`` code."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    LAUNCHES[count_key] += 1
