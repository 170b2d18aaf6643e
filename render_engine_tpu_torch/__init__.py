"""render_engine_tpu_torch — the engine's PyTorch + CUDA port.

The same simulation and deferred renderer as ``render_engine_tpu``, written
for one NVIDIA Hopper GPU: plain tensor code is PyTorch, and each of the
three hand-written TPU kernels (tile raster, attribute resolve, fused shade)
is a hand-written CUDA C++ kernel under ``csrc/``, built on first use and
bound through ``ctypes`` (see ``kernels.py``).

Every kernel wrapper takes a plain PyTorch version of its kernel for tensors
that live on the CPU, and launches the CUDA kernel (or raises) for tensors on
the GPU. The package imports ``torch`` and numpy only.
"""

__version__ = "0.1.0"
