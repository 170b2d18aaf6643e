"""The least time an NVIDIA H100 could take for a kernel's work.

The benchmark's yardstick for the ``*_roofline`` metrics, which later
changes to the port cannot move: the card's peaks here, and each kernel's
bytes and operations in its kernel-row file (``kernels/<kind>.py``, a
frozen copy of render_engine_tpu_torch/kernel_bounds.py's arithmetic).

For a kernel call on given inputs, the bound is the larger of two times:
the bytes the work must move (each input byte it needs read once, each
output byte written once) over the card's memory rate, and the float
operations these inputs need over the card's float32 rate outside the
tensor cores. The rates are NVIDIA's data-sheet peaks for the H100 SXM at
its 700 W limit (3.35 TB/s, 67 TFLOP/s); a card set below 700 W reaches
less. Work that depends on the data is counted for these inputs.

``bound`` turns bytes and operations into ``(bound_ms, "bytes" |
"operations")``.
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM at 700 W: HBM3 bytes a second and float32
# operations a second outside the tensor cores
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
