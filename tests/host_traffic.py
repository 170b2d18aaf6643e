"""A context in which every read of a tensor's value on the host and every
upload raises: the CPU's stand-in for a CUDA graph's capture, which fails
on both. Used by the programs' tests in this process and by spawned CPU
ranks (it imports torch and the port only)."""

import contextlib

import numpy as np
import torch

from render_engine_tpu_torch.render import raster_pallas as RP


@contextlib.contextmanager
def no_host_traffic():
    """Every read of a tensor's value on the host and every upload
    raises (an index by a 0-dim tensor, a boolean mask, a list or an array
    too, which PyTorch reads or uploads), except inside K1's plain
    version."""
    def refuse(name):
        def call(*a, **kw):
            raise AssertionError(f"host traffic: {name}")
        return call

    saved = [(obj, n, getattr(obj, n)) for obj, names in (
        (torch.Tensor, ("item", "tolist", "numpy", "__bool__", "__int__",
                        "__float__", "__index__")),
        (torch, ("tensor", "as_tensor", "from_numpy"))) for n in names]

    getitem, setitem = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def host_index(index):
        # a 0-dim tensor index is read on the host as a Python number; a
        # boolean mask is counted on the host (its nonzero entries); a
        # list or an array is uploaded
        parts = index if isinstance(index, tuple) else (index,)
        return any(isinstance(i, (list, np.ndarray)) or (
            isinstance(i, torch.Tensor)
            and (i.dim() == 0 or i.dtype == torch.bool)) for i in parts)

    def checked_get(t, index):
        if host_index(index):
            raise AssertionError("host traffic: an index read or uploaded")
        return getitem(t, index)

    def checked_set(t, index, value):
        if host_index(index):
            raise AssertionError("host traffic: an index read or uploaded")
        return setitem(t, index, value)

    def patch():
        for obj, n, _ in saved:
            setattr(obj, n, refuse(n))
        torch.Tensor.__getitem__ = checked_get
        torch.Tensor.__setitem__ = checked_set

    def lift():
        for obj, n, fn in saved:
            setattr(obj, n, fn)
        torch.Tensor.__getitem__ = getitem
        torch.Tensor.__setitem__ = setitem

    plain = RP.tile_raster_reference

    def k1_plain(*a, **kw):
        lift()
        try:
            return plain(*a, **kw)
        finally:
            patch()

    RP.tile_raster_reference = k1_plain
    patch()
    try:
        yield
    finally:
        lift()
        RP.tile_raster_reference = plain
