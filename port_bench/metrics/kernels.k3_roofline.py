"""K3's share of its roofline, in %: its bound (``kernels/k3.py``, per
launch on recorded arguments) over its device time in the profiled
frames. Nothing where the profiled frames ran no K3."""


def read(rec):
    return rec.get("profile", {}).get("roofline_by_kind", {}).get("k3")
