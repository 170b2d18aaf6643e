"""The default route's shading kernel's share of its roofline, in %: its
bound (``kernels/deferred_shade.py``, per launch on recorded arguments)
over its device time in the profiled frames. Nothing where the profiled
frames ran no such kernel."""


def read(rec):
    return rec.get("profile", {}).get("roofline_by_kind", {}).get(
        "deferred_shade")
