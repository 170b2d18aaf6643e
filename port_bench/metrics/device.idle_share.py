"""1 minus the union of the profiled frames' device rows (kernels, copies,
memsets) over their span by CUDA events."""


def read(rec):
    p = rec.get("profile")
    if not p or p["span_ms"] <= 0 or not p["rows"]:
        return None
    return 1.0 - p["busy_us"] / 1e3 / p["span_ms"]
