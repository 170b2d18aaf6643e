"""Device rows (kernels, copies, memsets) a frame in the profiled
frames."""


def read(rec):
    p = rec.get("profile")
    return p["rows"] / p["frames"] if p and p["rows"] else None
