"""Seconds the programs captured in set-up took to warm up and capture:
the sum of ``Engine.capture_seconds()``."""


def read(rec):
    c = rec.get("capture_seconds")
    return float(sum(c.values())) if c else None
