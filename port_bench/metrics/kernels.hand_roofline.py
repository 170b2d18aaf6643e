"""The hand kernels' share of their roofline, in %: the summed bound
(``bounds.py``, per launch on recorded arguments) over the summed device
time of K1 (two-pass and one-pass), K2 and K3 in the profiled frames.
Nothing where the profiled frames ran none of them or a kind has no
bound."""


def read(rec):
    return rec.get("profile", {}).get("roofline_pct")
