"""The hand kernels' share of their roofline, in %: the summed bound
(``kernels/k1.py``, ``k1_one_pass.py``, ``k2.py`` and ``k3.py``, per launch
on recorded arguments) over the summed device time of K1 (two-pass and
one-pass), K2 and K3 in the profiled frames. Other kernel rows are not in
it. Nothing where the profiled frames ran none of them."""


def read(rec):
    return rec.get("profile", {}).get("roofline_pct")
