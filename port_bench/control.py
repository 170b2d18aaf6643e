"""The readings that set the limits of ``check.py``: for each seed, one run
of the cell with the program's readings and the control's (the reference
with TF32 matrix products, ``reference/precision.py``, in the program's
place), one JSON line a seed. Never run by the benchmark's own runs. The
window has to reach the run from the start's last frame
(``check.FOLLOW``) for the control to be read over all of it.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 12
"""

import time

T_PROC = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import argparse
    import json

    from port_bench import bench

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args()
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        res, _ = bench.run(args.workload, seed, args.seconds, False, t0,
                           control=True)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "program": {k: v["value"] for k, v in
                                      res["checks"].items()},
                          "control": res.get("control"),
                          "control_where": res.get("control_where"),
                          "program_where": res.get("checked_where"),
                          "metrics": {k: v["value"] for k, v in
                                      res["metrics"].items()},
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    main()
