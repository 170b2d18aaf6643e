"""Host ms a frame of the ``Player`` itself: each ``player.step`` call's
host time less that of the engine's calls made within it (its controls,
the recorded frame decoded, the detached camera's flight and its own
bookkeeping), the median over the span phase's ``player.step`` calls
(``spans.py``). None where the span phase holds no such call."""

import statistics


def read(rec):
    calls = (rec.get("spans") or {}).get("frames", [])
    players = {f["index"]: f["host"][0]["ms"] for f in calls
               if f["call"] == "player.step"}
    inner = dict.fromkeys(players, 0.0)
    for f in calls:
        if f.get("within") in inner:
            inner[f["within"]] += f["host"][0]["ms"]
    ms = [players[k] - inner[k] for k in players]
    return statistics.median(ms) if ms else None
