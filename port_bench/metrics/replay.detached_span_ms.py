"""Device ms of the ``render`` span of the detached camera's render, the
median over the span phase's calls (``spans.py``): the ``engine.render``
calls made within a ``player.step`` call (``runtime/replay.py``). None
where the span phase holds no such call (a program without a ``Player``,
or an engine whose calls do not name the call they were made within)."""

import statistics


def read(rec):
    calls = (rec.get("spans") or {}).get("frames", [])
    players = {f["index"] for f in calls if f["call"] == "player.step"}
    ms = [x["ms"] for f in calls
          if f["call"] == "engine.render" and f.get("within") in players
          for x in f.get("spans", []) if x["name"] == "render"]
    return statistics.median(ms) if ms else None
