"""Device ms of one captured step: CUDA events around consecutive
``Engine.step`` calls, over their number."""


def read(rec):
    return rec.get("step_ms")
