"""Device ms of one render of the cell's route with the shadow maps left
alone: CUDA events around consecutive ``Engine.render()`` calls, over their
number."""


def read(rec):
    return rec.get("render_ms")
