"""Device ms of one shadow-map update: CUDA events around consecutive
``Engine.update_shadows()`` calls, over the updates the host schedule made
among them."""


def read(rec):
    return rec.get("shadow_update_ms")
