"""The program's states as the check reads them.

``state_of`` reads an engine's state through its public views (the
world's columns, the camera vector, the shadow tables and the schedule's
host integers); the program's records are made with it, where the
program's reference file (``reference/programs/<name>.py``) gives no
``state_of`` of its own. Nothing here imports the port."""

from __future__ import annotations


def state_of(eng) -> dict:
    """Copies of an engine's world columns, camera vector and shadow
    tables (``{"world": {...}, "camv": t, "shadow": {...} | None}``), read
    through ``Engine.world``, ``.camera`` and ``.shadow_state``."""
    w = eng.world
    world = {"alive": w.alive.clone(), "comp_mask": w.comp_mask.clone()}
    world.update({f"comps.{k}": v.clone() for k, v in w.comps.items()})
    sh = eng.shadow_state
    shadow = None if sh is None else {
        "maps": sh.maps.clone(), "light_mats": sh.light_mats.clone(),
        "slot_entity": sh.slot_entity.clone(),
        "slot_face": sh.slot_face.clone(),
        "cursor": int(sh.cursor), "tick": int(sh.tick)}
    return {"world": world, "camv": eng.camera.serialize().clone(),
            "shadow": shadow}
