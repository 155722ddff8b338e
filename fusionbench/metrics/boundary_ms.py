"""boundary_ms (ms, program span): the device-synchronised time of a
submap boundary (``_dispatch_submap``: local solve, keyframe, global match
and solve, retirement), the engine's ``dev_submap`` in its serialized
replay after the window, mean per boundary."""


def read(rec):
    rep = rec["replay"] or {}
    return rep.get("device_ms", {}).get("dev_submap")
