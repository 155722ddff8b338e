"""fps (frames/s, host clock): frames whose pose, fusion and render the
device completed inside the closed-loop window, over the window's seconds."""


def read(rec):
    return rec["window"].get("fps")
