"""Images whose results reached the host inside the window, over the
window's seconds (host clock)."""


def read(ctx):
    t = ctx["timed"]
    return t["images"] / t["seconds"] if t["seconds"] > 0 else None
