"""Device ms a batch under the decode and NMS scopes (``post_decode``,
``nms_candidates``, ``nms_suppress``, ``nms_merge``)."""

from benchmark import trace


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    us = sum(ev.us for ev in tr["events"]
             if (trace.scope_of(ev)[0] or "").startswith(("post_", "nms_")))
    return us / 1e3 / tr["batches"] if us > 0 else None
