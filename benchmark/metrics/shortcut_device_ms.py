"""Device ms a batch under the engine's shortcut stage scopes
(``stage*_shortcut_L*``): the residual adds and their requantization."""

from benchmark import trace


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    us = sum(ev.us for ev in tr["events"]
             if trace.scope_of(ev)[1] == "shortcut")
    return us / 1e3 / tr["batches"] if us > 0 else None
