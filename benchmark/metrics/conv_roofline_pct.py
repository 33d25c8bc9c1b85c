"""The conv layers' share of their roofline: the least time of every conv
unit of the traced batches (``roofline.conv_bound_s``: counted from the
layer shapes, whatever kernel runs them) over the device time of the
engine's stage scopes that run convs and pools (every stage kind but
those below)."""

from benchmark import roofline, trace

NOT_CONV = {"route", "shortcut", "gap", "dense", "upsample"}


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    us = 0.0
    for ev in tr["events"]:
        scope, kind = trace.scope_of(ev)
        if kind is not None and kind not in NOT_CONV:
            us += ev.us
    if us <= 0:
        return None
    peak_ops, bw = roofline.peaks(ctx["device_name"])
    bound = roofline.conv_bound_s(ctx["cfg"], ctx["batch"], peak_ops, bw)
    return 100.0 * bound * tr["batches"] / (us / 1e6)
