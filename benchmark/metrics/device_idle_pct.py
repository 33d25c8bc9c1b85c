"""The share of the traced window in which no kernel, copy or set ran on
the card, from the union of the device events' spans."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["events"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
