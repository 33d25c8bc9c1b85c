"""The whole step's share of the card's int8 peak while the card works:
the model's useful operations (``roofline.ops_per_image``, 2 a
multiply-accumulate) of the traced window's images, over the seconds in
which an operation ran on the card in that window (the union of its
device events), over the data sheet's dense int8 peak. The wall's idle
time is ``device_idle_pct``'s; this reads how much of the peak the step's
device work reaches, whichever kernels run it."""

from benchmark import roofline


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    peak_ops, _ = roofline.peaks(ctx["device_name"])
    ops = roofline.ops_per_image(ctx["cfg"]) * ctx["batch"] * tr["batches"]
    return 100.0 * ops / tr["busy_s"] / peak_ops
