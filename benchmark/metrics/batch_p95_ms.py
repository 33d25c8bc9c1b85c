"""The 95th percentile, over every batch of the window, of the time from
its dispatch to its results on the host, in ms (host clock; numpy's
linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    lat = ctx["timed"]["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
