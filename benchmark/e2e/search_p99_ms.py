"""search_p99_ms: the 99th percentile of every request's time in the
window, by the client's clock around the call (linear interpolation)."""

import numpy as np


def read(ctx):
    lat = ctx.window.lat
    return float(np.percentile(lat, 99) * 1e3) if lat else None
