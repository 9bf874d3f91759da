"""tail_p99_ms: the 99th percentile of every request's time in the traced
window, by the client's clock around the call (linear interpolation). The
same statistic as `e2e/search_p99_ms.py`, read under the profiler: the
end-to-end p99 spread between processes by more than a bound can hold in
the host-bound cells, so it stands here, beside the rate it moves."""

import numpy as np


def read(ctx):
    lat = ctx.window.lat
    return float(np.percentile(lat, 99) * 1e3) if lat else None
