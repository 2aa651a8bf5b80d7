"""The 90th percentile over every request of the window of its latency:
from the start of its batch's ``serve_batch`` call to the call's return
with the results on the host (linear interpolation between order
statistics)."""
import numpy as np


def read(ctx):
    lat = [(r["t1"] - r["t0"]) * 1e3 for r in ctx.records for _ in range(r["rows"])]
    return float(np.percentile(lat, 90))
