"""The 90th percentile over every request of the traced window of its
decision time: from the start of its batch's ``cascade.serve_batch`` span to
that batch's decision instant, the end of its ``cascade.decide`` span (the
offload mask is on the host), read from the spans the program records on
its tracer (``LMCascade.obs``) while the profiler runs.  Nothing when the
program records no such spans, or when the window's ``cascade.serve_batch``
spans are not one a batch."""
import numpy as np


def read(ctx):
    obs = getattr(getattr(ctx.driver, "cascade", None), "obs", None)
    if obs is None or obs.tracer is None:
        return None
    roots = obs.tracer.spans("cascade.serve_batch")
    if not roots or len(roots) != len(ctx.records):
        return None
    decided = {e["args"]["parent"]: e["ts"] + e["dur"]
               for e in obs.tracer.spans("cascade.decide") if "parent" in e["args"]}
    lat = []
    for root in roots:
        end = decided.get(root["args"]["id"])
        if end is None:
            return None
        lat += [(end - root["ts"]) / 1e3] * int(root["args"]["rows"])
    return float(np.percentile(lat, 90))
