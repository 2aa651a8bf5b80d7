"""Mean milliseconds a batch of the ``engine.features`` span (the weak
logits' feature pass inside ``cascade.decide``) over the traced window: its
device interval (two CUDA events around the span, on the card), or its host
interval where there is none (the CPU), read from the spans the program
records on its tracer (``LMCascade.obs``) while the profiler runs.  Nothing
when the program records no such spans, or when the window's
``cascade.serve_batch`` spans are not one a batch."""


def read(ctx):
    obs = getattr(getattr(ctx.driver, "cascade", None), "obs", None)
    if obs is None or obs.tracer is None:
        return None
    n = len(obs.tracer.spans("cascade.serve_batch"))
    feats = obs.tracer.spans("engine.features")
    if not n or n != len(ctx.records) or not feats:
        return None
    ms = [e["args"].get("device_ms", e["dur"] / 1e3) for e in feats]
    return sum(ms) / n
