"""Mean milliseconds a batch of the ``strong_forward_ms`` stage of
``LMCascade.serve_batch`` (the program's synchronised stage timing,
``stage_ms``), over the traced window's batches."""


def read(ctx):
    if not ctx.stage_ms or "strong_forward_ms" not in ctx.stage_ms:
        return None
    return ctx.stage_ms["strong_forward_ms"] / len(ctx.records)
