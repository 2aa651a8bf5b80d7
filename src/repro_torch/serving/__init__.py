"""The LM early-exit cascade serve path: ``cascade_serving`` (``LMCascade``)
and ``decode_loop`` (``generate``)."""
