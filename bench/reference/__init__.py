"""The plain references: one module a model family (``reference.<family>``,
named by a configuration file's ``reference`` key), each a float32 PyTorch
forward from the published description with ``embed``, ``layers``,
``final`` and ``unembed``; ``reference.common`` holds the scoring head, the
decision stack and the matrix products (exact float32, or the fp8 control).
Nothing here imports ``jax``, ``repro`` or ``repro_torch``, and nothing here
reads what the program made: the weights and inputs are the benchmark's."""
