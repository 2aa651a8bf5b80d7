"""Hand-written Hopper kernels (``csrc/``), each with a ``ops.py`` wrapper
and a plain PyTorch ``ref.py`` beside it; ``dispatch`` picks between them by
the device the data lies on, ``_build`` compiles and loads the sources."""
