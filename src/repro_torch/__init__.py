"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout, imports neither ``jax`` nor ``repro``, and replaces each
Pallas kernel on its path with a hand-written CUDA kernel
(``repro_torch.kernels``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where every kernel takes its plain PyTorch version.
"""
