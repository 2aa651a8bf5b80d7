"""Yi-6B [arXiv:2403.04652] — llama-architecture dense decoder with GQA.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="yi-6b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5e6,
)
