"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + shared attention.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Every 6th layer applies the single SHARED transformer block (attention +
SwiGLU, one parameter set reused at 9 depths, each with its own KV cache);
the remaining 45 layers are Mamba2 (SSD) blocks.  long_500k decodes from
O(1) SSM state; the shared attention block uses its ring-window cache.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    mamba_head_dim=64,
    shared_attn_period=6,
)
