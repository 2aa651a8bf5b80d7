"""RWKV6 "Finch" 1.6B [arXiv:2404.05892].

24L d_model=2048, attention-free, d_ff=7168, vocab=65536.  Data-dependent
decay (per-channel w_t from a LoRA of the shifted input) and token-shift
mixing; head_size 64 (32 heads).  Decodes from O(1) recurrent state, so
long_500k runs natively (no window needed).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="rwkv6-1.6b",
    arch_type="rwkv",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # d_model / head_size
    num_kv_heads=32,
    head_dim=64,
    rwkv_head_size=64,
    d_ff=7168,
    vocab_size=65536,
)
