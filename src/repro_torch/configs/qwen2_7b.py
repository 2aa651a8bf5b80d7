"""Qwen2-7B [arXiv:2407.10671] — dense decoder, GQA, QKV bias.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2-7b",
    arch_type="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    qkv_bias=True,
    attn_seq_shard=True,  # 28 heads % 16 != 0 -> context-parallel attention (§Perf #2)
    rope_theta=1e6,
)
