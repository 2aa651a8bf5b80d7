"""Qwen3-14B [hf:Qwen/Qwen3-8B family] — dense decoder, GQA + qk_norm.

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.  Per-head RMS
q/k normalisation (qk_norm), no QKV bias (qwen3 dropped it).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen3-14b",
    arch_type="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    attn_seq_shard=True,  # 40 heads % 16 != 0 (§Perf #2)
    rope_theta=1e6,
)
