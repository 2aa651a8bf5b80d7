"""Qwen2-VL-2B language backbone [arXiv:2409.12191].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  M-RoPE with
(temporal, height, width) frequency sections (16, 24, 24) over head_dim/2.
The ViT encoder + projector is STUBBED: ``input_specs`` supplies projected
patch embeddings as a vision prefix (dynamic-resolution handled upstream).
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="qwen2-vl-2b",
    arch_type="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,  # qwen2 family QKV bias
    attn_seq_shard=True,  # 12 heads % 16 != 0 (§Perf #2)
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    vision_tokens=256,  # stubbed vision-prefix length
    tie_embeddings=True,  # qwen2-vl-2b ties embeddings
)
