"""DeepSeek-V2-Lite (16B) [arXiv:2405.04434] — MLA + fine-grained MoE.

27L d_model=2048 16H vocab=102400.  MLA: kv_lora_rank=512, qk_nope=128,
qk_rope=64 (decode caches only the 512-d latent + 64-d rope key — the
paper-headline KV saving, implemented in the absorbed form).  MoE: 64
routed experts top-6 + 2 shared, expert d_ff=1408, first layer dense.

NOTE: the assignment bracket says "160 routed" while its headline says
"MoE 64e top-6"; the release has 64 routed — we follow the headline/release
(64) and record the discrepancy here.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,  # dense first layer
    d_ff_expert=1408,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    first_k_dense=1,
    moe_groups=16,  # group-local dispatch (see EXPERIMENTS.md §Perf #1)
    use_mla=True,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    vocab_size=102400,
    rope_theta=1e4,
)
