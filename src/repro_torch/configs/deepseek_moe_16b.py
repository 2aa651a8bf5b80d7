"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained MoE.

28L d_model=2048 16H (kv=16, full MHA) vocab=102400.  64 routed experts
(top-6) + 2 shared experts, expert d_ff=1408; first layer dense (d_ff
10944 as in the release).  Expert-parallel sharding over the `model` axis.
"""
from repro_torch.models.lm import LMConfig

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
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
    vocab_size=102400,
    rope_theta=1e4,
)
