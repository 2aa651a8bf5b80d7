"""Architecture registry: one module per assigned architecture (the JAX
package's ten config files, re-pointed at the port's ``LMConfig``).

``get_config(name)`` returns the full-scale LMConfig; ``--arch <id>`` in the
launchers resolves through here.  ``long_context_variant`` swaps in the
sliding-window attention config used for the long_500k shape (dense/MoE/VLM
archs, whose decode then keeps a ring cache; SSM/hybrid run their native
recurrent state).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.lm import LMConfig

ARCH_IDS: List[str] = [
    "qwen2_vl_2b",
    "rwkv6_1b6",
    "yi_6b",
    "qwen1_5_32b",
    "qwen2_7b",
    "deepseek_moe_16b",
    "whisper_base",
    "qwen3_14b",
    "deepseek_v2_lite_16b",
    "zamba2_2b7",
]

# public ids as given in the assignment (dashes) -> module names
ALIASES: Dict[str, str] = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "yi-6b": "yi_6b",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2-7b": "qwen2_7b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-base": "whisper_base",
    "qwen3-14b": "qwen3_14b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "zamba2-2.7b": "zamba2_2b7",
}


def get_config(name: str) -> LMConfig:
    mod_name = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def long_context_variant(cfg: LMConfig, window: int = 8192) -> LMConfig:
    """Sliding-window variant for long_500k decode on attention archs.
    SSM/hybrid archs already decode in O(1) state; hybrid additionally
    windows its shared attention block."""
    if cfg.arch_type == "rwkv":
        return cfg
    return dataclasses.replace(cfg, window=window)


def all_configs() -> Dict[str, LMConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
