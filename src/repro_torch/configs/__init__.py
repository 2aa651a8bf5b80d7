"""Architecture registry: one module per assigned architecture (the JAX
package's ten config files, re-pointed at the port's ``LMConfig``).

``get_config(name)`` returns the full-scale LMConfig; ``--arch <id>`` in the
launchers resolves through here.  The sliding-window variant of the JAX
package's registry comes with the ring cache (ROADMAP.md queue A item 9).
"""
from __future__ import annotations

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

