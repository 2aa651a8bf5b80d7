"""Batched autoregressive decode loop over ``decode_step``.

``cascade_generate`` (engine-gated weak/strong decode) needs
``runtime.session.OffloadSession``, which comes with ROADMAP.md queue A
item 2; it raises until then.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.lm import LMConfig, decode_step, prefill
from repro_torch.serving import timing


@torch.no_grad()
def generate(
    params,
    cfg: LMConfig,
    batch: Dict,
    steps: int,
    capacity: Optional[int] = None,
    greedy: bool = True,
    generator: Optional[torch.Generator] = None,
    *,
    stage_ms: Optional[Dict[str, float]] = None,
) -> torch.Tensor:
    """Prefill + ``steps`` greedy or sampled tokens; returns (B, steps) int32
    on the params' device.  Sampling draws from ``generator`` (on that
    device): the distribution is the JAX package's, the draws are not.
    ``stage_ms``, when given, accumulates the ``prefill_ms`` and
    ``decode_ms`` of the call (waiting for the device at each boundary)."""
    dev = params["embed"].device
    t0 = timing.now(stage_ms, dev)
    S = int(batch["tokens"].shape[1])
    capacity = capacity or (S + steps)
    logits, cache = prefill(params, cfg, batch, capacity=capacity)

    def pick(lg):
        if greedy:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        probs = torch.softmax(lg.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    toks = [pick(logits)]
    t0 = timing.add(stage_ms, "prefill_ms", t0, dev)
    for t in range(steps - 1):
        logits, cache = decode_step(params, cfg, cache, toks[-1], S + t)
        toks.append(pick(logits))
    timing.add(stage_ms, "decode_ms", t0, dev)
    return torch.stack(toks, dim=1)


def cascade_generate(*args, **kwargs):
    raise NotImplementedError(
        "cascade_generate needs runtime.session.OffloadSession, which comes with "
        "ROADMAP.md queue A item 2; route rows by LMCascade.serve_batch's "
        "decisions and call generate on each stack until then"
    )
