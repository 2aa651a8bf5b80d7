"""Batched autoregressive decode loop over ``decode_step``, plus the
engine-gated weak/strong cascade decode (``cascade_generate``)."""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.models.lm import LMConfig, decode_step, forward, prefill
from repro_torch.obs.trace import stage
from repro_torch.runtime.session import OffloadSession


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
    S = int(batch["tokens"].shape[1])
    capacity = capacity or (S + steps)

    def pick(lg):
        if greedy:
            return torch.argmax(lg, dim=-1).to(torch.int32)
        probs = torch.softmax(lg.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)

    with stage(None, "generate.prefill", stage_ms=stage_ms, key="prefill_ms", device=dev):
        logits, cache = prefill(params, cfg, batch, capacity=capacity)
        toks = [pick(logits)]
    with stage(None, "generate.decode", stage_ms=stage_ms, key="decode_ms", device=dev):
        for t in range(steps - 1):
            logits, cache = decode_step(params, cfg, cache, toks[-1], S + t)
            toks.append(pick(logits))
    return torch.stack(toks, dim=1)


@torch.no_grad()
def cascade_generate(
    params,
    cfg: LMConfig,
    batch: Dict,
    steps: int,
    *,
    engine=None,
    session=None,
    exit_layer: int,
    micro_batch: int = 8,
    capacity: Optional[int] = None,
    greedy: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Dict:
    """Session-gated decode: every request decodes through the early-exit
    (weak) stack; rows the ``OffloadSession`` offloads decode at full depth
    instead.  The decision reads only the weak prompt logits — the same
    deployability constraint as the detection cascade.

    Requests flow through a stream session in arrival (row) order, so
    stateful policies (``token_bucket``) carry across calls when the caller
    passes a long-lived ``session``; passing just ``engine`` opens a
    throwaway session for this batch.  ``batch`` values must share the
    leading batch dimension (dense / RWKV / MoE stacks, a VLM batch without
    ``positions_3d``).  Each stack decodes its rows, gathered by an index
    tensor on the params' device, through :func:`generate`; sampling draws
    from ``generator``.  Returns the generated tokens (a (B, steps) int32
    tensor on the params' device) plus the decisions (host numpy) and the
    session telemetry.

    A batch with ``positions_3d`` (3, B, S) raises ``ValueError``: its batch
    axis is the second, and ``repro``'s call cuts every value on the first
    (``repro/serving/decode_loop.py:102``), so it would take the rows of the
    three id planes instead of the batch's rows.
    """
    from repro_torch.serving.cascade_serving import truncate_params, truncated_config

    if "positions_3d" in batch:
        raise ValueError("cascade_generate cuts every batch value on axis 0, as repro's does; "
                         "positions_3d (3, B, S) has its batch on axis 1: serve a VLM batch with "
                         "M-RoPE ids through generate on each stack")
    if session is None:
        if engine is None:
            raise ValueError("pass engine= or session=")
        session = OffloadSession(engine, micro_batch=micro_batch)

    dev = params["embed"].device
    wcfg = truncated_config(cfg, exit_layer)
    wparams = truncate_params(params, cfg, exit_layer)
    wlogits, _ = forward(wparams, wcfg, batch)
    decisions = session.submit_batch((wlogits, batch.get("labels")))
    del wlogits
    offload = np.array([d.offload for d in decisions], bool)
    estimates = np.array([d.estimate for d in decisions])

    # decisions are known before decoding (they read only prompt logits), so
    # each row decodes through exactly one stack
    B = int(batch["tokens"].shape[0])
    out = torch.zeros((B, steps), dtype=torch.int32, device=dev)
    for p, c, rows in ((wparams, wcfg, np.flatnonzero(~offload)),
                       (params, cfg, np.flatnonzero(offload))):
        if rows.size:
            idx = torch.from_numpy(rows).to(dev)
            sub = {k: torch.as_tensor(v).to(dev)[idx] for k, v in batch.items()}
            out[idx] = generate(p, c, sub, steps, capacity=capacity, greedy=greedy,
                                generator=generator)
    return {
        "tokens": out,
        "offload": offload,
        "estimates": estimates,
        "offload_ratio": float(offload.mean()) if offload.size else 0.0,
        "telemetry": session.telemetry.as_dict(),
    }
