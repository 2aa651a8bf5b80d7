"""ORIC-gated cascade serving for LMs (paper §V-A transfer): the early-exit
cascade of ``repro.serving.cascade_serving``.

The "weak detector" is the model truncated at layer k with the shared LM
head; the "strong detector" is the full depth.  One
:class:`repro_torch.api.OffloadEngine` owns the decision: ``lm_logits``
features of the weak logits -> the one-hidden-layer MLP (the
``estimator_mlp`` kernel) -> quantile threshold.

``fit`` computes the oracle rewards (NLL_weak - NLL_strong) on calibration
batches and fits the engine on the weak logits' features; an engine either
package fitted crosses over as the artifact ``save`` writes.  ``serve_batch``
decides one batch; ``serve_stream`` streams batches through one
:class:`repro_torch.runtime.OffloadSession`.  The port serves the dense,
VLM and RWKV stacks (one layer stack each) and the MoE family (its two
stacks, with or without MLA), as ``repro`` does.  A VLM batch's
``vision_embeds`` and ``positions_3d`` go to every forward with the
tokens.  The hybrid and encoder-decoder families have no early-exit
cascade in ``repro`` (its ``truncate_params`` knows only these stacks), and
none here: they are served through ``decode_loop.generate``.

Spans: with an ``Obs`` attached (``LMCascade.obs``), or while
``torch.profiler`` records, each batch is a ``cascade.serve_batch`` tree
(:func:`repro_torch.obs.trace.stage`): ``cascade.weak_forward``,
``cascade.decide`` (the engine's ``engine.features`` / ``engine.estimator``
/ ``engine.policy`` inside), ``cascade.nll``, ``cascade.strong_forward``,
``cascade.nll``; every forward's layers are ``lm.layer`` spans.  The end of
``cascade.decide`` is the batch's decision instant: the offload mask is on
the host.  A profiled batch with no ``Obs`` attached attaches a tracer-only
one, so a profiled run carries the spans by itself.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.api import LMLogitsFeatures, MLPRewardModel, OffloadEngine
from repro_torch.api.features import logits_features  # re-export, as in repro
from repro_torch.core.estimator import EstimatorConfig
from repro_torch.kernels.dispatch import DeviceLike
from repro_torch.models.lm import LMConfig, check_arch, forward, tree_map
from repro_torch.obs import Obs
from repro_torch.obs.trace import profiler_active, stage
from repro_torch.runtime.session import OffloadSession

PyTree = dict

__all__ = [
    "LMCascade",
    "logits_features",
    "sequence_nll",
    "truncate_params",
    "truncated_config",
]


_STACKS = ("layers", "dense_layers", "moe_layers")


def _check_cascade(cfg: LMConfig) -> None:
    check_arch(cfg)
    if cfg.arch_type in ("hybrid", "encdec"):
        raise ValueError(f"{cfg.name}: the early-exit cascade cuts the dense, VLM, MoE and RWKV "
                         f"stacks, as repro's does; the {cfg.arch_type} family is served by "
                         f"generate")


def truncate_params(params: PyTree, cfg: LMConfig, exit_layer: int) -> PyTree:
    """Early-exit params: the first ``exit_layer`` layers + the shared head.
    The MoE family's two stacks are cut as ``repro`` cuts them: the first
    min(exit_layer, first_k_dense) dense layers (the stack left out when
    that is 0) and the MoE layers after them (a stack of length 0 when the
    exit comes before the first).  Every tensor is a view of ``params`` (no
    weight is copied)."""
    _check_cascade(cfg)
    p = {k: v for k, v in params.items() if k not in _STACKS}
    if "layers" in params:
        p["layers"] = tree_map(lambda a: a[:exit_layer], params["layers"])
        return p
    take_dense = min(exit_layer, cfg.first_k_dense)
    if take_dense:
        p["dense_layers"] = tree_map(lambda a: a[:take_dense], params["dense_layers"])
    if "moe_layers" in params:
        take_moe = max(exit_layer - cfg.first_k_dense, 0)
        p["moe_layers"] = tree_map(lambda a: a[:take_moe], params["moe_layers"])
    return p


def truncated_config(cfg: LMConfig, exit_layer: int) -> LMConfig:
    _check_cascade(cfg)
    kw = {"num_layers": exit_layer}
    if cfg.arch_type == "moe":
        kw["first_k_dense"] = min(cfg.first_k_dense, exit_layer)
    return dataclasses.replace(cfg, **kw)


def sequence_nll(logits: torch.Tensor, labels) -> torch.Tensor:
    """Per-sequence mean NLL (B,) float32.  logits (B,S,V), labels (B,S)
    with -1 pad."""
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.asarray(labels))
    labels = labels.to(device=logits.device, dtype=torch.int64)
    valid = labels >= 0
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (lse - gold) * valid
    return nll.sum(-1) / valid.sum(-1).clamp(min=1)


@dataclass
class LMCascade:
    """ORIC-style cascade for an LM: truncation point + the decision engine
    (features -> estimator -> rank transform -> policy)."""

    cfg: LMConfig
    exit_layer: int
    engine: OffloadEngine
    #: where the spans go (an operator attaches one; see the module docstring)
    obs: Optional[Obs] = field(default=None, repr=False, compare=False)

    # -- views of the engine's stack --------------------------------------
    @property
    def estimator(self):
        return self.engine.reward_model.estimator

    @property
    def cdf(self):
        return self.engine.transform

    @property
    def policy(self):
        return self.engine.policy

    @classmethod
    def fit(
        cls,
        params: PyTree,
        cfg: LMConfig,
        exit_layer: int,
        calib_batches,  # iterable of batches (tokens + labels)
        ratio: float = 0.2,
        epochs: int = 40,
        seed: int = 0,
    ) -> "LMCascade":
        """Oracle rewards on the calibration batches, then the engine (the
        MORIC estimator on the weak logits' features + quantile threshold)
        fitted on the parameters' device.  Each batch's logits are reduced
        to features and NLLs before the next forward, so at most one
        (B, S, V) logits tensor is alive at a time."""
        dev = params["embed"].device
        wcfg = truncated_config(cfg, exit_layer)
        wparams = truncate_params(params, cfg, exit_layer)
        extractor = LMLogitsFeatures(device=dev)
        feats, rewards = [], []
        with torch.no_grad():
            for batch in calib_batches:
                wlogits, _ = forward(wparams, wcfg, batch)
                nll_w = sequence_nll(wlogits, batch["labels"])
                feats.append(extractor((wlogits, batch["labels"])))
                del wlogits
                slogits, _ = forward(params, cfg, batch)
                nll_s = sequence_nll(slogits, batch["labels"])
                del slogits
                rewards.append((nll_w - nll_s).cpu().numpy())  # > 0: offload helps
        engine = OffloadEngine(
            feature_extractor=extractor,
            reward_model=MLPRewardModel(
                config=EstimatorConfig(hidden=(64,), epochs=epochs, seed=seed), device=dev
            ),
            ratio=ratio,
        )
        engine.fit(features=torch.cat(feats), rewards=np.concatenate(rewards))
        return cls(cfg=cfg, exit_layer=exit_layer, engine=engine)

    def _tracer(self):
        """The attached ``Obs``'s tracer; while ``torch.profiler`` records and
        none is attached, a tracer-only ``Obs`` of the cascade's own."""
        if self.obs is None and profiler_active():
            self.obs = Obs(metrics=False, profiling=False)
        return self.obs.tracer if self.obs is not None else None

    def _stages(self, params: PyTree, batch: Dict, decide, tr, stage_ms=None):
        """One batch's stages: the weak pass, ``decide(weak outputs)`` ->
        (decisions, the offload mask on the host), the weak NLLs, the strong
        pass and its NLLs.  Returns (decisions, mask, nll_weak, nll_strong)."""
        dev = params["embed"].device
        with stage(tr, "cascade.serve_batch", device=dev) as root:
            with stage(tr, "cascade.weak_forward", stage_ms=stage_ms, key="weak_forward_ms",
                       device=dev):
                wparams = truncate_params(params, self.cfg, self.exit_layer)
                wlogits, _ = forward(wparams, truncated_config(self.cfg, self.exit_layer), batch,
                                     tracer=tr)
            with stage(tr, "cascade.decide", stage_ms=stage_ms, key="decide_ms", device=dev):
                decisions, offload = decide((wlogits, batch["labels"]))
            with stage(tr, "cascade.nll", stage_ms=stage_ms, key="nll_ms", device=dev):
                nll_w = sequence_nll(wlogits, batch["labels"]).cpu().numpy()
                del wlogits
            with stage(tr, "cascade.strong_forward", stage_ms=stage_ms, key="strong_forward_ms",
                       device=dev):
                slogits, _ = forward(params, self.cfg, batch, tracer=tr)
            with stage(tr, "cascade.nll", stage_ms=stage_ms, key="nll_ms", device=dev):
                nll_s = sequence_nll(slogits, batch["labels"]).cpu().numpy()
                del slogits
            if tr is not None:
                root.set(**_batch_args(batch, offload))
        return decisions, offload, nll_w, nll_s

    @torch.no_grad()
    def serve_batch(self, params: PyTree, batch: Dict, *,
                    stage_ms: Optional[Dict[str, float]] = None) -> Dict:
        """Weak pass for everyone; decisions from the weak logits; the strong
        pass over the whole batch, whose rows the decisions then select (the
        reference's semantics: in a deployment only offloaded rows would
        cross to the strong model).  Returns per-request NLLs (host numpy),
        decisions and the blended quality.  ``stage_ms`` accumulates
        ``weak_forward_ms``, ``decide_ms``, ``strong_forward_ms`` and
        ``nll_ms`` when given, waiting for the device at each stage's open
        and close."""
        tr = self._tracer()

        def decide(weak_out):
            decision = self.engine.decide(weak_out, tracer=tr)
            return decision, decision.offload

        decision, offload, nll_w, nll_s = self._stages(params, batch, decide, tr, stage_ms)
        return {
            "estimates": decision.estimates,
            "offload": offload,
            "nll_weak": nll_w,
            "nll_strong": nll_s,
            "nll_final": np.where(offload, nll_s, nll_w),
            "offload_ratio": decision.ratio,
        }

    @torch.no_grad()
    def serve_stream(
        self,
        params: PyTree,
        batches,
        *,
        micro_batch: int = 8,
        ratio: Optional[float] = None,
        session=None,
        set_ratio_at: Optional[Dict[int, float]] = None,
    ) -> Dict:
        """Streaming serve: requests arrive batch by batch and flow through
        one :class:`repro_torch.runtime.OffloadSession` in arrival order —
        the stateful counterpart of ``serve_batch`` (policy state,
        realized-ratio telemetry, and mid-stream ``set_ratio_at`` re-budgets
        carry across batches).  Realized rewards (NLL_weak - NLL_strong of
        each request that actually went to the strong model) are recorded
        into the session telemetry, so ``reward_sum / rewards_recorded`` is
        the mean realized quality delta of the offloaded traffic.

        ``set_ratio_at`` maps global request index -> new target ratio; a
        re-budget lands at the batch boundary before the batch that holds
        its request.  Each batch's weak logits stay on the device through
        the decision (one ``estimator_mlp`` launch a batch); returns the
        concatenated per-request results (host numpy) plus the telemetry."""
        tr = self._tracer()
        if session is None:
            session = OffloadSession(self.engine, ratio=ratio, micro_batch=micro_batch,
                                     obs=self.obs)
        rebudget = dict(set_ratio_at or {})

        def decide(weak_out):
            decisions = session.submit_batch(weak_out)
            return decisions, np.array([d.offload for d in decisions], bool)

        served = 0
        est, off, nw, ns = [], [], [], []
        for batch in batches:
            # re-budgets land at the nearest batch boundary, in step order
            for step in sorted(rebudget):
                if step < served + int(batch["tokens"].shape[0]):
                    session.set_ratio(rebudget.pop(step))
            decisions, mask, nll_w, nll_s = self._stages(params, batch, decide, tr)
            for r in (nll_w - nll_s)[mask]:
                session.record_reward(float(r))
            est.append(np.array([d.estimate for d in decisions]))
            off.append(mask)
            nw.append(nll_w)
            ns.append(nll_s)
            served += len(mask)
        offload = np.concatenate(off) if off else np.zeros(0, bool)
        nll_w = np.concatenate(nw) if nw else np.zeros(0)
        nll_s = np.concatenate(ns) if ns else np.zeros(0)
        return {
            "estimates": np.concatenate(est) if est else np.zeros(0),
            "offload": offload,
            "nll_weak": nll_w,
            "nll_strong": nll_s,
            "nll_final": np.where(offload, nll_s, nll_w),
            "offload_ratio": float(offload.mean()) if offload.size else 0.0,
            "telemetry": session.telemetry.as_dict(),
        }

    def set_ratio(self, ratio: float) -> None:
        """Runtime offload-budget adjustment (delegates to the engine)."""
        self.engine.set_ratio(ratio)

    def save(self, path: str) -> None:
        """Persist the decision stack (not the LM weights) as one artifact."""
        self.engine.save(
            path, extra_meta={"exit_layer": self.exit_layer, "cfg_name": self.cfg.name}
        )

    @classmethod
    def load(cls, path: str, cfg: LMConfig, *, device: DeviceLike = "cuda",
             obs: Optional[Obs] = None) -> "LMCascade":
        """Rebuild from a saved engine on ``device``; the LM config and params
        are the caller's (the artifact carries only the decision stack).
        ``obs`` receives the spans of every batch."""
        engine = OffloadEngine.load(path, device=device)
        return cls(cfg=cfg, exit_layer=int(engine.extra_meta["exit_layer"]), engine=engine,
                   obs=obs)


def _batch_args(batch: Dict, offload: np.ndarray) -> Dict[str, int]:
    """The root span's args: rows, padded length, positions with a label
    (read once the batch is done) and rows offloaded."""
    tokens, labels = batch["tokens"], batch["labels"]
    scored = (labels >= 0).sum() if isinstance(labels, torch.Tensor) else \
        np.count_nonzero(np.asarray(labels) >= 0)
    return {"rows": int(tokens.shape[0]), "pad": int(tokens.shape[1]), "scored": int(scored),
            "offloaded": int(np.count_nonzero(offload))}
