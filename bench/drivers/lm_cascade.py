"""The driver of the LM offloading cascade (traffic files whose ``driver``
is ``lm_cascade``): set-up, the closed-loop window over
``LMCascade.serve_batch``, and the check of what the window served against
the plain reference.

Set-up (timed as ``setup_s``): the seeded weights on the device over the
port's parameter tree (``harness.weights``); the traffic pool and the
mix's calibration batches (one block of the layout a ``calibration_blocks``,
``harness.traffic``); the calibration, in which the program's weak stack
(``truncate_params`` + ``forward``) and its ``logits_features`` run over
each calibration batch; an engine artifact written from the seed and those
features (an MLP head drawn from the seed, standardised on the calibration
features with the configuration's ``std_floor``, its estimates on them as
the calibration scores, so that the threshold offloads the mix's ``ratio``
of traffic like the calibration set), loaded through ``LMCascade.load``;
then ``serve_batch`` once on the first calibration batch of each padded
shape, which warms every shape the window uses.  Nothing is fitted.

The window: one client sends a batch, waits for ``serve_batch`` to return
its results on the host, and sends the next, until ``seconds`` have passed;
the batch that crosses the deadline completes and counts.  A traced window
passes ``stage_ms`` (the program's synchronised stage timing) and runs
under ``torch.profiler``.

The check (after the window, the peak memory read and the program's state
freed): the reference runs over the calibration prompts and over the
prompts of the sampled batches (the limits file's ``sample_batches``,
``traffic.sample_batches``), each at its own length, in float32 with TF32
off, calibrates its own decision stack the same way, and the program's
answers are compared with it (``harness.check``).  The program's threshold
is the one its artifact defines: the (1 - ratio) quantile of the
calibration scores the benchmark wrote into it.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import check, flops
from harness import traffic as tr
from harness.weights import make_params
from reference import common as ref


def lm_config(model: Dict):
    from repro_torch.models.lm import LMConfig

    return LMConfig(**model)


def head_from_seed(seed: int, F: int, H: int) -> Dict[str, np.ndarray]:
    """The reward head: He-normal weights from ``seed``, small biases."""
    rng = np.random.default_rng([seed, 3])
    return {"w1": (rng.standard_normal((F, H)) * np.sqrt(2.0 / F)).astype(np.float32),
            "b1": (rng.standard_normal(H) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal(H) * np.sqrt(2.0 / H)).astype(np.float32),
            "b2": np.zeros((), np.float32)}


def write_engine(path: str, head: Dict, cal_features: np.ndarray, ratio: float,
                 exit_layer: int, cfg_name: str, top_k: int, std_floor: float,
                 standardize: bool = True) -> np.ndarray:
    """An ``OffloadEngine`` artifact (the ``.npz`` layout of the port's
    ``save_flat``): the head standardised on ``cal_features`` (floor
    ``std_floor``), its estimates on them as the calibration scores, which
    it returns.  ``standardize=False`` writes mu 0 and sigma 1 beside the
    same scores: the program then runs the head on raw features, a fault
    the check must see."""
    mu, sigma = ref.standardizer(cal_features, std_floor)
    mu, sigma = mu.astype(np.float32), sigma.astype(np.float32)
    scores = ref.mlp((cal_features.astype(np.float32) - mu) / sigma, head)
    if not standardize:
        mu, sigma = np.zeros_like(mu), np.ones_like(sigma)
    F, H = head["w1"].shape
    meta = {
        "kind": "offload_engine", "version": 1, "ratio": ratio, "transform": "cdf",
        "policy": {"name": "threshold", "kwargs": {}},
        "feature_extractor": {"name": "lm_logits", "spec": {"top_k": top_k}},
        "reward_model": {"kind": "mlp", "in_dim": F, "use_fused": True,
                         "config": {"hidden": [H], "sigmoid_out": True, "standardize": True}},
        "extra": {"exit_layer": exit_layer, "cfg_name": cfg_name},
    }
    arrays = {
        "model/params/layer0/w": head["w1"], "model/params/layer0/b": head["b1"],
        "model/params/layer1/w": head["w2"][:, None], "model/params/layer1/b": head["b2"][None],
        "model/mu": mu, "model/sigma": sigma,
        "calibration": scores.astype(np.float64), "transform_sorted": np.sort(scores),
        "__meta__": np.asarray(json.dumps(meta)),
    }
    np.savez(path, **arrays)
    return scores


def _request(batch: Dict, i: int):
    n = batch["lengths"][i]
    return batch["tokens"][i, :n], batch["labels"][i, :n]


def _inputs(batch: Dict) -> Dict:
    return {"tokens": batch["tokens"], "labels": batch["labels"]}


class Driver:
    """One run of a cell: ``setup``, ``window``, ``failed``, ``free``, then
    ``readings`` (the interface ``harness.runner`` drives)."""

    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, int(seed), device
        c = cell.config
        self.model = c["model"]
        self.exit_layer = int(c["cascade"]["exit_layer"])
        self.top_k = int(c["cascade"]["top_k"])
        self.hidden = int(c["cascade"]["hidden"])
        self.std_floor = float(c["cascade"]["std_floor"])
        self.mix = tr.Mix.from_file(cell.traffic)
        self.served: List[Dict] = []
        self.outs: List[Dict] = []
        self._ref: Dict[str, Dict] = {}

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from repro_torch.api.features import logits_features
        from repro_torch.models.lm import abstract_params, forward
        from repro_torch.serving.cascade_serving import truncate_params, truncated_config

        c, dev = self.cell.config, self.device
        parts, t = {}, time.perf_counter()

        def lap(name):
            nonlocal t
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            parts[name] = time.perf_counter() - t
            t = time.perf_counter()

        self.setup_parts = parts
        self.cfg = lm_config(self.model)
        self.params = make_params(abstract_params(self.cfg), c["init"], c.get("float32_leaves", ()),
                                  self.cfg.act_dtype, self.seed, dev)
        lap("weights_s")
        vocab = self.model["vocab_size"]
        self.cal = tr.calibration_batches(self.mix, vocab, self.seed)
        self.pool = tr.window_batches(self.mix, vocab, self.seed)
        lap("traffic_s")
        wparams = truncate_params(self.params, self.cfg, self.exit_layer)
        wcfg = truncated_config(self.cfg, self.exit_layer)
        feats = []
        with torch.no_grad():
            for b in self.cal:
                wl, _ = forward(wparams, wcfg, _inputs(b))
                labels = torch.from_numpy(b["labels"]).to(dev)
                feats.append(logits_features(wl, labels, self.top_k).cpu().numpy())
                del wl
        self.cal_features = np.concatenate(feats).astype(np.float64)
        lap("calibration_s")
        self.head = head_from_seed(self.seed, self.cal_features.shape[1], self.hidden)
        self.cascade, scores = self.load_engine(self.std_floor)
        self.threshold = ref.threshold(scores, self.mix.ratio)
        lap("engine_s")
        for b in tr.warm_batches(self.cal):
            self.cascade.serve_batch(self.params, _inputs(b))
        lap("warm_s")

    def load_engine(self, std_floor: float, standardize: bool = True):
        """(``LMCascade`` loaded from an artifact written from the seed's
        head and the calibration features, the calibration scores)."""
        from repro_torch.serving.cascade_serving import LMCascade

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "engine.npz")
            scores = write_engine(path, self.head, self.cal_features, self.mix.ratio,
                                  self.exit_layer, self.cfg.name, self.top_k, std_floor,
                                  standardize)
            return LMCascade.load(path, self.cfg, device=self.device), scores

    # ------------------------------------------------------------ window
    def window(self, seconds: float, stage_ms: Optional[Dict] = None) -> Dict:
        """Serve batches until ``seconds`` have passed; per batch its
        start, end, rows and scored positions."""
        records = []
        t_start = time.perf_counter()
        i = 0
        while True:
            batch = self.pool[i % len(self.pool)]
            i += 1
            t0 = time.perf_counter()
            out = self.cascade.serve_batch(self.params, _inputs(batch), stage_ms=stage_ms)
            t1 = time.perf_counter()
            self.served.append(batch)
            self.outs.append(out)
            records.append({"t0": t0 - t_start, "t1": t1 - t_start, "rows": len(batch["lengths"]),
                            "pad": batch["pad"], "lengths": batch["lengths"],
                            "scored": sum(n - 1 for n in batch["lengths"])})
            if t1 - t_start >= seconds:
                return {"records": records, "window_s": t1 - t_start}

    def failed(self) -> int:
        """Requests whose returned numbers are not all finite."""
        bad = 0
        for out in self.outs:
            ok = np.ones(len(out["offload"]), bool)
            for key in ("estimates", "nll_weak", "nll_strong", "nll_final"):
                ok &= np.isfinite(np.asarray(out[key], np.float64))
            bad += int((~ok).sum())
        return bad

    def model_flops(self, records: List[Dict]) -> Optional[float]:
        """Model FLOPs of the weak and the strong pass over the scored
        positions of ``records`` (None where ``harness.flops`` has no count
        for the family)."""
        scored = [n - 1 for r in records for n in r["lengths"]]
        return flops.cascade_flops(self.model, self.exit_layer, scored)

    def free(self) -> None:
        """Drop the program's state (the cascade and its engine); the
        weights are the benchmark's and stay for the reference."""
        del self.cascade
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def sample(self) -> List[int]:
        return tr.sample_batches(int(self.cell.limits["sample_batches"]), self.served, self.seed)

    def program_answers(self, idx: List[int]) -> Dict[str, np.ndarray]:
        cat = lambda k: np.concatenate([np.asarray(self.outs[j][k]) for j in idx])  # noqa: E731
        out = {k: cat(k) for k in ("estimates", "offload", "nll_weak", "nll_strong", "nll_final")}
        out["threshold"] = self.threshold
        return out

    def reference_run(self, idx: List[int], matmul: str = "exact") -> Dict:
        """The reference (or, with ``matmul="fp8"``, the control) over the
        calibration prompts and the sampled batches' prompts: features and
        NLLs (kept, so that each decision stack reuses them)."""
        key = f"{matmul}:{idx}"
        if key not in self._ref:
            fam = importlib.import_module(f"reference.{self.cell.config['reference']}")
            cal = [_request(b, i) for b in self.cal for i in range(len(b["lengths"]))]
            sample = [_request(self.served[j], i) for j in idx
                      for i in range(len(self.served[j]["lengths"]))]
            with ref.float32_exact(), torch.no_grad():
                self._ref[key] = ref.score(fam, self.params, self.model, self.exit_layer, cal,
                                           sample, self.top_k, ref.MATMULS[matmul])
        return self._ref[key]

    def reference_answers(self, idx: List[int], matmul: str = "exact",
                          std_floor: Optional[float] = None) -> Dict[str, np.ndarray]:
        """The reference's answers for the sampled batches: its decision
        stack calibrated on its own calibration features."""
        res = self.reference_run(idx, matmul)
        floor = self.std_floor if std_floor is None else std_floor
        dec = ref.decisions(res["cal_features"], res["features"], self.head, self.mix.ratio,
                            floor)
        return {"estimates": dec["estimates"], "offload": dec["offload"],
                "threshold": dec["threshold"], "nll_weak": res["nll_weak"],
                "nll_strong": res["nll_strong"],
                "nll_final": np.where(dec["offload"], res["nll_strong"], res["nll_weak"])}

    def readings(self) -> Dict:
        """(the numbers ``harness.check`` reads, what the run's diagnostic
        line adds): the program's answers for the sampled batches against
        the reference's."""
        idx = self.sample()
        t = time.perf_counter()
        prog, refr = self.program_answers(idx), self.reference_answers(idx)
        values = check.readings(prog, refr, self.cell.limits["flip_band_logit"])
        diag = {"reference_s": time.perf_counter() - t, "sampled_batches": idx,
                "threshold": [prog["threshold"], refr["threshold"]],
                "offload_ratio": float(np.mean(np.concatenate([o["offload"] for o in self.outs]))),
                "calibration_requests": sum(len(b["lengths"]) for b in self.cal)}
        return {"values": values, "diag": diag}
