"""Streaming reward-model refit from realized offload outcomes.

Every offloaded frame comes back with the strong detection, so the realized
reward (strong−weak per-frame AP, the exact quantity the estimator was fit
to predict) is observable for free on the offloaded subset.  This module
turns that signal into model updates along two paths:

- **Incremental last-layer least-squares** (:class:`LastLayerSolver`): the
  fused estimator is ``sigmoid(gelu(x W0 + b0) W1 + b1)``, so with the
  hidden layer frozen the head is a linear model in logit space.  Recursive
  ridge with a forgetting factor folds each observed block into sufficient
  statistics ``(A, b)`` in O(H²) and re-solves the head in O(H³) for H
  hidden units — microseconds per update, no gradient steps.
- **Periodic mini-refit** (:func:`mini_refit`): a few AdamW epochs of the
  paper's Eq. 7 weighted-MSE loss over the replay ring buffer, warm-started
  from the current params.  This also moves the hidden layer, which the
  incremental path cannot.

:class:`ReplayBuffer` is the ring buffer of realized ``(features, reward)``
blocks feeding both paths — feature rows are exactly what
``engine.features`` extracts from the padded ``DetectionsBatch`` plane, so
`AdaptiveEngine.observe` can pass through what the session already scored.
All state (ring contents, cursor) serializes as flat arrays for replayable
checkpoints.

The port of ``repro.online.updates``.  The buffer and the solver are copied
numpy (the solve in float64); ``hidden_features`` and ``apply_last_layer``
work on the estimator's parameters where they live (the engine's device),
and ``mini_refit`` differentiates the plain forward with autograd and steps
the port's AdamW there, as ``RewardEstimator.fit`` does.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.api.reward_model import MLPRewardModel
from repro_torch.core.estimator import value_and_grad, weighted_mse_loss
from repro_torch.train.adamw import adamw_init, adamw_update

_LOGIT_EPS = 1e-4


class ReplayBuffer:
    """Fixed-capacity ring buffer of realized (features, reward) rows.

    Rows are overwritten oldest-first once full; ``data()`` returns the
    valid rows in chronological order.  ``cursor``/``count`` are part of the
    serialized state so a restored buffer keeps overwriting from the same
    slot (bit-identical replay).
    """

    def __init__(self, capacity: int, feature_dim: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.feature_dim = int(feature_dim)
        self.x = np.zeros((self.capacity, self.feature_dim), np.float32)
        self.y = np.zeros((self.capacity,), np.float32)
        self.cursor = 0
        self.count = 0

    def __len__(self) -> int:
        return min(self.count, self.capacity)

    def append(self, x: np.ndarray, y: np.ndarray) -> None:
        """Append a block of rows (x: (N, F) or (F,), y: (N,) or scalar)."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None, :]
        y = np.atleast_1d(np.asarray(y, np.float32))
        if x.shape[0] != y.shape[0]:
            raise ValueError(f"block mismatch: {x.shape[0]} rows vs {y.shape[0]} rewards")
        if x.shape[1] != self.feature_dim:
            raise ValueError(f"feature dim {x.shape[1]} != buffer dim {self.feature_dim}")
        for i in range(x.shape[0]):
            self.x[self.cursor] = x[i]
            self.y[self.cursor] = y[i]
            self.cursor = (self.cursor + 1) % self.capacity
            self.count += 1

    def data(self) -> Tuple[np.ndarray, np.ndarray]:
        """Valid rows, oldest first."""
        n = len(self)
        if self.count <= self.capacity:
            return self.x[:n].copy(), self.y[:n].copy()
        order = (np.arange(self.capacity) + self.cursor) % self.capacity
        return self.x[order].copy(), self.y[order].copy()

    def state(self) -> Dict[str, np.ndarray]:
        return {
            "x": self.x.copy(),
            "y": self.y.copy(),
            "cursor": np.asarray(self.cursor, np.int64),
            "count": np.asarray(self.count, np.int64),
        }

    @classmethod
    def from_state(cls, state: Dict[str, np.ndarray]) -> "ReplayBuffer":
        x = np.asarray(state["x"], np.float32)
        buf = cls(capacity=x.shape[0], feature_dim=x.shape[1])
        buf.x = x.copy()
        buf.y = np.asarray(state["y"], np.float32).copy()
        buf.cursor = int(np.asarray(state["cursor"]))
        buf.count = int(np.asarray(state["count"]))
        return buf


# ---------------------------------------------------------------------------
# incremental last-layer least squares
# ---------------------------------------------------------------------------

@torch.no_grad()
def hidden_features(model: MLPRewardModel, x: np.ndarray) -> np.ndarray:
    """Hidden activations ``gelu(x_std W0 + b0)`` of the fused MLP (the tanh
    GELU, as ``jax.nn.gelu``'s default) — the design matrix of the
    last-layer linear model; computed on the estimator's device, returned
    to the host."""
    est = model.estimator
    if est is None:
        raise RuntimeError("hidden_features() before fit()")
    if len(est.params) != 2:
        raise ValueError("last-layer solve needs a single-hidden-layer MLP")
    x = np.asarray(x, np.float32)
    if model.config.standardize:
        x = (x - est._mu) / est._sigma
    p0 = est.params["layer0"]
    xt = torch.as_tensor(x).to(p0["w"].device)
    return F.gelu(xt @ p0["w"] + p0["b"], approximate="tanh").cpu().numpy()


def reward_to_logit(y: np.ndarray) -> np.ndarray:
    """Map sigmoid-head targets in [0, 1] to the pre-sigmoid logit scale the
    linear head operates on."""
    y = np.clip(np.asarray(y, np.float64), _LOGIT_EPS, 1.0 - _LOGIT_EPS)
    return np.log(y / (1.0 - y))


class LastLayerSolver:
    """Recursive ridge regression for the sigmoid head, with forgetting.

    Maintains sufficient statistics ``A = Σ λ^age Φᵀ Φ`` and
    ``b = Σ λ^age Φᵀ y`` over augmented hidden features ``Φ = [h, 1]`` and
    logit-space targets; ``solve()`` returns the ridge head
    ``(A + l2·I)⁻¹ b`` split into weights and bias.  ``forget`` < 1 decays
    old evidence per ingested block, so post-shift observations dominate.
    """

    def __init__(self, hidden_dim: int, l2: float = 1e-2, forget: float = 1.0):
        if not 0.0 < forget <= 1.0:
            raise ValueError(f"forget must be in (0, 1], got {forget}")
        self.hidden_dim = int(hidden_dim)
        self.l2 = float(l2)
        self.forget = float(forget)
        d = self.hidden_dim + 1
        self.A = np.zeros((d, d), np.float64)
        self.b = np.zeros((d,), np.float64)
        self.n_ingested = 0

    def ingest(self, h: np.ndarray, y_logit: np.ndarray) -> None:
        """Fold one block of hidden features / logit targets into (A, b)."""
        h = np.asarray(h, np.float64)
        if h.ndim == 1:
            h = h[None, :]
        y = np.atleast_1d(np.asarray(y_logit, np.float64))
        phi = np.concatenate([h, np.ones((h.shape[0], 1))], axis=1)
        self.A = self.forget * self.A + phi.T @ phi
        self.b = self.forget * self.b + phi.T @ y
        self.n_ingested += h.shape[0]

    def solve(self) -> Tuple[np.ndarray, float]:
        """Ridge solution as (w: (H,), b: scalar) for the sigmoid head."""
        if self.n_ingested == 0:
            raise RuntimeError("solve() before any ingest()")
        d = self.hidden_dim + 1
        w = np.linalg.solve(self.A + self.l2 * np.eye(d), self.b)
        return w[:-1], float(w[-1])

    def reset(self) -> None:
        """Drop accumulated evidence (after a full refit moves the hidden
        layer, the old design matrix no longer applies)."""
        self.A[:] = 0.0
        self.b[:] = 0.0
        self.n_ingested = 0

    def state(self) -> Dict[str, np.ndarray]:
        return {
            "A": self.A.copy(),
            "b": self.b.copy(),
            "n_ingested": np.asarray(self.n_ingested, np.int64),
        }

    @classmethod
    def from_state(
        cls, state: Dict[str, np.ndarray], l2: float = 1e-2, forget: float = 1.0
    ) -> "LastLayerSolver":
        A = np.asarray(state["A"], np.float64)
        solver = cls(hidden_dim=A.shape[0] - 1, l2=l2, forget=forget)
        solver.A = A.copy()
        solver.b = np.asarray(state["b"], np.float64).copy()
        solver.n_ingested = int(np.asarray(state["n_ingested"]))
        return solver


def apply_last_layer(model: MLPRewardModel, w: np.ndarray, b: float) -> None:
    """Install a solved head into the live estimator params (in place, so
    every session scoring through the engine sees it immediately: the new
    tensors miss the model's ``pipeline_params`` cache)."""
    est = model.estimator
    if est is None:
        raise RuntimeError("apply_last_layer() before fit()")
    dev = est.params["layer1"]["w"].device
    est.params["layer1"] = {
        "w": torch.as_tensor(np.asarray(w, np.float32)[:, None]).to(dev),
        "b": torch.as_tensor(np.asarray([b], np.float32)).to(dev),
    }


# ---------------------------------------------------------------------------
# periodic mini-refit
# ---------------------------------------------------------------------------

def mini_refit(
    model: MLPRewardModel,
    x: np.ndarray,
    y: np.ndarray,
    *,
    epochs: int = 8,
    lr: float = 5e-4,
    batch_size: int = 128,
    seed: int = 0,
) -> List[float]:
    """Warm-started AdamW refit over a replay block (moves all layers), on
    the estimator's device.

    Keeps the fitted standardization moments (``_mu``/``_sigma``) — the
    feature extractor is unchanged, only the reward mapping moved — and
    shuffles with a dedicated seeded numpy generator (the JAX package's
    permutations), so replays are bit-identical.
    """
    est = model.estimator
    if est is None:
        raise RuntimeError("mini_refit() before fit()")
    cfg = model.config
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    if cfg.standardize:
        x = (x - est._mu) / est._sigma
    dev = est.params["layer0"]["w"].device
    xt = torch.as_tensor(x).to(dev)
    yt = torch.as_tensor(y).to(dev)

    def loss_fn(p, xb, yb):
        return weighted_mse_loss(p, xb, yb, weighted=cfg.weighted, sigmoid_out=cfg.sigmoid_out)

    params, opt_state = est.params, adamw_init(est.params)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    losses: List[float] = []
    for _ in range(int(epochs)):
        perm = torch.from_numpy(rng.permutation(n)).to(dev)
        for s in range(0, n, batch_size):
            sel = perm[s : s + batch_size]
            loss, grads = value_and_grad(loss_fn, params, xt[sel], yt[sel])
            params, opt_state = adamw_update(
                grads, opt_state, params, lr, weight_decay=cfg.weight_decay
            )
            losses.append(float(loss))
    est.params = params
    return losses
