"""The paper's primary contribution: ORIC/MORIC offloading rewards, the
reward estimator's inference half, decision policies and the box features."""
from repro_torch.core.estimator import (
    EstimatorConfig,
    RewardEstimator,
    mlp_apply,
    mlp_init,
)
from repro_torch.core.features import extract_features, extract_features_batch, feature_dim
from repro_torch.core.policy import ThresholdPolicy, TokenBucket
from repro_torch.core.reward import (
    CdfTransform,
    MatchedImage,
    RewardOracle,
    cascade_map,
    match_pairs_batched,
    topk_offload_mask,
)

__all__ = [
    "EstimatorConfig",
    "RewardEstimator",
    "mlp_apply",
    "mlp_init",
    "extract_features",
    "extract_features_batch",
    "feature_dim",
    "ThresholdPolicy",
    "TokenBucket",
    "CdfTransform",
    "MatchedImage",
    "RewardOracle",
    "cascade_map",
    "match_pairs_batched",
    "topk_offload_mask",
]
