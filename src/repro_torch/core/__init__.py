"""The paper's primary contribution: ORIC/MORIC offloading rewards, the
frugal reward estimator, decision policies, and the baselines it is
evaluated against."""
from repro_torch.core.reward import (
    CdfTransform,
    MatchedImage,
    RewardOracle,
    cascade_map,
    match_pairs,
    match_pairs_batched,
    ori,
    ori_batch,
    topk_offload_mask,
)
from repro_torch.core.features import extract_features, extract_features_batch, feature_dim
from repro_torch.core.estimator import (
    EstimatorConfig,
    RewardEstimator,
    cnn_apply,
    cnn_init,
    mlp_apply,
    mlp_init,
    weighted_mse_loss,
)
from repro_torch.core.policy import ThresholdPolicy, TokenBucket
from repro_torch.core.baselines import (
    AdaptiveFeedingSVM,
    DCSBRule,
    dcsb_signals,
    fit_dcsb,
    random_offload_mask,
)
from repro_torch.core.cascade import Cascade, CascadeRecord

__all__ = [
    "CdfTransform",
    "MatchedImage",
    "RewardOracle",
    "cascade_map",
    "match_pairs",
    "match_pairs_batched",
    "ori",
    "ori_batch",
    "topk_offload_mask",
    "extract_features",
    "extract_features_batch",
    "feature_dim",
    "EstimatorConfig",
    "RewardEstimator",
    "cnn_apply",
    "cnn_init",
    "mlp_apply",
    "mlp_init",
    "weighted_mse_loss",
    "ThresholdPolicy",
    "TokenBucket",
    "AdaptiveFeedingSVM",
    "DCSBRule",
    "dcsb_signals",
    "fit_dcsb",
    "random_offload_mask",
    "Cascade",
    "CascadeRecord",
]
