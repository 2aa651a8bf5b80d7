"""The OffloadEngine API: one decision-stack object, fitted on calibration
data or loaded from an artifact either package saved."""
from repro_torch.api.engine import DecisionBatch, OffloadEngine
from repro_torch.api.features import (
    DetectionBoxFeatures,
    FeatureExtractor,
    LMLogitsFeatures,
    list_feature_extractors,
    logits_features,
    make_feature_extractor,
    register_feature_extractor,
)
from repro_torch.api.policies import (
    Policy,
    QuantileThresholdPolicy,
    TokenBucketPolicy,
    TopKPolicy,
    list_policies,
    make_policy,
    policy_context_params,
    quantile_threshold,
    register_policy,
)
from repro_torch.api.reward_model import (
    CNNRewardModel,
    MLPRewardModel,
    RewardModel,
    reward_model_from_state,
)

__all__ = [
    "OffloadEngine",
    "DecisionBatch",
    "FeatureExtractor",
    "DetectionBoxFeatures",
    "LMLogitsFeatures",
    "logits_features",
    "list_feature_extractors",
    "make_feature_extractor",
    "register_feature_extractor",
    "Policy",
    "QuantileThresholdPolicy",
    "TopKPolicy",
    "TokenBucketPolicy",
    "list_policies",
    "make_policy",
    "policy_context_params",
    "quantile_threshold",
    "register_policy",
    "RewardModel",
    "MLPRewardModel",
    "CNNRewardModel",
    "reward_model_from_state",
]
