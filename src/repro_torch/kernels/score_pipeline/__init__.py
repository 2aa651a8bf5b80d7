from repro_torch.kernels.score_pipeline.ops import pipeline_params, score_pipeline
from repro_torch.kernels.score_pipeline.ref import score_pipeline_ref

__all__ = ["pipeline_params", "score_pipeline", "score_pipeline_ref"]
