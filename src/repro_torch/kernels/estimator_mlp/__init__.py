from repro_torch.kernels.estimator_mlp.ops import estimator_mlp
from repro_torch.kernels.estimator_mlp.ref import estimator_mlp_ref

__all__ = ["estimator_mlp", "estimator_mlp_ref"]
