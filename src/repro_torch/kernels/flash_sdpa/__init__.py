from repro_torch.kernels.flash_sdpa.ops import flash_sdpa
from repro_torch.kernels.flash_sdpa.ref import flash_sdpa_ref

__all__ = ["flash_sdpa", "flash_sdpa_ref"]
