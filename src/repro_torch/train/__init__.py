"""Training substrate; this slice ports only the ``.npz`` artifact format."""
from repro_torch.train.checkpoint import load_flat, save_flat

__all__ = ["load_flat", "save_flat"]
