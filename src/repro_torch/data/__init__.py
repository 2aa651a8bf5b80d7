from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.data.shapes import CLASS_NAMES, IMAGE_SIZE, NUM_CLASSES, ShapesDataset

__all__ = ["CLASS_NAMES", "IMAGE_SIZE", "NUM_CLASSES", "ShapesDataset", "synth_lm_batch"]
