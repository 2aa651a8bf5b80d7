from repro_torch.data.lm_synth import synth_lm_batch
from repro_torch.data.modality_stubs import audio_frame_embeddings, vision_patch_embeddings
from repro_torch.data.shapes import (
    CLASS_NAMES,
    IMAGE_SIZE,
    NUM_CLASSES,
    ShapesDataset,
    render_image,
)

__all__ = ["CLASS_NAMES", "IMAGE_SIZE", "NUM_CLASSES", "ShapesDataset", "audio_frame_embeddings",
           "render_image", "synth_lm_batch", "vision_patch_embeddings"]
