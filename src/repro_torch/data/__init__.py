from repro_torch.data.shapes import CLASS_NAMES, IMAGE_SIZE, NUM_CLASSES, ShapesDataset

__all__ = ["CLASS_NAMES", "IMAGE_SIZE", "NUM_CLASSES", "ShapesDataset"]
