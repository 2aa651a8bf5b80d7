from repro_torch.kernels.iou_matrix.ops import iou_matrix, iou_matrix_batch
from repro_torch.kernels.iou_matrix.ref import iou_matrix_batch_ref, iou_matrix_ref

__all__ = ["iou_matrix", "iou_matrix_batch", "iou_matrix_batch_ref", "iou_matrix_ref"]
