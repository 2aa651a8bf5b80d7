from repro_torch.kernels.iou_matrix.ops import (
    greedy_match,
    iou_matrix,
    iou_matrix_batch,
    iou_plan,
    nms_keep,
)
from repro_torch.kernels.iou_matrix.ref import (
    greedy_match_ref,
    iou_matrix_batch_ref,
    iou_matrix_ref,
    nms_keep_ref,
)

__all__ = ["greedy_match", "greedy_match_ref", "iou_matrix", "iou_matrix_batch",
           "iou_matrix_batch_ref", "iou_matrix_ref", "iou_plan", "nms_keep", "nms_keep_ref"]
