"""Detection substrate: box ops (``boxes``), NMS (``nms``), the padded batch
data plane with its greedy matcher (``batch``) and the host-side numpy mAP
engine (``map_engine``).  Import from the submodules: the IoU kernel's plain
version reads ``boxes``, so this package re-exports nothing."""
