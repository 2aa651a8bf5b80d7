"""Training substrate: AdamW and LR schedules on nested dicts of tensors,
the ``.npz`` checkpoint formats, and the detector training loop
(``trainer``, imported from its module: it pulls in the detector)."""
from repro_torch.train.adamw import AdamWState, adamw_init, adamw_update
from repro_torch.train.checkpoint import load_flat, load_pytree, save_flat, save_pytree
from repro_torch.train.schedule import constant_schedule, warmup_cosine

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "constant_schedule",
    "load_flat",
    "load_pytree",
    "save_flat",
    "save_pytree",
    "warmup_cosine",
]
