"""Functional optimizers over trees of tensors (the AdamW and SGD with
momentum of ``repro.optim``)."""
from repro_torch.optim.adamw import adamw_init, adamw_update, clip_by_global_norm, sgdm_init, sgdm_update
from repro_torch.optim.schedules import make_lr_schedule

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm", "make_lr_schedule", "sgdm_init", "sgdm_update"]
