from repro_torch.checkpoint.ckpt import (
    latest_state_dir,
    load_pytree,
    load_state,
    restore_latest,
    save_pytree,
    save_state,
)

__all__ = [
    "save_pytree",
    "load_pytree",
    "restore_latest",
    "save_state",
    "load_state",
    "latest_state_dir",
]
