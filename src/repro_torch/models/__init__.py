"""Architecture assembly of the port: layer blocks, the decoder stacks,
the encoder-decoder, the registry and the stacked layer layout."""
from repro_torch.models import stacking
from repro_torch.models.registry import build_model, init_params, model_apply
from repro_torch.models.stacking import stack_params, unstack_params

__all__ = [
    "build_model",
    "init_params",
    "model_apply",
    "stacking",
    "stack_params",
    "unstack_params",
]
