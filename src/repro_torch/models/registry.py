"""Model registry of the port: the dense decoder family only, so far."""
from __future__ import annotations

import torch

from repro_torch.models import transformer


def init_params(cfg, generator: torch.Generator):
    """Random parameters for ``cfg``, drawn from ``generator`` on its device."""
    if cfg.family != "dense":
        raise NotImplementedError(f"the port serves the dense family only, not {cfg.family!r}")
    return transformer.init_lm(cfg, generator)
