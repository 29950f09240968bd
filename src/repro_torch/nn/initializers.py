"""Parameter initializers, each drawing from an explicit ``torch.Generator``.

The tensors land on the generator's device.  The distributions are those of
``repro.nn.initializers``; the values are not JAX's (the two RNGs differ).
"""
from __future__ import annotations

import torch


def normal_init(generator: torch.Generator, shape, stddev: float = 0.02, dtype=torch.float32):
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.normal_(0.0, stddev, generator=generator)


def truncated_lecun(generator: torch.Generator, shape, fan_in_axis: int = 0, dtype=torch.float32):
    """LeCun-normal (fan-in) truncated at two standard deviations.

    ``fan_in_axis`` is 1 for a stacked ``(L, d_in, d_out)`` leaf, so each
    layer's slice has the distribution of a per-layer ``(d_in, d_out)`` init.
    """
    fan_in = shape[fan_in_axis] if len(shape) > fan_in_axis else 1
    std = (1.0 / max(1, fan_in)) ** 0.5
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def zeros_init(generator: torch.Generator, shape, dtype=torch.float32):
    """Zeros on the generator's device (nothing is drawn)."""
    return torch.zeros(shape, dtype=dtype, device=generator.device)
