"""Learning-rate schedules, as ``repro.optim.schedules`` (float32 arithmetic)."""
from __future__ import annotations

import math

import numpy as np


def make_lr_schedule(kind: str, base_lr: float, warmup_steps: int, total_steps: int):
    """``sched(step) -> lr`` as a Python float holding the float32 value
    that the JAX schedule gives for the same step."""
    if kind not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule {kind!r}")
    f32 = np.float32

    def sched(step) -> float:
        step = f32(step)
        warm = min(f32(1.0), (step + f32(1.0)) / f32(max(warmup_steps, 1)))
        frac = np.clip((step - f32(warmup_steps)) / f32(max(total_steps - warmup_steps, 1)), f32(0.0), f32(1.0))
        if kind == "cosine":
            decay = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * frac, dtype=np.float32))
        elif kind == "linear":
            decay = f32(1.0) - frac
        else:
            decay = f32(1.0)
        return float(f32(base_lr) * warm * decay)

    return sched
