"""DropPEFT core of the port, as ``repro.core``.

- ``stld``         — stochastic transformer layer dropout (paper §3.2)
- ``schedules``    — per-layer dropout-rate distributions (paper Fig. 6b)
- ``configurator`` — online bandit for dropout-rate configs (paper §3.3, Alg. 1)
- ``peft``         — LoRA / Adapter / BitFit param partitioning (paper §2.2)
- ``ptls``         — personalized transformer layer sharing (paper §4)
"""
from repro_torch.core import configurator, peft, ptls, schedules, stld

__all__ = ["configurator", "peft", "ptls", "schedules", "stld"]
