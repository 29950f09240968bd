"""Deprecated flag-table shim over the hook-based federated algorithm API,
as ``repro.federated.simulator``.

It keeps the legacy surface importable: :class:`Strategy` (the old boolean
flag table), ``METHODS`` (one entry per method of the reference's table) and
:class:`FederatedSimulator`, which emits a :class:`DeprecationWarning` and
delegates to :class:`~repro_torch.federated.runner.ExperimentRunner`.  New
code should use :func:`repro_torch.api.experiment`::

    from repro_torch import api
    result = api.experiment(method="droppeft", rounds=10, seed=0)
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.federated.algorithms import DropPEFT, FedAdaOPT, FederatedAlgorithm, FedHetLoRA
from repro_torch.federated.runner import ExperimentRunner, SimResult

__all__ = ["Strategy", "METHODS", "SimResult", "FederatedSimulator", "algorithm_from_strategy"]


@dataclass
class Strategy:
    """Deprecated flag table describing a paper method or ablation; the
    flags map onto a registered algorithm through
    :func:`algorithm_from_strategy`."""

    name: str = "droppeft"
    stld: bool = True
    configurator: bool = True
    ptls: bool = True
    fixed_rate: float = 0.5          # used when configurator is off
    hetlora: bool = False            # FedHetLoRA baseline
    hetlora_ranks: tuple = (4, 8, 16)
    adaopt: bool = False             # FedAdaOPT progressive-depth baseline
    adaopt_grow_every: int = 5


METHODS: Dict[str, Strategy] = {
    "fedlora": Strategy("fedlora", stld=False, configurator=False, ptls=False),
    "fedadapter": Strategy("fedadapter", stld=False, configurator=False, ptls=False),
    "fedhetlora": Strategy("fedhetlora", stld=False, configurator=False, ptls=False, hetlora=True),
    "fedadaopt": Strategy("fedadaopt", stld=False, configurator=False, ptls=False, adaopt=True),
    "droppeft": Strategy("droppeft"),
    "droppeft_b1": Strategy("droppeft_b1", stld=False),            # w/o STLD
    "droppeft_b2": Strategy("droppeft_b2", configurator=False),    # fixed rate
    "droppeft_b3": Strategy("droppeft_b3", ptls=False),            # w/o PTLS
}


def algorithm_from_strategy(strategy: Strategy) -> FederatedAlgorithm:
    """Map a legacy flag table onto an algorithm instance."""
    if strategy.hetlora:
        algo: FederatedAlgorithm = FedHetLoRA(ranks=strategy.hetlora_ranks)
    elif strategy.adaopt:
        algo = FedAdaOPT(grow_every=strategy.adaopt_grow_every)
    else:
        # DropPEFT with every component toggleable covers the whole
        # homogeneous-rank, full-depth method family (FedLoRA and FedAdapter too)
        algo = DropPEFT(stld=strategy.stld, configurator=strategy.configurator, ptls=strategy.ptls,
                        fixed_rate=strategy.fixed_rate)
    algo.name = strategy.name
    return algo


class FederatedSimulator:
    """Deprecated: construct experiments through :mod:`repro_torch.api`
    instead.  Delegates to :class:`ExperimentRunner` on ``device`` (None =
    the card)."""

    def __init__(self, cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, *, strategy: "Strategy | str" = "droppeft",
                 task=None, cost_cfg=None, seed: int = 0, cohort_mode: str = "auto", device=None):
        warnings.warn("FederatedSimulator is deprecated; use repro_torch.api.experiment(...) "
                      "or repro_torch.federated.runner.ExperimentRunner", DeprecationWarning, stacklevel=2)
        self.strategy = METHODS[strategy] if isinstance(strategy, str) else strategy
        self._runner = ExperimentRunner(cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg,
                                        algorithm=algorithm_from_strategy(self.strategy), task=task,
                                        cost_cfg=cost_cfg, seed=seed, cohort_mode=cohort_mode, device=device)

    def run(self, rounds: Optional[int] = None, target_accuracy: Optional[float] = None) -> SimResult:
        return self._runner.run(rounds=rounds, target_accuracy=target_accuracy)

    # legacy attribute surface, delegated to the runner
    @property
    def runner(self) -> ExperimentRunner:
        return self._runner

    @property
    def cohort_mode(self) -> str:
        return self._runner.cohort_mode

    @property
    def task(self):
        return self._runner.ctx.task

    @property
    def devices(self):
        return self._runner.ctx.devices

    @property
    def global_peft(self):
        return self._runner.state.global_peft

    @property
    def device_peft(self):
        return self._runner.state.device_peft
