"""Federated-PEFT baselines from the paper's evaluation (§6), as
``repro.federated.algorithms.baselines``.

    FedLoRA / FedAdapter -- vanilla federated PEFT (FedAvg, full depth)
    FedHetLoRA           -- rank-heterogeneous LoRA (not ported: it raises
                            at ``bind``, ROADMAP queue 1, item 6)
    FedAdaOPT            -- progressive-depth adapter training
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.federated.algorithms.base import FederatedAlgorithm, register
from repro_torch.federated.state import RoundState


@register("fedlora")
class FedLoRA(FederatedAlgorithm):
    """Vanilla federated LoRA: FedAvg over homogeneous client trees."""


@register("fedadapter")
class FedAdapter(FederatedAlgorithm):
    """Vanilla federated adapters (the same loop; the PEFT kind comes from
    the config, and the port's PEFT is LoRA)."""


@register("fedhetlora")
class FedHetLoRA(FederatedAlgorithm):
    """Rank-heterogeneous LoRA matched to device tiers.  Its sequential
    cohort, ``hetlora_aggregate`` and ``truncate_lora_rank`` are not ported
    (ROADMAP queue 1, item 6, of which hetlora and the joint bandit are
    left): binding it raises."""

    requires_sequential = True
    hetlora_ranks = (4, 8, 16)

    def __init__(self, *, ranks: Optional[Sequence[int]] = None):
        super().__init__()
        if ranks is not None:
            self.hetlora_ranks = tuple(ranks)

    def bind(self, ctx):
        raise NotImplementedError("fedhetlora is not ported (ROADMAP queue 1, item 6; left of it: hetlora's "
                                  "sequential cohort, hetlora_aggregate and truncate_lora_rank, and the joint "
                                  "bandit)")


@register("fedadaopt")
class FedAdaOPT(FederatedAlgorithm):
    """Progressive-depth adapters: start shallow, grow the trainable depth
    by two layers every ``adaopt_grow_every`` rounds; updates beyond the
    active depth are discarded before evaluation."""

    adaopt_grow_every = 5

    def __init__(self, *, grow_every: Optional[int] = None):
        super().__init__()
        if grow_every is not None:
            self.adaopt_grow_every = grow_every

    def active_depth(self, state: RoundState) -> int:
        return min(self.ctx.cfg.num_layers, 2 + (state.round_index // self.adaopt_grow_every) * 2)
