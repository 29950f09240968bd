"""Federated-PEFT baselines from the paper's evaluation (§6), as
``repro.federated.algorithms.baselines``.

    FedLoRA / FedAdapter -- vanilla federated PEFT (FedAvg, full depth)
    FedHetLoRA           -- rank-heterogeneous LoRA matched to device tiers
    FedAdaOPT            -- progressive-depth adapter training
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import peft as peft_lib
from repro_torch.federated import server as server_lib
from repro_torch.federated.algorithms.base import FederatedAlgorithm, register
from repro_torch.federated.state import CohortResults, RoundState
from repro_torch.models.stacking import tree_map


@register("fedlora")
class FedLoRA(FederatedAlgorithm):
    """Vanilla federated LoRA: FedAvg over homogeneous client trees."""


@register("fedadapter")
class FedAdapter(FederatedAlgorithm):
    """Vanilla federated adapters (the same loop; the PEFT kind comes from
    ``peft_cfg.method``)."""


@register("fedhetlora")
class FedHetLoRA(FederatedAlgorithm):
    """Rank-heterogeneous LoRA: each device trains at the rank its hardware
    tier affords (``tx2``, ``nx``, ``agx``: ``hetlora_ranks``); the server
    zero-pads to the largest rank and aggregates by rank share.  Trees of
    different ranks cannot share a device axis, so the cohort runs
    sequentially."""

    requires_sequential = True
    hetlora_ranks = (4, 8, 16)

    def __init__(self, *, ranks: Optional[Sequence[int]] = None):
        super().__init__()
        if ranks is not None:
            self.hetlora_ranks = tuple(ranks)

    def bind(self, ctx):
        """The device ranks from the tiers, and the global tree drawn anew
        at the largest rank from the context's PEFT seed (on the CPU, then
        placed, as the runner draws its tree)."""
        super().bind(ctx)
        tiers = {"tx2": 0, "nx": 1, "agx": 2}
        self.device_rank = [self.hetlora_ranks[tiers[p]] for p in ctx.device_profile]
        self.max_rank = max(self.hetlora_ranks)
        peft_cfg = dataclasses.replace(ctx.peft_cfg, lora_rank=self.max_rank)
        tree = peft_lib.init_peft(ctx.cfg, peft_cfg, torch.Generator().manual_seed(ctx.peft_key))
        return tree_map(lambda t: t.to(ctx.device), tree)

    def client_init(self, state: RoundState, dev: int):
        return server_lib.truncate_lora_rank(state.global_peft, self.device_rank[dev])

    def merge(self, state: RoundState, results: CohortResults):
        client_ranks = [self.device_rank[dev] for dev in results.plan.cohort]
        # the deadline and async schedules' staleness weights multiply the rank shares
        return server_lib.hetlora_aggregate(self._merge_trees(results), client_ranks, self.max_rank,
                                            extra_weights=results.weights)


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
