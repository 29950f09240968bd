"""DropPEFT (the paper's method) and its b1/b2/b3 ablations, as
``repro.federated.algorithms.droppeft``.

DropPEFT = STLD layer dropout during local fine-tuning + the online bandit
dropout-rate configurator (Algorithm 1) + PTLS personalized layer sharing
(Eq. 6 / Fig. 8).  The ablations toggle one component each:

    droppeft_b1 -- without STLD (dropout off; the bandit is moot)
    droppeft_b2 -- without the configurator (fixed dropout rate)
    droppeft_b3 -- without PTLS (plain FedAvg aggregation)
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.configurator import JointConfigurator, OnlineConfigurator
from repro_torch.federated import compression as compression_lib
from repro_torch.federated import server as server_lib
from repro_torch.federated.algorithms.base import FederatedAlgorithm, register
from repro_torch.federated.scheduler import feasible_rate_floor
from repro_torch.federated.state import CohortResults, RoundState


@register("droppeft")
class DropPEFT(FederatedAlgorithm):
    """STLD + bandit configurator + PTLS (paper §3)."""

    stld = True
    use_configurator = True
    use_ptls = True

    def __init__(self, *, stld: Optional[bool] = None, configurator: Optional[bool] = None,
                 ptls: Optional[bool] = None, fixed_rate: Optional[float] = None):
        super().__init__()
        if stld is not None:
            self.stld = stld
        if configurator is not None:
            self.use_configurator = configurator
        if ptls is not None:
            self.use_ptls = ptls
        if fixed_rate is not None:
            self.fixed_rate = fixed_rate

    def build_configurator(self, ctx):
        # the bandit only exists when there is a dropout rate to tune
        if not (self.use_configurator and self.stld):
            return None
        fed = ctx.fed_cfg
        kwargs = dict(rate_grid=fed.rate_grid, num_candidates=fed.num_candidates, explore_rate=fed.explore_rate,
                      explore_interval=fed.explore_interval, window_size=fed.window_size, seed=ctx.seed)
        comp = getattr(ctx, "compression", None)
        if comp is not None and comp.tune:
            # the joint (dropout rate x compression level) arms; the rewards
            # come from the modelled round times, which bill the compressed
            # uplink
            cfgor = JointConfigurator(levels=compression_lib.LEVELS, **kwargs)
        else:
            cfgor = OnlineConfigurator(**kwargs)
        # under a finite deadline, rates the slowest profile can never
        # finish in time are infeasible arms: floor the candidates there
        sched = getattr(ctx, "schedule", None)
        if sched is not None and sched.policy == "deadline" and math.isfinite(sched.deadline_s):
            cfgor.set_rate_floor(feasible_rate_floor(
                ctx.system, ctx.device_profile, sched.deadline_s, rate_grid=fed.rate_grid, batch=fed.batch_size,
                seq=ctx.task.seq_len, local_steps=fed.local_steps,
            ))
        return cfgor

    def client_init(self, state: RoundState, dev: int):
        """Shared layers from the global model; personalized layers local."""
        if dev not in state.device_peft or not self.use_ptls:
            return state.global_peft
        own = state.device_peft[dev]
        mask = state.last_mask.get(dev)
        if mask is None:
            return state.global_peft
        shared = np.asarray(mask, dtype=bool)  # a host row of the last round's masks
        if isinstance(state.global_peft, (list, tuple)):
            return [g if s else o for g, o, s in zip(state.global_peft, own, shared.tolist())]
        return server_lib.select_layers(shared, state.global_peft, own)

    def compute_masks(self, state: RoundState, results: CohortResults):
        if not self.use_ptls:
            return super().compute_masks(state, results)
        fed, cfg = self.ctx.fed_cfg, self.ctx.cfg
        k = max(1, int(fed.ptls_share_fraction * cfg.num_layers))
        importances = torch.from_numpy(np.stack([np.asarray(imp) for imp in results.importances]))
        return server_lib.cohort_shared_masks(importances, k).numpy()

    def merge(self, state: RoundState, results: CohortResults):
        if not self.use_ptls:
            return super().merge(state, results)
        # the deadline and async schedules may set staleness weights; None
        # keeps the unweighted PTLS masked mean
        weights = None if results.weights is None else np.asarray(results.weights)
        return server_lib.ptls_aggregate(self._merge_trees(results), results.masks, state.global_peft,
                                         weights=weights)

    def feedback(self, state: RoundState, results: CohortResults, round_times):
        if state.configurator is None:
            return
        gains = []
        for i, dev in enumerate(results.plan.cohort):
            prev = state.prev_acc.get(dev, 1.0 / self.ctx.task.num_classes)
            gains.append(max(results.accuracies[i] - prev, 0.0))
        cfgor = state.configurator
        if getattr(cfgor, "joint", False) and results.plan.compression is not None:
            cfgor.report(list(zip([float(r) for r in results.plan.rates], results.plan.compression)), gains,
                         round_times)
        else:
            cfgor.report(results.plan.rates, gains, round_times)


@register("droppeft_b1")
class DropPEFTNoSTLD(DropPEFT):
    """Ablation b1: no layer dropout (and therefore no rate bandit)."""

    stld = False


@register("droppeft_b2")
class DropPEFTFixedRate(DropPEFT):
    """Ablation b2: fixed dropout rate instead of the online configurator."""

    use_configurator = False


@register("droppeft_b3")
class DropPEFTNoPTLS(DropPEFT):
    """Ablation b3: plain FedAvg aggregation instead of PTLS."""

    use_ptls = False
