"""Round-loop state containers, as ``repro.federated.state``.

:class:`RoundState` is the immutable value threaded through every lifecycle
hook of a :class:`~repro_torch.federated.algorithms.FederatedAlgorithm`:
hooks return a new one (``dataclasses.replace``) and never mutate a state.
The PEFT trees and the error-feedback residuals of a compressed uplink are
tensors on the device; the rest is host bookkeeping (the round counters,
the numpy generator of cohorts and bandwidths, the bandit, the metric
history).

``key`` is the seed of the round's torch generators (STLD gates): an int,
split by :func:`split_key` as the reference splits its PRNG key (one
fan-out per round, one generator per device), and never drawn from
``rng``, whose numpy stream stays the reference's draw for draw.

:class:`RoundPlan` is what ``configure_round`` decides; :class:`CohortResults`
carries the per-device outputs of ``cohort_step`` plus what later hooks
attach (share masks, system-model costs).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

_KEY_BOUND = 2**62


def split_key(key: int, n: int) -> List[int]:
    """``n`` new keys from ``key``: seeds drawn from a CPU generator seeded
    with ``key`` (a pure function of ``key``)."""
    gen = torch.Generator().manual_seed(int(key))
    return [int(k) for k in torch.randint(_KEY_BOUND, (n,), generator=gen, dtype=torch.int64)]


@dataclass(frozen=True)
class RoundState:
    """Immutable snapshot of a federated experiment between rounds."""

    key: int                                  # seed of the round's torch generators
    global_peft: Any                          # server-side PEFT tree
    device_peft: Dict[int, Any] = field(default_factory=dict)
    last_mask: Dict[int, Any] = field(default_factory=dict)   # PTLS share masks
    ef_residual: Dict[int, Any] = field(default_factory=dict)  # EF residual trees (float32)
    round_index: int = 0
    global_step: int = 0                      # LR-schedule offset
    cum_time: float = 0.0                     # simulated wall-clock (s)
    virtual_time: float = 0.0                 # scheduler clock (== cum_time in sync)
    server_version: int = 0                   # aggregations applied (staleness base)
    prev_acc: Dict[int, float] = field(default_factory=dict)
    rng: Any = None                           # numpy Generator (cohorts, bandwidth)
    configurator: Any = None                  # OnlineConfigurator | None
    history: Tuple[dict, ...] = ()            # one metrics row per finished round


@dataclass
class RoundPlan:
    """What ``configure_round`` decided for one round."""

    round_index: int
    cohort: List[int]
    rates: List[float]                 # per-device mean dropout rates
    adaopt_depth: int                  # progressive depth (== num_layers when off)
    start_pefts: Optional[list] = None # filled by the scheduler via client_init
    compression: Optional[List[str]] = None  # per-device uplink levels | None


@dataclass
class CohortResults:
    """Per-device outputs of one trained cohort, in cohort order."""

    plan: RoundPlan
    pefts: list                        # updated PEFT trees
    metrics: list                      # per-device dicts (loss/accuracy/...), on the host
    importances: list                  # PTLS layer importances, on the host
    accuracies: List[float]            # local-val accuracy after the round
    masks: Any = None                  # (N, L) bool share masks (aggregate)
    cost: Any = None                   # SystemModel CohortCost (report)
    staleness: Any = None              # (N,) int server-version lag (async/carry)
    weights: Any = None                # (N,) staleness aggregation weights | None
    uplink_pefts: Optional[list] = None  # server-side reconstructions (merge)
    uplink_ratio: Any = None           # (N,) compressed/fp32 uplink factor | None
