"""Deterministic fault injection for the virtual-clock scheduler, a
numpy-only copy of ``repro.federated.faults``.

* :class:`FaultPlan` — a frozen, JSON-serializable description of which
  faults fire with what probability or schedule, plus the retry policy.
* :class:`FaultInjector` — the plan's executor.  Every draw is keyed by
  ``(plan.seed, fault kind, dispatch round, device)`` through its own
  ``numpy`` bit generator, so outcomes are a pure function of the plan and
  the dispatch coordinates (independent of draw order and cohort mode),
  and they are the reference's draw for draw.
* :class:`ServerKilled` — raised by the scheduler after the checkpoint at
  a planned kill round; a runner rebuilt with ``resume=True`` continues
  bit-exactly.

Fault semantics (threaded through
:class:`~repro_torch.federated.scheduler.VirtualClockScheduler`):

* **client dropout** — the device completes a random fraction of its local
  round and vanishes: its update never aggregates, the burned compute,
  energy and partial traffic are billed, and it re-enters the dispatch
  pool after an exponential virtual-time backoff.
* **bandwidth collapse** — the uplink slows by
  ``bandwidth_collapse_factor``; the update arrives late but intact.
* **NaN update** — the update arrives on time but non-finite; the
  scheduler's screen rejects it.
* **device churn** — a device cannot be dispatched inside
  ``[t_leave, t_rejoin)`` virtual-time windows.
* **server kill** — :class:`ServerKilled` after the checkpoint at the
  planned round.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional, Tuple

import numpy as np

__all__ = ["FaultPlan", "FaultInjector", "ServerKilled"]


class ServerKilled(RuntimeError):
    """Simulated server crash (``FaultPlan.kill_at_rounds``).

    Raised *after* the round's checkpoint is durably on disk, so the drill
    is exactly a production restart: rebuild the runner with
    ``resume=True`` and the run continues bit-identically to one that was
    never killed.
    """


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, declarative description of every fault a run will see.

    All probabilities are per dispatched job.  ``nan_updates`` pins
    corruptions to exact ``(dispatch_round, device)`` coordinates on top of
    the probabilistic ``nan_update_prob``.  ``churn`` rows are
    ``(device, t_leave, t_rejoin)`` virtual-time unavailability windows.
    A default-constructed plan (``FaultPlan()``) injects nothing and is
    bit-transparent: attaching it must not change any result array.
    """

    seed: int = 0
    dropout_prob: float = 0.0
    dropout_frac: Tuple[float, float] = (0.3, 0.9)   # completed fraction range
    bandwidth_collapse_prob: float = 0.0
    bandwidth_collapse_factor: float = 8.0           # comm-time multiplier
    nan_update_prob: float = 0.0
    nan_updates: Tuple[Tuple[int, int], ...] = ()    # (dispatch_round, device)
    churn: Tuple[Tuple[int, float, float], ...] = () # (device, t_leave, t_rejoin)
    kill_at_rounds: Tuple[int, ...] = ()             # ServerKilled after ckpt
    retry_backoff_s: float = 30.0                    # first-retry virtual delay
    max_backoff_s: float = 600.0                     # exponential backoff cap

    def __post_init__(self):
        for name in ("dropout_prob", "bandwidth_collapse_prob", "nan_update_prob"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {p}")
        lo, hi = self.dropout_frac
        if not (0.0 < lo <= hi <= 1.0):
            raise ValueError(
                f"dropout_frac must satisfy 0 < lo <= hi <= 1, got {self.dropout_frac}"
            )
        if self.bandwidth_collapse_factor < 1.0:
            raise ValueError(
                f"bandwidth_collapse_factor must be >= 1, "
                f"got {self.bandwidth_collapse_factor}"
            )
        if self.retry_backoff_s <= 0 or self.max_backoff_s < self.retry_backoff_s:
            raise ValueError(
                "need 0 < retry_backoff_s <= max_backoff_s, got "
                f"{self.retry_backoff_s}/{self.max_backoff_s}"
            )
        # normalize JSON-loaded lists into hashable tuples
        object.__setattr__(self, "dropout_frac", tuple(self.dropout_frac))
        object.__setattr__(
            self, "nan_updates", tuple(tuple(x) for x in self.nan_updates)
        )
        object.__setattr__(self, "churn", tuple(tuple(x) for x in self.churn))
        object.__setattr__(self, "kill_at_rounds", tuple(self.kill_at_rounds))

    @property
    def any_faults(self) -> bool:
        return bool(
            self.dropout_prob
            or self.bandwidth_collapse_prob
            or self.nan_update_prob
            or self.nan_updates
            or self.churn
            or self.kill_at_rounds
        )

    # ------------------------------------------------------------- (de)serde
    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls(**json.loads(text))

    @classmethod
    def from_file(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(f.read())


def resolve_fault_plan(plan) -> Optional[FaultPlan]:
    """Normalize None | FaultPlan | dict | JSON-file path into a plan."""
    if plan is None or isinstance(plan, FaultPlan):
        return plan
    if isinstance(plan, dict):
        return FaultPlan(**plan)
    if isinstance(plan, str):
        return FaultPlan.from_file(plan)
    raise TypeError(
        f"fault_plan must be a FaultPlan, dict, or JSON path, got {plan!r}"
    )


# Distinct substream per fault kind so e.g. enabling bandwidth collapse
# cannot shift which devices drop out under the same seed.
_KIND = {"dropout": 1, "dropout_frac": 2, "bandwidth": 3, "nan": 4}


@dataclass
class FaultInjector:
    """Executes a :class:`FaultPlan` with order-independent randomness."""

    plan: FaultPlan
    _nan_set: frozenset = field(init=False)

    def __post_init__(self):
        self._nan_set = frozenset(self.plan.nan_updates)

    def _u(self, kind: str, round_index: int, dev: int) -> float:
        """One uniform draw, a pure function of (seed, kind, round, dev)."""
        rng = np.random.default_rng(
            (self.plan.seed, _KIND[kind], round_index, dev)
        )
        return float(rng.random())

    # -------------------------------------------------------- per-fault API
    def dropout_at(self, round_index: int, dev: int) -> Optional[float]:
        """Completed-fraction of the job if the client drops, else None."""
        p = self.plan.dropout_prob
        if p <= 0.0 or self._u("dropout", round_index, dev) >= p:
            return None
        lo, hi = self.plan.dropout_frac
        return lo + (hi - lo) * self._u("dropout_frac", round_index, dev)

    def bandwidth_factor_at(self, round_index: int, dev: int) -> float:
        p = self.plan.bandwidth_collapse_prob
        if p > 0.0 and self._u("bandwidth", round_index, dev) < p:
            return self.plan.bandwidth_collapse_factor
        return 1.0

    def corrupts(self, round_index: int, dev: int) -> bool:
        if (round_index, dev) in self._nan_set:
            return True
        p = self.plan.nan_update_prob
        return p > 0.0 and self._u("nan", round_index, dev) < p

    def unavailable(self, dev: int, t: float) -> bool:
        """Is ``dev`` churned out of the population at virtual time ``t``?"""
        return any(
            d == dev and t_leave <= t < t_rejoin
            for d, t_leave, t_rejoin in self.plan.churn
        )

    def next_rejoin(self, dev: int, t: float) -> Optional[float]:
        """Earliest rejoin instant > ``t`` for a currently-churned device."""
        times = [
            t_rejoin
            for d, t_leave, t_rejoin in self.plan.churn
            if d == dev and t_leave <= t < t_rejoin
        ]
        return min(times) if times else None

    def kills_after(self, round_index: int) -> bool:
        return round_index in self.plan.kill_at_rounds

    def backoff_s(self, consecutive_failures: int) -> float:
        """Exponential virtual-time backoff for the n-th consecutive
        failure of one device (n >= 1), capped at ``max_backoff_s``."""
        return min(
            self.plan.retry_backoff_s * (2.0 ** (consecutive_failures - 1)),
            self.plan.max_backoff_s,
        )
