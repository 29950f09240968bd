"""Online exploration-exploitation configurator for dropout rates.

A copy of ``repro.core.configurator``'s rate bandit (the paper's Algorithm
1) and its joint (rate x compression level) variant, pure Python and
numpy: the same seed and the same rewards give the same arms, round by
round, and the same ``state_dict``.

* the action space is narrowed per §3.3: a preset per-layer distribution
  shape (default ``incremental``) plus a discrete grid of average rates,
  so an "arm" is the scalar mean rate;
* reward of an arm = accuracy gain per unit wall-clock time, R = dA / T
  (Eq. 5), averaged over the devices that evaluated it;
* phases alternate: one EXPLORATION sweep evaluates every candidate in
  ``list_c`` (start-up list + ``n*eps`` random arms), keeps the top
  ``n*(1-eps)`` by reward within a sliding window of the latest ``size_w``
  evaluations, then EXPLOITATION reuses the best-known arm for
  ``explore_interval`` rounds.

:class:`JointConfigurator` keys its arms by ``(rate, level)`` pairs over
the product of the rate grid and the uplink compression levels.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


_ARM_MEMORY = 3  # recent evaluations kept per arm (staleness, paper Line 12)


@dataclass
class ArmStats:
    rate: float
    rewards: List[float] = field(default_factory=list)
    last_eval: int = -1  # round index of last evaluation (staleness)

    def add(self, r: float):
        self.rewards.append(r)
        del self.rewards[:-_ARM_MEMORY]  # keep only recent evidence

    @property
    def reward(self) -> float:
        if not self.rewards:
            return float("-inf")
        return sum(self.rewards) / len(self.rewards)


class OnlineConfigurator:
    """Algorithm 1.  ``next_round()`` -> list of mean rates (one per device);
    ``report(rates, acc_gains, times)`` feeds back rewards."""

    def __init__(
        self,
        rate_grid: Sequence[float] = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
        startup: Sequence[float] = (0.2, 0.5, 0.7),
        num_candidates: int = 4,
        explore_rate: float = 0.3,
        explore_interval: int = 5,
        window_size: int = 8,
        seed: int = 0,
        rate_floor: float = 0.0,
    ):
        self.rate_grid = list(rate_grid)
        self.num_candidates = num_candidates
        self.explore_rate = explore_rate
        self.explore_interval = explore_interval
        self.window_size = window_size
        self.rate_floor = float(rate_floor)
        self._rng = random.Random(seed)
        self.arms: Dict[float, ArmStats] = {}
        self.list_c: List[float] = [r for r in startup if r >= self.rate_floor]
        self.history: List[float] = []  # evaluation order (for staleness)
        self.is_explore = True
        self._exploit_rounds_left = 0
        self._round = 0

    # ------------------------------------------------------------------ api
    def next_round(self, n_devices: int, *, as_array: bool = False):
        """Dropout mean-rates for this round's cohort.

        ``as_array=True`` returns an (N,) float32 vector ready to feed the
        batched cohort engine; otherwise a plain python list.  ``report``
        accepts either form back (float32 round-trips snap to their arms).
        """
        if self.is_explore:
            if not self.list_c:
                self._refill_candidates()
            # evaluate candidates in parallel across the cohort: round-robin
            rates = [self.list_c[i % len(self.list_c)] for i in range(n_devices)]
        else:
            rates = [self.best_rate()] * n_devices
        self._pending = sorted(set(rates))
        if as_array:
            return np.asarray(rates, dtype=np.float32)
        return rates

    def report(self, rates: Sequence[float], acc_gains: Sequence[float], times: Sequence[float]):
        """Per-device rewards R = dA / T (Eq. 5).

        Accepts python lists or numpy vectors (a float32 vector of rates
        comes back as its arms); rates are snapped to their exact arm keys so a
        float32 round-trip cannot mint duplicate arms.
        """
        rates = self._report_keys(rates)
        acc_gains = [float(g) for g in np.asarray(acc_gains).ravel()]
        times = [float(t) for t in np.asarray(times).ravel()]
        self._round += 1
        for r, da, t in zip(rates, acc_gains, times):
            arm = self.arms.setdefault(r, ArmStats(rate=r))
            arm.add(da / max(t, 1e-9))
            arm.last_eval = self._round
            self.history.append(r)
        # sliding window: discard overly stale arms (Line 12), but never the
        # current best — exploitation must always have its winner to return
        best = self.best_rate() if self.arms else None
        recent = set(self.history[-self.window_size * max(1, len(self._pending)) :])
        for r in list(self.arms):
            if r == best:
                continue
            if r not in recent and self.arms[r].last_eval < self._round - self.window_size:
                del self.arms[r]

        if self.is_explore:
            for r in self._pending:
                if r in self.list_c:
                    self.list_c.remove(r)
            if not self.list_c:  # exploration sweep finished -> exploit winner
                self._keep_top_candidates()
                self.is_explore = False
                self._exploit_rounds_left = self.explore_interval
        else:
            self._exploit_rounds_left -= 1
            if self._exploit_rounds_left <= 0:
                self.is_explore = True
                self._refill_candidates()

    def best_rate(self) -> float:
        """Highest-reward arm at or above the rate floor.

        With no evidence yet, falls back to the feasible grid rate closest
        to 0.5 (exactly 0.5 on the default grid, preserving the historical
        default)."""
        eligible = [a for a in self.arms.values() if self._meets_floor(a.rate)]
        if not eligible:
            return self._fallback_key(self._feasible_grid())
        return max(eligible, key=lambda a: a.reward).rate

    def set_rate_floor(self, floor: float) -> None:
        """Deadline-aware mode: restrict candidate rates to ``>= floor``.

        The virtual-clock scheduler computes the floor as the smallest grid
        rate whose predicted slowest-profile round time fits the deadline —
        rates below it would always be cut off and waste exploration
        rounds.  Existing below-floor arms stop being selected and age out
        through the regular window eviction like any other idle arm."""
        self.rate_floor = float(floor)
        self.list_c = [r for r in self.list_c if self._meets_floor(r)]
        if not self.list_c:
            self._refill_candidates()

    # ------------------------------------------------------- serialization
    def state_dict(self) -> dict:
        """JSON-serializable snapshot; restoring it resumes the bandit's
        explore/exploit schedule and python RNG stream bit-exactly."""
        return {
            "arms": [
                {"rate": a.rate, "rewards": list(a.rewards), "last_eval": a.last_eval}
                for a in self.arms.values()
            ],
            "list_c": list(self.list_c),
            "history": list(self.history),
            "rate_floor": self.rate_floor,
            "is_explore": self.is_explore,
            "exploit_rounds_left": self._exploit_rounds_left,
            "round": self._round,
            "pending": list(getattr(self, "_pending", [])),
            "has_pending": hasattr(self, "_pending"),
            "rng_state": list(self._rng.getstate()),
        }

    def load_state_dict(self, state: dict) -> None:
        self.arms = {}
        for a in state["arms"]:
            key = self._key_from_json(a["rate"])
            self.arms[key] = ArmStats(
                rate=key, rewards=list(a["rewards"]), last_eval=a["last_eval"]
            )
        self.list_c = [self._key_from_json(k) for k in state["list_c"]]
        self.history = [self._key_from_json(k) for k in state["history"]]
        self.rate_floor = float(state.get("rate_floor", 0.0))
        self.is_explore = state["is_explore"]
        self._exploit_rounds_left = state["exploit_rounds_left"]
        self._round = state["round"]
        if state.get("has_pending", True):
            self._pending = [self._key_from_json(k) for k in state["pending"]]
        elif hasattr(self, "_pending"):
            del self._pending  # snapshot predates the first next_round
        rng_state = state["rng_state"]
        self._rng.setstate((rng_state[0], tuple(rng_state[1]), rng_state[2]))

    # ------------------------------------------------------------- internals
    # small arm-key hooks so a subclass can swap the key type (the joint
    # configurator keys arms by (rate, level) tuples) without touching the
    # explore/exploit machinery, which is key-agnostic
    def _meets_floor(self, key) -> bool:
        return key >= self.rate_floor

    def _fallback_key(self, grid):
        return min(grid, key=lambda r: abs(r - 0.5)) if grid else 0.5

    def _report_keys(self, rates) -> list:
        return [self._snap_rate(float(r)) for r in np.asarray(rates).ravel()]

    def _key_from_json(self, key):
        return key

    def _snap_rate(self, r: float) -> float:
        """Map a (possibly float32-degraded) rate back to its exact arm key."""
        candidates = set(self.rate_grid) | set(self.arms) | set(self.list_c) | set(
            getattr(self, "_pending", ())
        )
        if not candidates:
            return r
        best = min(candidates, key=lambda c: abs(c - r))
        return best if abs(best - r) < 1e-5 else r

    def _feasible_grid(self) -> List[float]:
        grid = [r for r in self.rate_grid if r >= self.rate_floor]
        return grid or ([max(self.rate_grid)] if self.rate_grid else [])

    def _refill_candidates(self):
        n_explore = max(1, int(self.num_candidates * self.explore_rate))
        grid = self._feasible_grid()
        fresh = [r for r in grid if r not in self.arms]
        self._rng.shuffle(fresh)
        new = fresh[:n_explore]
        if not new and grid:  # grid exhausted: resample anywhere feasible
            new = [self._rng.choice(grid) for _ in range(n_explore)]
        top = self._top_rates(self.num_candidates - len(new))
        self.list_c = list(dict.fromkeys(new + top)) or [self.best_rate()]

    def _keep_top_candidates(self):
        keep = max(1, int(self.num_candidates * (1.0 - self.explore_rate)))
        self.list_c = self._top_rates(keep) or [self.best_rate()]

    def _top_rates(self, k: int) -> List[float]:
        eligible = [a for a in self.arms.values() if self._meets_floor(a.rate)]
        ranked = sorted(eligible, key=lambda a: a.reward, reverse=True)
        return [a.rate for a in ranked[:k]]


class JointConfigurator(OnlineConfigurator):
    """Algorithm 1 over the joint (dropout rate x compression level) space.

    The arm is a ``(rate, level)`` tuple, so the bandit trades layer dropout
    against uplink compression on one reward: accuracy gain per modelled
    second of the round, which already bills the compressed uplink.  The
    explore/exploit machinery is inherited; the arm key, the candidate
    grid (the product of rates and levels) and the report and snap plumbing
    change.  ``rate_floor`` constrains the rate axis alone.
    """

    joint = True

    def __init__(
        self,
        rate_grid: Sequence[float] = (0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9),
        startup: Sequence[float] = (0.2, 0.5, 0.7),
        levels: Sequence[str] = ("none", "int8", "topk", "int8+topk"),
        **kwargs,
    ):
        self.levels = tuple(levels)
        if not self.levels:
            raise ValueError("JointConfigurator needs at least one level")
        super().__init__(rate_grid=rate_grid, startup=startup, **kwargs)
        # each startup rate paired with a cycling level: the first sweep is
        # as long as the rate-only bandit's, and _refill_candidates explores
        # the rest of the product grid in later sweeps
        self.list_c = [
            (float(r), self.levels[i % len(self.levels)])
            for i, r in enumerate(startup)
            if float(r) >= self.rate_floor
        ]

    # ------------------------------------------------------------------ api
    def next_round(self, n_devices: int, *, as_array: bool = False):
        raise TypeError("JointConfigurator draws (rate, level) arms; use next_round_joint()")

    def next_round_joint(self, n_devices: int):
        """-> (rates, levels): one (dropout rate, compression level) arm per
        cohort member, round-robin over the candidates while exploring."""
        if self.is_explore:
            if not self.list_c:
                self._refill_candidates()
            arms = [self.list_c[i % len(self.list_c)] for i in range(n_devices)]
        else:
            arms = [self.best_rate()] * n_devices
        self._pending = sorted(set(arms))
        return [float(rate) for rate, _ in arms], [level for _, level in arms]

    # ------------------------------------------------------- serialization
    def state_dict(self) -> dict:
        state = super().state_dict()
        state["joint"] = True
        state["levels"] = list(self.levels)
        return state

    # ------------------------------------------------------------- internals
    def _meets_floor(self, key) -> bool:
        return key[0] >= self.rate_floor

    def _fallback_key(self, grid):
        if not grid:
            return (0.5, self.levels[0])
        # the rate closest to 0.5 at the mildest level
        return min(grid, key=lambda ar: (abs(ar[0] - 0.5), self.levels.index(ar[1])))

    def _report_keys(self, arms) -> list:
        return [self._snap_arm((float(r), str(lv))) for r, lv in arms]

    def _key_from_json(self, key):
        # JSON gives tuples back as lists
        if isinstance(key, (list, tuple)):
            return (float(key[0]), str(key[1]))
        return key

    def _snap_arm(self, arm):
        rate, level = arm
        candidates = [
            k
            for k in (set(self._feasible_grid()) | set(self.arms) | set(self.list_c)
                      | set(getattr(self, "_pending", ())))
            if k[1] == level
        ]
        if not candidates:
            return arm
        best = min(candidates, key=lambda k: abs(k[0] - rate))
        return best if abs(best[0] - rate) < 1e-5 else arm

    def _feasible_grid(self) -> list:
        rates = [r for r in self.rate_grid if r >= self.rate_floor]
        if not rates:
            rates = [max(self.rate_grid)] if self.rate_grid else []
        return [(float(r), lv) for r in rates for lv in self.levels]
