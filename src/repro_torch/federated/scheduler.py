"""The round loop's scheduler, as ``repro.federated.scheduler``: its
``sync`` policy.

``sync`` closes a round when the slowest cohort member finishes: the
lifecycle hooks run in the reference's order and draw the same streams, so
the port's ``SimResult`` follows the reference's round by round.  The
``deadline`` and ``async-buffer`` policies (stragglers dropped or carried,
FedBuff-style buffered aggregation) are configured as in the reference but
not ported (ROADMAP queue 1, item 6): running them raises.  A runner with
a ``checkpoint_dir`` saves every ``checkpoint_every`` rounds, after the
last round and after the round that reaches the target, as the
reference's; ``state_dict`` holds what ``sync`` keeps between rounds (no
job in flight, the event log) in the reference's layout.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple, Union

import numpy as np

_POLICIES = ("sync", "deadline", "async-buffer")
_STRAGGLER = ("drop", "carry")


@dataclass(frozen=True)
class ScheduleConfig:
    """How the scheduler closes aggregation steps."""

    policy: str = "sync"             # sync | deadline | async-buffer
    deadline_s: float = math.inf     # round budget (deadline policy)
    straggler: str = "drop"          # drop | carry (deadline policy)
    buffer_size: int = 0             # K arrivals per aggregation (async; 0 -> cohort/2)
    staleness_alpha: float = 0.0     # w = 1/(1+s)^alpha; 0 = uniform

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown schedule policy {self.policy!r}; one of {_POLICIES}")
        if self.straggler not in _STRAGGLER:
            raise ValueError(f"unknown straggler policy {self.straggler!r}; one of {_STRAGGLER}")
        if not self.deadline_s > 0:
            raise ValueError(f"deadline_s must be positive, got {self.deadline_s}")
        if self.staleness_alpha < 0:
            raise ValueError(f"staleness_alpha must be >= 0, got {self.staleness_alpha}")
        if self.buffer_size < 0:
            raise ValueError(f"buffer_size must be >= 0, got {self.buffer_size}")


def resolve_schedule(schedule: Union[str, ScheduleConfig, None], **overrides) -> ScheduleConfig:
    """Normalize a policy name / config / None into a ScheduleConfig,
    applying any non-None keyword overrides.  With no explicit policy the
    overrides infer one (``deadline_s`` or ``straggler`` -> ``deadline``,
    ``buffer_size`` -> ``async-buffer``), and an override that would be
    dead under ``sync`` raises."""
    kw = {k: v for k, v in overrides.items() if v is not None}
    if schedule is None:
        if "deadline_s" in kw or "straggler" in kw:
            cfg = ScheduleConfig(policy="deadline")
        elif "buffer_size" in kw:
            cfg = ScheduleConfig(policy="async-buffer")
        elif "staleness_alpha" in kw:
            raise ValueError(
                "staleness_alpha has no effect without a straggler-tolerant policy; pass "
                "schedule='deadline' (straggler='carry') or schedule='async-buffer'"
            )
        else:
            cfg = ScheduleConfig()
    elif isinstance(schedule, ScheduleConfig):
        cfg = schedule
    elif isinstance(schedule, str):
        cfg = ScheduleConfig(policy=schedule)
    else:
        raise TypeError(f"schedule must be a name or ScheduleConfig, got {schedule!r}")
    if cfg.policy == "sync" and kw:
        raise ValueError(
            f"scheduling options {sorted(kw)} have no effect under the sync policy; pass "
            "schedule='deadline' or schedule='async-buffer'"
        )
    return replace(cfg, **kw) if kw else cfg


class VirtualClockScheduler:
    """Drives one :class:`~repro_torch.federated.runner.ExperimentRunner`'s
    round loop.  One ``SimResult`` row per aggregation step.
    ``event_log`` records every arrival as ``(round_index, device,
    finish_time)`` in event order (by finish time, ties by device id)."""

    def __init__(self, runner, cfg: Optional[ScheduleConfig] = None):
        self.runner = runner
        self.cfg = cfg or getattr(runner, "schedule", None) or ScheduleConfig()
        if self.cfg.policy != "sync":
            raise NotImplementedError(
                f"schedule policy {self.cfg.policy!r} is not ported (ROADMAP queue 1, item 6); the port runs 'sync'")
        self.event_log: List[Tuple[int, int, float]] = []

    def run(self, rounds: Optional[int] = None, target_accuracy: Optional[float] = None):
        runner = self.runner
        total = rounds or runner.ctx.fed_cfg.rounds
        while runner.state.round_index < total:
            row = self._sync_round(total, target_accuracy)
            hit_target = target_accuracy is not None and row["acc"] >= target_accuracy
            if runner.checkpoint_dir and (runner.state.round_index % runner.checkpoint_every == 0
                                          or runner.state.round_index == total or hit_target):
                runner.save_checkpoint()
            if hit_target:
                break
        return runner.result()

    def _sync_round(self, total: int, target: Optional[float] = None) -> dict:
        """One barrier round, hook for hook."""
        runner, algo = self.runner, self.runner.algorithm
        state = runner.state
        plan = algo.configure_round(state)
        plan.start_pefts = [algo.client_init(state, dev) for dev in plan.cohort]
        state, results = algo.cohort_step(state, plan)
        state, results = algo.compress_uplink(state, results)
        state = algo.aggregate(state, results)
        state, row = algo.report(state, results)
        t0 = runner.state.cum_time
        runner.state = replace(
            state,
            round_index=state.round_index + 1,
            history=state.history + (row,),
            virtual_time=state.cum_time,
            server_version=state.server_version + 1,
        )
        times = np.asarray(results.cost.total_time_s).tolist()
        for t, dev in sorted(zip(times, plan.cohort), key=lambda p: (p[0], p[1])):
            self.event_log.append((plan.round_index, dev, t0 + t))
        return row

    # --------------------------------------------------------- durable state
    def state_dict(self) -> Tuple[list, dict]:
        """``(jobs_arrays, meta)`` as the reference's: ``sync`` keeps no job
        in flight between rounds, so the arrays are empty and the meta holds
        the event log (and the reference's empty fault and retry records)."""
        meta = {
            "jobs": [],
            "event_log": [[int(r), int(d), float(t)] for r, d, t in self.event_log],
            "fault_log": [],
            "backoff": {},
            "fail_count": {},
        }
        return [], meta

    def load_state_dict(self, jobs_arrays: list, meta: dict) -> None:
        """Rebuild the state saved by :meth:`state_dict`."""
        if jobs_arrays or meta.get("jobs"):
            raise ValueError("the checkpoint holds jobs in flight, which only the unported policies keep")
        self.event_log = [(int(r), int(d), float(t)) for r, d, t in meta.get("event_log", [])]
