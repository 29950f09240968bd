"""Event-driven virtual-clock scheduler, as ``repro.federated.scheduler``.

A priority queue of device-completion events, driven by
``SystemModel.cohort_round_cost``, behind one :class:`ScheduleConfig`:

* ``sync`` — the round closes when the slowest cohort member finishes; the
  lifecycle hooks run in the reference's order and draw the same streams.
* ``deadline`` — the round closes at ``virtual_time + deadline_s`` (or
  when everyone finishes, if earlier; never before the first arrival).
  Stragglers are ``"drop"``-ped (their updates discarded, their burned
  compute billed) or ``"carry"``-ed (their updates stay in flight and
  aggregate in a later round, with a staleness discount when
  ``staleness_alpha > 0``).  ``deadline_s=inf`` is ``sync``, bit for bit.
* ``async-buffer`` — FedBuff-style: the server aggregates every
  ``buffer_size`` arrivals with weights ``w_i ∝ 1/(1+s_i)^alpha`` (``s_i``
  the server versions since the update's dispatch), then dispatches as
  many replacement devices.

A job is trained eagerly at dispatch (its inputs depend only on the state
at dispatch) and completes later on the virtual clock.  The heap is keyed
``(finish_time, device_id)``; arrival sets come from the heap while every
floating-point reduction runs in dispatch order, so the event log and the
aggregates are the reference's.  A :class:`~repro_torch.federated.faults
.FaultInjector` perturbs dispatched jobs (dropout, bandwidth collapse, NaN
updates, churn) and ``_screen`` rejects what never arrived intact; under a
fault plan ``sync`` runs as a deadline round with an infinite budget.
:class:`~repro_torch.federated.faults.ServerKilled` is raised after the
planned round's checkpoint.  ``state_dict`` holds the jobs in flight (their
PEFT trees and uplinks as arrays, their scalars in the meta), the event and
fault logs and the retry bookkeeping, in the reference's layout.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.federated import server as server_lib
from repro_torch.federated.faults import FaultInjector, ServerKilled
from repro_torch.federated.state import CohortResults, RoundPlan
from repro_torch.models.stacking import tree_leaves, tree_map

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

    @property
    def keeps_in_flight_state(self) -> bool:
        """True when updates may live across aggregation boundaries
        (async-buffer, deadline + carry)."""
        return self.policy == "async-buffer" or (self.policy == "deadline" and self.straggler == "carry")


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


def feasible_rate_floor(system, profiles: Sequence[str], deadline_s: float, *, rate_grid: Sequence[float],
                        batch: int, seq: int, local_steps: int, bandwidth_mbps: float = 40.0) -> float:
    """Smallest grid rate whose predicted slowest-profile round time fits
    the deadline (expected active fraction ``1 - rate``); the largest grid
    rate when none does.  Feeds ``OnlineConfigurator.set_rate_floor``."""
    grid = sorted(set(float(r) for r in rate_grid))
    if not grid:
        return 0.0
    profs = sorted(set(profiles))
    for r in grid:
        cost = system.cohort_round_cost(
            devices=profs, bandwidth_mbps=bandwidth_mbps, batch=batch, seq=seq, local_steps=local_steps, peft=True,
            active_fraction=1.0 - r, share_fraction=1.0,
        )
        if float(cost.total_time_s.max()) <= deadline_s:
            return r
    return grid[-1]


@dataclass
class _Job:
    """One in-flight local update: trained at dispatch, completed on the
    virtual clock."""

    dev: int
    rate: float
    version: int            # server_version at dispatch (staleness base)
    dispatch_round: int
    cohort_pos: int         # position within its dispatch cohort (reduction order)
    dispatch_time: float
    duration: float         # SystemModel total_time_s
    finish: float           # absolute virtual completion time
    peft: Any
    metrics: dict
    importance: Any
    accuracy: float
    active_frac: float
    mask: np.ndarray        # (L,) bool share-mask row
    compute_s: float
    comm_s: float
    energy_j: float
    traffic_mb: float
    memory_gb: float
    failed: bool = False    # client dropped mid-round (fault injection)
    uplink_peft: Any = None  # server-side reconstruction (compressed uplink)
    comp: str = ""          # compression level this uplink used ("" = none)

    @property
    def order_key(self) -> Tuple[int, int]:
        return (self.dispatch_round, self.cohort_pos)


def _tree_finite(tree) -> bool:
    """Every element of ``tree`` finite (one host sync)."""
    return bool(torch.stack([torch.isfinite(x).all() for x in tree_leaves(tree)]).all())


def _nan_like(tree):
    return tree_map(lambda x: torch.full_like(x, float("nan")), tree)


# the _Job scalars of the checkpoint meta, with the cast applied on save and
# on load; a field missing from an older record loads at its default
_JOB_SCALARS = (
    ("dev", int), ("rate", float), ("version", int), ("dispatch_round", int),
    ("cohort_pos", int), ("dispatch_time", float), ("duration", float),
    ("finish", float), ("accuracy", float), ("active_frac", float),
    ("compute_s", float), ("comm_s", float), ("energy_j", float),
    ("traffic_mb", float), ("memory_gb", float), ("failed", bool),
    ("comp", str),
)
_JOB_SCALAR_DEFAULTS = {"comp": ""}


def _host(x):
    """A checkpointed array (a CPU tensor) as numpy."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class VirtualClockScheduler:
    """Drives one :class:`~repro_torch.federated.runner.ExperimentRunner`'s
    round loop through the configured policy.  One ``SimResult`` row per
    aggregation step.  ``event_log`` records every arrival as
    ``(round_index, device, finish_time)`` in event order; ``fault_log``
    every rejected update and every bandwidth collapse."""

    def __init__(self, runner, cfg: Optional[ScheduleConfig] = None, faults: Optional[FaultInjector] = None):
        self.runner = runner
        self.cfg = cfg or getattr(runner, "schedule", None) or ScheduleConfig()
        self.faults = faults
        self.event_log: List[Tuple[int, int, float]] = []
        self.fault_log: List[dict] = []            # rejected updates + billing
        self._heap: List[Tuple[float, int]] = []   # (finish_time, dev)
        self._jobs: Dict[int, _Job] = {}
        self._backoff: Dict[int, float] = {}       # dev -> earliest re-dispatch t
        self._fail_count: Dict[int, int] = {}      # dev -> consecutive failures

    @property
    def in_flight(self) -> frozenset:
        return frozenset(self._jobs)

    def run(self, rounds: Optional[int] = None, target_accuracy: Optional[float] = None):
        runner = self.runner
        total = rounds or runner.ctx.fed_cfg.rounds
        step = {"sync": self._sync_round, "deadline": self._deadline_round,
                "async-buffer": self._async_step}[self.cfg.policy]
        if self.faults is not None and self.cfg.policy == "sync":
            # an infinite-budget deadline round is sync, bit for bit, and
            # routes every completion through the fault-aware event loop
            step = self._deadline_round
        while runner.state.round_index < total:
            row = step(total, target_accuracy)
            hit_target = target_accuracy is not None and row["acc"] >= target_accuracy
            if runner.checkpoint_dir and (runner.state.round_index % runner.checkpoint_every == 0
                                          or runner.state.round_index == total or hit_target):
                runner.save_checkpoint()
            if self.faults is not None and self.faults.kills_after(runner.state.round_index):
                raise ServerKilled(
                    f"fault plan kills the server after round {runner.state.round_index}; rebuild the runner "
                    "with resume=True to continue from the newest checkpoint")
            if hit_target:
                break
        return runner.result()

    # ------------------------------------------------------------- sync path
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

    # ------------------------------------------------------------- dispatch
    def _dispatch_exclusions(self) -> frozenset:
        """Devices that cannot be dispatched now: in flight, backing off
        after a fault, or churned out.  Expired backoffs are purged."""
        if self.faults is None:
            return self.in_flight
        t = self.runner.state.virtual_time
        for dev in [d for d, ready in self._backoff.items() if ready <= t]:
            del self._backoff[dev]
        excl = set(self._jobs) | set(self._backoff)
        for dev in range(self.runner.ctx.fed_cfg.num_devices):
            if self.faults.unavailable(dev, t):
                excl.add(dev)
        return frozenset(excl)

    def _next_available_time(self, t: float) -> Optional[float]:
        """Earliest instant after ``t`` when an excluded device becomes
        dispatchable (backoff expiry or churn rejoin), or None."""
        times = [ready for ready in self._backoff.values() if ready > t]
        if self.faults is not None:
            for dev in range(self.runner.ctx.fed_cfg.num_devices):
                if dev in self._jobs:
                    continue
                rejoin = self.faults.next_rejoin(dev, t)
                if rejoin is not None and rejoin > t:
                    times.append(rejoin)
        return min(times) if times else None

    def _inject_dispatch_faults(self, job: _Job) -> None:
        """Apply the fault plan to a freshly dispatched job: stretch its
        uplink, cut it at the dropout instant (partial work billed, update
        lost), or make its update NaN.  The training streams are untouched."""
        inj = self.faults
        r, dev = job.dispatch_round, job.dev
        bw = inj.bandwidth_factor_at(r, dev)
        if bw > 1.0:
            extra = job.comm_s * (bw - 1.0)
            job.comm_s *= bw
            job.duration += extra
            self.fault_log.append({"round": r, "dev": dev, "reason": "bandwidth-collapse",
                                   "time": job.dispatch_time, "slowdown": bw})
        frac = inj.dropout_at(r, dev)
        if frac is not None:
            job.failed = True
            job.duration *= frac
            job.compute_s *= frac
            job.comm_s *= frac
            job.energy_j *= frac
            job.traffic_mb *= frac
        if inj.corrupts(r, dev):
            job.peft = _nan_like(job.peft)
            if job.uplink_peft is not None:
                job.uplink_peft = _nan_like(job.uplink_peft)
        job.finish = job.dispatch_time + job.duration

    def _dispatch(self, size: Optional[int] = None) -> Tuple[Optional[RoundPlan], List[_Job]]:
        """Sample and train a cohort at the current virtual time and push
        its completion events; costs through the algorithm's ``round_cost``,
        as the sync ``report``."""
        runner, algo = self.runner, self.runner.algorithm
        state = runner.state
        plan = algo.configure_round(state, size=size, exclude=self._dispatch_exclusions())
        if not plan.cohort:
            return None, []
        plan.start_pefts = [algo.client_init(state, dev) for dev in plan.cohort]
        state, results = algo.cohort_step(state, plan)
        state, results = algo.compress_uplink(state, results)
        results.masks = algo.compute_masks(state, results)
        cost, active_fracs = algo.round_cost(state, results)
        t0 = state.virtual_time
        rates = [float(r) for r in plan.rates]
        total_s = np.asarray(cost.total_time_s).tolist()
        compute_s = np.asarray(cost.compute_time_s).tolist()
        comm_s = np.asarray(cost.comm_time_s).tolist()
        energy_j = np.asarray(cost.energy_j).tolist()
        traffic_mb = np.asarray(cost.traffic_mb).tolist()
        memory_gb = np.asarray(cost.memory_gb).tolist()
        jobs = []
        for i, dev in enumerate(plan.cohort):
            job = _Job(
                dev=dev, rate=rates[i], version=state.server_version, dispatch_round=plan.round_index,
                cohort_pos=i, dispatch_time=t0, duration=total_s[i], finish=t0 + total_s[i],
                peft=results.pefts[i], metrics=results.metrics[i], importance=results.importances[i],
                accuracy=results.accuracies[i], active_frac=active_fracs[i], mask=np.asarray(results.masks[i]),
                compute_s=compute_s[i], comm_s=comm_s[i], energy_j=energy_j[i], traffic_mb=traffic_mb[i],
                memory_gb=memory_gb[i],
                uplink_peft=results.uplink_pefts[i] if results.uplink_pefts is not None else None,
                comp=plan.compression[i] if plan.compression else "",
            )
            if self.faults is not None:
                self._inject_dispatch_faults(job)
            jobs.append(job)
            self._jobs[dev] = job
            heapq.heappush(self._heap, (job.finish, dev))
        runner.state = state  # key and global_step advanced by cohort_step
        return plan, jobs

    def _pop_arrivals_until(self, close_t: float, round_index: int) -> List[_Job]:
        """Pop every event with ``finish <= close_t`` in (finish, dev) order."""
        arrived = []
        while self._heap and self._heap[0][0] <= close_t:
            finish, dev = heapq.heappop(self._heap)
            arrived.append(self._jobs.pop(dev))
            self.event_log.append((round_index, dev, finish))
        return arrived

    def _pop_k_arrivals(self, k: int, round_index: int) -> List[_Job]:
        arrived = []
        for _ in range(min(k, len(self._heap))):
            finish, dev = heapq.heappop(self._heap)
            arrived.append(self._jobs.pop(dev))
            self.event_log.append((round_index, dev, finish))
        return arrived

    def _screen(self, arrived: List[_Job], round_index: int) -> List[_Job]:
        """Accept or reject each arrival: a dropped client never delivered,
        and a non-finite update is screened out.  Rejected work stays
        billed, the rejection goes to ``fault_log``, and a dropped device
        backs off exponentially.  The identity without an injector."""
        if self.faults is None:
            return arrived
        ok = []
        for job in sorted(arrived, key=lambda j: j.order_key):
            if job.failed:
                reason = "dropout"
            elif not _tree_finite(job.peft if job.uplink_peft is None else job.uplink_peft):
                reason = "non-finite-update"
            else:
                self._fail_count.pop(job.dev, None)
                ok.append(job)
                continue
            entry = {"round": round_index, "dev": job.dev, "reason": reason, "time": job.finish,
                     "burned_compute_s": job.compute_s, "burned_energy_j": job.energy_j}
            if reason == "dropout":
                n = self._fail_count.get(job.dev, 0) + 1
                self._fail_count[job.dev] = n
                retry_at = job.finish + self.faults.backoff_s(n)
                self._backoff[job.dev] = retry_at
                entry["retry_after"] = retry_at
            self.fault_log.append(entry)
        return ok

    # ----------------------------------------------------------- aggregation
    def _aggregate_arrivals(self, arrived: List[_Job], adaopt_depth: int):
        """The algorithm's aggregation of an arrival set, in dispatch order,
        with staleness weights when ``staleness_alpha > 0``."""
        runner, algo = self.runner, self.runner.algorithm
        state = runner.state
        if not arrived:
            return state, None
        arrived = sorted(arrived, key=lambda j: j.order_key)
        results = CohortResults(
            plan=RoundPlan(
                round_index=state.round_index, cohort=[j.dev for j in arrived], rates=[j.rate for j in arrived],
                adaopt_depth=adaopt_depth,
                compression=[j.comp or "none" for j in arrived] if any(j.comp for j in arrived) else None,
            ),
            pefts=[j.peft for j in arrived],
            metrics=[j.metrics for j in arrived],
            importances=[j.importance for j in arrived],
            accuracies=[j.accuracy for j in arrived],
            masks=np.stack([j.mask for j in arrived]),
        )
        if any(j.uplink_peft is not None for j in arrived):
            results.uplink_pefts = [j.uplink_peft if j.uplink_peft is not None else j.peft for j in arrived]
        staleness = np.array([state.server_version - j.version for j in arrived], dtype=np.int64)
        results.staleness = staleness
        if self.cfg.staleness_alpha > 0:
            results.weights = server_lib.staleness_weights(staleness, self.cfg.staleness_alpha)
        return algo.aggregate(state, results), results

    def _feedback_and_prev_acc(self, state, fb_results, realized, arrived):
        """Reward the bandit with the realized virtual-clock times; advance
        ``prev_acc`` for the incorporated updates only."""
        self.runner.algorithm.feedback(state, fb_results, realized)
        prev_acc = dict(state.prev_acc)
        for job in arrived:
            prev_acc[job.dev] = job.accuracy
        return prev_acc

    # --------------------------------------------------------- deadline path
    def _deadline_round(self, total: int, target: Optional[float] = None) -> dict:
        runner, ctx = self.runner, self.runner.ctx
        cfg = self.cfg
        t0 = runner.state.virtual_time
        round_index = runner.state.round_index
        plan, jobs = self._dispatch()
        while not self._jobs:
            # every device backs off or is churned out and nothing is in
            # flight: idle-advance the clock to the next availability
            nxt = self._next_available_time(runner.state.virtual_time)
            if nxt is None:
                raise RuntimeError("deadline scheduler has no dispatchable devices and nothing in flight — "
                                   "num_devices is too small for the carry backlog")
            runner.state = replace(runner.state, virtual_time=nxt)
            t0 = nxt
            plan, jobs = self._dispatch()
        state = runner.state
        # close at min(deadline, everyone done), never before the first arrival
        close_t = max(j.finish for j in self._jobs.values())
        if math.isfinite(cfg.deadline_s):
            close_t = min(close_t, t0 + cfg.deadline_s)
        close_t = max(close_t, min(j.finish for j in self._jobs.values()))
        arrived = self._pop_arrivals_until(close_t, round_index)
        if cfg.straggler == "drop":
            self._heap.clear()
            self._jobs.clear()
        ok = self._screen(arrived, round_index)
        arrived_devs = {j.dev for j in ok}
        state, agg_results = self._aggregate_arrivals(ok, plan.adaopt_depth if plan else ctx.cfg.num_layers)

        if cfg.straggler == "carry":
            # every accepted arrival, on time or late, reports its full
            # realized duration and its trained accuracy
            if agg_results is not None:
                ordered = sorted(ok, key=lambda j: j.order_key)
                prev_acc = self._feedback_and_prev_acc(
                    state, agg_results, np.asarray([j.duration for j in ordered], dtype=np.float64), ok)
            else:
                prev_acc = state.prev_acc
        else:
            # the dispatched cohort reports: arrivals their duration, cut-off
            # stragglers the deadline they burned and no accuracy gain
            assert plan is not None
            chance = 1.0 / ctx.task.num_classes
            fb_accs, realized = [], []
            for job in jobs:
                if job.dev in arrived_devs and job.dispatch_round == round_index:
                    fb_accs.append(job.accuracy)
                    realized.append(job.duration)
                else:
                    fb_accs.append(state.prev_acc.get(job.dev, chance))
                    realized.append(min(job.duration, cfg.deadline_s))
            fb_results = CohortResults(
                plan=plan, pefts=[j.peft for j in jobs], metrics=[j.metrics for j in jobs],
                importances=[j.importance for j in jobs], accuracies=fb_accs,
                masks=np.stack([j.mask for j in jobs]),
            )
            prev_acc = self._feedback_and_prev_acc(state, fb_results, np.asarray(realized, dtype=np.float64), ok)

        row = self._row(close_t, arrived=sorted(ok, key=lambda j: j.order_key), dispatched=jobs)
        runner.state = replace(
            state, cum_time=close_t, virtual_time=close_t, server_version=state.server_version + 1,
            prev_acc=prev_acc, round_index=state.round_index + 1, history=state.history + (row,),
        )
        return row

    # ------------------------------------------------------------ async path
    def _async_step(self, total: int, target: Optional[float] = None) -> dict:
        runner, ctx = self.runner, self.runner.ctx
        fed = ctx.fed_cfg
        if not self._jobs:
            self._dispatch(size=fed.devices_per_round)  # prime: devices_per_round in flight
        while not self._jobs:
            nxt = self._next_available_time(runner.state.virtual_time)
            if nxt is None:
                raise RuntimeError("async scheduler drained its event queue")
            runner.state = replace(runner.state, virtual_time=nxt)
            self._dispatch(size=fed.devices_per_round)
        k = self.cfg.buffer_size or max(1, fed.devices_per_round // 2)
        round_index = runner.state.round_index
        arrived = self._pop_k_arrivals(k, round_index)
        if not arrived:
            raise RuntimeError("async scheduler drained its event queue")
        close_t = max(j.finish for j in arrived)  # heap pops are monotone
        ok = self._screen(arrived, round_index)
        state, agg_results = self._aggregate_arrivals(ok, ctx.cfg.num_layers)
        ordered = sorted(ok, key=lambda j: j.order_key)
        if agg_results is not None:
            realized = np.asarray([j.duration for j in ordered], dtype=np.float64)
            prev_acc = self._feedback_and_prev_acc(state, agg_results, realized, ok)
        else:
            prev_acc = state.prev_acc
        row = self._row(close_t, arrived=ordered, dispatched=sorted(arrived, key=lambda j: j.order_key))
        if agg_results is not None:
            row["staleness"] = float(np.mean(agg_results.staleness))
        state = replace(
            state, cum_time=close_t, virtual_time=close_t, server_version=state.server_version + 1,
            prev_acc=prev_acc, round_index=state.round_index + 1, history=state.history + (row,),
        )
        runner.state = state
        # refill as many as just arrived, unless the run ends here
        if state.round_index < total and not (target is not None and row["acc"] >= target):
            self._dispatch(size=len(arrived))
        return row

    # --------------------------------------------------------- durable state
    def state_dict(self) -> Tuple[list, dict]:
        """``(jobs_arrays, meta)``: one array tree per job in flight (PEFT
        update, metrics, importance, share mask, uplink), aligned with the
        ``meta["jobs"]`` scalar records, plus the event and fault logs and
        the retry bookkeeping, as the reference's.  The heap is keyed
        ``(finish, dev)``, so the rebuilt one pops in the same order."""
        jobs = [self._jobs[dev] for dev in sorted(self._jobs)]
        jobs_arrays, job_meta = [], []
        for j in jobs:
            jobs_arrays.append({
                "peft": j.peft,
                "metrics": j.metrics,
                "importance": j.importance if j.importance is not None else [],
                "mask": j.mask,
                "uplink_peft": j.uplink_peft if j.uplink_peft is not None else [],
            })
            record = {name: cast(getattr(j, name)) for name, cast in _JOB_SCALARS}
            record["has_importance"] = j.importance is not None
            record["has_uplink"] = j.uplink_peft is not None
            job_meta.append(record)
        meta = {
            "jobs": job_meta,
            "event_log": [[int(r), int(d), float(t)] for r, d, t in self.event_log],
            "fault_log": list(self.fault_log),
            "backoff": {str(k): float(v) for k, v in self._backoff.items()},
            "fail_count": {str(k): int(v) for k, v in self._fail_count.items()},
        }
        return jobs_arrays, meta

    def load_state_dict(self, jobs_arrays: list, meta: dict) -> None:
        """Rebuild the state saved by :meth:`state_dict`; the PEFT trees go
        to the runner's device, the host records back to numpy."""
        device = self.runner.device
        self._jobs.clear()
        self._heap = []
        for arrs, jm in zip(jobs_arrays, meta["jobs"]):
            scalars = {name: cast(jm[name]) if name in jm else _JOB_SCALAR_DEFAULTS[name]
                       for name, cast in _JOB_SCALARS}
            job = _Job(
                peft=tree_map(lambda t: t.to(device), arrs["peft"]),
                metrics={k: _host(v) for k, v in arrs["metrics"].items()},
                importance=_host(arrs["importance"]) if jm["has_importance"] else None,
                mask=_host(arrs["mask"]),
                uplink_peft=tree_map(lambda t: t.to(device), arrs["uplink_peft"]) if jm.get("has_uplink") else None,
                **scalars,
            )
            self._jobs[job.dev] = job
            self._heap.append((job.finish, job.dev))
        heapq.heapify(self._heap)
        self.event_log = [(int(r), int(d), float(t)) for r, d, t in meta.get("event_log", [])]
        self.fault_log = list(meta.get("fault_log", []))
        self._backoff = {int(k): float(v) for k, v in meta.get("backoff", {}).items()}
        self._fail_count = {int(k): int(v) for k, v in meta.get("fail_count", {}).items()}

    # ------------------------------------------------------------------ rows
    def _row(self, close_t, *, arrived: List[_Job], dispatched: List[_Job]) -> dict:
        """One history row: accuracy and loss describe what the server
        aggregated; rate, active, traffic, energy and memory bill the work
        dispatched this step (a deadline-dropped straggler pro rata to the
        time it spent before the cut)."""
        cut = self.cfg.policy == "deadline" and self.cfg.straggler == "drop"

        def _frac(j: _Job) -> float:
            if not cut or j.finish <= close_t:
                return 1.0
            return max(close_t - j.dispatch_time, 0.0) / j.duration

        if arrived:
            acc = float(np.mean([j.accuracy for j in arrived]))
            loss = float(np.mean(np.asarray([j.metrics["loss"] for j in arrived], dtype=np.float64)))
        else:  # nothing incorporated: carry the previous row's curve values
            hist = self.runner.state.history
            acc = float(hist[-1]["acc"]) if hist else 0.0
            loss = float(hist[-1]["loss"]) if hist else 0.0
        billed = dispatched
        return {
            "time": close_t,
            "acc": acc,
            "loss": loss,
            "rate": float(np.mean([j.rate for j in billed])) if billed else 0.0,
            "active": float(np.mean([j.active_frac for j in billed])) if billed else 0.0,
            "traffic": float(np.sum([j.traffic_mb * _frac(j) for j in billed])) if billed else 0.0,
            "energy": float(np.sum([j.energy_j * _frac(j) for j in billed])) if billed else 0.0,
            "memory": float(np.max([j.memory_gb for j in billed])) if billed else 0.0,
            "arrivals": len(arrived),
        }
