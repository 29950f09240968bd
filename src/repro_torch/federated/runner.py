"""The federated round loop, as ``repro.federated.runner``.

:class:`ExperimentRunner` builds an :class:`ExperimentContext` (task,
device shards, hardware profiles, system model, execution engine), binds a
:class:`~repro_torch.federated.algorithms.FederatedAlgorithm`, and drives
its lifecycle hooks round by round through the scheduler, threading an
immutable :class:`~repro_torch.federated.state.RoundState`.

The numpy and ``random`` streams are the reference's, draw for draw: the
task, the Dirichlet shards, each device's batches, the device profiles
(``default_rng(seed)``), then each round's cohort and bandwidths, and the
bandit.  The torch streams (base weights, the initial LoRA, the STLD gates)
come from ``state.split_key(seed, 3)``, as the reference splits its seed
key in three, and never from the numpy generator.

Any round boundary can be checkpointed (``checkpoint_dir``) in the
reference's format and resumed bit-exactly (``resume=True``): the round's
torch seed ``key``, the numpy streams of the round loop and of every
device's batches, the bandit, the PEFT trees, the share masks, the
error-feedback residuals, the scheduler's jobs in flight and the metric
history.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.core.peft import init_peft
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import DeviceDataset
from repro_torch.data.synthetic import make_task
from repro_torch.federated.algorithms import FederatedAlgorithm, get_algorithm
from repro_torch.federated.compression import CompressionConfig, resolve_compression
from repro_torch.federated.engine import CohortEngine
from repro_torch.federated.faults import FaultInjector, resolve_fault_plan
from repro_torch.federated.scheduler import ScheduleConfig, VirtualClockScheduler, resolve_schedule
from repro_torch.federated.state import RoundState, split_key
from repro_torch.federated.system_model import SystemModel, sample_device
from repro_torch.models.registry import init_params, place_params
from repro_torch.models import stacking
from repro_torch.models.stacking import tree_map


@dataclass
class SimResult:
    rounds: int
    cum_time_s: np.ndarray           # (R,) scheduler virtual clock at each aggregation
    accuracy: np.ndarray             # (R,) mean val accuracy of aggregated updates
    loss: np.ndarray                 # (R,)
    rates: np.ndarray                # (R,) mean dropout rate used
    active_fraction: np.ndarray      # (R,) measured E[L~]/L
    traffic_mb: np.ndarray           # (R,) cohort total
    energy_j: np.ndarray             # (R,) cohort total
    memory_gb: np.ndarray            # (R,) max per-device footprint
    final_accuracy: float = 0.0
    arrivals: Optional[np.ndarray] = None  # (R,) updates aggregated per step

    def time_to_accuracy(self, target: float, *, sustained: bool = False) -> Optional[float]:
        """Simulated time until ``accuracy >= target``; ``sustained=True``
        requires the target to hold for every later round too."""
        if sustained:
            suffix_min = np.minimum.accumulate(self.accuracy[::-1])[::-1]
            hit = np.where(suffix_min >= target)[0]
        else:
            hit = np.where(self.accuracy >= target)[0]
        return float(self.cum_time_s[hit[0]]) if len(hit) else None


@dataclass
class ExperimentContext:
    """Everything an algorithm's hooks may consult; built once per seed."""

    cfg: Any
    peft_cfg: Any
    stld_cfg: Any
    fed_cfg: Any
    train_cfg: Any
    task: Any
    devices: List[DeviceDataset]
    device_profile: List[str]
    system: SystemModel
    seed: int
    peft_key: int                  # the seed init_peft drew from (hetlora draws anew from it)
    init_global_peft: Any
    num_classes: Any               # np.arange(task.num_classes)
    device: Any = None             # where the base weights and the PEFT trees live
    engine: Optional[CohortEngine] = None
    schedule: Optional[ScheduleConfig] = None        # virtual-clock scheduling policy
    compression: Optional[CompressionConfig] = None  # uplink compression | None


def _build_context(cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, *, task=None, cost_cfg=None, seed=0,
                   device_profile=None, params=None, device=None):
    """The reference's construction order, so that the numpy streams (task,
    shards, device profiles) are its own.  ``device_profile`` pins the
    hardware mix instead of sampling it (no profile draws).  ``params``
    (a float32 tree, e.g. drawn on the CPU) replaces the drawn base weights;
    either way they are placed once in ``cfg.dtype`` on ``device``."""
    torch.zeros((), device=device)  # the card (or the device asked for), or raise before any work
    rng = np.random.default_rng(seed)
    key, k_params, k_peft = split_key(seed, 3)
    task = task or make_task(vocab_size=cfg.vocab_size, seed=seed)
    parts = dirichlet_partition(task.labels, fed_cfg.num_devices, fed_cfg.dirichlet_alpha, seed=seed)
    devices = [DeviceDataset(task, idx, seed=seed + i) for i, idx in enumerate(parts)]
    if device_profile is None:
        device_profile = [sample_device(rng) for _ in range(fed_cfg.num_devices)]
    else:
        device_profile = list(device_profile)
        if len(device_profile) != fed_cfg.num_devices:
            raise ValueError(f"device_profile has {len(device_profile)} entries for {fed_cfg.num_devices} devices")
    if params is None:
        base_params = init_params(cfg, torch.Generator(device=device).manual_seed(k_params), place=True)
    else:
        base_params = place_params(params, cfg, device)
    # the LoRA is drawn on the CPU, so that every device starts from the same tree
    global_peft = tree_map(lambda t: t.to(device), init_peft(cfg, peft_cfg, torch.Generator().manual_seed(k_peft)))
    ctx = ExperimentContext(
        cfg=cfg,
        peft_cfg=peft_cfg,
        stld_cfg=stld_cfg,
        fed_cfg=fed_cfg,
        train_cfg=train_cfg,
        task=task,
        devices=devices,
        device_profile=device_profile,
        system=SystemModel(cost_cfg or cfg, peft_cfg),
        seed=seed,
        peft_key=k_peft,
        init_global_peft=global_peft,
        num_classes=np.arange(task.num_classes),
        device=device,
    )
    return ctx, rng, key, base_params


def fresh_algorithm(algorithm):
    """Per-run copy of an algorithm prototype, configuration preserved
    (a shallow copy; ``bind`` recomputes all derived state)."""
    if isinstance(algorithm, str):
        return algorithm
    algo = copy.copy(algorithm)
    algo.ctx = None
    return algo


class ExperimentRunner:
    """Round loop and state threading for one experiment.

    ``device`` (None = the card) holds the base weights and every PEFT
    tree.  ``cohort_mode`` ``"auto"`` resolves as the reference's:
    ``"batched"`` for every algorithm but one whose ``requires_sequential``
    is set (its per-device trees cannot share a device axis), which runs
    ``"sequential"``; ``"batched"`` for such an algorithm raises
    ``ValueError``.  With ``checkpoint_dir`` the scheduler saves the round
    state (:meth:`save_checkpoint`); ``resume=True`` restores the newest
    complete snapshot there (a fresh start when there is none).
    ``schedule`` is a policy name or a :class:`ScheduleConfig`,
    ``fault_plan`` a :class:`~repro_torch.federated.faults.FaultPlan`, a
    dict of its fields or a JSON path, ``compression`` a level name,
    ``"auto"`` (the joint rate x level bandit), a dict or a
    :class:`CompressionConfig`.  A method with ``device_rank`` (FedHetLoRA)
    gets one set of client programs per rank (``engine.enable_hetlora``)."""

    def __init__(self, cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, *,
                 algorithm: "FederatedAlgorithm | str" = "droppeft", task=None, cost_cfg=None, seed: int = 0,
                 cohort_mode: str = "auto", schedule: "ScheduleConfig | str" = "sync", device_profile=None,
                 checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1, resume: bool = False,
                 fault_plan=None, compression=None, params=None, device=None):
        if cohort_mode not in ("auto", "batched", "sequential"):
            raise ValueError(f"unknown cohort_mode {cohort_mode!r}")
        if resume and not checkpoint_dir:
            raise ValueError("resume=True requires checkpoint_dir")
        if stld_cfg.mode not in ("cond", "gather"):
            raise ValueError(f"STLD mode must be 'cond' or 'gather', got {stld_cfg.mode!r}")
        self.compression = resolve_compression(compression)
        self.fault_plan = resolve_fault_plan(fault_plan)
        if isinstance(algorithm, str):
            algorithm = get_algorithm(algorithm)()
        else:
            algorithm = fresh_algorithm(algorithm)
        if cohort_mode == "batched" and algorithm.requires_sequential:
            name = getattr(algorithm, "name", type(algorithm).__name__)
            raise ValueError(f"cohort_mode='batched' cannot stack {name}'s heterogeneous PEFT trees; "
                             "use 'sequential' (or 'auto')")
        if cohort_mode == "auto":
            cohort_mode = "sequential" if algorithm.requires_sequential else "batched"
        self.algorithm = algorithm
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, checkpoint_every)
        self.schedule = resolve_schedule(schedule)
        self.device = torch.device("cuda" if device is None else device)

        ctx, rng, key, base_params = _build_context(
            cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, task=task, cost_cfg=cost_cfg, seed=seed,
            device_profile=device_profile, params=params, device=self.device,
        )
        ctx.schedule = self.schedule  # visible to bind() and build_configurator
        ctx.compression = self.compression
        self.ctx = ctx
        global_peft = algorithm.bind(ctx)
        self.cohort_mode = cohort_mode
        ctx.engine = CohortEngine(cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, ctx.task, ctx.devices, base_params,
                                  cohort_mode=cohort_mode, stld_enabled=algorithm.stld, device=self.device)
        if getattr(algorithm, "device_rank", None) is not None:
            ctx.engine.enable_hetlora(algorithm.device_rank)
        self.state = RoundState(key=key, global_peft=global_peft, rng=rng,
                                configurator=algorithm.build_configurator(ctx))
        self.scheduler = VirtualClockScheduler(
            self, self.schedule, faults=FaultInjector(self.fault_plan) if self.fault_plan is not None else None)
        if resume:
            self._restore_latest()

    def run(self, rounds: Optional[int] = None, target_accuracy: Optional[float] = None) -> SimResult:
        """Drive the round loop through the scheduler (``target_accuracy``
        stops it early)."""
        return self.scheduler.run(rounds=rounds, target_accuracy=target_accuracy)

    def result(self) -> SimResult:
        hist = self.state.history
        res = SimResult(
            rounds=len(hist),
            cum_time_s=np.asarray([r["time"] for r in hist]),
            accuracy=np.asarray([r["acc"] for r in hist]),
            loss=np.asarray([r["loss"] for r in hist]),
            rates=np.asarray([r["rate"] for r in hist]),
            active_fraction=np.asarray([r["active"] for r in hist]),
            traffic_mb=np.asarray([r["traffic"] for r in hist]),
            energy_j=np.asarray([r["energy"] for r in hist]),
            memory_gb=np.asarray([r["memory"] for r in hist]),
            arrivals=np.asarray([r.get("arrivals", -1) for r in hist]),
        )
        res.final_accuracy = self.ctx.engine.final_accuracy(
            self.state.global_peft, self.state.device_peft, self.ctx.num_classes
        )
        return res

    # --------------------------------------------------------- checkpointing
    # The reference's meta version 3: the scheduler section (jobs in flight,
    # the event and fault logs, the retry bookkeeping), the fault plan and
    # the error-feedback residuals.
    CKPT_META_VERSION = 3

    def save_checkpoint(self) -> str:
        """Persist the full round state as the reference's runner does; a
        run resumed from it is bit-identical.  ``key`` is the port's own
        (an int, saved as int64), not the reference's JAX key."""
        state = self.state
        sched_jobs, sched_meta = self.scheduler.state_dict()
        arrays = {
            "key": np.int64(state.key),
            "global_peft": state.global_peft,
            "device_peft": {str(d): t for d, t in sorted(state.device_peft.items())},
            "last_mask": {str(d): np.asarray(m) for d, m in sorted(state.last_mask.items())},
            "ef_residual": {str(d): t for d, t in sorted(state.ef_residual.items())},
            "scheduler_jobs": sched_jobs,
        }
        meta = {
            "meta_version": self.CKPT_META_VERSION,
            "scheduler": sched_meta,
            "fault_plan": None if self.fault_plan is None else self.fault_plan.to_json(),
            "round_index": state.round_index,
            "global_step": state.global_step,
            "cum_time": state.cum_time,
            "virtual_time": state.virtual_time,
            "server_version": state.server_version,
            "prev_acc": {str(d): v for d, v in state.prev_acc.items()},
            "rng_state": state.rng.bit_generator.state,
            "device_rng": [d._rng.bit_generator.state for d in self.ctx.devices],
            "configurator": state.configurator.state_dict() if state.configurator else None,
            "history": list(state.history),
        }
        return ckpt_lib.save_state(self.checkpoint_dir, state.round_index, arrays, meta)

    def _peft_native_layout(self, tree):
        """A checkpointed PEFT tree in this runner's layout (stacked, or a
        per-layer list for a heterogeneous stack), on its device."""
        native_stacked = stacking.is_stacked(self.ctx.init_global_peft)
        if native_stacked and isinstance(tree, (list, tuple)):
            tree = stacking.from_layer_list(list(tree), stacked=True)
        elif not native_stacked and stacking.is_stacked(tree):
            tree = stacking.layer_list(tree, self.ctx.cfg.num_layers)
        return tree_map(lambda t: t.to(self.device), tree)

    def _restore_latest(self):
        latest = ckpt_lib.latest_state_dir(self.checkpoint_dir)
        if latest is None:
            return  # nothing saved yet: a fresh start
        arrays, meta = ckpt_lib.load_state(latest)
        state = self.state
        if meta.get("scheduler") is None and self.schedule.keeps_in_flight_state:
            raise ValueError(
                f"checkpoint at {latest} has no in-flight scheduler state (meta version "
                f"{meta.get('meta_version', 1)}) and cannot resume under policy={self.schedule.policy!r}/"
                f"straggler={self.schedule.straggler!r}; resume it under schedule='sync' or deadline+drop")
        if len(meta["device_rng"]) != len(self.ctx.devices):
            raise ValueError(
                f"checkpoint at {latest} was saved with {len(meta['device_rng'])} devices but this runner has "
                f"{len(self.ctx.devices)}; resume requires an identical config")
        if (meta["configurator"] is None) != (state.configurator is None):
            raise ValueError(f"checkpoint at {latest} disagrees with this runner about the rate configurator; "
                             "resume requires the same method/config")
        state.rng.bit_generator.state = meta["rng_state"]
        for dev, rng_state in zip(self.ctx.devices, meta["device_rng"]):
            dev._rng.bit_generator.state = rng_state
        configurator = state.configurator
        if configurator is not None:
            configurator.load_state_dict(meta["configurator"])
        self.state = RoundState(
            key=int(arrays["key"]),
            global_peft=self._peft_native_layout(arrays["global_peft"]),
            device_peft={int(d): self._peft_native_layout(t) for d, t in arrays["device_peft"].items()},
            last_mask={int(d): m.numpy() for d, m in arrays["last_mask"].items()},
            ef_residual={int(d): tree_map(lambda t: t.to(self.device), r)
                         for d, r in arrays.get("ef_residual", {}).items()},
            round_index=meta["round_index"],
            global_step=meta["global_step"],
            cum_time=meta["cum_time"],
            virtual_time=meta.get("virtual_time", meta["cum_time"]),
            server_version=meta.get("server_version", meta["round_index"]),
            prev_acc={int(d): v for d, v in meta["prev_acc"].items()},
            rng=state.rng,
            configurator=configurator,
            history=tuple(meta["history"]),
        )
        if meta.get("scheduler") is not None:
            self.scheduler.load_state_dict(arrays.get("scheduler_jobs", []), meta["scheduler"])


def run_replicates(seeds: Sequence[int], cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, *, algorithm="droppeft",
                   rounds: Optional[int] = None, target_accuracy: Optional[float] = None,
                   **runner_kwargs) -> List[SimResult]:
    """Multi-seed replication: one independent runner (fresh task partition,
    device profiles and model init) per seed."""
    results = []
    for seed in seeds:
        runner = ExperimentRunner(cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg,
                                  algorithm=fresh_algorithm(algorithm), seed=seed, **runner_kwargs)
        results.append(runner.run(rounds=rounds, target_accuracy=target_accuracy))
    return results
