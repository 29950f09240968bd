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
key in three, and never from the numpy generator.  Checkpoints are not
ported (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.peft import init_peft
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.pipeline import DeviceDataset
from repro_torch.data.synthetic import make_task
from repro_torch.federated.algorithms import FederatedAlgorithm, get_algorithm
from repro_torch.federated.engine import CohortEngine
from repro_torch.federated.scheduler import ScheduleConfig, VirtualClockScheduler, resolve_schedule
from repro_torch.federated.state import RoundState, split_key
from repro_torch.federated.system_model import SystemModel, sample_device
from repro_torch.models.registry import init_params, place_params
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
    init_global_peft: Any
    num_classes: Any               # np.arange(task.num_classes)
    engine: Optional[CohortEngine] = None


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
        init_global_peft=global_peft,
        num_classes=np.arange(task.num_classes),
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


def unported(option: str, item: int):
    """The error for an option that names a feature the port lacks."""
    return NotImplementedError(f"{option} is not ported (ROADMAP queue 1, item {item})")


class ExperimentRunner:
    """Round loop and state threading for one experiment.

    ``device`` (None = the card) holds the base weights and every PEFT
    tree.  ``cohort_mode`` ``"auto"`` resolves as the reference's:
    ``"batched"`` for every algorithm but one whose ``requires_sequential``
    is set (its per-device trees cannot share a device axis), which runs
    ``"sequential"``; ``"batched"`` for such an algorithm raises
    ``ValueError``.  ``checkpoint_dir``/``resume``, ``fault_plan`` and
    ``compression`` are not ported and raise."""

    def __init__(self, cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, *,
                 algorithm: "FederatedAlgorithm | str" = "droppeft", task=None, cost_cfg=None, seed: int = 0,
                 cohort_mode: str = "auto", schedule: "ScheduleConfig | str" = "sync", device_profile=None,
                 checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1, resume: bool = False,
                 fault_plan=None, compression=None, params=None, device=None):
        if cohort_mode not in ("auto", "batched", "sequential"):
            raise ValueError(f"unknown cohort_mode {cohort_mode!r}")
        for option, value, item in (("checkpoint_dir", checkpoint_dir, 4), ("resume", resume, 4),
                                    ("fault_plan", fault_plan, 6), ("compression", compression, 6)):
            if value:
                raise unported(f"{option}={value!r}", item)
        if stld_cfg.mode != "cond":
            raise unported(f"stld_mode={stld_cfg.mode!r}", 5)
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
        self.schedule = resolve_schedule(schedule)
        self.scheduler = VirtualClockScheduler(self, self.schedule)  # raises for an unported policy
        self.device = torch.device("cuda" if device is None else device)

        ctx, rng, key, base_params = _build_context(
            cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, task=task, cost_cfg=cost_cfg, seed=seed,
            device_profile=device_profile, params=params, device=self.device,
        )
        self.ctx = ctx
        global_peft = algorithm.bind(ctx)
        self.cohort_mode = cohort_mode
        ctx.engine = CohortEngine(cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, ctx.task, ctx.devices, base_params,
                                  cohort_mode=cohort_mode, device=self.device)
        self.state = RoundState(key=key, global_peft=global_peft, rng=rng,
                                configurator=algorithm.build_configurator(ctx))

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
