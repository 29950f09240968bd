"""Steady-state guard: count the port's one-time set-ups and hold a run to
a budget of them, as ``repro.analysis.recompile_guard``.

The reference counts XLA compiles: a static argument churning or a shape
leaking into a cache key recompiles every round.  The port compiles
nothing per shape; what it sets up at first use is its kernels' libraries
(an ``nvcc`` build, a library load), their entry points, and its per-shape
launch plans (``ops._segmented_plan``, ``ops._tickets``,
``ops._decode_splits``).  Each fires an event through
``kernels._build.setup_listeners``, and :class:`CompilationCounter` counts
them, so a test or the CLI can assert that a steady-state experiment sets
up nothing new::

    with recompile_guard(max_compiles=0, label="droppeft rounds 3-6"):
        runner.run(rounds=6)          # rounds 0-3 already warmed the caches

:func:`check_experiment_recompiles` runs the standard check: warm a
smoke-scale experiment for a few rounds under a schedule policy, then
extend it and require at most the policy's budget of new set-ups (0 for
sync and deadline; async-buffer refills dispatch cohorts of varying size,
so it keeps the reference's small allowance).  On the card it also reports,
without bounding them, the caching allocator's new segments
(``torch.cuda.memory_stats()["segment.all.allocated"]``).  On the CPU the
kernels' plain twins set nothing up, so the check passes trivially.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.analysis.report import Violation
from repro_torch.kernels import _build

# steady-state budget of NEW set-ups after a warmed-up multi-round run
DEFAULT_BUDGETS: Dict[str, int] = {
    "sync": 0,
    "deadline": 0,
    # async refills dispatch as many devices as just arrived, so late rounds
    # can still meet a cohort size the warm-up never saw; bounded by the
    # buffer-size grid, not by the rounds
    "async-buffer": 8,
}


class RecompileBudgetExceeded(RuntimeError):
    """A guarded block set up more than its budget."""


class CompilationCounter:
    """Context manager counting the port's one-time set-ups (builds,
    library loads, entry-point lookups, launch-plan misses) fired while it
    is open; ``events`` holds each as ``(kind, what)``."""

    def __init__(self):
        self.count = 0
        self.events: List[tuple] = []

    def _listen(self, kind: str, what: str) -> None:
        self.count += 1
        self.events.append((kind, what))

    def __enter__(self) -> "CompilationCounter":
        _build.setup_listeners.append(self._listen)
        return self

    def __exit__(self, *exc) -> bool:
        _build.setup_listeners.remove(self._listen)
        return False


@contextlib.contextmanager
def recompile_guard(max_compiles: int, *, label: str = ""):
    """Assert the with-block sets up at most ``max_compiles`` things.

    Yields the live :class:`CompilationCounter`; raises
    :class:`RecompileBudgetExceeded` on exit if the budget was blown.
    Exceptions from the block propagate unchanged."""
    with CompilationCounter() as counter:
        yield counter
    if counter.count > max_compiles:
        raise RecompileBudgetExceeded(
            f"{label or 'guarded block'}: {counter.count} set-up(s) ({counter.events[:8]}), budget {max_compiles}"
        )


# ------------------------------------------------------- experiment check
def _quickstart_runner(method: str, policy: str, *, seed: int = 0, device=None):
    """A smoke-scale experiment runner matching the reference's check."""
    from repro_torch import api
    from repro_torch.configs import FederatedConfig, TrainConfig, get_config
    from repro_torch.data.synthetic import make_task

    cfg = get_config("qwen3-1.7b", smoke=True).replace(
        num_layers=4, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, vocab_size=128, dtype="float32",
    )
    return api.build(
        method,
        cfg=cfg,
        fed_cfg=FederatedConfig(num_devices=5, devices_per_round=3, local_steps=2, batch_size=8),
        train_cfg=TrainConfig(learning_rate=5e-3, total_steps=100, warmup_steps=2),
        task=make_task(num_examples=256, vocab_size=128, seed=0),
        schedule=policy,
        seed=seed,
        device=device,
    )


def _segments(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return torch.cuda.memory_stats(device).get("segment.all.allocated", 0)


def check_experiment_recompiles(
    method: str = "droppeft",
    policies: Sequence[str] = ("sync",),
    device=None,
    *,
    warmup_rounds: int = 3,
    extra_rounds: int = 3,
    budgets: Optional[Dict[str, int]] = None,
    progress=None,
    report: Optional[dict] = None,
) -> List[Violation]:
    """Warm a multi-round experiment per policy on ``device`` (None = the
    card), extend it, and require at most the policy's budget of new
    set-ups.  ``report``, if given, receives per policy the set-ups
    counted, their kinds, and the allocator's new segments."""
    budgets = dict(DEFAULT_BUDGETS, **(budgets or {}))
    device = torch.device("cuda" if device is None else device)
    violations: List[Violation] = []
    for policy in policies:
        if progress:
            progress(f"{method}/{policy}")
        runner = _quickstart_runner(method, policy, device=device)
        runner.run(rounds=warmup_rounds)  # sets up every steady-state kernel and plan
        segments = _segments(device)
        with CompilationCounter() as counter:
            runner.run(rounds=warmup_rounds + extra_rounds)
        if report is not None:
            kinds: Dict[str, int] = {}
            for kind, _ in counter.events:
                kinds[kind] = kinds.get(kind, 0) + 1
            report[policy] = {"setups": counter.count, "by_kind": kinds, "budget": budgets[policy],
                              "new_segments": _segments(device) - segments}
        if counter.count > budgets[policy]:
            violations.append(
                Violation(
                    "recompile",
                    f"{method}/{policy}",
                    f"{counter.count} set-up(s) in rounds {warmup_rounds}..{warmup_rounds + extra_rounds} "
                    f"(budget {budgets[policy]}; {counter.events[:8]}) — a shape is churning a launch plan per round",
                    "make the varying value a tensor argument, or bucket it so the set of plans is bounded",
                )
            )
    return violations
