"""The port's steady-state guard (``repro_torch.analysis.recompile_guard``)
on the CPU: the counter hears the set-ups the port fires through
``kernels._build.setup_listeners`` (a library build and load, an entry
point's first lookup, a launch-plan miss), stops counting when its context
exits, and ``recompile_guard`` raises over its budget and passes within it;
the experiment check runs the reference's smoke experiment under each
schedule policy (on the CPU the kernels' twins set nothing up)."""
import importlib

import pytest

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro_torch.analysis.recompile_guard import (
    DEFAULT_BUDGETS, CompilationCounter, RecompileBudgetExceeded, check_experiment_recompiles, recompile_guard,
)
from repro_torch.kernels import _build, ops


def test_counter_hears_the_hook_and_stops_after_exit():
    with CompilationCounter() as counter:
        _build.fire_setup("plan", "a")
        assert counter.count == 1
    _build.fire_setup("plan", "b")
    assert counter.count == 1 and counter.events == [("plan", "a")]
    assert counter._listen not in _build.setup_listeners


def test_guard_raises_over_budget_and_passes_within():
    with recompile_guard(1, label="within") as counter:
        _build.fire_setup("load", "x")
    assert counter.count == 1
    with pytest.raises(RecompileBudgetExceeded, match="over"):
        with recompile_guard(0, label="over"):
            _build.fire_setup("load", "x")
    assert not _build.setup_listeners


def test_plan_cache_fires_on_a_miss_only():
    plans = {}
    with CompilationCounter() as counter:
        for key in (1, 2, 1, 2, 1):
            ops._plan(plans, key, lambda key=key: key * 10, "test")
    assert counter.events == [("plan", "test 1"), ("plan", "test 2")] and plans == {1: 10, 2: 20}


def test_library_load_and_entry_lookup_fire_once(monkeypatch, tmp_path):
    """``_build.load`` fires a build (when the library is missing) and a load
    the first time; ``ops._entry`` an entry the first time."""
    lib_path = tmp_path / "libfake.so"

    class Lib:
        class fn:  # an entry point ctypes would give
            pass

    monkeypatch.setattr(_build, "library_path", lambda name: lib_path)
    monkeypatch.setattr(_build, "build", lambda names: lib_path.write_bytes(b""))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(ops, "_entry_points", {})
    monkeypatch.setitem(ops._SIGNATURES, "fake", ("fn", []))
    with CompilationCounter() as counter:
        ops._entry("fake")
        ops._entry("fake")
        _build.load("fake")
    assert counter.events == [("build", "fake"), ("load", "fake"), ("entry", "fake")]


@pytest.mark.parametrize("policy", ["sync", "deadline", "async-buffer"])
def test_experiment_check_passes_on_the_cpu(policy):
    report = {}
    assert check_experiment_recompiles(policies=(policy,), device="cpu", report=report, warmup_rounds=2,
                                       extra_rounds=2) == []
    assert report[policy] == {"setups": 0, "by_kind": {}, "budget": DEFAULT_BUDGETS[policy], "new_segments": 0}


def test_experiment_check_reports_a_blown_budget(monkeypatch):
    """A runner whose extended rounds set something up each round is held
    to the policy's budget (the set-ups fired through the port's hook)."""
    guard_module = importlib.import_module("repro_torch.analysis.recompile_guard")  # the package exports the function

    class Runner:
        def run(self, rounds):
            for r in range(rounds):
                _build.fire_setup("plan", f"round {r}")

    monkeypatch.setattr(guard_module, "_quickstart_runner", lambda method, policy, device=None: Runner())
    (v,) = check_experiment_recompiles(policies=("sync",), device="cpu")
    assert v.rule == "recompile" and v.where == "droppeft/sync" and "budget 0" in v.message
