"""The port's virtual-clock scheduler and fault injection against the JAX
package, on the CPU.

* ``FaultInjector``'s draws (dropout and its completed fraction, bandwidth
  collapse, NaN updates, churn, backoff, kills) equal the reference's over
  a grid of rounds and devices; ``FaultPlan`` JSON reads both ways.
* ``resolve_schedule`` and ``feasible_rate_floor`` equal the reference's.
* The runner against JAX's over 3 aggregations of ``droppeft`` at the smoke
  size of ``tests/test_torch_federated.py`` (the checks and tolerances of
  ``tests/_torch_fed_parity.py``: dispatches, aggregations, history,
  ``event_log``, ``fault_log``, global LoRA): ``deadline`` with ``drop``
  under a fault plan, ``deadline`` with ``carry`` (α 0.5) at ``int8+topk``
  with error feedback under a fault plan, and ``async-buffer`` (α 0.5).
  The deadline, 2.2 ms of modelled time, is about the median of the first
  sync round's device times at this seed, so about half the cohort
  straggles.
* In the port alone: ``deadline_s=inf``, an empty fault plan and
  ``compression="none"`` are ``sync`` bit for bit; a run killed after round 2 with jobs in flight and EF
  residuals, resumed by a fresh runner, gives the uninterrupted run's bits.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from _torch_fed_parity import assert_follows_jax, assert_trees_equal, jax_run, port_run
from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import get_config as jax_get_config
from repro.federated import faults as jax_faults
from repro.federated import scheduler as jax_scheduler
from repro.federated.system_model import SystemModel as JaxSystemModel
from repro_torch import api
from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.federated import faults, scheduler
from repro_torch.federated.system_model import SystemModel

DEADLINE = 0.0022
PLAN = dict(seed=1, dropout_prob=0.25, bandwidth_collapse_prob=0.25, nan_updates=((0, 0), (1, 2), (2, 3)))


# ------------------------------------------------------------- faults
def test_fault_injector_draws_equal_the_reference():
    plan = dict(seed=5, dropout_prob=0.3, dropout_frac=(0.2, 0.8), bandwidth_collapse_prob=0.4,
                bandwidth_collapse_factor=6.0, nan_update_prob=0.2, nan_updates=((3, 1), (0, 7)),
                churn=((2, 1.0, 5.0), (4, 0.5, 0.75), (2, 8.0, 9.0)), kill_at_rounds=(2, 5), retry_backoff_s=10.0,
                max_backoff_s=100.0)
    ours, theirs = faults.FaultInjector(faults.FaultPlan(**plan)), jax_faults.FaultInjector(jax_faults.FaultPlan(**plan))
    for r in range(12):
        assert ours.kills_after(r) == theirs.kills_after(r)
        for dev in range(16):
            assert ours.dropout_at(r, dev) == theirs.dropout_at(r, dev)
            assert ours.bandwidth_factor_at(r, dev) == theirs.bandwidth_factor_at(r, dev)
            assert ours.corrupts(r, dev) == theirs.corrupts(r, dev)
    for dev in range(6):
        for t in np.linspace(0.0, 10.0, 41).tolist():
            assert ours.unavailable(dev, t) == theirs.unavailable(dev, t)
            assert ours.next_rejoin(dev, t) == theirs.next_rejoin(dev, t)
    assert [ours.backoff_s(n) for n in range(1, 9)] == [theirs.backoff_s(n) for n in range(1, 9)]
    assert {ours.dropout_at(r, d) is None for r in range(12) for d in range(16)} == {True, False}


def test_fault_plan_json_reads_both_ways(tmp_path):
    plan = faults.FaultPlan(**PLAN, churn=((1, 0.0, 2.0),), kill_at_rounds=(2,))
    assert jax_faults.FaultPlan.from_json(plan.to_json()) == jax_faults.FaultPlan(**PLAN, churn=((1, 0.0, 2.0),),
                                                                                  kill_at_rounds=(2,))
    back = faults.FaultPlan.from_json(jax_faults.FaultPlan.from_json(plan.to_json()).to_json())
    assert back == plan and json.loads(back.to_json()) == json.loads(plan.to_json())
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    assert faults.resolve_fault_plan(str(path)) == plan == faults.resolve_fault_plan(dict(json.loads(plan.to_json())))
    assert faults.resolve_fault_plan(None) is None and not faults.FaultPlan().any_faults
    for bad in ({"dropout_prob": 1.5}, {"dropout_frac": (0.9, 0.1)}, {"bandwidth_collapse_factor": 0.5},
                {"retry_backoff_s": 0.0}):
        with pytest.raises(ValueError):
            faults.FaultPlan(**bad)


# ------------------------------------------------------------- configs
def test_resolve_schedule_and_rate_floor_follow_jax():
    for schedule, kw in ((None, {}), ("deadline", {"deadline_s": 5.0}), (None, {"deadline_s": 5.0}),
                         (None, {"buffer_size": 3}), ("async-buffer", {"staleness_alpha": 0.5}),
                         ("deadline", {"straggler": "carry", "staleness_alpha": 0.25})):
        got, want = scheduler.resolve_schedule(schedule, **kw), jax_scheduler.resolve_schedule(schedule, **kw)
        assert vars(got) == vars(want) and got.keeps_in_flight_state == want.keeps_in_flight_state
    for bad in (("sync", {"deadline_s": 1.0}), (None, {"staleness_alpha": 0.5})):
        with pytest.raises(ValueError):
            scheduler.resolve_schedule(bad[0], **bad[1])
    ours = SystemModel(get_config("qwen3-1.7b"), PEFTConfig())
    theirs = JaxSystemModel(jax_get_config("qwen3-1.7b"), JaxPEFTConfig())
    grid = FederatedConfig().rate_grid
    for deadline in (1.0, 20.0, 60.0, 120.0, 600.0, math.inf):
        kw = dict(rate_grid=grid, batch=16, seq=32, local_steps=4)
        got = scheduler.feasible_rate_floor(ours, ["tx2", "nx", "agx"], deadline, **kw)
        assert got == jax_scheduler.feasible_rate_floor(theirs, ["tx2", "nx", "agx"], deadline, **kw)


# ------------------------------------------------------------- the runner
CASES = {
    "deadline-drop-faults": dict(schedule="deadline", deadline_s=DEADLINE, fault_plan=PLAN),
    "deadline-carry-int8+topk-faults": dict(schedule="deadline", deadline_s=DEADLINE, straggler="carry",
                                            staleness_alpha=0.5, compression="int8+topk", fault_plan=PLAN),
    "async-buffer": dict(schedule="async-buffer", buffer_size=2, staleness_alpha=0.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_runner_under_the_schedules_follows_jax(monkeypatch, case):
    kw = CASES[case]
    want = jax_run("droppeft", 3, **kw)
    got = port_run(monkeypatch, "droppeft", 3, want["base"], want["peft0"], **kw)
    assert_follows_jax(got, want, rounds=3)
    history = got["history"]
    if case.startswith("deadline"):
        assert any(row["arrivals"] < len(d["cohort"]) for row, d in zip(history, got["rec"]["dispatch"]))
        assert {f["reason"] for f in got["faults"]} >= {"dropout", "non-finite-update"}
    if "carry" in case:  # a straggler lands in a later round
        assert any(d not in got["rec"]["dispatch"][r]["cohort"] for r, d, _ in got["events"])
    if case == "async-buffer":
        assert [row["arrivals"] for row in history] == [2, 2, 2]
        assert any(len(set(a["weights"].tolist())) > 1 for a in got["rec"]["aggregate"])


# ------------------------------------------------------------- port alone
_PORT = dict(cfg=get_config("qwen3-1.7b", smoke=True).replace(num_layers=4, d_model=32, d_ff=64, num_heads=2,
                                                               num_kv_heads=2, vocab_size=128, dtype="float32"),
             peft_cfg=PEFTConfig(lora_rank=2), stld_cfg=STLDConfig(mode="gather", gather_bucket=1),
             fed_cfg=FederatedConfig(num_devices=6, devices_per_round=4, local_steps=2, batch_size=8),
             train_cfg=TrainConfig(learning_rate=5e-3, total_steps=100, warmup_steps=2), seed=3, device="cpu")


def _bits(runner, result):
    return dict(history=runner.state.history, events=runner.scheduler.event_log, faults=runner.scheduler.fault_log,
                final=result.final_accuracy, peft=runner.state.global_peft)


def _assert_same_bits(got, want):
    for key in ("history", "events", "faults", "final"):
        assert got[key] == want[key], key
    assert_trees_equal(got["peft"], want["peft"])


def test_infinite_deadline_an_empty_fault_plan_and_no_compression_are_sync_bit_for_bit():
    runs = []
    for kw in ({}, {"schedule": "deadline", "deadline_s": math.inf}, {"fault_plan": faults.FaultPlan()},
               {"compression": "none"}):
        runner = api.build("droppeft", **_PORT, **kw)
        runs.append(_bits(runner, runner.run(rounds=2)))
    for other in runs[1:]:
        _assert_same_bits(other, runs[0])


def test_kill_and_resume_with_jobs_in_flight_is_bit_identical(tmp_path):
    kw = dict(schedule="deadline", deadline_s=DEADLINE, straggler="carry", compression="int8+topk")
    plan = faults.FaultPlan(**PLAN)
    runner = api.build("droppeft", **_PORT, fault_plan=plan, **kw)
    whole = _bits(runner, runner.run(rounds=3))
    d = str(tmp_path / "ckpt")
    killed = api.build("droppeft", **_PORT, fault_plan=dataclasses.replace(plan, kill_at_rounds=(2,)),
                       checkpoint_dir=d, **kw)
    with pytest.raises(faults.ServerKilled):
        killed.run(rounds=3)
    arrays, meta = ckpt_lib.load_state(ckpt_lib.latest_state_dir(d))
    assert meta["round_index"] == 2 and meta["scheduler"]["jobs"] and arrays["ef_residual"]
    assert faults.FaultPlan.from_json(meta["fault_plan"]).kill_at_rounds == (2,)
    resumed = api.build("droppeft", **_PORT, fault_plan=plan, checkpoint_dir=d, resume=True, **kw)
    assert resumed.scheduler.in_flight == killed.scheduler.in_flight
    _assert_same_bits(_bits(resumed, resumed.run(rounds=3)), whole)
