"""The port's training CLI (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``) and against the port's own API, on the
CPU at smoke size (qwen3-1.7b's smoke config, 4 devices, 2 a round, 2
local steps of batch 4).

* Options: every option of the reference's parser, its default, choices,
  type and action, is the port's, which adds ``--device``.  The reference's
  parser is captured by a patched ``ArgumentParser.parse_args`` that records
  it and raises, so its ``main`` never runs.
* Output: ``main([... "--device", "cpu"])`` writes the history JSON and
  global tree of ``api.build(...).run()`` (that is, ``api.experiment``)
  with the same arguments, bit for bit.
* Resume: one round with ``--state-dir``, then ``--resume`` to two, gives
  the uninterrupted two-round run's JSON and tree bit for bit.
* Faults: ``--fault-plan`` with a file that holds the fields of the
  ``--fault-*`` flags gives their run's JSON; the fault summary prints.
* Against the reference: one run of the reference's CLI, and the port's
  CLI given its base weights, initial LoRA and STLD draws
  (``tests/_torch_fed_parity.py``'s ``JaxDraws``), in float32 (both CLIs'
  ``get_config`` patched to the float32 smoke config, where the federated
  tests' tolerances apply): every round's cohort, rates, active layers and
  accuracies equal; the modelled time, traffic and energy within 1e-12
  relative; the loss within 1e-5 relative; the global LoRA within the
  after-AdamW bound of ``tests/test_torch_training.py`` for the CLI's own
  learning-rate schedule; the final accuracy equal.
"""
import argparse
import json
import sys

import numpy as np
import pytest

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from _torch_fed_parity import JaxDraws, assert_trees_equal, leaves, record
from repro import api as jax_api
from repro.launch import train as jax_train
from repro_torch import api, convert
from repro_torch.checkpoint import load_pytree
from repro_torch.core import stld
from repro_torch.federated import runner as runner_lib
from repro_torch.launch import train
from repro_torch.optim import make_lr_schedule

SMOKE = ["--smoke", "--devices", "4", "--cohort", "2", "--local-steps", "2", "--batch-size", "4"]


def _cli(tmp, name, *extra, rounds=2):
    """The port's CLI on the CPU: (runner, result, the history JSON, the
    saved global tree loaded into the runner's)."""
    out, ckpt = tmp / f"{name}.json", tmp / f"{name}-ckpt"
    runner, res = train.main([*SMOKE, "--rounds", str(rounds), "--device", "cpu", "--ckpt-dir", str(ckpt),
                              "--out", str(out), *extra])
    saved = ckpt / runner.ctx.cfg.name / f"step_{res.rounds:08d}"
    tree = load_pytree(runner.state.global_peft, str(saved))
    return runner, res, json.loads(out.read_text()), tree


@pytest.fixture(scope="module")
def two_rounds(tmp_path_factory):
    return _cli(tmp_path_factory.mktemp("cli"), "two")


def _parser_of(main, monkeypatch, argv=None):
    """The ArgumentParser that ``main`` builds, captured at parse time."""
    seen = []

    class Captured(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen.append(self)
        raise Captured

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(sys, "argv", ["train"])
    with pytest.raises(Captured):
        main() if argv is None else main(argv)
    monkeypatch.undo()
    return seen[0]


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, None if a.choices is None else list(a.choices), a.type,
                     type(a).__name__, a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


def test_options_equal_the_reference_parser(monkeypatch):
    ours, theirs = _options(_parser_of(train.main, monkeypatch, [])), _options(_parser_of(jax_train.main, monkeypatch))
    assert list(ours) == list(theirs) + ["device"]
    for dest, option in theirs.items():
        assert ours[dest] == option, dest
    assert ours["device"][:2] == (("--device",), "cuda")


def test_cli_writes_the_json_and_tree_of_api_experiment(two_rounds):
    runner, res, hist, tree = two_rounds
    assert sorted(hist) == ["accuracy", "arch", "compression", "cum_time_s", "energy_j", "fault_log",
                            "final_accuracy", "method", "schedule", "traffic_mb"]
    args = train.build_parser().parse_args([*SMOKE, "--rounds", "2", "--device", "cpu"])
    same = api.build(args.method, **train.build_kwargs(args, None))
    result = same.run(rounds=2)
    assert hist == json.loads(json.dumps(train.history(args, same.ctx.cfg, same, result)))
    assert hist["arch"] == "qwen3-1.7b-smoke" and hist["schedule"] == "sync" and len(hist["accuracy"]) == 2
    assert_trees_equal(tree, same.state.global_peft)
    assert_trees_equal(tree, runner.state.global_peft)


def test_resume_equals_the_uninterrupted_run(two_rounds, tmp_path):
    _, _, hist, tree = two_rounds
    state = str(tmp_path / "state")
    _cli(tmp_path, "first", "--state-dir", state, rounds=1)
    runner, res, resumed, resumed_tree = _cli(tmp_path, "resumed", "--state-dir", state, "--resume")
    assert runner.state.round_index == 2 and res.rounds == 2
    assert resumed == hist
    assert_trees_equal(resumed_tree, tree)


def test_fault_plan_file_equals_the_shorthand_flags(tmp_path, capsys):
    sched = ["--schedule", "deadline", "--straggler", "carry", "--compression", "int8+topk"]
    _, _, flags, flags_tree = _cli(tmp_path, "flags", *sched, "--fault-dropout", "0.3", "--fault-nan", "0.3")
    assert "faults: " in capsys.readouterr().out and flags["fault_log"]
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"dropout_prob": 0.3, "nan_update_prob": 0.3, "seed": 0}))
    _, _, from_file, file_tree = _cli(tmp_path, "file", *sched, "--fault-plan", str(plan))
    assert from_file == flags and flags["schedule"] == "deadline" and flags["compression"] == "int8+topk"
    assert_trees_equal(file_tree, flags_tree)


def test_fault_flags_override_the_plan_file_and_default_to_the_seed(tmp_path):
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"dropout_prob": 0.3, "seed": 7}))
    parse = train.build_parser().parse_args
    assert train.fault_plan_from(parse(["--seed", "4"])) is None
    shorthand = train.fault_plan_from(parse(["--seed", "4", "--fault-nan", "0.1"]))
    assert (shorthand.seed, shorthand.nan_update_prob, shorthand.dropout_prob) == (4, 0.1, 0.0)
    both = train.fault_plan_from(parse(["--fault-plan", str(plan), "--fault-bandwidth", "0.2"]))
    assert (both.seed, both.dropout_prob, both.bandwidth_collapse_prob) == (7, 0.3, 0.2)


def _float32(get_config):
    return lambda arch, smoke=False: get_config(arch, smoke=smoke).replace(dtype="float32")


def test_the_cli_follows_the_reference_cli(monkeypatch, tmp_path):
    argv = [*SMOKE, "--rounds", "2"]
    seen = {}
    build = jax_api.build

    def jax_build(*args, **kw):
        runner = seen["runner"] = build(*args, **kw)
        seen["base"] = {k: v for k, v in runner.ctx.engine.base_params.items()}
        seen["peft0"] = runner.ctx.init_global_peft
        seen["rec"] = record(runner)
        return runner

    monkeypatch.setattr(jax_api, "build", jax_build)
    monkeypatch.setattr(jax_train, "get_config", _float32(jax_train.get_config))
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir", str(tmp_path / "jax-ckpt"),
                                      "--out", str(tmp_path / "jax.json")])
    jax_train.main()
    want = json.loads((tmp_path / "jax.json").read_text())
    jax_runner = seen["runner"]

    draws = JaxDraws(0, 2)
    port_build = api.build

    def replayed_build(*args, **kw):
        runner = port_build(*args, params=convert.params_from_jax(seen["base"], "cpu"), **kw)
        engine = runner.ctx.engine
        run_cohort = engine.run_cohort

        def replayed(key, global_step, cohort, *rest):
            draws.dispatch(len(cohort))
            return run_cohort(key, global_step, cohort, *rest)

        engine.run_cohort = replayed
        seen["port_rec"] = record(runner)
        return runner

    monkeypatch.setattr(runner_lib, "init_peft", lambda cfg, peft_cfg, gen: convert.peft_from_jax(seen["peft0"], "cpu"))
    monkeypatch.setattr(stld, "sample_drops", draws.drops)
    monkeypatch.setattr(api, "build", replayed_build)
    monkeypatch.setattr(train, "get_config", _float32(train.get_config))
    runner, res, got, tree = _cli(tmp_path, "port", rounds=2)

    g_rec, w_rec = seen["port_rec"], seen["rec"]
    assert len(g_rec["dispatch"]) == len(w_rec["dispatch"]) == 2
    for g, w in zip(g_rec["dispatch"], w_rec["dispatch"]):
        for key in ("cohort", "rates", "active", "accs"):
            assert g[key] == w[key], key
    for g, w in zip(g_rec["aggregate"], w_rec["aggregate"]):
        np.testing.assert_array_equal(g["masks"], w["masks"])
    for key in ("arch", "method", "schedule", "compression", "fault_log", "accuracy", "final_accuracy"):
        assert got[key] == want[key], key
    for key in ("cum_time_s", "traffic_mb", "energy_j"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=0, err_msg=key)
    for g, w in zip(runner.state.history, jax_runner.state.history):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        assert (g["rate"], g["active"], g["arrivals"]) == (w["rate"], w["active"], w["arrivals"])
    # the after-AdamW bound for the CLI's schedule (lr 5e-3, 20 warm-up steps)
    sched = make_lr_schedule("cosine", 5e-3, 20, 4)
    limit = 2 * sum(sched(step) for step in range(jax_runner.state.global_step)) + 1e-6
    g_leaves, w_leaves = leaves(tree), leaves(jax_runner.state.global_peft)
    assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
    diffs = np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in zip(g_leaves, w_leaves)])
    assert diffs.max() <= limit and np.mean(diffs <= 1e-6) >= 0.99, (diffs.max(), limit)
