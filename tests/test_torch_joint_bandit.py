"""The port's joint (dropout rate x compression level) bandit against the
JAX package, on the CPU.

* ``JointConfigurator`` gives JAX's arms draw for draw over 14 rounds of
  the same reported rewards (seeded numpy): the start-up pairs, the
  exploration sweeps over the product grid, the exploitation of the best
  arm, with and without a rate floor (set at construction and later by
  ``set_rate_floor``); its ``state_dict`` through JSON equals JAX's every
  round, and a bandit restored from it mid-run draws on as the original.
  ``next_round`` raises ``TypeError``, no levels ``ValueError``, as there.
* The runner with ``compression="auto"``: droppeft for 3 rounds at the
  smoke size of ``tests/test_torch_federated.py``, with JAX's weights,
  initial LoRA and STLD draws, follows JAX's run round by round
  (``assert_follows_jax``) in both cohort modes; its bandit ends in JAX's
  state (arms, lists, history equal; rewards within 1e-12 relative, as the
  modelled times they divide by).
"""
import json

import numpy as np
import pytest

from repro.core import configurator as jax_configurator
from repro.federated import compression as jax_compression
from repro_torch.core import configurator
from repro_torch.federated import compression
from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from _torch_fed_parity import assert_follows_jax, jax_run, port_run

KW = dict(num_candidates=4, explore_rate=0.5, explore_interval=3, window_size=4, seed=5)


def _json(state):
    return json.loads(json.dumps(state))


def _drive(bandits, rounds, rng, n=5):
    """``rounds`` rounds of arms from each bandit (all must agree) with the
    same rewards reported to each; returns the arms drawn."""
    drawn = []
    for _ in range(rounds):
        arms = [b.next_round_joint(n) for b in bandits]
        assert all(a == arms[0] for a in arms[1:])
        rates, levels = arms[0]
        gains, times = rng.random(n) * 0.1, rng.random(n) * 10.0 + 1.0
        for b in bandits:
            b.report(list(zip(rates, levels)), gains, times)
        states = [_json(b.state_dict()) for b in bandits]
        assert all(s == states[0] for s in states[1:])
        drawn.append(arms[0])
    return drawn


@pytest.mark.parametrize("floor", [None, "init", "later"])
def test_joint_configurator_draws_as_jax(floor):
    kw = dict(KW, rate_floor=0.4) if floor == "init" else KW
    ours = configurator.JointConfigurator(levels=compression.LEVELS, **kw)
    theirs = jax_configurator.JointConfigurator(levels=jax_compression.LEVELS, **kw)
    assert compression.LEVELS == jax_compression.LEVELS and ours.list_c == theirs.list_c
    rng = np.random.default_rng(11)
    drawn = _drive([ours, theirs], 5, rng)
    if floor == "later":
        ours.set_rate_floor(0.6)
        theirs.set_rate_floor(0.6)
    drawn += _drive([ours, theirs], 9, rng)
    if floor is None:
        first = drawn[0]
        assert list(zip(*first)) == [(0.2, "none"), (0.5, "int8"), (0.7, "topk"), (0.2, "none"), (0.5, "int8")]
    assert len({lv for _, levels in drawn for lv in levels}) >= 3  # later sweeps reach other levels
    assert any(len(set(zip(*arms))) == 1 for arms in drawn)  # an exploitation round: one arm for all
    if floor is not None:
        assert min(r for rates, _ in drawn[5:] for r in rates) >= (0.4 if floor == "init" else 0.6)


def test_joint_state_dict_round_trips_and_resumes():
    rng = np.random.default_rng(12)
    ours = configurator.JointConfigurator(levels=compression.LEVELS, **KW)
    theirs = jax_configurator.JointConfigurator(levels=jax_compression.LEVELS, **KW)
    _drive([ours, theirs], 6, rng)
    state = _json(ours.state_dict())
    assert state == _json(theirs.state_dict()) and state["joint"] is True and state["levels"] == list(compression.LEVELS)
    assert all(isinstance(k, list) for k in state["list_c"] + state["history"])  # tuples come back as lists
    restored = configurator.JointConfigurator(levels=compression.LEVELS, **dict(KW, seed=99))
    restored.load_state_dict(state)
    assert restored.arms.keys() == ours.arms.keys() and all(isinstance(k, tuple) for k in restored.arms)
    _drive([ours, restored, theirs], 6, rng)
    with pytest.raises(TypeError):
        ours.next_round(4)
    with pytest.raises(ValueError):
        configurator.JointConfigurator(levels=())


@pytest.fixture(scope="module")
def jax_auto():
    return jax_run("droppeft", 3, compression="auto")


@pytest.mark.parametrize("cohort_mode", ["batched", "sequential"])
def test_auto_compression_runner_follows_jax(jax_auto, monkeypatch, cohort_mode):
    want = jax_auto
    got = port_run(monkeypatch, "droppeft", 3, want["base"], want["peft0"], cohort_mode=cohort_mode,
                   compression="auto")
    assert_follows_jax(got, want, rounds=3)
    state, want_state = got["runner"].state.configurator.state_dict(), want["configurator"]
    assert state["joint"] and sorted(state) == sorted(want_state)
    arms = lambda s: [(tuple(a["rate"]), a["last_eval"]) for a in s["arms"]]  # noqa: E731
    assert arms(_json(state)) == arms(_json(want_state))
    for key in ("list_c", "history", "pending", "is_explore", "round", "rng_state", "levels"):
        assert _json(state)[key] == _json(want_state)[key], key
    for a, b in zip(state["arms"], want_state["arms"]):
        np.testing.assert_allclose(a["rewards"], b["rewards"], rtol=1e-12, atol=0)
    levels = [lv for _, lv in state["history"]]
    assert {"none", "int8", "topk"} <= set(levels)
    assert all(a["uplinks"] for a in got["rec"]["aggregate"][:1])  # the first round compressed some uplinks
