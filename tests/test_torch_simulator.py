"""The port's deprecated ``FederatedSimulator`` shim against the JAX
package's ``repro.federated.simulator``, on the CPU.

``Strategy`` and ``METHODS`` equal the reference's field for field;
``algorithm_from_strategy`` gives the reference's algorithm class and
settings for every entry (and for a custom strategy); ``FederatedSimulator``
warns with a ``DeprecationWarning``, and its run equals ``api.experiment``'s
with the same arguments bit for bit (the smoke sizes of
``tests/_torch_fed_parity.py``, 2 rounds), its legacy properties reading the
runner's state.
"""
import dataclasses

import numpy as np
import pytest

from _torch_fed_parity import CFG_KW, FED_KW, SEED, TRAIN_KW, assert_trees_equal
from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.federated import simulator as jax_simulator
from repro_torch import api
from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.federated import simulator

_SETTINGS = ("name", "stld", "use_configurator", "use_ptls", "fixed_rate", "hetlora_ranks", "adaopt_grow_every",
             "requires_sequential")


def _settings(algo):
    return type(algo).__name__, {key: getattr(algo, key, None) for key in _SETTINGS}


def test_methods_equal_the_reference_field_for_field():
    assert [f.name for f in dataclasses.fields(simulator.Strategy)] == \
        [f.name for f in dataclasses.fields(jax_simulator.Strategy)]
    assert dataclasses.asdict(simulator.Strategy()) == dataclasses.asdict(jax_simulator.Strategy())
    assert list(simulator.METHODS) == list(jax_simulator.METHODS)
    for name, strategy in jax_simulator.METHODS.items():
        assert dataclasses.asdict(simulator.METHODS[name]) == dataclasses.asdict(strategy), name


@pytest.mark.parametrize("name", list(jax_simulator.METHODS) + ["custom"])
def test_algorithm_from_strategy_equals_the_reference(name):
    if name == "custom":
        ours = simulator.Strategy("custom", configurator=False, fixed_rate=0.3, hetlora=True, hetlora_ranks=(2, 4, 6))
        theirs = jax_simulator.Strategy("custom", configurator=False, fixed_rate=0.3, hetlora=True,
                                        hetlora_ranks=(2, 4, 6))
    else:
        ours, theirs = simulator.METHODS[name], jax_simulator.METHODS[name]
    assert _settings(simulator.algorithm_from_strategy(ours)) == \
        _settings(jax_simulator.algorithm_from_strategy(theirs))


def _configs():
    return (get_config("qwen3-1.7b", smoke=True).replace(**CFG_KW), PEFTConfig(lora_rank=2),
            STLDConfig(mode="cond", mean_rate=0.5), FederatedConfig(**FED_KW), TrainConfig(**TRAIN_KW))


@pytest.mark.parametrize("strategy", ["droppeft", "droppeft_b2"])
def test_simulator_warns_and_equals_api_experiment(strategy):
    cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg = _configs()
    with pytest.warns(DeprecationWarning, match="FederatedSimulator is deprecated"):
        sim = simulator.FederatedSimulator(cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, strategy=strategy,
                                           seed=SEED, device="cpu")
    got = sim.run(rounds=2)
    algo = simulator.algorithm_from_strategy(simulator.METHODS[strategy])
    runner = api.build(algo, cfg=cfg, peft_cfg=peft_cfg, stld_cfg=stld_cfg, fed_cfg=fed_cfg, train_cfg=train_cfg,
                       seed=SEED, device="cpu")
    want = runner.run(rounds=2)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name
    assert_trees_equal(sim.global_peft, runner.state.global_peft)
    assert sorted(sim.device_peft) == sorted(runner.state.device_peft)
    assert sim.runner.state.round_index == 2 and sim.cohort_mode == "batched"
    assert len(sim.devices) == fed_cfg.num_devices and sim.task.seq_len == runner.ctx.task.seq_len
    assert sim.strategy is simulator.METHODS[strategy]
