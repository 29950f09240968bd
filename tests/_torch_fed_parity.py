"""Helpers shared by the port's federated parity tests
(``tests/test_torch_gather.py``, ``test_torch_compression.py``,
``test_torch_schedules.py``): the smoke configuration of
``tests/test_torch_federated.py``, JAX's STLD draws replayed into the port,
per-dispatch and per-aggregation records from either package's hooks, and
the round-by-round comparison.

JAX's threefry keys and torch's generators never agree, so the port's
sampler (``stld.sample_drops``, or ``stld.sample_active_indices`` in gather
mode) is patched to draw from the reference's key stream: the seed key
split in three (``runner.py``), one fan-out of n+1 keys a dispatch of n
devices (``engine.py``), one split a local step (``client.py``), on the
rates the port computed.  A dispatch's size is read off the engine's
``run_cohort`` call, so cohorts of any size (async refills, devices
excluded while in flight) replay too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.configs import FederatedConfig as JaxFederatedConfig
from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import STLDConfig as JaxSTLDConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import stld as jax_stld
from repro.optim import make_lr_schedule as jax_make_lr_schedule
from repro_torch import api, convert
from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import stld
from repro_torch.federated import runner as runner_lib

CFG_KW = dict(num_layers=4, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, vocab_size=128, dtype="float32")
FED_KW = dict(num_devices=6, devices_per_round=4, local_steps=2, batch_size=8)
TRAIN_KW = dict(learning_rate=5e-3, total_steps=100, warmup_steps=2)
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run a module's tests on one intra-op torch thread, then restore the
    count.  The runs here are many small ops; beside other test processes
    (the suite runs 6 workers) torch's OpenMP threads spin against each
    other and a smoke run slows 10× or more.  Import it into a test module
    to apply it there."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree, path=()):
    """(path, numpy leaf) pairs of a tree of dicts and lists, dict keys
    sorted: one order for JAX's and the port's trees."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in leaves(t, path + (i,))]
    arr = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return [(path, arr)]


def assert_trees_equal(got, want):
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(a, b, err_msg=str(path))


class JaxDraws:
    """The reference's STLD draws for the port's sampler (module
    docstring); ``gather`` replays ``sample_active_indices``."""

    def __init__(self, seed, steps, gather=False):
        self.key = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
        self.steps, self.gather, self.calls, self.n = steps, gather, 0, 0

    def dispatch(self, n):
        splits = jax.random.split(self.key, n + 1)
        self.key, self.dev_keys, self.n, self.calls = splits[0], splits[1:], n, 0

    def _step_key(self):
        i, s = divmod(self.calls, self.steps)
        assert i < self.n, "more draws than the dispatch's devices take"
        self.calls += 1
        if s == 0:
            self.rng = self.dev_keys[i]
        self.rng, kd = jax.random.split(self.rng)
        return kd

    def drops(self, generator, rates, min_active=1):
        return torch.from_numpy(np.array(jax_stld.sample_drops(self._step_key(), jnp.asarray(rates.numpy()),
                                                               min_active)))

    def indices(self, generator, rates, k):
        idx = jax_stld.sample_active_indices(self._step_key(), jnp.asarray(rates.numpy()), k)
        return torch.from_numpy(np.array(idx)).long()


def record(runner):
    """Per-dispatch and per-aggregation records from the ``cohort_step``
    and ``aggregate`` hooks of either package's algorithm."""
    algo, rec = runner.algorithm, {"dispatch": [], "aggregate": []}
    cohort_step, aggregate = algo.cohort_step, algo.aggregate

    def on_cohort_step(state, plan):
        state, results = cohort_step(state, plan)
        rec["dispatch"].append({
            "cohort": list(plan.cohort), "rates": [float(r) for r in plan.rates],
            "accs": [float(a) for a in results.accuracies],
            "active": [float(m["active_layers"]) for m in results.metrics],
        })
        return state, results

    def on_aggregate(state, results):
        out = aggregate(state, results)
        rec["aggregate"].append({
            "cohort": list(results.plan.cohort), "masks": np.asarray(results.masks),
            "weights": None if results.weights is None else np.asarray(results.weights),
            "uplinks": results.uplink_pefts is not None, "global": out.global_peft,
            "global_step": state.global_step,
            "ef": sorted(getattr(out, "ef_residual", {}) or {}),
        })
        return out

    algo.cohort_step, algo.aggregate = on_cohort_step, on_aggregate
    return rec


def jax_kwargs(stld_kw, fed_kw, arch, cfg_kw, peft_kw=None):
    return dict(cfg=jax_get_config(arch, smoke=True).replace(**cfg_kw),
                peft_cfg=JaxPEFTConfig(**{"method": "lora", "lora_rank": 2, **(peft_kw or {})}),
                stld_cfg=JaxSTLDConfig(**stld_kw), fed_cfg=JaxFederatedConfig(**fed_kw),
                train_cfg=JaxTrainConfig(**TRAIN_KW), seed=SEED)


def jax_run(method, rounds, *, stld_kw=None, fed_kw=FED_KW, arch="qwen3-1.7b", cfg_kw=CFG_KW, peft_kw=None,
            **kwargs):
    """The reference's run, sequential: (base, initial PEFT tree of the
    context, the global tree ``bind`` gave (hetlora draws its own), records,
    result, event log, fault log, the bandit's final ``state_dict``)."""
    stld_kw = stld_kw or dict(mode="cond", mean_rate=0.5)
    runner = jax_api.build(method, **jax_kwargs(stld_kw, fed_kw, arch, cfg_kw, peft_kw), cohort_mode="sequential",
                           **kwargs)
    base = jax.tree.map(np.asarray, runner.ctx.engine.base_params)
    peft0 = jax.tree.map(np.asarray, runner.ctx.init_global_peft)
    global0 = jax.tree.map(np.asarray, runner.state.global_peft)
    rec = record(runner)
    result = runner.run(rounds=rounds)
    cfgor = runner.state.configurator
    return dict(base=base, peft0=peft0, global0=global0, rec=rec, result=result, history=runner.state.history,
                events=list(runner.scheduler.event_log), faults=list(runner.scheduler.fault_log),
                configurator=None if cfgor is None else cfgor.state_dict())


def port_runner(monkeypatch, method, base, peft0, *, stld_kw=None, fed_kw=FED_KW, arch="qwen3-1.7b", cfg_kw=CFG_KW,
                cohort_mode="batched", peft_kw=None, **kwargs):
    """The port's runner on the CPU with JAX's weights, initial PEFT tree
    (``peft_kw`` the ``PEFTConfig`` fields past rank 2 LoRA) and key stream
    (not run yet)."""
    stld_kw = stld_kw or dict(mode="cond", mean_rate=0.5)
    fed = FederatedConfig(**fed_kw)
    draws = JaxDraws(SEED, fed.local_steps, gather=stld_kw.get("mode") == "gather")
    monkeypatch.setattr(runner_lib, "init_peft", lambda cfg, peft_cfg, gen: convert.peft_from_jax(peft0, "cpu"))
    monkeypatch.setattr(stld, "sample_drops", draws.drops)
    monkeypatch.setattr(stld, "sample_active_indices", draws.indices)
    runner = api.build(
        method, cfg=get_config(arch, smoke=True).replace(**cfg_kw),
        peft_cfg=PEFTConfig(**{"lora_rank": 2, **(peft_kw or {})}),
        stld_cfg=STLDConfig(**stld_kw), fed_cfg=fed, train_cfg=TrainConfig(**TRAIN_KW), seed=SEED,
        params=convert.params_from_jax(base, "cpu"), device="cpu", cohort_mode=cohort_mode, **kwargs,
    )
    engine = runner.ctx.engine
    run_cohort = engine.run_cohort

    def replayed(key, global_step, cohort, *args):
        draws.dispatch(len(cohort))
        return run_cohort(key, global_step, cohort, *args)

    engine.run_cohort = replayed
    return runner


def port_run(monkeypatch, method, rounds, base, peft0, **kwargs):
    runner = port_runner(monkeypatch, method, base, peft0, **kwargs)
    rec = record(runner)
    result = runner.run(rounds=rounds)
    return dict(rec=rec, result=result, history=runner.state.history, events=list(runner.scheduler.event_log),
                faults=list(runner.scheduler.fault_log), runner=runner)


def _close_dict(got, want, key):
    """Two JSON-like records: equal, floats within 1e-12 relative."""
    assert sorted(got) == sorted(want), key
    for k in want:
        if isinstance(want[k], float):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=f"{key}.{k}")
        else:
            assert got[k] == want[k], (key, k)


def assert_follows_jax(got, want, fed_kw=FED_KW, rounds=None):
    """Every dispatch's cohort, rates, active layers and accuracies equal;
    every aggregation's arrivals, masks and staleness weights equal and its
    global LoRA within the after-AdamW bound of
    ``tests/test_torch_training.py`` (every element within 2 * the sum of
    the step sizes so far + 1e-6, 99% within 1e-6); the history rows (time,
    traffic, energy, memory within 1e-12 relative; loss within 1e-5; the
    rest equal), the event log (times within 1e-12 relative) and the fault
    log; ``final_accuracy`` equal."""
    sched = jax_make_lr_schedule("cosine", TRAIN_KW["learning_rate"], TRAIN_KW["warmup_steps"],
                                 TRAIN_KW["total_steps"])
    g_rec, w_rec = got["rec"], want["rec"]
    assert len(g_rec["dispatch"]) == len(w_rec["dispatch"])
    for r, (g, w) in enumerate(zip(g_rec["dispatch"], w_rec["dispatch"])):
        for key in ("cohort", "rates", "active", "accs"):
            assert g[key] == w[key], ("dispatch", r, key)
    assert len(g_rec["aggregate"]) == len(w_rec["aggregate"])
    for r, (g, w) in enumerate(zip(g_rec["aggregate"], w_rec["aggregate"])):
        assert g["cohort"] == w["cohort"] and g["uplinks"] == w["uplinks"] and g["ef"] == w["ef"], r
        assert g["global_step"] == w["global_step"], r
        np.testing.assert_array_equal(g["masks"], w["masks"])
        assert (g["weights"] is None) == (w["weights"] is None), r
        if w["weights"] is not None:
            np.testing.assert_allclose(g["weights"], w["weights"], rtol=1e-12)
        lr_sum = sum(float(sched(step)) for step in range(w["global_step"]))
        g_leaves, w_leaves = leaves(g["global"]), leaves(w["global"])
        assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
        diffs = np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in zip(g_leaves, w_leaves)])
        assert diffs.max() <= 2 * lr_sum + 1e-6, (r, diffs.max())
        assert np.mean(diffs <= 1e-6) >= 0.99, (r, np.mean(diffs <= 1e-6))
    assert len(got["history"]) == len(want["history"]) == (rounds or len(want["history"]))
    for r, (g, w) in enumerate(zip(got["history"], want["history"])):
        assert sorted(g) == sorted(w), r
        for key in ("time", "traffic", "energy", "memory"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-12, atol=0, err_msg=f"{r} {key}")
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5, err_msg=str(r))
        for key in sorted(set(w) - {"time", "traffic", "energy", "memory", "loss"}):
            assert g[key] == w[key], (r, key)
    assert [(r, d) for r, d, _ in got["events"]] == [(r, d) for r, d, _ in want["events"]]
    np.testing.assert_allclose([t for *_, t in got["events"]], [t for *_, t in want["events"]], rtol=1e-12, atol=0)
    assert len(got["faults"]) == len(want["faults"])
    for i, (g, w) in enumerate(zip(got["faults"], want["faults"])):
        _close_dict(g, w, f"fault {i}")
    assert got["result"].final_accuracy == want["result"].final_accuracy
