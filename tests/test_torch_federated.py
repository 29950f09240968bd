"""The port's federated server half against the JAX package, on the CPU.

Unit parity: the PTLS mask and masked layer mean, the aggregators and the
layer select, on numpy draws, in both layer layouts (float32 within 1e-6,
masks equal); the numpy copies (Dirichlet shards, device batches, the
system model, the rate bandit) give identical outputs.

The runner against JAX's: ``droppeft`` for 3 rounds, ``droppeft_b3`` (the
FedAvg path) and ``fedadaopt`` (progressive depth) for 2, at the smoke
sizes of ``tests/test_cohort_parity.py`` (4 layers, d_model 32, float32, 6
devices with 4 a round, 2 local steps, batch 8, LoRA rank 2); and the
batched runner for 2 rounds of ``droppeft`` at the smoke configs of
rwkv6-3b and jamba (float32, 4 devices with 2 a round, 2 local steps,
batch 4).  The port
gets JAX's base weights and initial global LoRA through ``convert`` and
JAX's STLD gates through a patched ``stld.sample_drops`` that replays the
reference's key stream (the seed key split in three; one fan-out of n+1
keys a round; one split per local step).  The JAX runner runs
``cohort_mode="sequential"``; the port's runs in both of its modes,
``sequential`` and ``batched``, each held to that one JAX run.  Every round: cohorts, rates, active layers,
PTLS masks and accuracies equal; the history's time, traffic, energy and
memory within 1e-12 relative; loss within 1e-5; the global LoRA within the
after-AdamW bound of ``tests/test_torch_training.py`` (every element within
2 * (the sum of the step sizes of every local step so far) + 1e-6, 99%
within 1e-6).  ``final_accuracy`` equal.
"""
import os

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
from repro.core import configurator as jax_configurator
from repro.core import ptls as jax_ptls
from repro.core import stld as jax_stld
from repro.data import partition as jax_partition
from repro.data import pipeline as jax_pipeline
from repro.federated import server as jax_server
from repro.federated import system_model as jax_system_model
from repro.models import stacking as jax_stacking
from repro.optim import make_lr_schedule as jax_make_lr_schedule
from repro_torch import api, convert
from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import configurator, ptls, stld
from repro_torch.data import partition, pipeline
from repro_torch.data.synthetic import make_task
from repro_torch.federated import runner as runner_lib
from repro_torch.federated.algorithms.droppeft import DropPEFT
from repro_torch.federated import server, system_model
from repro_torch.models import stacking
from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)

ATOL = 1e-6


# ------------------------------------------------------------- helpers
def _leaves(tree, path=()):
    """(path, float32 numpy leaf) pairs of a tree of dicts and lists, dict
    keys sorted: one order for JAX's and the port's trees."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in _leaves(t, path + (i,))]
    arr = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return [(path, arr)]


def _assert_trees(got, want, atol=ATOL, exact=False):
    g, w = _leaves(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if exact:
            np.testing.assert_array_equal(a, b, err_msg=str(path))
        else:
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=str(path))


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _pt(tree):
    return convert.peft_from_jax(tree, "cpu")


def _lora(rng, lead=()):
    """A LoRA tree on q and v whose leaves carry ``lead`` (e.g. (L,)) before
    the per-layer shapes."""
    def leaf(*shape):
        return rng.standard_normal(lead + shape, dtype=np.float32)

    return {"attn": {"q": {"a": leaf(6, 2), "b": leaf(2, 6)}, "v": {"a": leaf(6, 2), "b": leaf(2, 4)}}}


def _cohort(rng, n, num_layers, layout):
    """``n`` client trees and a previous global, stacked ``(L, ...)`` or as
    a per-layer list."""
    if layout == "stacked":
        return [_lora(rng, (num_layers,)) for _ in range(n)], _lora(rng, (num_layers,))
    clients = [[_lora(rng) for _ in range(num_layers)] for _ in range(n)]
    return clients, [_lora(rng) for _ in range(num_layers)]


# ------------------------------------------------------------- PTLS masks
@pytest.mark.parametrize("k", [1, 3, 4, 9])
def test_shared_masks_match_jax_with_ties(k):
    """Layers that no step activated tie at importance 0: the stable sort
    takes them in layer order, as ``jnp.argsort``."""
    rng = np.random.default_rng(40)
    imps = rng.random((5, 8), dtype=np.float32)
    imps[0, [1, 4, 6]] = 0.0
    imps[1] = 0.0
    imps[2, :4] = imps[2, 4:]  # ties at non-zero values too
    want = np.asarray(jax_server.cohort_shared_masks(jnp.asarray(imps), k))
    got = server.cohort_shared_masks(torch.from_numpy(imps), k).numpy()
    np.testing.assert_array_equal(got, want)
    for n in range(5):
        np.testing.assert_array_equal(ptls.shared_layer_mask(torch.from_numpy(imps[n]), k).numpy(),
                                      np.asarray(jax_ptls.shared_layer_mask(jnp.asarray(imps[n]), k)))
    assert (got.sum(axis=1) == min(k, 8)).all()


# ------------------------------------------------------------- aggregation
def _masks(rng, n, num_layers):
    masks = rng.random((n, num_layers)) < 0.5
    masks[:, 2] = False  # a layer shared by nobody
    masks[:, 0] = True   # one shared by everybody
    return masks


@pytest.mark.parametrize("layout", ["stacked", "list"])
@pytest.mark.parametrize("weighted", [False, True])
def test_masked_layer_mean_matches_jax(layout, weighted):
    rng = np.random.default_rng(41)
    clients, prev = _cohort(rng, 4, 5, layout)
    masks = _masks(rng, 4, 5)
    weights = jax_server.staleness_weights([0, 2, 1, 3], 0.5) if weighted else None
    if layout == "stacked":
        upd_j = jax.tree.map(lambda *xs: jnp.stack(xs), *_jnp(clients))
        upd_t = stacking.tree_map(lambda *xs: torch.stack(xs), *[_pt(c) for c in clients])
    else:
        upd_j = [jax.tree.map(lambda *xs: jnp.stack(xs), *[_jnp(c[l]) for c in clients]) for l in range(5)]
        upd_t = [stacking.tree_map(lambda *xs: torch.stack(xs), *[_pt(c[l]) for c in clients]) for l in range(5)]
    want = jax_ptls.masked_layer_mean(upd_j, jnp.asarray(masks), _jnp(prev), weights)
    got = ptls.masked_layer_mean(upd_t, torch.from_numpy(masks), _pt(prev), weights)
    _assert_trees(got, want)
    unshared = stacking.layer_view(got, 2)
    _assert_trees(unshared, stacking.layer_view(_pt(prev), 2), exact=True)  # the previous global, bit for bit


@pytest.mark.parametrize("layout,cohort_stacked", [("stacked", False), ("stacked", True), ("list", False)])
@pytest.mark.parametrize("weighted", [False, True])
def test_ptls_aggregate_matches_jax(layout, weighted, cohort_stacked):
    """Client trees as a list or as one cohort-stacked ``(N, L, ...)``
    tree (the stacked layout's)."""
    rng = np.random.default_rng(42)
    clients, prev = _cohort(rng, 3, 4, layout)
    masks = _masks(rng, 3, 4)
    weights = jax_server.staleness_weights([1, 0, 4], 1.0) if weighted else None
    cj, ct = [_jnp(c) for c in clients], [_pt(c) for c in clients]
    if cohort_stacked:
        cj = jax.tree.map(lambda *xs: jnp.stack(xs), *cj)
        ct = stacking.tree_map(lambda *xs: torch.stack(xs), *ct)
    want = jax_server.ptls_aggregate(cj, masks, _jnp(prev), weights=weights)
    got = server.ptls_aggregate(ct, masks, _pt(prev), weights=weights)
    _assert_trees(got, want)


@pytest.mark.parametrize("layout", ["stacked", "list"])
def test_fedavg_and_weighted_fedavg_match_jax(layout):
    rng = np.random.default_rng(43)
    clients, _ = _cohort(rng, 5, 3, layout)
    _assert_trees(server.fedavg([_pt(c) for c in clients]), jax_server.fedavg([_jnp(c) for c in clients]))
    weights = jax_server.staleness_weights([0, 1, 2, 0, 5], 0.7)
    _assert_trees(server.weighted_fedavg([_pt(c) for c in clients], weights),
                  jax_server.weighted_fedavg([_jnp(c) for c in clients], weights))


@pytest.mark.parametrize("alpha", [0.0, 0.5, 2.0])
def test_staleness_weights_match_jax(alpha):
    s = [0, 3, 1, 7, 0]
    np.testing.assert_array_equal(server.staleness_weights(s, alpha), jax_server.staleness_weights(s, alpha))


@pytest.mark.parametrize("axis", [0, 1])
def test_select_layers_matches_jax(axis):
    rng = np.random.default_rng(44)
    lead = (6,) if axis == 0 else (3, 6)
    take, keep = _lora(rng, lead), _lora(rng, lead)
    mask = np.array([True, False, False, True, True, False])
    want = jax_stacking.select_layers(mask, _jnp(take), _jnp(keep), axis=axis)
    _assert_trees(stacking.select_layers(mask, _pt(take), _pt(keep), axis=axis), want, exact=True)
    if axis == 0:
        _assert_trees(server.select_layers(mask, _pt(take), _pt(keep)),
                      jax_server.select_layers(mask, _jnp(take), _jnp(keep)), exact=True)


@pytest.mark.parametrize("with_fallback", [False, True])
def test_screen_finite_matches_jax(with_fallback):
    rng = np.random.default_rng(45)
    tree = _lora(rng, (4,))
    tree["attn"]["q"]["a"][0, 1, 1] = np.nan
    tree["attn"]["q"]["b"][2, 0, 3] = np.inf
    tree["attn"]["v"]["a"][3, 5, 0] = -np.inf
    fallback = _lora(rng, (4,)) if with_fallback else None
    want = jax_server.screen_finite(_jnp(tree), None if fallback is None else _jnp(fallback))
    got = server.screen_finite(_pt(tree), None if fallback is None else _pt(fallback))
    _assert_trees(got, want, exact=True)
    assert all(np.isfinite(a).all() for _, a in _leaves(got))


@pytest.mark.parametrize("layout", ["stacked", "list"])
def test_droppeft_client_init_matches_jax(layout):
    """PTLS client init: a device's shared layers from the global tree, its
    personalized layers from its own, in either layout; a device without a
    tree or mask starts from the global."""
    from types import SimpleNamespace

    from repro.federated.algorithms import DropPEFT as JaxDropPEFT
    from repro.federated.state import RoundState as JaxRoundState
    from repro_torch.federated.algorithms import DropPEFT
    from repro_torch.federated.state import RoundState

    rng = np.random.default_rng(46)
    (own,), glob = _cohort(rng, 1, 5, layout)
    mask = np.array([True, False, True, False, False])
    ctx = SimpleNamespace(cfg=SimpleNamespace(num_layers=5))
    ours, theirs = DropPEFT(), JaxDropPEFT()
    ours.ctx = theirs.ctx = ctx
    state = RoundState(key=0, global_peft=_pt(glob), device_peft={3: _pt(own)}, last_mask={3: mask})
    jstate = JaxRoundState(key=None, global_peft=_jnp(glob), device_peft={3: _jnp(own)}, last_mask={3: mask})
    _assert_trees(ours.client_init(state, 3), theirs.client_init(jstate, 3), exact=True)
    _assert_trees(ours.client_init(state, 1), _pt(glob), exact=True)


# ------------------------------------------------------------- numpy copies
@pytest.mark.parametrize("alpha,num_devices", [(1.0, 100), (0.1, 20)])
def test_partition_and_device_batches_equal_jax(alpha, num_devices):
    task = make_task(vocab_size=128, num_examples=1200, seed=6)
    ours = partition.dirichlet_partition(task.labels, num_devices, alpha, seed=6)
    theirs = jax_partition.dirichlet_partition(task.labels, num_devices, alpha, seed=6)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    for dev in (0, num_devices - 1):
        d_ours = pipeline.DeviceDataset(task, ours[dev], seed=6 + dev)
        d_theirs = jax_pipeline.DeviceDataset(task, theirs[dev], seed=6 + dev)
        for _ in range(2):  # the second draw continues the device's stream
            for b_ours, b_theirs in zip(d_ours.train_batches(8, 3), d_theirs.train_batches(8, 3)):
                for k in b_theirs:
                    np.testing.assert_array_equal(b_ours[k], b_theirs[k])
        for k, v in d_theirs.val_batch().items():
            np.testing.assert_array_equal(d_ours.val_batch()[k], v)
        assert len(d_ours) == len(d_theirs)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_match_jax(arch, smoke):
    assert get_config(arch, smoke=smoke).param_counts() == jax_get_config(arch, smoke=smoke).param_counts()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
def test_cohort_round_cost_equals_jax(arch):
    rng_ours, rng_theirs = np.random.default_rng(7), np.random.default_rng(7)
    devices = [system_model.sample_device(rng_ours) for _ in range(9)]
    assert devices == [jax_system_model.sample_device(rng_theirs) for _ in range(9)]
    assert set(devices) == {"tx2", "nx", "agx"}
    bw = [system_model.sample_bandwidth(rng_ours) for _ in devices]
    assert bw == [jax_system_model.sample_bandwidth(rng_theirs) for _ in devices]
    kw = dict(devices=devices, bandwidth_mbps=np.asarray(bw), batch=16, seq=32, local_steps=4, peft=True,
              active_fraction=np.linspace(0.2, 1.0, 9), share_fraction=np.full(9, 0.5))
    ours = system_model.SystemModel(get_config(arch), PEFTConfig()).cohort_round_cost(**kw)
    theirs = jax_system_model.SystemModel(jax_get_config(arch), JaxPEFTConfig()).cohort_round_cost(**kw)
    for field in ("compute_time_s", "comm_time_s", "memory_gb", "energy_j", "traffic_mb", "total_time_s"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
    one = system_model.SystemModel(get_config(arch), PEFTConfig()).round_cost(device="agx", seq=32)
    assert vars(one) == vars(jax_system_model.SystemModel(jax_get_config(arch), JaxPEFTConfig()).round_cost(
        device="agx", seq=32))


def test_configurator_follows_jax_under_a_scripted_reward_stream():
    """The same rates round by round for 20 rounds of rewards drawn from a
    seeded stream, and a ``state_dict`` round trip mid-run continues both
    the schedule and the Python ``random`` stream."""
    kw = dict(num_candidates=4, explore_rate=0.3, explore_interval=2, window_size=3, seed=11)
    ours, theirs = configurator.OnlineConfigurator(**kw), jax_configurator.OnlineConfigurator(**kw)
    rng = np.random.default_rng(12)
    for rnd in range(20):
        rates = ours.next_round(7)
        assert rates == theirs.next_round(7), rnd
        gains, times = rng.random(7) * 0.1, 1.0 + rng.random(7)
        ours.report(rates, gains, times)
        theirs.report(rates, gains, times)
        assert ours.state_dict() == theirs.state_dict()
        if rnd == 9:
            restored = configurator.OnlineConfigurator(**dict(kw, seed=0))
            restored.load_state_dict(ours.state_dict())
            ours = restored
    assert np.asarray(ours.next_round(3, as_array=True)).dtype == np.float32


# ------------------------------------------------------------- the runner
_CFG_KW = dict(num_layers=4, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, vocab_size=128, dtype="float32")
_FED_KW = dict(num_devices=6, devices_per_round=4, local_steps=2, batch_size=8)
_TRAIN_KW = dict(learning_rate=5e-3, total_steps=100, warmup_steps=2)
SEED = 3


class _JaxGates:
    """The port's ``stld.sample_drops`` replaced by the reference's draws:
    the seed key split in three (``runner.py``), a fan-out of n+1 keys a
    round (``engine.py``), one split per local step (``client.py``), on
    the rates the port computed."""

    def __init__(self, seed, n, steps):
        self.key = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
        self.n, self.steps, self.calls = n, steps, 0

    def __call__(self, generator, rates, min_active=1):
        i, s = (self.calls // self.steps) % self.n, self.calls % self.steps
        self.calls += 1
        if i == 0 and s == 0:
            splits = jax.random.split(self.key, self.n + 1)
            self.key, self.dev_keys = splits[0], splits[1:]
        if s == 0:
            self.rng = self.dev_keys[i]
        self.rng, kd = jax.random.split(self.rng)
        return torch.from_numpy(np.array(jax_stld.sample_drops(kd, jnp.asarray(rates.numpy()), min_active)))


def _record(runner, rows):
    """Keep each round's plan, masks, accuracies, active layers and the
    aggregated global, from the ``report`` hook of either package."""
    algo = runner.algorithm
    report = algo.report

    def wrapped(state, results):
        rows.append({
            "cohort": list(results.plan.cohort), "rates": [float(r) for r in results.plan.rates],
            "masks": np.asarray(results.masks), "accs": list(results.accuracies),
            "active": [float(m["active_layers"]) for m in results.metrics], "global": state.global_peft,
        })
        return report(state, results)

    algo.report = wrapped


@pytest.fixture(scope="module")
def jax_runs():
    return {}


def _jax_run(jax_runs, method, rounds, arch="qwen3-1.7b", cfg_kw=_CFG_KW, fed_kw=_FED_KW):
    if (method, arch) not in jax_runs:
        runner = jax_api.build(
            method, cfg=jax_get_config(arch, smoke=True).replace(**cfg_kw),
            peft_cfg=JaxPEFTConfig(method="lora", lora_rank=2), stld_cfg=JaxSTLDConfig(mode="cond", mean_rate=0.5),
            fed_cfg=JaxFederatedConfig(**fed_kw), train_cfg=JaxTrainConfig(**_TRAIN_KW), seed=SEED,
            cohort_mode="sequential",
        )
        base = jax.tree.map(np.asarray, runner.ctx.engine.base_params)
        peft0 = jax.tree.map(np.asarray, runner.ctx.init_global_peft)
        rows = []
        _record(runner, rows)
        result = runner.run(rounds=rounds)
        jax_runs[(method, arch)] = (base, peft0, rows, result)
    return jax_runs[(method, arch)]


def _port_run(monkeypatch, method, rounds, base, peft0, arch="qwen3-1.7b", cfg_kw=_CFG_KW, fed_kw=_FED_KW,
              cohort_mode="batched"):
    """The port's runner given JAX's weights, initial LoRA and key stream;
    returns its recorded rows and result."""
    fed = FederatedConfig(**fed_kw)
    monkeypatch.setattr(runner_lib, "init_peft", lambda cfg, peft_cfg, gen: convert.peft_from_jax(peft0, "cpu"))
    monkeypatch.setattr(stld, "sample_drops", _JaxGates(SEED, fed.devices_per_round, fed.local_steps))
    runner = api.build(
        method, cfg=get_config(arch, smoke=True).replace(**cfg_kw), peft_cfg=PEFTConfig(lora_rank=2),
        stld_cfg=STLDConfig(mode="cond", mean_rate=0.5), fed_cfg=fed, train_cfg=TrainConfig(**_TRAIN_KW), seed=SEED,
        params=convert.params_from_jax(base, "cpu"), device="cpu", cohort_mode=cohort_mode,
    )
    assert runner.cohort_mode == cohort_mode
    rows = []
    _record(runner, rows)
    return rows, runner.run(rounds=rounds)


def _assert_follows_jax(rows, want_rows, got, want, fed, rounds):
    """Every round's plan, active layers, masks and accuracies equal; the
    global LoRA within the after-AdamW bound; the history as the module
    docstring says."""
    sched = jax_make_lr_schedule("cosine", _TRAIN_KW["learning_rate"], _TRAIN_KW["warmup_steps"],
                                 _TRAIN_KW["total_steps"])
    per_round = fed.devices_per_round * fed.local_steps
    assert len(rows) == len(want_rows) == rounds
    for r, (g, w) in enumerate(zip(rows, want_rows)):
        for key in ("cohort", "rates", "active", "accs"):
            assert g[key] == w[key], (r, key)
        np.testing.assert_array_equal(g["masks"], w["masks"])
        lr_sum = sum(float(sched(step)) for step in range((r + 1) * per_round))
        g_leaves, w_leaves = _leaves(g["global"]), _leaves(w["global"])
        assert [p for p, _ in g_leaves] == [p for p, _ in w_leaves]
        diffs = np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in zip(g_leaves, w_leaves)])
        assert diffs.max() <= 2 * lr_sum + 1e-6, (r, diffs.max())
        assert np.mean(diffs <= 1e-6) >= 0.99, (r, np.mean(diffs <= 1e-6))
    for field in ("cum_time_s", "traffic_mb", "energy_j", "memory_gb"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=1e-12, atol=0)
    for field in ("accuracy", "rates", "active_fraction", "arrivals"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5)
    assert got.final_accuracy == want.final_accuracy
    assert got.rounds == want.rounds == rounds


@pytest.mark.parametrize("cohort_mode", ["sequential", "batched"])
@pytest.mark.parametrize("method,rounds", [("droppeft", 3), ("droppeft_b3", 2), ("fedadaopt", 2)])
def test_runner_follows_jax_round_by_round(jax_runs, monkeypatch, method, rounds, cohort_mode):
    base, peft0, want_rows, want = _jax_run(jax_runs, method, rounds)
    rows, got = _port_run(monkeypatch, method, rounds, base, peft0, cohort_mode=cohort_mode)
    _assert_follows_jax(rows, want_rows, got, want, FederatedConfig(**_FED_KW), rounds)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b"])
def test_batched_runner_follows_jax_for_ssm_and_hybrid_stacks(jax_runs, monkeypatch, arch):
    """The batched runner against JAX's for 2 rounds of ``droppeft`` at the
    smoke configs of rwkv6-3b (the ``ssm`` family, stacked layout) and
    jamba (``hybrid``: a per-layer list, Mamba and MoE layers), float32, 4
    devices with 2 a round, 2 local steps of batch 4; the same checks and
    tolerances as the qwen3 runs."""
    fed_kw = dict(num_devices=4, devices_per_round=2, local_steps=2, batch_size=4)
    kw = dict(arch=arch, cfg_kw={"dtype": "float32"}, fed_kw=fed_kw)
    base, peft0, want_rows, want = _jax_run(jax_runs, "droppeft", 2, **kw)
    rows, got = _port_run(monkeypatch, "droppeft", 2, base, peft0, **kw)
    _assert_follows_jax(rows, want_rows, got, want, FederatedConfig(**fed_kw), 2)


# ------------------------------------------------------------- options of queue 1
_TINY = dict(cfg=get_config("qwen3-1.7b", smoke=True).replace(**_CFG_KW),
             fed_cfg=FederatedConfig(num_devices=4, devices_per_round=2, local_steps=1, batch_size=2), device="cpu")


@pytest.mark.parametrize("kwargs", [
    {"compression": "auto"}, {"compression": {"kind": "int8", "tune": True}}, {"peft": "adapter"},
    {"method": "fedhetlora"}, {"peft": "bitfit"}, {"peft": "none"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_options_raise(kwargs):
    """The options of queue 1, items 6 and 7 that raised until the joint
    bandit, FedHetLoRA and the adapter, BitFit and empty PEFT kinds were
    ported now build and run a round, with the PEFT tree of the kind asked
    for (``tests/test_torch_peft_methods.py``, ``test_torch_hetlora.py``
    and ``test_torch_joint_bandit.py`` hold them to the JAX package).  The
    name is the one the test had while these options raised: each case
    now asserts that its option runs."""
    kwargs = dict(kwargs)
    method = kwargs.pop("method", "droppeft")
    runner = api.build(method, **_TINY, **kwargs)
    result = runner.run(rounds=1)
    assert result.rounds == 1 and np.isfinite(result.cum_time_s).all() and np.isfinite(result.final_accuracy)
    keys = set(runner.state.global_peft)
    want = {"adapter": {"adapter_attn", "adapter_mlp"}, "bitfit": {"bias_attn", "bias_mlp"}, "none": set()}
    assert keys == want.get(kwargs.get("peft"), {"attn"})


@pytest.mark.parametrize("kwargs", [
    {"stld_mode": "gather"},
    {"compression": "int8"}, {"fault_plan": {"dropout_prob": 0.1}}, {"schedule": "deadline"},
    {"schedule": "async-buffer"}, {"deadline_s": 30.0}, {"buffer_size": 2},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_options_of_queue_items_5_and_6_run(kwargs):
    """Options that raised until gather mode, compression, the deadline and
    async-buffer schedules and fault injection were ported now build and
    run a round (``tests/test_torch_gather.py``, ``test_torch_compression.py``
    and ``test_torch_schedules.py`` hold them to the JAX package)."""
    result = api.build("droppeft", **_TINY, **kwargs).run(rounds=1)
    assert result.rounds == 1 and np.isfinite(result.cum_time_s).all()


@pytest.mark.parametrize("kwargs", [{"checkpoint_dir": "ckpts"}, {"resume": True}],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_checkpoint_options_follow_the_reference(kwargs, tmp_path):
    """``resume=True`` without a ``checkpoint_dir`` raises ``ValueError``,
    as the reference's runner does; a ``checkpoint_dir`` with no snapshot
    yet resumes as a fresh start and is written only once a round ends."""
    if "resume" in kwargs:
        with pytest.raises(ValueError, match="requires checkpoint_dir"):
            api.build("droppeft", **_TINY, **kwargs)
        return
    d = str(tmp_path / kwargs["checkpoint_dir"])
    runner = api.build("droppeft", **_TINY, checkpoint_dir=d, resume=True)
    assert runner.state.round_index == 0 and runner.checkpoint_dir == d and not os.path.exists(d)


class _NeedsSequential(DropPEFT):
    """DropPEFT flagged as hetlora is: its trees cannot share a device axis."""

    requires_sequential = True


def test_auto_cohort_mode_runs_sequential():
    """``auto`` resolves as the reference's runner: ``sequential`` only for
    an algorithm that ``requires_sequential``, ``batched`` for the others;
    ``batched`` for such an algorithm raises ``ValueError``."""
    assert api.build(_NeedsSequential(), **_TINY).cohort_mode == "sequential"
    assert api.build("droppeft", **_TINY).cohort_mode == "batched"
    assert api.build("droppeft", cohort_mode="sequential", **_TINY).cohort_mode == "sequential"
    for method in (_NeedsSequential(), "fedhetlora"):
        with pytest.raises(ValueError, match="cannot stack"):
            api.build(method, cohort_mode="batched", **_TINY)
