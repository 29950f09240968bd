"""Gather-mode STLD and the stack modes of the port against the JAX package,
on the CPU.

* ``sample_active_indices``: sorted, distinct, k of them, one generator
  draw a call; its inclusion frequencies over 4 000 draws within 0.03 of
  JAX's over 4 000 keys (both Gumbel top-k on the same rates);
  ``static_active_count`` equal to the reference's on a grid;
  ``sample_drops_block`` equal to the reference's on JAX's Bernoulli
  draws.
* A gather ``local_round`` on JAX's indices (the port's sampler patched),
  at the smoke size of ``tests/test_torch_training.py``: metrics within
  1e-5 relative, importances 1e-4, the PEFT tree within its after-AdamW
  bound, ``active_layers`` exactly k.
* The runner in gather mode against JAX's, round by round for 2 rounds of
  ``droppeft`` (the checks and tolerances of
  ``tests/test_torch_federated.py``, buckets that let the bandit's rates
  give the devices different k), on qwen3 in both cohort modes and
  rwkv6-3b batched; the port's runner on jamba's heterogeneous stack
  raises ``ValueError``, as JAX's ``stack_apply`` does (below).
* ``model_apply`` in the ``scan`` and ``group`` stack modes against JAX's
  logits at qwen3's and jamba's smoke sizes (1e-4 abs, float32), with
  gates; ``scan`` and ``gather`` on jamba and ``group`` on a depth
  the layer pattern's period does not divide raise ``ValueError`` in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from _torch_fed_parity import CFG_KW, FED_KW, assert_follows_jax, jax_run, leaves, port_run
from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import STLDConfig as JaxSTLDConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import peft as jax_peft
from repro.core import stld as jax_stld
from repro.core.schedules import unit_shape as jax_unit_shape
from repro.federated.client import make_client_fns as jax_make_client_fns
from repro.models.registry import init_params as jax_init_params
from repro.models.registry import model_apply as jax_model_apply
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import api, convert
from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import stld
from repro_torch.data.synthetic import make_task
from repro_torch.federated.client import make_client_fns
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import model_apply
from repro_torch.optim import adamw_init, make_lr_schedule

GATHER = dict(mode="gather", mean_rate=0.5, gather_bucket=2)


# ------------------------------------------------------------- samplers
def test_sample_active_indices_sorted_distinct_and_as_frequent_as_jax():
    rates = torch.tensor([0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 0.95, 0.2])
    k, draws = 3, 4000
    gen, twin = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    stld.sample_active_indices(gen, rates, k)
    torch.rand((8,), generator=twin)
    assert torch.equal(gen.get_state(), twin.get_state())  # one draw of the generator a call
    counts = np.zeros(8)
    for _ in range(draws):
        idx = stld.sample_active_indices(gen, rates, k)
        assert idx.dtype == torch.int64 and len(idx) == k
        assert idx.tolist() == sorted(set(idx.tolist()))
        counts[idx.numpy()] += 1
    keys = jax.random.split(jax.random.PRNGKey(1), draws)
    jidx = np.asarray(jax.vmap(lambda key: jax_stld.sample_active_indices(key, jnp.asarray(rates.numpy()), k))(keys))
    want = np.bincount(jidx.ravel(), minlength=8) / draws
    np.testing.assert_allclose(counts / draws, want, atol=0.03)
    assert counts[0] > counts[5] > counts[6]  # keep-probability orders inclusion


def test_static_active_count_matches_jax_on_a_grid():
    for num_layers in (2, 4, 8, 28, 32, 40):
        for mean_rate in np.linspace(0.0, 0.95, 20).tolist():
            for bucket in (1, 2, 4):
                for min_active in (1, 2):
                    want = jax_stld.static_active_count(mean_rate, num_layers, bucket, min_active)
                    assert stld.static_active_count(mean_rate, num_layers, bucket, min_active) == want


@pytest.mark.parametrize("block_size,min_active", [(2, 1), (3, 2), (4, 5)])
def test_sample_drops_block_matches_jax_on_its_bernoulli_draws(monkeypatch, block_size, min_active):
    rates = jnp.asarray(np.random.default_rng(5).uniform(0.2, 0.9, 10), dtype=jnp.float32)
    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_stld.sample_drops_block(key, rates, block_size, min_active))
        monkeypatch.setattr(stld, "sample_drops", lambda gen, r, min_active=1, key=key: torch.from_numpy(
            np.array(jax_stld.sample_drops(key, jnp.asarray(r.numpy()), min_active))))
        got = stld.sample_drops_block(torch.Generator(), torch.from_numpy(np.array(rates)), block_size, min_active)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------- local round
@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    jcfg = jax_get_config("qwen3-1.7b", smoke=True).replace(num_layers=4, dtype="float32")
    jparams = jax.jit(jax_init_params, static_argnums=1)(key, jcfg)
    jpeft = jax.jit(jax_peft.init_peft, static_argnums=(1, 2))(jax.random.fold_in(key, 1), jcfg, JaxPEFTConfig())
    jpeft = jax.tree.map(lambda x: x + 0.02 * jax.random.normal(jax.random.fold_in(key, 2), x.shape), jpeft)
    cfg = get_config("qwen3-1.7b", smoke=True).replace(num_layers=4, dtype="float32")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    peft = convert.peft_from_jax(jax.tree.map(np.asarray, jpeft), "cpu")
    task = make_task(vocab_size=cfg.vocab_size, seq_len=16, num_examples=64, seed=3)
    return jcfg, jparams, jpeft, cfg, params, peft, task


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_gather_local_round_with_jax_indices_matches_jax(setup, monkeypatch):
    """Three local steps at k = 2 of 4 layers."""
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    seed, mean_rate, steps, k = 7, 0.5, 3, 2
    rates = jnp.clip(jax_unit_shape("incremental", 4) * mean_rate, 0.0, 0.95)
    rng, indices = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, kd = jax.random.split(rng)
        indices.append(np.asarray(jax_stld.sample_active_indices(kd, rates, k)))
    assert len({tuple(i) for i in indices}) > 1  # the steps run different layers
    per_step = [task.lm_batch(np.arange(4 * i, 4 * i + 4)) for i in range(steps)]
    batches = {key: np.stack([b[key] for b in per_step]) for key in ("tokens", "targets", "mask")}

    jfns = jax_make_client_fns(jcfg, JaxPEFTConfig(), JaxSTLDConfig(mode="gather"), JaxTrainConfig())
    jp, _, jm, jimp = jfns.local_round(jparams, jpeft, jax_adamw_init(jpeft), jax.tree.map(jnp.asarray, batches),
                                       mean_rate, jax.random.PRNGKey(seed), 3, num_active=k)
    it = iter(indices)
    monkeypatch.setattr(stld, "sample_active_indices", lambda gen, r, kk: torch.from_numpy(next(it).copy()).long())
    fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(mode="gather"), TrainConfig(), device="cpu")
    tp, _, tm, timp = fns.local_round(params, peft, adamw_init(peft), batches, mean_rate,
                                      torch.Generator().manual_seed(seed), 3, num_active=k)
    assert float(tm["active_layers"]) == float(jm["active_layers"]) == k
    for key in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(_np(tm[key]), np.asarray(jm[key]), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(_np(timp), np.asarray(jimp), rtol=1e-4, atol=1e-12)
    sched = make_lr_schedule("cosine", 2e-4, 20, 1000)
    lr_sum = sum(sched(3 + i) for i in range(steps))
    diffs = np.concatenate([np.abs(a - b).ravel() for (_, a), (_, b) in zip(leaves(tp), leaves(jp))])
    assert diffs.max() <= 2 * lr_sum + 1e-6 and np.mean(diffs <= 1e-6) >= 0.99


def test_gather_train_step_runs_the_static_count(setup, monkeypatch):
    """``make_train_step(stld_mode="gather")`` draws k =
    ``static_active_count`` indices a step and runs exactly those layers
    (the other layers' LoRA gradients are zero, so AdamW leaves them as
    weight decay moves them)."""
    _, _, _, cfg, params, peft, task = setup
    seen = []
    sample = stld.sample_active_indices

    def recorded(gen, rates, k):
        seen.append(sample(gen, rates, k))
        return seen[-1]

    monkeypatch.setattr(stld, "sample_active_indices", recorded)
    step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="gather", mean_rate=0.75, gather_bucket=1)
    tokens = np.concatenate([task.lm_batch(np.arange(4))["tokens"], task.lm_batch(np.arange(4))["targets"][:, -1:]],
                            axis=1)
    _, _, metrics = step(params, peft, adamw_init(peft), {"tokens": tokens}, torch.Generator().manual_seed(0))
    assert len(seen) == 1 and len(seen[0]) == jax_stld.static_active_count(0.75, 4, 1) == 1
    assert np.isfinite(float(metrics["loss"]))


# ------------------------------------------------------------- the runner
@pytest.fixture(scope="module")
def jax_runs():
    return {}


_SMALL_FED = dict(num_devices=4, devices_per_round=2, local_steps=2, batch_size=4)
_ARCH_KW = {"qwen3-1.7b": dict(fed_kw=FED_KW, cfg_kw=CFG_KW, stld_kw=GATHER),  # 4 layers: k 2 or 4
            "rwkv6-3b": dict(fed_kw=_SMALL_FED, cfg_kw={"dtype": "float32"},  # 2 layers: k 1 or 2
                             stld_kw=dict(GATHER, gather_bucket=1))}


@pytest.mark.parametrize("arch,cohort_mode", [("qwen3-1.7b", "sequential"), ("qwen3-1.7b", "batched"),
                                              ("rwkv6-3b", "batched")])
def test_gather_runner_follows_jax_round_by_round(jax_runs, monkeypatch, arch, cohort_mode):
    kw = _ARCH_KW[arch]
    if arch not in jax_runs:
        jax_runs[arch] = jax_run("droppeft", 2, arch=arch, **kw)
    want = jax_runs[arch]
    got = port_run(monkeypatch, "droppeft", 2, want["base"], want["peft0"], arch=arch, cohort_mode=cohort_mode, **kw)
    ks = {a for d in got["rec"]["dispatch"] for a in d["active"]}
    assert len(ks) > 1, ks  # the cohorts mixed static counts
    assert_follows_jax(got, want, rounds=2)


@pytest.mark.parametrize("cohort_mode", ["batched", "sequential"])
def test_gather_on_a_heterogeneous_stack_raises(cohort_mode):
    runner = api.build("droppeft", cfg=get_config("jamba-v0.1-52b", smoke=True).replace(dtype="float32"),
                       stld_cfg=STLDConfig(**GATHER), fed_cfg=FederatedConfig(**_SMALL_FED), device="cpu",
                       cohort_mode=cohort_mode)
    with pytest.raises(ValueError, match="homogeneous"):
        runner.run(rounds=1)


# ------------------------------------------------------------- stack modes
def _model(arch, **cfg_kw):
    jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32", **cfg_kw)
    cfg = get_config(arch, smoke=True).replace(dtype="float32", **cfg_kw)
    jparams = jax_init_params(jax.random.PRNGKey(4), jcfg)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    return jcfg, jparams, cfg, params, tokens


@pytest.mark.parametrize("arch,mode", [("qwen3-1.7b", "scan"), ("qwen3-1.7b", "group"), ("jamba-v0.1-52b", "group")])
def test_stack_modes_match_jax_logits(arch, mode):
    jcfg, jparams, cfg, params, tokens = _model(arch)
    drops = np.array([True, False] * (cfg.num_layers // 2))
    want, _, _ = jax_model_apply(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, stack_mode=mode,
                                 drops=jnp.asarray(drops))
    got, _, _ = model_apply(params, cfg, {"tokens": torch.from_numpy(tokens)}, stack_mode=mode,
                            drops=torch.from_numpy(drops))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode,cfg_kw", [("scan", {}), ("gather", {}), ("group", {"num_layers": 3})])
def test_stack_modes_raise_where_jax_raises(mode, cfg_kw):
    jcfg, jparams, cfg, params, tokens = _model("jamba-v0.1-52b", **cfg_kw)
    idx = np.array([0])
    with pytest.raises(ValueError):
        jax_model_apply(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, stack_mode=mode,
                        active_idx=jnp.asarray(idx) if mode == "gather" else None)
    with pytest.raises(ValueError):
        model_apply(params, cfg, {"tokens": torch.from_numpy(tokens)}, stack_mode=mode,
                    active_idx=torch.from_numpy(idx) if mode == "gather" else None)
