"""The port's local-training slice against the JAX package, on the CPU (the
kernels' plain twins), at the smoke size of qwen3-1.7b with 2 layers in
float32.

The JAX params and a LoRA tree (r=8, alpha=16, on q and v, ``b`` moved off
zero so that dA is not zero) go through ``repro_torch.convert``.  JAX's
threefry keys and torch's generators never agree, so the tests hand JAX's
STLD gates to the port (the port's sampler is patched).

Tolerances, each with its reason:
* logits 1e-4 abs, loss and metrics 1e-5 rel: float32 sums in another order;
* PEFT gradients 2e-5 abs + 1e-3 rel: the same, through the backward;
* AdamW on identical gradients 1e-6 rel: the same arithmetic;
* the PEFT tree after AdamW steps from each side's own gradients: AdamW's
  first steps move an element by about lr * sign(g), so an element whose
  gradient lies within float error of 0 may move the other way.  Every
  element within 2 * (sum of the step sizes) + 1e-6, and 99% of them within
  1e-6;
* gates, tokens, active-layer counts and accuracies exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import STLDConfig as JaxSTLDConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import peft as jax_peft
from repro.core import ptls as jax_ptls
from repro.core import stld as jax_stld
from repro.core.schedules import drop_rates as jax_drop_rates
from repro.core.schedules import unit_shape as jax_unit_shape
from repro.data.synthetic import make_task as jax_make_task
from repro.federated.client import make_client_fns as jax_make_client_fns
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import init_params as jax_init_params
from repro.models.registry import model_apply as jax_model_apply
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip_by_global_norm
from repro.optim import make_lr_schedule as jax_make_lr_schedule
from repro_torch import convert
from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import ptls, stld
from repro_torch.core.schedules import drop_rates, unit_shape
from repro_torch.data.synthetic import make_task
from repro_torch.federated.client import make_client_fns
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import model_apply
from repro_torch.models.stacking import tree_leaves
from repro_torch.models.transformer import lm_apply
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, make_lr_schedule

LOGIT_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
SEQ = 16


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    jcfg = jax_get_config("qwen3-1.7b", smoke=True).replace(num_layers=2, dtype="float32")
    jparams = jax.jit(jax_init_params, static_argnums=1)(key, jcfg)
    jpeft = jax.jit(jax_peft.init_peft, static_argnums=(1, 2))(jax.random.fold_in(key, 1), jcfg, JaxPEFTConfig())
    jpeft = jax.tree.map(lambda x: x + 0.02 * jax.random.normal(jax.random.fold_in(key, 2), x.shape), jpeft)
    cfg = get_config("qwen3-1.7b", smoke=True).replace(num_layers=2, dtype="float32")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    peft = convert.peft_from_jax(jax.tree.map(np.asarray, jpeft), "cpu")
    task = make_task(vocab_size=cfg.vocab_size, seq_len=SEQ, num_examples=64, seed=3)
    return jcfg, jparams, jpeft, cfg, params, peft, task


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _jax_tree_np(tree):
    return [np.asarray(leaf, np.float32) for leaf in jax.tree.leaves(tree)]


def _close_trees(got, want, atol, rtol=0.0):
    got_leaves, want_leaves = tree_leaves(got), _jax_tree_np(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(_np(g), w, atol=atol, rtol=rtol)


def _close_after_adamw(got, want, lr_sum):
    """The tree after AdamW steps (see the module docstring)."""
    diffs = np.concatenate([np.abs(_np(g) - w).ravel() for g, w in zip(tree_leaves(got), _jax_tree_np(want))])
    assert diffs.max() <= 2 * lr_sum + 1e-6, diffs.max()
    assert np.mean(diffs <= 1e-6) >= 0.99, np.mean(diffs <= 1e-6)


def _jax_gates(seed, rates, steps, min_active=1):
    """The gates ``local_round`` draws: one key split per step."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, kd = jax.random.split(rng)
        out.append(np.asarray(jax_stld.sample_drops(kd, rates, min_active)))
    return out


def _feed_gates(monkeypatch, gates):
    """Patch the port's sampler to hand out ``gates`` in turn."""
    it = iter(gates)
    monkeypatch.setattr(stld, "sample_drops", lambda generator, rates, min_active=1: torch.from_numpy(next(it).copy()))


# ------------------------------------------------------------- data, STLD
def test_synthetic_task_and_batches_match_jax():
    ours, theirs = make_task(seed=5, num_examples=40), jax_make_task(seed=5, num_examples=40)
    np.testing.assert_array_equal(ours.tokens, theirs.tokens)
    np.testing.assert_array_equal(ours.labels, theirs.labels)
    idx = np.asarray([3, 1, 4, 1, 5])
    for k, v in theirs.lm_batch(idx).items():
        np.testing.assert_array_equal(ours.lm_batch(idx)[k], v)


@pytest.mark.parametrize("distribution", ["uniform", "incremental", "decay"])
def test_unit_shape_and_drop_rates_match_jax(distribution):
    np.testing.assert_allclose(_np(unit_shape(distribution, 28)), np.asarray(jax_unit_shape(distribution, 28)), rtol=1e-6)
    np.testing.assert_allclose(
        _np(drop_rates(distribution, 0.6, 28)), np.asarray(jax_drop_rates(distribution, 0.6, 28)), rtol=1e-6
    )
    np.testing.assert_allclose(  # Eq. 4; about 14 of 28 at mean rate 0.5 (the clip at 0.95 adds a little)
        float(stld.expected_active_layers(drop_rates(distribution, 0.5, 28))),
        float(jax_stld.expected_active_layers(jax_drop_rates(distribution, 0.5, 28))), rtol=1e-6,
    )


@pytest.mark.parametrize("mean_rate,min_active", [(0.5, 1), (0.9, 4), (0.95, 28), (0.0, 1)])
def test_gates_from_jax_uniforms_match_sample_drops(mean_rate, min_active):
    """``_force_min_active(u < rates)`` on JAX's own uniform draw gives
    JAX's gates bit for bit, the floor included."""
    rates = jnp.clip(jax_unit_shape("incremental", 28) * mean_rate, 0.0, 0.95)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_stld.sample_drops(key, rates, min_active))
        u = torch.from_numpy(np.array(jax.random.uniform(key, (28,))))
        trates = torch.from_numpy(np.array(rates))
        got = stld._force_min_active(u < trates, trates, min_active)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int((~got).sum()) >= min_active


def test_sample_drops_consumes_its_generator():
    rates = drop_rates("incremental", 0.5, 28)
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    first = stld.sample_drops(g1, rates)
    assert torch.equal(first, stld.sample_drops(g2, rates))
    assert first.dtype == torch.bool and first.device.type == "cpu"
    assert any(not torch.equal(first, stld.sample_drops(g1, rates)) for _ in range(8))  # a fresh draw per call


# ------------------------------------------------------------- loss, optimizer, PTLS
@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_jax(masked):
    rng = np.random.default_rng(30)
    logits = rng.standard_normal((3, 5, 11), dtype=np.float32) * 3
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.5).astype(np.float32) if masked else None
    _, want = jax_softmax_xent(jnp.asarray(logits), jnp.asarray(labels), None if mask is None else jnp.asarray(mask))
    _, got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels), None if mask is None else torch.from_numpy(mask))
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-6)


def _grad_tree(rng, scale):
    return {
        "attn": {
            "q": {"a": rng.standard_normal((3, 16, 4), dtype=np.float32) * scale,
                  "b": rng.standard_normal((3, 4, 8), dtype=np.float32) * scale},
            "v": {"a": rng.standard_normal((3, 16, 4), dtype=np.float32) * scale,
                  "b": rng.standard_normal((3, 4, 6), dtype=np.float32) * scale},
        }
    }


def _torch_tree(tree):
    return convert.peft_from_jax(tree, "cpu")


@pytest.mark.parametrize("scale", [0.01, 1.0])  # below and above the clip norm
def test_clip_by_global_norm_matches_jax(scale):
    grads = _grad_tree(np.random.default_rng(31), scale)
    want, want_norm = jax_clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    got, got_norm = clip_by_global_norm(_torch_tree(grads), 1.0)
    np.testing.assert_allclose(_np(got_norm), np.asarray(want_norm), rtol=1e-6)
    _close_trees(got, want, atol=0, rtol=1e-6)


def test_adamw_matches_jax_on_identical_grads():
    rng = np.random.default_rng(32)
    params = _grad_tree(rng, 0.1)
    jparams, tparams = jax.tree.map(jnp.asarray, params), _torch_tree(params)
    jstate, tstate = jax_adamw_init(jparams), adamw_init(tparams)
    for step in range(3):
        grads = _grad_tree(rng, 0.01)
        kw = dict(lr=1e-3 * (step + 1), beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)
        jparams, jstate = jax_adamw_update(jax.tree.map(jnp.asarray, grads), jstate, jparams, **kw)
        tparams, tstate = adamw_update(_torch_tree(grads), tstate, tparams, **kw)
    _close_trees(tparams, jparams, atol=1e-7, rtol=1e-6)
    _close_trees(tstate["m"], jstate["m"], atol=1e-9, rtol=1e-6)
    _close_trees(tstate["v"], jstate["v"], atol=1e-12, rtol=1e-6)
    assert tstate["count"] == int(jstate["count"]) == 3


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_jax(kind):
    ours, theirs = make_lr_schedule(kind, 2e-4, 20, 1000), jax_make_lr_schedule(kind, 2e-4, 20, 1000)
    for step in (0, 1, 5, 19, 20, 21, 400, 999, 1000, 1500):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6)


def test_layer_grad_norms_and_importance_match_jax():
    rng = np.random.default_rng(33)
    jstate, tstate = jax_ptls.ImportanceAccumulator.init(3), ptls.ImportanceAccumulator.init(3, "cpu")
    for drops in ([False, True, False], [True, True, False], [False, False, False]):
        grads = _grad_tree(rng, 1.0)
        jn = jax_ptls.layer_grad_norms(jax.tree.map(jnp.asarray, grads))
        tn = ptls.layer_grad_norms(_torch_tree(grads))
        np.testing.assert_allclose(_np(tn), np.asarray(jn), rtol=1e-6)
        jstate = jax_ptls.ImportanceAccumulator.update(jstate, jn, jnp.asarray(drops))
        tstate = ptls.ImportanceAccumulator.update(tstate, tn, torch.tensor(drops))
    np.testing.assert_allclose(
        _np(ptls.ImportanceAccumulator.importance(tstate)),
        np.asarray(jax_ptls.ImportanceAccumulator.importance(jstate)), rtol=1e-6,
    )


# ------------------------------------------------------------- model level
@pytest.mark.parametrize("drops", [None, [False, True], [True, False]])
def test_lm_apply_with_drops_matches_jax(setup, drops):
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    tokens = task.tokens[:3]
    jd = None if drops is None else jnp.asarray(drops)
    want, _, _ = jax.jit(
        lambda p, pf, t, d: jax_model_apply(p, jcfg, {"tokens": t}, drops=d, peft=pf, lora_scale=2.0, stack_mode="unroll")
    )(jparams, jpeft, jnp.asarray(tokens), jd)
    got, _, _ = lm_apply(params, cfg, torch.from_numpy(tokens), drops=drops, peft=peft, lora_scale=2.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    targets = np.roll(tokens, -1, axis=1)
    jloss, _ = jax_softmax_xent(want, jnp.asarray(targets))
    tloss, _ = softmax_xent(got, torch.from_numpy(targets))
    np.testing.assert_allclose(_np(tloss), np.asarray(jloss), rtol=1e-5)


@pytest.mark.parametrize("drops", [[False, False], [False, True]])
def test_peft_grads_match_jax_value_and_grad(setup, drops):
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    batch = task.lm_batch(np.arange(4))

    def jloss(pf):
        logits, _, _ = jax_model_apply(jparams, jcfg, {"tokens": jnp.asarray(batch["tokens"])},
                                       drops=jnp.asarray(drops), peft=pf, lora_scale=2.0, stack_mode="unroll")
        return jax_softmax_xent(logits, jnp.asarray(batch["targets"]), jnp.asarray(batch["mask"]))

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jpeft)

    def tloss(pf):
        logits, _, _ = model_apply(params, cfg, {"tokens": torch.from_numpy(batch["tokens"])}, drops=drops,
                                   peft=pf, lora_scale=2.0)
        return softmax_xent(logits, torch.from_numpy(batch["targets"]), torch.from_numpy(batch["mask"]))

    (tl, _), tgrads = value_and_grad(tloss)(peft)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    _close_trees(tgrads, jgrads, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    if drops[1]:  # a dropped layer's slice of every leaf gets exactly zero
        assert all(not g[1].any() for g in tree_leaves(tgrads))


def test_train_step_off_matches_jax(setup):
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    train_cfg = JaxTrainConfig()
    tokens = np.concatenate([task.tokens[:4], task.tokens[4:8, :1]], axis=1)  # (B, S+1)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxPEFTConfig(), train_cfg, stld_mode="off"))
    jp, _, jm = jstep(jparams, jpeft, jax_adamw_init(jpeft), {"tokens": jnp.asarray(tokens)}, jax.random.PRNGKey(0))
    step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="off")
    tp, tstate, tm = step(params, peft, adamw_init(peft), {"tokens": tokens}, torch.Generator().manual_seed(0))
    for k in ("loss", "accuracy", "grad_norm", "tokens"):
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    _close_after_adamw(tp, jp, train_cfg.learning_rate)
    assert tstate["count"] == 1


def test_train_step_cond_with_jax_gates_matches_jax(setup, monkeypatch):
    """``stld_mode="cond"``: JAX's key 3 drops layer 0, which the port's
    step gets through its (patched) sampler; layer 0's slice of every PEFT
    leaf then takes no gradient and only weight decay moves it."""
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    train_cfg, key = JaxTrainConfig(), jax.random.PRNGKey(3)
    rates = jnp.clip(jax_unit_shape("incremental", 2) * 0.5, 0.0, 0.95)
    gate = np.asarray(jax_stld.sample_drops(key, rates, 1))
    assert gate.tolist() == [True, False]
    tokens = np.concatenate([task.tokens[:4], task.tokens[4:8, :1]], axis=1)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxPEFTConfig(), train_cfg, stld_mode="cond"))
    jp, _, jm = jstep(jparams, jpeft, jax_adamw_init(jpeft), {"tokens": jnp.asarray(tokens)}, key)
    _feed_gates(monkeypatch, [gate])
    step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="cond")
    tp, _, tm = step(params, peft, adamw_init(peft), {"tokens": tokens}, torch.Generator().manual_seed(3))
    for k in ("loss", "accuracy", "grad_norm", "tokens"):
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    _close_after_adamw(tp, jp, train_cfg.learning_rate)
    lr, wd = train_cfg.learning_rate, train_cfg.weight_decay
    for new, old in zip(tree_leaves(tp), tree_leaves(peft)):
        torch.testing.assert_close(new[0], old[0] - lr * wd * old[0], rtol=1e-6, atol=1e-9)


def test_local_round_with_jax_gates_matches_jax(setup, monkeypatch):
    """Two local steps; step 0 runs both layers, step 1 drops layer 1."""
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    seed, mean_rate, steps = 7, 0.5, 2
    rates = jnp.clip(jax_unit_shape("incremental", 2) * mean_rate, 0.0, 0.95)
    gates = _jax_gates(seed, rates, steps)
    assert [g.tolist() for g in gates] == [[False, False], [False, True]]
    per_step = [task.lm_batch(np.arange(4 * i, 4 * i + 4)) for i in range(steps)]
    batches = {k: np.stack([b[k] for b in per_step]) for k in ("tokens", "targets", "mask")}

    jfns = jax_make_client_fns(jcfg, JaxPEFTConfig(), JaxSTLDConfig(), JaxTrainConfig())
    jp, _, jm, jimp = jfns.local_round(
        jparams, jpeft, jax_adamw_init(jpeft), jax.tree.map(jnp.asarray, batches), mean_rate,
        jax.random.PRNGKey(seed), 3,
    )
    _feed_gates(monkeypatch, gates)
    fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig(), device="cpu")
    tp, tstate, tm, timp = fns.local_round(
        params, peft, adamw_init(peft), batches, mean_rate, torch.Generator().manual_seed(seed), 3
    )
    assert float(tm["active_layers"]) == float(jm["active_layers"]) == 1.5
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(timp), np.asarray(jimp), rtol=1e-4)
    sched = make_lr_schedule("cosine", 2e-4, 20, 1000)
    _close_after_adamw(tp, jp, sched(3) + sched(4))
    assert tstate["count"] == steps

    labels, toks = task.labels[8:16], task.tokens[8:16]
    want = jfns.evaluate(jparams, jp, jnp.asarray(toks), jnp.asarray(labels), jnp.arange(task.num_classes))
    got = fns.evaluate(params, tp, toks, labels, np.arange(task.num_classes))
    assert float(got) == float(want)


def _record_rates(monkeypatch):
    """Patch the port's sampler to keep the rates of each draw."""
    seen, sample = [], stld.sample_drops

    def recorded(generator, rates, min_active=1):
        seen.append(rates.clone())
        return sample(generator, rates, min_active)

    monkeypatch.setattr(stld, "sample_drops", recorded)
    return seen


@pytest.mark.parametrize("entry", ["client", "train_step"])
def test_normal_shape_from_jax_gives_the_reference_rates(setup, monkeypatch, entry):
    """JAX's ``unit_shape("normal", L)`` handed to the port gives the
    reference's per-layer rates, clip included (the port's own default
    draws other noise)."""
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    mean_rate = 0.5
    jshape = np.array(jax_unit_shape("normal", cfg.num_layers))
    want = np.clip(jshape * mean_rate, 0.0, 0.95)
    seen = _record_rates(monkeypatch)
    if entry == "client":
        fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(distribution="normal"), TrainConfig(), device="cpu",
                              shape=torch.from_numpy(jshape))
        batch = task.lm_batch(np.arange(4))
        fns.local_round(params, peft, adamw_init(peft), {k: v[None] for k, v in batch.items()}, mean_rate,
                        torch.Generator().manual_seed(0), 0)
    else:
        step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="cond", mean_rate=mean_rate,
                               distribution="normal", shape=jshape)
        step(params, peft, adamw_init(peft), {"tokens": task.tokens[:4]}, torch.Generator().manual_seed(0))
    assert len(seen) == 1
    np.testing.assert_allclose(_np(seen[0]), want, rtol=1e-6)


def test_train_step_normal_default_shape_ignores_the_global_generator(setup, monkeypatch):
    """Two ``make_train_step`` calls with ``distribution="normal"`` and no
    shape, with the global generator moved between them, draw the same
    rates and give the same step from the same ``rng``."""
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    seen = _record_rates(monkeypatch)
    outs = []
    for seed in (11, 12):
        torch.manual_seed(seed)
        torch.randn(7)
        step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="cond", distribution="normal")
        outs.append(step(params, peft, adamw_init(peft), {"tokens": task.tokens[:4]}, torch.Generator().manual_seed(5)))
    assert len(seen) == 2 and torch.equal(seen[0], seen[1])
    shape = unit_shape("normal", cfg.num_layers, generator=torch.Generator().manual_seed(0))
    want = torch.clamp(shape * 0.5, 0.0, 0.95)
    assert torch.equal(seen[0], want)
    (p1, _, m1), (p2, _, m2) = outs
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
