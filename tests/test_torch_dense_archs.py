"""The port's dense decoders glm4-9b, h2o-danube-1.8b and yi-6b against the
JAX package, on the CPU (the kernels' plain twins), at their smoke configs
in float32.

Each arch differs from qwen3-1.7b by its config alone: glm4's q/k/v bias
and 2 KV heads, h2o-danube's sliding window (64 at smoke size) and its ring
cache of ``min(max_len, window)`` slots, yi's ``rope_theta`` of 5e6, and an
untied ``lm_head`` in all three.  The JAX params and a LoRA tree (r=8 on q
and v, ``b`` moved off zero) go through ``repro_torch.convert``; JAX's STLD
gates are handed to the port, as in ``tests/test_torch_training.py``.
h2o-danube reaches its window: training runs S 96, and serving decodes past
position 64, so the ring wraps.

Tolerances, as in ``tests/test_torch_training.py`` and
``tests/test_torch_serving.py``: logits 1e-4 abs, loss and metrics 1e-5
rel, PEFT gradients 2e-5 abs + 1e-3 rel (float32 sums in another order);
the tree after AdamW steps every element within 2 * (sum of the step
sizes) + 1e-6 and 99% within 1e-6; gates, tokens and accuracies exactly.
The kernels' twins at the new head shapes (16 query heads a KV head, head
dim 80) are held to the Pallas kernels within ``tests/test_kernels.py``'s
2e-5.
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
from repro.core import stld as jax_stld
from repro.core.schedules import unit_shape as jax_unit_shape
from repro.federated.client import make_client_fns as jax_make_client_fns
from repro.kernels.flash_decode import flash_decode_pallas
from repro.kernels.ops import flash_attention as jax_flash_attention
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import init_params as jax_init_params
from repro.models.registry import model_apply as jax_model_apply
from repro.optim import adamw_init as jax_adamw_init
from repro.serving.adapters import AdapterPoolCache as JaxAdapterPoolCache
from repro.serving.adapters import AdapterRegistry as JaxAdapterRegistry
from repro.serving.batcher import ContinuousBatcher as JaxContinuousBatcher
from repro.serving.batcher import Request as JaxRequest
from repro.serving.batcher import batched_caches as jax_batched_caches
from repro_torch import api, convert
from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import stld
from repro_torch.data.synthetic import make_task
from repro_torch.federated.client import make_client_fns
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_serve_step, value_and_grad
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import init_params, model_apply
from repro_torch.models.stacking import tree_leaves
from repro_torch.nn.attention import ring_positions
from repro_torch.optim import adamw_init, make_lr_schedule
from repro_torch.serving.adapters import AdapterPoolCache, AdapterRegistry
from repro_torch.serving.batcher import Request, batched_caches

ARCHS = ["glm4-9b", "h2o-danube-1.8b", "yi-6b"]
LOGIT_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
KERNEL_ATOL = 2e-5
SEQ = {"glm4-9b": 16, "h2o-danube-1.8b": 96, "yi-6b": 16}  # danube past its window of 64
_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        key = jax.random.PRNGKey(0)
        jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
        jparams = jax.jit(jax_init_params, static_argnums=1)(key, jcfg)
        jpeft = jax.jit(jax_peft.init_peft, static_argnums=(1, 2))(jax.random.fold_in(key, 1), jcfg, JaxPEFTConfig())
        jpeft = jax.tree.map(lambda x: x + 0.02 * jax.random.normal(jax.random.fold_in(key, 2), x.shape), jpeft)
        cfg = get_config(arch, smoke=True).replace(dtype="float32")
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        peft = convert.peft_from_jax(jax.tree.map(np.asarray, jpeft), "cpu")
        task = make_task(vocab_size=cfg.vocab_size, seq_len=SEQ[arch], num_examples=24, seed=3)
        _SETUPS[arch] = (jcfg, jparams, jpeft, cfg, params, peft, task)
    return _SETUPS[arch]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _paths(tree, path=()):
    """(path, shape, dtype name) of every leaf, dict keys sorted."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    dtype = str(tree.dtype).replace("torch.", "")
    return [(path, tuple(tree.shape), dtype)]


def _close_trees(got, want, atol, rtol=0.0):
    got_leaves, want_leaves = tree_leaves(got), [np.asarray(x, np.float32) for x in jax.tree.leaves(want)]
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(_np(g), w, atol=atol, rtol=rtol)


# ------------------------------------------------------------- the configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference_field_for_field(arch):
    for smoke in (False, True):
        want, got = jax_get_config(arch, smoke=smoke), get_config(arch, smoke=smoke)
        for field in ("name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab_size",
                      "head_dim", "qk_norm", "sliding_window", "rope_theta", "attention_bias", "tie_embeddings",
                      "max_seq_len", "norm_eps", "dtype", "param_dtype"):
            assert getattr(got, field) == getattr(want, field), (smoke, field)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_dtypes_match_jax(arch):
    """The same leaves, shapes and dtypes: glm4's q/k/v biases, the untied
    head; drawn with and without placing each projection as it is drawn."""
    jcfg, jparams, _, cfg, _, _, _ = _setup(arch)
    want = _paths(jax.tree.map(np.asarray, jparams))
    drawn = init_params(cfg, torch.Generator().manual_seed(0))
    assert _paths(drawn) == want
    assert ("lm_head",) in [p for p, _, _ in want]
    assert (("layers", "attn", "wq", "b") in [p for p, _, _ in want]) == (arch == "glm4-9b")
    placed = init_params(cfg, torch.Generator().manual_seed(0), place=True)
    for a, b in zip(tree_leaves(drawn), tree_leaves(placed)):
        assert torch.equal(a, b)


# ------------------------------------------------------------- training
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_with_drops_match_jax(arch):
    jcfg, jparams, jpeft, cfg, params, peft, task = _setup(arch)
    tokens, drops = task.tokens[:2], [False, True]
    want, _, _ = jax.jit(
        lambda p, pf, t: jax_model_apply(p, jcfg, {"tokens": t}, drops=jnp.asarray(drops), peft=pf, lora_scale=2.0,
                                         stack_mode="unroll")
    )(jparams, jpeft, jnp.asarray(tokens))
    got, _, _ = model_apply(params, cfg, {"tokens": torch.from_numpy(tokens)}, drops=drops, peft=peft, lora_scale=2.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_peft_grads_match_jax_value_and_grad(arch):
    jcfg, jparams, jpeft, cfg, params, peft, task = _setup(arch)
    batch = task.lm_batch(np.arange(2))

    def jloss(pf):
        logits, _, _ = jax_model_apply(jparams, jcfg, {"tokens": jnp.asarray(batch["tokens"])}, peft=pf,
                                       lora_scale=2.0, stack_mode="unroll")
        return jax_softmax_xent(logits, jnp.asarray(batch["targets"]), jnp.asarray(batch["mask"]))

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jpeft)

    def tloss(pf):
        logits, _, _ = model_apply(params, cfg, {"tokens": torch.from_numpy(batch["tokens"])}, peft=pf,
                                   lora_scale=2.0)
        return softmax_xent(logits, torch.from_numpy(batch["targets"]), torch.from_numpy(batch["mask"]))

    (tl, _), tgrads = value_and_grad(tloss)(peft)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    _close_trees(tgrads, jgrads, atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_round_with_jax_gates_matches_jax(arch, monkeypatch):
    """Two local steps of batch 4 with JAX's gates, then ``evaluate``."""
    jcfg, jparams, jpeft, cfg, params, peft, task = _setup(arch)
    seed, mean_rate, steps = 7, 0.5, 2
    rates = jnp.clip(jax_unit_shape("incremental", cfg.num_layers) * mean_rate, 0.0, 0.95)
    rng, gates = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, kd = jax.random.split(rng)
        gates.append(np.asarray(jax_stld.sample_drops(kd, rates, 1)))
    per_step = [task.lm_batch(np.arange(4 * i, 4 * i + 4)) for i in range(steps)]
    batches = {k: np.stack([b[k] for b in per_step]) for k in ("tokens", "targets", "mask")}
    jfns = jax_make_client_fns(jcfg, JaxPEFTConfig(), JaxSTLDConfig(), JaxTrainConfig())
    jp, _, jm, jimp = jfns.local_round(jparams, jpeft, jax_adamw_init(jpeft), jax.tree.map(jnp.asarray, batches),
                                       mean_rate, jax.random.PRNGKey(seed), 3)
    it = iter(gates)
    monkeypatch.setattr(stld, "sample_drops", lambda generator, rates, min_active=1: torch.from_numpy(next(it).copy()))
    fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig(), device="cpu")
    tp, _, tm, timp = fns.local_round(params, peft, adamw_init(peft), batches, mean_rate,
                                      torch.Generator().manual_seed(seed), 3)
    assert float(tm["active_layers"]) == float(jm["active_layers"])
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(timp), np.asarray(jimp), rtol=1e-4)
    sched = make_lr_schedule("cosine", 2e-4, 20, 1000)
    diffs = np.concatenate([np.abs(_np(g) - np.asarray(w)).ravel()
                            for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp))])
    assert diffs.max() <= 2 * (sched(3) + sched(4)) + 1e-6 and np.mean(diffs <= 1e-6) >= 0.99
    toks, labels = task.tokens[16:24], task.labels[16:24]
    want = jfns.evaluate(jparams, jp, jnp.asarray(toks), jnp.asarray(labels), jnp.arange(task.num_classes))
    assert float(fns.evaluate(params, tp, toks, labels, np.arange(task.num_classes))) == float(want)


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_logits_match_jax_past_the_window(arch):
    """Decode steps through an adapter pool, rows at different depths, the
    deepest past position 64 (h2o-danube's ring of 64 slots wraps and its
    window masks the oldest): logits, tokens and positions agree."""
    jcfg, jparams, jpeft, cfg, params, peft, _ = _setup(arch)
    jreg, reg = JaxAdapterRegistry(), AdapterRegistry()
    jreg.register("t", jpeft)
    reg.register("t", peft)
    jpool, pool = JaxAdapterPoolCache(jreg, n_slots=1), AdapterPoolCache(reg, n_slots=1)
    jpeft_pool, tpeft_pool = jpool.pooled_peft(jpool.lookup(["t"] * 3)), pool.pooled_peft(pool.lookup(["t"] * 3))
    jcaches = jax_batched_caches(jcfg, 3, 80, dtype=jnp.float32)
    caches = batched_caches(cfg, 3, 80, dtype=torch.float32)
    assert caches["k"].shape[2] == (64 if arch == "h2o-danube-1.8b" else 80)
    pos = np.asarray([0, 40, 62], np.int32)
    jcaches = dict(jcaches, pos=jnp.broadcast_to(jnp.asarray(pos), jcaches["pos"].shape))
    caches["pos"][:] = torch.from_numpy(pos)
    jstep, step = jax.jit(jax_make_serve_step(jcfg, stack_mode="scan")), make_serve_step(cfg)
    rng = np.random.default_rng(8)
    for _ in range(5):
        tok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jlogits, jnext, jcaches = jstep(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches, peft=jpeft_pool)
        logits, nxt, caches = step(params, torch.from_numpy(tok), torch.from_numpy(pos), caches, peft=tpeft_pool)
        np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_tokens_match_jax_past_the_window(arch):
    """Three requests, one of 60 prompt tokens and 10 new ones (past
    h2o-danube's window of 64): the completions equal the JAX batcher's."""
    jcfg, jparams, jpeft, cfg, params, peft, _ = _setup(arch)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (60, 5, 12)]
    jreg = JaxAdapterRegistry()
    jreg.register("t", jpeft)
    jbatcher = JaxContinuousBatcher(jax_make_serve_step(jcfg, stack_mode="scan"), jparams, jcfg,
                                    JaxAdapterPoolCache(jreg, n_slots=2), batch=2, max_len=96,
                                    cache_dtype=jnp.float32)
    batcher = api.serve(cfg=cfg, params=params, adapters={"t": peft}, batch=2, max_len=96, n_slots=2,
                        cache_dtype="float32", device="cpu")
    for j, p in enumerate(prompts):
        jbatcher.submit(JaxRequest(prompt=p, adapter="t", max_new_tokens=10, uid=j))
        batcher.submit(Request(prompt=p, adapter="t", max_new_tokens=10, uid=j))
    want = {c.uid: (c.tokens, c.finish_reason) for c in jbatcher.run()}
    assert {c.uid: (c.tokens, c.finish_reason) for c in batcher.run()} == want


# ------------------------------------------------------------- the new head shapes
def _ring(s, last):
    return (last - np.mod(last - np.arange(s), s)).astype(np.int32)


@pytest.mark.parametrize("h,kv,d,s,qpos,window", [
    (16, 1, 32, 64, 63, None),  # 16 query heads a KV head (glm4-9b's grouping)
    (4, 2, 80, 64, 100, 40),  # head dim 80 (h2o-danube's), a window over a wrapped ring
])
def test_decode_twin_at_new_head_shapes_matches_flash_decode_pallas(h, kv, d, s, qpos, window):
    rng = np.random.default_rng(50)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32) for shape in ((2, h, d), (2, s, kv, d), (2, s, kv, d)))
    kpos = _ring(s, qpos)
    want = flash_decode_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos), qpos,
                               window=window, block_k=32)
    got = ops.flash_decode(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           torch.full((2,), qpos, dtype=torch.int32),
                           ring_positions(torch.full((2,), qpos, dtype=torch.int32), s), window=window)
    assert torch.equal(ring_positions(torch.tensor([qpos], dtype=torch.int32), s)[0], torch.from_numpy(kpos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL, rtol=0)


@pytest.mark.parametrize("h,kv,d,s,window", [
    (16, 1, 32, 64, None),  # 16 query heads a KV head
    (4, 2, 80, 96, 40),  # head dim 80 with a window
])
def test_attention_twin_at_new_head_shapes_matches_flash_attention_pallas(h, kv, d, s, window):
    rng = np.random.default_rng(51)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32) for shape in ((1, s, h, d), (1, s, kv, d), (1, s, kv, d)))
    want = jax_flash_attention(*(jnp.asarray(np.swapaxes(t, 1, 2)) for t in (q, k, v)), causal=True, window=window,
                               block_q=32, block_k=32)
    got = ops.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.swapaxes(np.asarray(want), 1, 2), atol=KERNEL_ATOL, rtol=0)
