"""The port's PEFT kinds (LoRA, adapter, BitFit, none) against the JAX
package, on the CPU, at the smoke configs of qwen3-1.7b (dense, stacked),
rwkv6-3b (``ssm``, stacked) and jamba (``hybrid``: adapter and LoRA trees
a per-layer list) in float32.

* ``init_peft``: the tree paths, shapes, dtypes and layout of JAX's, for
  every method and arch; a fresh tree leaves the outputs unchanged (``up``,
  ``b`` and the biases zero); ``count_params`` and ``flat_bytes`` equal.
* The model with JAX's weights and a nonzero PEFT tree (adapter ``up`` and
  the biases drawn away from zero): logits within 1e-4 (as
  ``tests/test_torch_jamba.py``'s logits) and PEFT gradients within 2e-5
  abs + 1e-3 rel (float32 sums in another order); a cohort (``devices``
  N) against N single-device calls, logits and gradients within 2e-5.
* ``merge_lora_into_base`` against JAX's in both layouts within 2e-5, and
  the merged base without LoRA against the unmerged model with it.
* GELU is ``jax.nn.gelu``'s tanh form (a case that fails with torch's
  default erf form); ``mlp_apply``'s GELU branch within 2e-5.
* ``sgdm_update`` over 3 steps within 2e-6; the system model's PEFT
  parameter counts and round costs equal.
* The q-blocked long-prefill path: JAX's ``multi_head_attention`` with
  ``_MAX_NAIVE_SCORES`` patched to 32 x 32, so that S 64 takes its loop
  over query blocks, against the port's cache-free attention (blockwise at
  every length), within 2e-5.
* Every registered method runs a round with LoRA, and the FedAvg-family
  methods with adapter and BitFit too (``tests/test_torch_peft_runs.py``
  holds those runs to JAX's round by round).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import get_config as jax_get_config
from repro.core import peft as jax_peft
from repro.federated import system_model as jax_system_model
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import init_params as jax_init_params
from repro.models.registry import model_apply as jax_model_apply
from repro.nn import attention as jax_attention
from repro.nn import mlp as jax_mlp
from repro.optim import sgdm_init as jax_sgdm_init
from repro.optim import sgdm_update as jax_sgdm_update
from repro_torch import api, convert
from repro_torch.configs import FederatedConfig, PEFTConfig, get_config
from repro_torch.core import peft
from repro_torch.federated import system_model
from repro_torch.federated.engine import stack_trees
from repro_torch.kernels import ops
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import stacking
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import init_params, model_apply
from repro_torch.nn import mlp
from repro_torch.optim import sgdm_init, sgdm_update
from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from _torch_fed_parity import CFG_KW, leaves

ARCHS = ("qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b")
METHODS = ("lora", "adapter", "bitfit", "none")
LOGIT_ATOL, GRAD_ATOL, GRAD_RTOL = 1e-4, 2e-5, 1e-3
SEQ = 12


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _shapes(tree):
    return [(path, a.shape, str(a.dtype)) for path, a in leaves(tree)]


def _close_trees(got, want, atol, rtol=0.0):
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=str(path))


@pytest.fixture(scope="module")
def models():
    """Per arch: JAX's config and weights (float32) and the port's copies."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
        jparams = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(i), jcfg)
        out[arch] = (jcfg, jparams, get_config(arch, smoke=True).replace(dtype="float32"),
                     convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"))
    return out


# ------------------------------------------------------------- init_peft
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_peft_has_the_reference_tree(method, arch):
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    want = jax_peft.init_peft(jax.random.PRNGKey(0), jcfg, JaxPEFTConfig(method=method))
    got = peft.init_peft(cfg, PEFTConfig(method=method), torch.Generator().manual_seed(0))
    assert stacking.is_stacked(got) == jax_peft.stacking.is_stacked(want)
    assert _shapes(got) == _shapes(want)
    assert peft.count_params(got) == jax_peft.count_params(want)
    assert peft.flat_bytes(got) == jax_peft.flat_bytes(want)
    for path, leaf in leaves(got):
        if path[-1] in ("b", "bias_attn", "bias_mlp") or path[-2:] == ("up", "w"):
            assert not leaf.any(), path  # a fresh tree is the identity
        elif path[-2:] == ("down", "w"):  # the adapter's LeCun-truncated down: fan-in d_model
            assert 0 < np.abs(leaf).max() <= 2.0 / np.sqrt(cfg.d_model) + 1e-6, path


# ------------------------------------------------------------- the model
def _nonzero_peft(jcfg, method, seed):
    """JAX's tree of ``method`` with every leaf moved off its init (so the
    adapter's ``up`` and the biases carry a signal)."""
    tree = jax_peft.init_peft(jax.random.PRNGKey(seed), jcfg, JaxPEFTConfig(method=method))
    return jax.tree.map(lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(seed + 1), x.shape), tree)


def _batch(cfg, seed, lead=()):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (*lead, 2, SEQ + 1)).astype(np.int32)
    return tokens[..., :-1], tokens[..., 1:]


@pytest.mark.parametrize("method", ["adapter", "bitfit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_peft_gradients_match_jax(models, method, arch):
    jcfg, jparams, cfg, params = models[arch]
    jtree = _nonzero_peft(jcfg, method, 10)
    tokens, targets = _batch(cfg, 11)

    def jloss(p):
        logits = jax_model_apply(jparams, jcfg, {"tokens": jnp.asarray(tokens)}, peft=p)[0]
        return jax_softmax_xent(logits, jnp.asarray(targets))[0], logits

    (_, want_logits), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jtree)

    def loss_fn(p):
        logits = model_apply(params, cfg, {"tokens": torch.from_numpy(tokens).long()}, peft=p)[0]
        return softmax_xent(logits, torch.from_numpy(targets).long())[0], {"logits": logits}

    (_, aux), grads = value_and_grad(loss_fn)(convert.peft_from_jax(jax.tree.map(np.asarray, jtree), "cpu"))
    np.testing.assert_allclose(_np(aux["logits"]), np.asarray(want_logits), atol=LOGIT_ATOL)
    _close_trees(grads, jax.tree.map(np.asarray, want_grads), GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("method", ["adapter", "bitfit"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cohort_matches_single_device_calls(models, method, arch):
    """Three devices' adapters or biases in the cohort layout (a per-layer
    list of (N, ...) leaves, the devices folded into the batch) give each
    device's own logits and gradients."""
    jcfg, _, cfg, params = models[arch]
    n = 3
    trees = [convert.peft_from_jax(jax.tree.map(np.asarray, _nonzero_peft(jcfg, method, 20 + 2 * i)), "cpu")
             for i in range(n)]
    tokens, targets = (torch.from_numpy(x).long() for x in _batch(cfg, 12, (n,)))

    def single(p, i):
        logits = model_apply(params, cfg, {"tokens": tokens[i]}, peft=p)[0]
        return softmax_xent(logits, targets[i])[0], {"logits": logits}

    def cohort(layers):
        logits = model_apply(params, cfg, {"tokens": tokens}, peft=layers, devices=n)[0].view(n, -1, SEQ,
                                                                                               cfg.vocab_size)
        loss = sum(softmax_xent(logits[i], targets[i])[0] for i in range(n))
        return loss, {"logits": logits}

    (_, aux), grads = value_and_grad(cohort)(stacking.layer_list(stack_trees(trees), cfg.num_layers, axis=1))
    for i in range(n):
        (_, want), want_grads = value_and_grad(single)(trees[i], i)
        np.testing.assert_allclose(_np(aux["logits"][i]), _np(want["logits"]), atol=GRAD_ATOL)
        got_i = stacking.tree_map(lambda g: g[i], grads)
        _close_trees(got_i, stacking.layer_list(want_grads, cfg.num_layers), GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "jamba-v0.1-52b"])
def test_merge_lora_into_base_matches_jax(models, arch):
    """Both layouts: qwen3's stacked layers and LoRA, jamba's per-layer
    lists (its Mamba LoRA is not merged, as the reference does not); then
    the merged base without LoRA against the unmerged model with it."""
    jcfg, jparams, cfg, params = models[arch]
    jtree = _nonzero_peft(jcfg, "lora", 30)
    scale = 2.0
    want = jax_peft.merge_lora_into_base(jparams["layers"], jtree, scale)
    tree = convert.peft_from_jax(jax.tree.map(np.asarray, jtree), "cpu")
    got = peft.merge_lora_into_base(params["layers"], tree, scale)
    _close_trees(got, jax.tree.map(np.asarray, want), 2e-5)
    assert any(not torch.equal(a, b) for a, b in zip(stacking.tree_leaves(got), stacking.tree_leaves(params["layers"])))
    if arch == "jamba-v0.1-52b":
        tree = [{k: v for k, v in layer.items() if k != "mamba"} for layer in tree]
    tokens = torch.from_numpy(_batch(cfg, 13)[0]).long()
    unmerged = model_apply(params, cfg, {"tokens": tokens}, peft=tree, lora_scale=scale)[0]
    merged = model_apply({**params, "layers": got}, cfg, {"tokens": tokens})[0]
    np.testing.assert_allclose(_np(merged), _np(unmerged), atol=LOGIT_ATOL)


# ------------------------------------------------------------- nn pieces
def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6.0, 6.0, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    np.testing.assert_allclose(_np(mlp.gelu(torch.from_numpy(x))), want, atol=2e-6)
    # the case discriminates: torch's default (the exact erf form) is off by more than the tolerance
    assert np.abs(_np(F.gelu(torch.from_numpy(x))) - want).max() > 1e-4


def test_gelu_mlp_branch_matches_jax():
    jcfg = jax_get_config("qwen3-1.7b", smoke=True).replace(activation="gelu", dtype="float32")
    cfg = get_config("qwen3-1.7b", smoke=True).replace(activation="gelu", dtype="float32")
    jp = jax_mlp.init_mlp(jax.random.PRNGKey(3), jcfg)
    jp = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(4), x.shape), jp)
    assert _shapes(mlp.init_mlp(cfg, torch.Generator())) == _shapes(jp)
    assert cfg.param_counts() == jcfg.param_counts()
    # the model's own init follows ``activation`` too (GELU MLPs and
    # LayerNorms; stacked, per-layer and RWKV6), and so does its forward
    for arch in ARCHS:
        jc = jax_get_config(arch, smoke=True).replace(activation="gelu", dtype="float32")
        c = get_config(arch, smoke=True).replace(activation="gelu", dtype="float32")
        jparams = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0), jc)
        jparams = jax.tree.map(lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(1), x.shape), jparams)
        assert _shapes(init_params(c, torch.Generator())) == _shapes(jparams), arch
        tokens = _batch(c, 8)[0]
        want_logits = jax_model_apply(jparams, jc, {"tokens": jnp.asarray(tokens)})[0]
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        got_logits = model_apply(params, c, {"tokens": torch.from_numpy(tokens).long()})[0]
        np.testing.assert_allclose(_np(got_logits), np.asarray(want_logits), atol=LOGIT_ATOL, err_msg=arch)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, cfg.d_model), dtype=np.float32)
    lora = {t: {"a": rng.standard_normal((d_in, 4), dtype=np.float32) * 0.1,
                "b": rng.standard_normal((4, d_out), dtype=np.float32) * 0.1}
            for t, (d_in, d_out) in (("up", (cfg.d_model, cfg.d_ff)), ("down", (cfg.d_ff, cfg.d_model)))}
    for p in (None, lora):
        want = jax_mlp.mlp_apply(jp, jcfg, jnp.asarray(x), None if p is None else jax.tree.map(jnp.asarray, p), 2.0)
        got = mlp.mlp_apply(convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), cfg, torch.from_numpy(x),
                            None if p is None else convert.peft_from_jax(p, "cpu"), 2.0)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


def test_adapter_apply_matches_jax():
    rng = np.random.default_rng(6)
    p = {"down": {"w": rng.standard_normal((32, 8), dtype=np.float32) * 0.2},
         "up": {"w": rng.standard_normal((8, 32), dtype=np.float32) * 0.2}}
    x = rng.standard_normal((3, 5, 32), dtype=np.float32)
    want = jax_mlp.adapter_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    np.testing.assert_allclose(_np(mlp.adapter_apply(convert.peft_from_jax(p, "cpu"), torch.from_numpy(x))),
                               np.asarray(want), atol=2e-5)


def test_sgdm_update_matches_jax_over_three_steps():
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 6), dtype=np.float32), "b": [rng.standard_normal(5, dtype=np.float32)]}
    jp, tp = jax.tree.map(jnp.asarray, params), convert.peft_from_jax(params, "cpu")
    jstate, tstate = jax_sgdm_init(jp), sgdm_init(tp)
    for step in range(3):
        grads = {"a": rng.standard_normal((4, 6), dtype=np.float32), "b": [rng.standard_normal(5, dtype=np.float32)]}
        jp, jstate = jax_sgdm_update(jax.tree.map(jnp.asarray, grads), jstate, jp, lr=0.1, momentum=0.9)
        tp, tstate = sgdm_update(convert.peft_from_jax(grads, "cpu"), tstate, tp, lr=0.1, momentum=0.9)
        _close_trees(tp, jax.tree.map(np.asarray, jp), 2e-6)
        _close_trees(tstate, jax.tree.map(np.asarray, jstate), 2e-6)


@pytest.mark.parametrize("method", METHODS)
def test_system_model_peft_bytes_match_jax(method):
    devices = ["tx2", "nx", "agx", "agx"]
    kw = dict(devices=devices, bandwidth_mbps=np.asarray([5.0, 20.0, 50.0, 80.0]), batch=16, seq=32, local_steps=4,
              peft=True, active_fraction=np.linspace(0.4, 1.0, 4), share_fraction=np.full(4, 0.5))
    for arch in ARCHS:
        ours = system_model.SystemModel(get_config(arch), PEFTConfig(method=method, adapter_dim=32))
        theirs = jax_system_model.SystemModel(jax_get_config(arch), JaxPEFTConfig(method=method, adapter_dim=32))
        assert ours.peft_params == theirs.peft_params
        got, want = ours.cohort_round_cost(**kw), theirs.cohort_round_cost(**kw)
        for field in ("compute_time_s", "comm_time_s", "memory_gb", "energy_j", "traffic_mb", "total_time_s"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_q_blocked_attention_matches_the_port(monkeypatch):
    """JAX's long-prefill loop over query blocks (taken past
    ``_MAX_NAIVE_SCORES`` scores a head) against the port's attention,
    which is blockwise at every length: S 64 with the limit patched to
    32 x 32 runs JAX's loop in blocks of 16 queries, causal and windowed."""
    rng = np.random.default_rng(8)
    b, s, h, kv, d = 2, 64, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, n, d), dtype=np.float32) for n in (h, kv, kv))
    pos = jnp.arange(s)
    sdpa, calls = jax_attention._sdpa, []
    monkeypatch.setattr(jax_attention, "_sdpa", lambda *a: calls.append(a[0].shape[1]) or sdpa(*a))
    for window in (None, 24):
        calls.clear()
        naive = jax_attention.multi_head_attention(*map(jnp.asarray, (q, k, v)), q_positions=pos, k_positions=pos,
                                                   window=window)
        monkeypatch.setattr(jax_attention, "_MAX_NAIVE_SCORES", 32 * 32)
        blocked = jax_attention.multi_head_attention(*map(jnp.asarray, (q, k, v)), q_positions=pos, k_positions=pos,
                                                     window=window)
        monkeypatch.setattr(jax_attention, "_MAX_NAIVE_SCORES", 8192 * 8192)
        assert calls == [s, 16, 16, 16, 16]  # the naive call, then four blocks of 16 queries
        got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True, window=window)
        np.testing.assert_allclose(_np(got), np.asarray(blocked), atol=2e-5)
        np.testing.assert_allclose(np.asarray(blocked), np.asarray(naive), atol=2e-6)


# ------------------------------------------------------------- every method
_TINY = dict(cfg=get_config("qwen3-1.7b", smoke=True).replace(**CFG_KW),
             fed_cfg=FederatedConfig(num_devices=4, devices_per_round=2, local_steps=1, batch_size=2), device="cpu")
_EVERY = [(m, "lora") for m in api.list_methods()] + [
    (m, kind) for m in ("droppeft", "fedlora", "fedadapter", "fedadaopt") for kind in ("adapter", "bitfit")]


@pytest.mark.parametrize("method,kind", _EVERY, ids=["-".join(c) for c in _EVERY])
def test_every_method_runs_a_round(method, kind):
    result = api.build(method, peft=kind, **_TINY).run(rounds=1)
    assert result.rounds == 1 and np.isfinite(result.final_accuracy) and np.isfinite(result.loss).all()
