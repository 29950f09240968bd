"""The port's serving path against the JAX package, on the CPU (the kernels'
plain twins), at the smoke size of qwen3-1.7b with 2 layers in float32.

The JAX params and two LoRA tenants of ranks 4 and 8 are built as
``tests/test_multi_adapter_serving.py::_two_tenant_setup`` builds them and
go through ``repro_torch.convert``.  Tolerances: 2e-5 for a single block,
1e-4 for the logits of the whole model (float32 sums in another order);
tokens and completions are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import get_config as jax_get_config
from repro.core import peft as jax_peft
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import transformer as jax_transformer
from repro.models.layers import layer_apply as jax_layer_apply
from repro.models.registry import init_params as jax_init_params
from repro.models.stacking import layer_view as jax_layer_view
from repro.nn.attention import attention_apply as jax_attention_apply
from repro.nn.linear import apply_linear as jax_apply_linear
from repro.nn.mlp import mlp_apply as jax_mlp_apply
from repro.nn.norms import apply_rmsnorm as jax_apply_rmsnorm
from repro.nn.rotary import apply_rotary as jax_apply_rotary
from repro.serving.adapters import AdapterPoolCache as JaxAdapterPoolCache
from repro.serving.adapters import AdapterRegistry as JaxAdapterRegistry
from repro.serving.batcher import ContinuousBatcher as JaxContinuousBatcher
from repro.serving.batcher import Request as JaxRequest
from repro.serving.batcher import batched_caches as jax_batched_caches
from repro_torch import api, convert
from repro_torch.configs import PEFTConfig, get_config
from repro_torch.core import peft
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer
from repro_torch.models.layers import layer_apply
from repro_torch.models.registry import init_params
from repro_torch.models.stacking import layer_view, tree_leaves
from repro_torch.nn.attention import attention_apply
from repro_torch.nn.linear import apply_linear
from repro_torch.nn.mlp import mlp_apply
from repro_torch.nn.norms import apply_rmsnorm
from repro_torch.nn.rotary import apply_rotary
from repro_torch.serving.adapters import AdapterPoolCache, AdapterRegistry
from repro_torch.serving.batcher import Request, batched_caches

BLOCK_ATOL = 2e-5
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    jcfg = jax_get_config("qwen3-1.7b", smoke=True).replace(num_layers=2, dtype="float32")
    jparams = jax.jit(jax_init_params, static_argnums=1)(key, jcfg)
    jtrees = {}
    for i, rank in enumerate((4, 8)):
        pcfg = JaxPEFTConfig(method="lora", lora_rank=rank, lora_targets=("q", "v"))
        tree = jax.jit(jax_peft.init_peft, static_argnums=(1, 2))(jax.random.fold_in(key, i), jcfg, pcfg)
        jtrees[f"client{i}"] = jax.jit(
            lambda t: jax.tree.map(lambda x: x + 0.02 * jax.random.normal(jax.random.fold_in(key, 99), x.shape), t)
        )(tree)
    cfg = get_config("qwen3-1.7b", smoke=True).replace(num_layers=2, dtype="float32")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    trees = {n: convert.peft_from_jax(jax.tree.map(np.asarray, t), "cpu") for n, t in jtrees.items()}
    return jcfg, jparams, jtrees, cfg, params, trees


def _t(arr):
    return torch.from_numpy(np.array(arr))


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=0)


# ------------------------------------------------------------- conversion
def test_convert_keeps_stacked_leaves(setup):
    _, jparams, jtrees, _, params, trees = setup
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(jleaves) == len(tree_leaves(params))
    for path, leaf in jleaves:
        node = params
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert params["layers"]["attn"]["wq"]["w"].shape[0] == 2  # stacked (L, ...)
    assert tuple(trees["client1"]["attn"]["v"]["a"].shape) == jtrees["client1"]["attn"]["v"]["a"].shape


def test_convert_bf16_leaves_from_ml_dtypes_and_uint16():
    x = np.random.default_rng(0).standard_normal((3, 5), dtype=np.float32)
    as_bf16 = np.asarray(jnp.asarray(x, jnp.bfloat16))  # ml_dtypes.bfloat16
    bits = as_bf16.view(np.uint16)  # the checkpoint format's view
    want = torch.from_numpy(x).to(torch.bfloat16)
    for leaf in (as_bf16, bits):
        got = convert.params_from_jax({"w": leaf}, "cpu")["w"]
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    cast = convert.peft_from_jax({"a": x}, "cpu", dtype=torch.bfloat16)["a"]
    assert torch.equal(cast, want)


def test_init_shapes_and_dtypes_match_jax(setup):
    jcfg, jparams, _, cfg, _, _ = setup
    gen = torch.Generator().manual_seed(0)
    ours = init_params(cfg, gen)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = ours
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape and node.dtype == torch.float32, path
    jtree = jax_peft.init_peft(jax.random.PRNGKey(1), jcfg, JaxPEFTConfig(lora_rank=8, lora_targets=("q", "v", "up")))
    tree = peft.init_peft(cfg, PEFTConfig(lora_rank=8, lora_targets=("q", "v", "up")), gen)
    assert jax.tree.map(lambda x: x.shape, jtree) == {
        g: {t: {k: tuple(v.shape) for k, v in n.items()} for t, n in d.items()} for g, d in tree.items()
    }
    assert not tree["attn"]["q"]["b"].any()  # b starts at zero
    assert peft.lora_scale(PEFTConfig(lora_rank=4)) == jax_peft.lora_scale(JaxPEFTConfig(lora_rank=4))


# ------------------------------------------------------------- per layer
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    want = jax_apply_rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x, dtype), 1e-5)
    got = apply_rmsnorm({"scale": _t(scale)}, _t(x).to(getattr(torch, dtype)), 1e-5)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, BLOCK_ATOL if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("positions", [np.arange(5), np.asarray([[0], [7], [300]])])
def test_rotary_matches_jax(positions):
    """A sequence (S,) and per-row decode positions (B, 1)."""
    b, s = (1, 5) if positions.ndim == 1 else (3, 1)
    x = np.random.default_rng(2).standard_normal((b, s, 4, 32), dtype=np.float32)
    want = jax_apply_rotary(jnp.asarray(x), jnp.asarray(positions), 1_000_000.0)
    _close(apply_rotary(_t(x), _t(positions), 1_000_000.0), want, BLOCK_ATOL)


def test_mlp_matches_jax(setup):
    jcfg, jparams, _, cfg, params, _ = setup
    x = np.random.default_rng(3).standard_normal((2, 3, cfg.d_model), dtype=np.float32)
    want = jax.jit(jax_mlp_apply, static_argnums=1)(jax_layer_view(jparams["layers"], 1)["mlp"], jcfg, jnp.asarray(x))
    _close(mlp_apply(layer_view(params["layers"], 1)["mlp"], cfg, _t(x)), want, BLOCK_ATOL)


@pytest.mark.parametrize("tenant", [None, "client1"])
def test_attention_block_cache_free_matches_jax(setup, tenant):
    """The cache-free path, bare and with a plain LoRA tree on q and v."""
    jcfg, jparams, jtrees, cfg, params, trees = setup
    x = np.random.default_rng(4).standard_normal((2, 6, cfg.d_model), dtype=np.float32)
    jpeft = jax_layer_view(jtrees[tenant], 0)["attn"] if tenant else None
    tpeft = layer_view(trees[tenant], 0)["attn"] if tenant else None
    want, _ = jax.jit(lambda p, x, pf: jax_attention_apply(p, jcfg, x, jnp.arange(6), peft=pf, lora_scale=2.0))(
        jax_layer_view(jparams["layers"], 0)["attn"], jnp.asarray(x), jpeft
    )
    got, cache = attention_apply(
        layer_view(params["layers"], 0)["attn"], cfg, _t(x), torch.arange(6), peft=tpeft, lora_scale=2.0
    )
    assert cache is None
    _close(got, want, BLOCK_ATOL)


def test_pooled_linear_multi_token_rows_match_jax(setup):
    """An adapter pool on a (B, S, d) input: every token of a row uses the
    row's adapter (the segmented kernel's rows repeat per token)."""
    jcfg, jparams, jtrees, cfg, params, trees = setup
    jreg, reg = JaxAdapterRegistry(), AdapterRegistry()
    for name in ("client0", "client1"):
        jreg.register(name, jtrees[name])
        reg.register(name, trees[name])
    jpool, pool = JaxAdapterPoolCache(jreg, n_slots=2), AdapterPoolCache(reg, n_slots=2)
    names = ["client1", "client0", "client1"]
    jq = jax_layer_view(jpool.pooled_peft(jpool.lookup(names)), 0)["attn"]["q"]
    tq = layer_view(pool.pooled_peft(pool.lookup(names)), 0)["attn"]["q"]
    x = np.random.default_rng(9).standard_normal((3, 4, cfg.d_model), dtype=np.float32)
    want = jax_apply_linear(jax_layer_view(jparams["layers"], 0)["attn"]["wq"], jnp.asarray(x), jq)
    got = apply_linear(layer_view(params["layers"], 0)["attn"]["wq"], _t(x), tq)
    _close(got, want, BLOCK_ATOL)


def test_layer_apply_matches_jax(setup):
    jcfg, jparams, _, cfg, params, _ = setup
    x = np.random.default_rng(5).standard_normal((2, 4, cfg.d_model), dtype=np.float32)
    want, _, _ = jax.jit(lambda p, x: jax_layer_apply(p, jcfg, x, positions=jnp.arange(4)))(
        jax_layer_view(jparams["layers"], 1), jnp.asarray(x)
    )
    got, _, _ = layer_apply(layer_view(params["layers"], 1), cfg, _t(x), positions=torch.arange(4))
    _close(got, want, BLOCK_ATOL)


def test_attention_batched_cache_matches_jax(setup):
    """The per-row ring write and decode attention: a fresh row, a mid-ring
    row, a wrapped ring and a recycled row over a ring of stale K/V."""
    jcfg, jparams, _, cfg, params, _ = setup
    rng = np.random.default_rng(6)
    b, s_max, hd = 4, 8, cfg.resolved_head_dim
    x = rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
    k0 = rng.standard_normal((b, s_max, cfg.num_kv_heads, hd), dtype=np.float32)
    v0 = rng.standard_normal((b, s_max, cfg.num_kv_heads, hd), dtype=np.float32)
    pos = np.asarray([0, 3, 13, 1], np.int32)
    jcache = {"k": jnp.asarray(k0), "v": jnp.asarray(v0), "pos": jnp.asarray(pos)}
    want, jnew = jax.jit(lambda p, x, c: jax_attention_apply(p, jcfg, x, c["pos"][:, None], cache=c))(
        jax_layer_view(jparams["layers"], 0)["attn"], jnp.asarray(x), jcache
    )
    cache = {"k": _t(k0), "v": _t(v0), "pos": _t(pos)}
    got, new = attention_apply(layer_view(params["layers"], 0)["attn"], cfg, _t(x), _t(pos)[:, None], cache=cache)
    _close(got, want, BLOCK_ATOL)
    _close(new["k"], jnew["k"], BLOCK_ATOL)
    _close(new["v"], jnew["v"], BLOCK_ATOL)
    np.testing.assert_array_equal(new["pos"].numpy(), np.asarray(jnew["pos"]))
    assert new["k"] is cache["k"]  # written in place


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("tenant", [None, "client0"])
def test_lm_apply_logits_match_jax(setup, tenant):
    jcfg, jparams, jtrees, cfg, params, trees = setup
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want, _, _ = jax.jit(lambda p, t, pf: jax_transformer.lm_apply(p, jcfg, t, peft=pf, lora_scale=4.0, stack_mode="scan"))(
        jparams, jnp.asarray(tokens), jtrees[tenant] if tenant else None
    )
    got, _, caches = transformer.lm_apply(
        params, cfg, _t(tokens), peft=trees[tenant] if tenant else None, lora_scale=4.0
    )
    assert caches is None and tuple(got.shape) == (2, 6, cfg.vocab_size)
    _close(got, want, LOGIT_ATOL)


def test_serve_step_logits_match_jax(setup):
    """Several decode steps through an adapter pool, rows at different
    depths: the logits of every step agree and the greedy tokens are equal."""
    jcfg, jparams, jtrees, cfg, params, trees = setup
    jreg, reg = JaxAdapterRegistry(), AdapterRegistry()
    for name in ("client0", "client1"):
        jreg.register(name, jtrees[name])
        reg.register(name, trees[name])
    jpool, pool = JaxAdapterPoolCache(jreg, n_slots=2), AdapterPoolCache(reg, n_slots=2)
    names = ["client1", "client0", "client1"]
    jpeft = jpool.pooled_peft(jpool.lookup(names))
    tpeft = pool.pooled_peft(pool.lookup(names))
    jstep = jax.jit(jax_make_serve_step(jcfg, stack_mode="scan"))
    step = make_serve_step(cfg)
    jcaches = jax_batched_caches(jcfg, 3, 8, dtype=jnp.float32)
    caches = batched_caches(cfg, 3, 8, dtype=torch.float32)
    pos = np.asarray([0, 2, 5], np.int32)
    jcaches = dict(jcaches, pos=jnp.broadcast_to(jnp.asarray(pos), (2, 3)))
    caches["pos"][:] = _t(pos)
    rng = np.random.default_rng(8)
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jlogits, jnext, jcaches = jstep(jparams, jnp.asarray(tok), jnp.asarray(pos), jcaches, peft=jpeft)
        logits, nxt, caches = step(params, _t(tok), _t(pos), caches, peft=tpeft)
        _close(logits, jlogits, LOGIT_ATOL)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnext))
        np.testing.assert_array_equal(caches["pos"].numpy(), np.asarray(jcaches["pos"]))
        pos = pos + 1


def _serve(params, trees, cfg, batch, n_slots=2):
    return api.serve(cfg=cfg, params=params, adapters=trees, batch=batch, max_len=16,
                     n_slots=n_slots, cache_dtype="float32", device="cpu")


def test_batcher_matches_jax_and_per_request_switching(setup):
    """The run of ``test_batched_mixed_adapters_match_per_request_switching``:
    the port's completions equal the JAX batcher's (tokens and finish
    reasons), and the port's batched tokens equal its per-request tokens."""
    jcfg, jparams, jtrees, cfg, params, trees = setup
    prompts = [[5, 7, 11], [13, 17], [19, 23, 29, 31]]
    adapters = ["client0", "client1", "client0"]
    jreg = JaxAdapterRegistry()
    for name, tree in jtrees.items():
        jreg.register(name, tree)
    jbatcher = JaxContinuousBatcher(
        jax_make_serve_step(jcfg, stack_mode="scan"), jparams, jcfg, JaxAdapterPoolCache(jreg, n_slots=2),
        batch=3, max_len=16, cache_dtype=jnp.float32,
    )
    batcher = _serve(params, trees, cfg, batch=3)
    for j in range(3):
        jbatcher.submit(JaxRequest(prompt=prompts[j], adapter=adapters[j], max_new_tokens=4, uid=j))
        batcher.submit(Request(prompt=prompts[j], adapter=adapters[j], max_new_tokens=4, uid=j))
    want = {c.uid: (c.tokens, c.finish_reason) for c in jbatcher.run()}
    done = {c.uid: c for c in batcher.run()}
    assert {u: (c.tokens, c.finish_reason) for u, c in done.items()} == want

    for j in range(3):
        solo = _serve(params, trees, cfg, batch=3)
        for z in range(3):  # uniform batch: every row a copy of request j
            solo.submit(Request(prompt=prompts[j], adapter=adapters[j], max_new_tokens=4, uid=f"{j}.{z}"))
        ref = {c.uid: c for c in solo.run()}[f"{j}.0"]
        assert done[j].tokens == ref.tokens and done[j].finish_reason == ref.finish_reason


@pytest.mark.parametrize("budgets", [(2, 8), (8, 2)])
def test_hot_swap_mid_generation_matches_solo(setup, budgets):
    """3 tenants through a 2-slot pool at batch 2: admitting the third
    request evicts a slot while the other row still generates; no
    request's tokens change against running alone."""
    _, _, _, cfg, params, trees = setup
    tenants = {f"t{i}": trees[f"client{i % 2}"] for i in range(3)}

    def serve_all(requests):
        b = _serve(params, tenants, cfg, batch=2)
        for r in requests:
            b.submit(r)
        return {c.uid: c.tokens for c in b.run()}, b.pool.swaps

    reqs = [
        Request(prompt=[5, 7], adapter="t0", max_new_tokens=budgets[0], uid=0),
        Request(prompt=[11, 13], adapter="t1", max_new_tokens=budgets[1], uid=1),
        Request(prompt=[17, 19], adapter="t2", max_new_tokens=3, uid=2),
    ]
    got, swaps = serve_all(reqs)
    assert swaps == 3  # t2's admission displaced a resident adapter
    for r in reqs:
        solo, _ = serve_all([Request(prompt=r.prompt, adapter=r.adapter, max_new_tokens=r.max_new_tokens, uid=r.uid)])
        assert got[r.uid] == solo[r.uid], r.uid


def test_batcher_guards(setup):
    """submit() rejects an empty prompt and one that would wrap the ring;
    run() raises on max_steps exhausted and on a queue stalled by pins held
    outside the batcher; lookup() rejects more adapters than slots."""
    _, _, _, cfg, params, trees = setup
    tenants = {f"t{i}": trees[f"client{i % 2}"] for i in range(3)}
    b = _serve(params, tenants, cfg, batch=2)
    with pytest.raises(ValueError, match="empty prompt"):
        b.submit(Request(prompt=[], adapter="t0"))
    with pytest.raises(ValueError, match="cache positions"):
        b.submit(Request(prompt=list(range(16)), adapter="t0"))
    b.submit(Request(prompt=[3, 5], adapter="t0", max_new_tokens=4, uid=0))
    with pytest.raises(RuntimeError, match="max_steps"):
        b.run(max_steps=1)

    b2 = _serve(params, tenants, cfg, batch=2)
    b2.pool.pin("t0")
    b2.pool.pin("t1")
    b2.submit(Request(prompt=[3, 5], adapter="t2", max_new_tokens=2, uid=0))
    with pytest.raises(RuntimeError, match="pinned"):
        b2.run()
    b2.pool.unpin("t0")
    assert len(b2.run()) == 1  # releasing a pin unblocks the queue
    with pytest.raises(ValueError, match="distinct adapters"):
        b2.pool.lookup(["t0", "t1", "t2"])


def test_pool_lru_eviction_pinning_and_padding(setup):
    _, _, _, _, _, trees = setup
    reg = AdapterRegistry()
    for i in range(3):
        reg.register(f"t{i}", trees[f"client{i % 2}"], alpha=16.0)
    pool = AdapterPoolCache(reg, n_slots=2)
    assert pool.r_max == 8
    s0, s1 = pool.slot_of("t0"), pool.slot_of("t1")
    assert {s0, s1} == {0, 1}
    # t0 (rank 4): zero-padded to r_max, alpha/rank folded into b
    qa, qb = pool._pool["attn"]["q"]["a"], pool._pool["attn"]["q"]["b"]
    assert torch.equal(qa[:, s0, :, :4], trees["client0"]["attn"]["q"]["a"]) and not qa[:, s0, :, 4:].any()
    assert torch.equal(qb[:, s0, :4], trees["client0"]["attn"]["q"]["b"] * 4.0)
    pool.slot_of("t0")  # refresh t0: t1 becomes LRU
    assert pool.slot_of("t2") == s1
    pool.pin("t0")
    pool.pin("t2")
    with pytest.raises(RuntimeError):
        pool.slot_of("t1")  # all slots pinned
    pool.unpin("t2")
    assert pool.slot_of("t1") == s1
    assert pool._ranks.tolist() == [4, 8] if s0 == 0 else [8, 4]
