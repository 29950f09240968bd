"""The last of the reference's public names in the port, against the JAX
package on the CPU (the kernels' plain twins), at the smoke size (2 layers)
in float32: ``multi_head_attention`` in each of its kernel cases, the STLD
``gate``, ``wkv_sequential_ref``, ``init_layer(force_kind=...)``,
``default_stack_mode``, ``make_client_fns(stack_mode=...)``, the ``layout``
of the init functions, ``softmax_xent(z_loss_coef=...)``, ``encode(drops,
peft)``, ``api.serve(model_overrides, stack_mode)`` and the five oracle
names of ``kernels.ref``.

Inputs come from numpy seeds; the reference gets the port's weights and
the same gates.  Tolerances, each with its reason:
* attention, the oracles, the z-loss and the WKV oracle 2e-5 abs
  (``tests/test_kernels.py``'s float32 bound);
* encoder states 1e-4 abs (float32 sums in another order over a stack);
* gradients 2e-5 abs + 1e-3 rel (``tests/test_torch_training.py``);
* the list layout against the stacked one, gates and tokens exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import STLDConfig as JaxSTLDConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.core import stld as jax_stld
from repro.federated.client import make_client_fns as jax_make_client_fns
from repro.kernels import ref as jax_ref
from repro.models import encdec as jax_encdec
from repro.models import stacking as jax_stacking
from repro.models.layers import init_layer as jax_init_layer
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import default_stack_mode as jax_default_stack_mode
from repro.nn.attention import multi_head_attention as jax_mha
from repro.nn.rwkv import wkv_sequential_ref as jax_wkv_sequential_ref
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import api
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import ARCH_IDS, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import stld
from repro_torch.core.peft import init_peft
from repro_torch.federated.client import make_client_fns
from repro_torch.federated.engine import stack_trees, unstack_tree
from repro_torch.kernels import ops, ref
from repro_torch.models import encdec, stacking
from repro_torch.models.layers import init_layer
from repro_torch.models.losses import cohort_softmax_xent, softmax_xent
from repro_torch.models.registry import default_stack_mode, init_params, place_params
from repro_torch.models.stacking import tree_leaves, tree_map
from repro_torch.nn.attention import INT32_MAX, multi_head_attention
from repro_torch.nn.rwkv import wkv_sequential_ref
from repro_torch.optim import adamw_init
from repro_torch.serving.batcher import Request

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)

ATOL, ENC_ATOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
B, H, KV, HD = 2, 4, 2, 16


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def to_jax(tree):
    return tree_map(lambda t: jnp.asarray(t.detach().numpy()), tree)


def _shapes(tree, path=()):
    """{path: shape} of a tree of dicts (either package's leaves)."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _shapes(v, path + (k,)).items()}
    return {path: tuple(tree.shape)}


# ------------------------------------------------------------- multi_head_attention
def _run(n, offset=0):
    return np.arange(n, dtype=np.int32) + offset


_PER_ROW_K = np.stack([_run(12), np.where(np.arange(12) < 7, np.arange(12), INT32_MAX)]).astype(np.int32)

# name: (Sq, Skv, q_positions, k_positions, causal, window, the kernel and its launches)
MHA_CASES = {
    "a causal run": (8, 8, _run(8, 5), _run(8, 5), True, None, ("flash_attention", 1)),
    "a causal run, window": (8, 8, _run(8, 5), _run(8, 5), True, 3, ("flash_attention", 1)),
    "a bidirectional run, window": (8, 8, _run(8, 2), _run(8, 2), False, 3, ("flash_attention", 1)),
    "b bidirectional, 1-D": (6, 10, _run(6, 4), _run(10), False, None, ("flash_attention", 1)),
    "b bidirectional, 2-D": (3, 12, np.array([[9, 1, 4], [2, 6, 0]], np.int32), _PER_ROW_K, False, None,
                             ("flash_attention", 1)),
    "c queries over a longer run": (4, 12, _run(4, 8), _run(12), True, None, ("flash_decode", 4)),
    "c queries over a longer run, window": (4, 12, _run(4, 8), _run(12), True, 5, ("flash_decode", 4)),
    "c a ring with unwritten slots": (2, 12, _run(2, 5), np.where(_run(12) < 7, _run(12), INT32_MAX).astype(np.int32),
                                      True, None, ("flash_decode", 2)),
    "d per-row positions": (1, 12, np.array([[9], [4]], np.int32), _PER_ROW_K, True, None, ("flash_decode", 1)),
    "d per-row positions, window": (3, 12, np.array([[9, 10, 11], [4, 5, 6]], np.int32), _PER_ROW_K, True, 4,
                                    ("flash_decode", 3)),
}


def _qkv(sq, skv, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, sq, H, HD), dtype=np.float32),
            *(rng.standard_normal((B, skv, KV, HD), dtype=np.float32) for _ in range(2)))


@pytest.fixture
def kernel_calls(monkeypatch):
    """The attention kernels' calls by name (the CPU runs their twins)."""
    calls = {"flash_attention": 0, "flash_decode": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(ops, name, counted)
    return calls


@pytest.mark.parametrize("case", MHA_CASES)
def test_multi_head_attention_matches_the_reference(case, kernel_calls):
    """Each case against ``repro.nn.attention.multi_head_attention`` at
    2e-5, on the kernel it names with its count of calls."""
    sq, skv, qpos, kpos, causal, window, (kernel, calls) = MHA_CASES[case]
    q, k, v = _qkv(sq, skv)
    with torch.no_grad():
        got = multi_head_attention(*map(torch.from_numpy, (q, k, v)), q_positions=torch.from_numpy(qpos),
                                   k_positions=torch.from_numpy(kpos), causal=causal, window=window)
    want = jax_mha(*map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
                   causal=causal, window=window)
    _close(got, want)
    assert kernel_calls == {"flash_attention": 0, "flash_decode": 0, kernel: calls}


@pytest.mark.parametrize("case", [c for c in MHA_CASES if MHA_CASES[c][-1][0] == "flash_attention"])
def test_multi_head_attention_trains_where_flash_attention_runs(case):
    """Cases (a) and (b): q, k and v's gradients against ``jax.grad``."""
    sq, skv, qpos, kpos, causal, window, _ = MHA_CASES[case]
    q, k, v = _qkv(sq, skv, seed=1)
    probe = np.random.default_rng(2).standard_normal((B, sq, H, HD), dtype=np.float32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = multi_head_attention(tq, tk, tv, q_positions=torch.from_numpy(qpos), k_positions=torch.from_numpy(kpos),
                               causal=causal, window=window)
    torch.sum(out * torch.from_numpy(probe)).backward()
    loss = lambda q, k, v: jnp.sum(jax_mha(q, k, v, q_positions=jnp.asarray(qpos), k_positions=jnp.asarray(kpos),
                                           causal=causal, window=window) * probe)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))):
        _close(got, want, GRAD_ATOL, GRAD_RTOL)


def test_multi_head_attention_raises_where_no_kernel_runs():
    """Decoding query by query has no backward, so it raises for an input
    that requires a gradient (and runs under ``no_grad``); a bidirectional
    window over positions that are not one run has no kernel."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 12))
    pos = {"q_positions": torch.from_numpy(_run(4, 8)), "k_positions": torch.from_numpy(_run(12))}
    with pytest.raises(ValueError, match="no backward"):
        multi_head_attention(q.requires_grad_(), k, v, **pos)
    with torch.no_grad():
        assert multi_head_attention(q, k, v, **pos).shape == (B, 4, H, HD)
    with pytest.raises(ValueError, match="no kernel"):
        multi_head_attention(q, k, v, causal=False, window=3, **pos)


# ------------------------------------------------------------- the STLD gate
def test_gate_matches_the_reference():
    """A dropped layer passes h and its cache through with an aux of 0.0
    (float32) and calls nothing; a kept one is ``block_fn``; ``drop`` a
    host bool or a 0-d CPU tensor."""
    rng = np.random.default_rng(3)
    h, c = rng.standard_normal((2, 3, 4), dtype=np.float32), rng.standard_normal((2, 5), dtype=np.float32)
    calls = []

    def block(h, cache):
        calls.append(1)
        return h * 2.0 + 1.0, torch.tensor(0.25), {"k": cache["k"] - 1.0}

    def jax_block(h, cache):
        return h * 2.0 + 1.0, jnp.float32(0.25), {"k": cache["k"] - 1.0}

    for drop in (True, torch.tensor(True), False, torch.tensor(False)):
        th, tc = torch.from_numpy(h), {"k": torch.from_numpy(c)}
        got = stld.gate(block, drop, th, tc)
        want = jax_stld.gate(jax_block, jnp.asarray(bool(drop)), jnp.asarray(h), {"k": jnp.asarray(c)})
        for g, w in zip((got[0], got[1], got[2]["k"]), (want[0], want[1], want[2]["k"])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[1].dtype == torch.float32 and got[1].ndim == 0
        if bool(drop):
            assert got[0] is th and got[2] is tc
    assert len(calls) == 2


# ------------------------------------------------------------- the WKV oracle
def test_wkv_sequential_ref_matches_the_reference():
    rng = np.random.default_rng(4)
    r, k, v = (rng.standard_normal((2, 7, 2, 8), dtype=np.float32) for _ in range(3))
    logw = -np.exp(rng.standard_normal((2, 7, 2, 8), dtype=np.float32))
    u = rng.standard_normal((2, 8), dtype=np.float32)
    got = wkv_sequential_ref(*map(torch.from_numpy, (r, k, v, logw, u)))
    want = jax_wkv_sequential_ref(*map(jnp.asarray, (r, k, v, logw, u)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


# ------------------------------------------------------------- init_layer and default_stack_mode
@pytest.mark.parametrize("arch, l, force_kind", [("whisper-tiny", 0, "attn"), ("whisper-tiny", 1, None),
                                                 ("jamba-v0.1-52b", 0, None), ("jamba-v0.1-52b", 0, "attn"),
                                                 ("rwkv6-3b", 1, None), ("granite-moe-3b-a800m", 0, None)])
def test_init_layer_structure_matches_the_reference(arch, l, force_kind):
    cfg = get_config(arch, smoke=True)
    got = init_layer(cfg, l, torch.Generator().manual_seed(0), force_kind=force_kind)
    want = jax.eval_shape(lambda key: jax_init_layer(key, jax_get_config(arch, smoke=True), l, force_kind),
                          jax.random.PRNGKey(0))
    assert _shapes(got) == _shapes(want)
    assert all(t.dtype == torch.float32 for t in tree_leaves(got))


def test_init_layer_keeps_its_old_import():
    from repro_torch.models.transformer import init_layer as from_transformer

    assert from_transformer is init_layer


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_default_stack_mode_matches_the_reference(arch):
    assert default_stack_mode(get_config(arch)) == jax_default_stack_mode(jax_get_config(arch))


# ------------------------------------------------------------- make_client_fns(stack_mode)
def _client_inputs(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params, peft = init_params(cfg, gen), init_peft(cfg, PEFTConfig(), gen)
    rng = np.random.default_rng(seed)
    shape = (2, 2, 8)  # steps, batch, tokens
    batches = {"tokens": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32),
               "targets": rng.integers(0, cfg.vocab_size, shape, dtype=np.int32),
               "mask": np.ones(shape, np.float32)}
    return params, peft, batches


@pytest.mark.parametrize("case", ["scan of a hybrid stack", "group off the period", "an unknown mode"])
def test_make_client_fns_raises_where_the_reference_raises(case):
    """jamba's smoke stack: the reference's round raises ``ValueError``
    while it traces, the port's when it is built (an unknown mode) or at
    its first step."""
    replace, mode = {"scan of a hybrid stack": ({}, "scan"), "group off the period": ({"num_layers": 3}, "group"),
                     "an unknown mode": ({}, "scanned")}[case]
    cfg = get_config("jamba-v0.1-52b", smoke=True).replace(dtype="float32", **replace)
    params, peft, batches = _client_inputs(cfg)
    jcfg = jax_get_config("jamba-v0.1-52b", smoke=True).replace(dtype="float32", **replace)
    jfns = jax_make_client_fns(jcfg, JaxPEFTConfig(), JaxSTLDConfig(), JaxTrainConfig(), stack_mode=mode)
    jpeft = to_jax(peft)
    with pytest.raises(ValueError):
        jfns.local_round(to_jax(params), jpeft, jax_adamw_init(jpeft), tree_map(jnp.asarray, batches), 0.5,
                         jax.random.PRNGKey(0), 0)
    with pytest.raises(ValueError):
        fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig(), stack_mode=mode, device="cpu")
        fns.local_round(params, peft, adamw_init(peft), batches, 0.5, torch.Generator().manual_seed(0), 0)


# ------------------------------------------------------------- layout
def test_maybe_stack_takes_the_reference_layouts():
    """``auto``, ``stacked`` and ``list`` as the reference's, on a
    homogeneous and a heterogeneous list; another layout raises."""
    rng = np.random.default_rng(5)
    same = [{"w": rng.standard_normal((2, 3), dtype=np.float32)} for _ in range(3)]
    mixed = same[:2] + [{"w": np.zeros((4,), np.float32)}]
    for layers in (same, mixed):
        for layout in ("auto", "stacked", "list"):
            port_layers = [tree_map(torch.from_numpy, layer) for layer in layers]
            try:
                want = jax_stacking.maybe_stack([tree_map(jnp.asarray, layer) for layer in layers], layout)
            except ValueError:
                with pytest.raises(ValueError):
                    stacking.maybe_stack(port_layers, layout)
                continue
            got = stacking.maybe_stack(port_layers, layout)
            assert stacking.is_stacked(got) == jax_stacking.is_stacked(want)
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="unknown layer layout"):
        stacking.maybe_stack(same, "rows")
    with pytest.raises(ValueError):
        jax_stacking.maybe_stack(same, "rows")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b", "granite-moe-3b-a800m", "whisper-tiny", "jamba-v0.1-52b"])
def test_init_layouts_hold_the_same_draws(arch):
    """``layout="list"`` of ``init_params`` and ``init_peft`` holds the
    ``auto`` draws, one tree a layer; ``stacked`` raises for a hybrid
    stack, as the reference's; an unknown layout raises."""
    cfg = get_config(arch, smoke=True)
    trees = {}
    for layout in ("auto", "list"):
        gen = torch.Generator().manual_seed(0)
        trees[layout] = (init_params(cfg, gen, layout), init_peft(cfg, PEFTConfig(), gen, layout))
    for auto, listed in zip(trees["auto"], trees["list"]):
        stacks = [(auto[k]["layers"], listed[k]["layers"]) for k in ("encoder", "decoder")] if "encoder" in auto \
            else [(auto["layers"], listed["layers"])] if "layers" in auto else [(auto, listed)]
        for a, b in stacks:
            assert isinstance(b, list) and len(b) == stacking.stack_size(a)
            for l, layer in enumerate(b):
                assert all(torch.equal(x, y) for x, y in zip(tree_leaves(stacking.layer_view(a, l)),
                                                              tree_leaves(layer)))
    if cfg.family == "hybrid":
        with pytest.raises(ValueError, match="heterogeneous"):
            init_params(cfg, torch.Generator().manual_seed(0), "stacked")
    with pytest.raises(ValueError, match="unknown layer layout"):
        init_params(cfg, torch.Generator().manual_seed(0), "rows")


@pytest.fixture(scope="module")
def qwen3_layouts():
    """qwen3's smoke model in float32, stacked and in the list layout, its
    LoRA moved off zero (the same numbers in both)."""
    cfg = get_config("qwen3-1.7b", smoke=True).replace(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params, peft = place_params(init_params(cfg, gen), cfg, "cpu"), init_peft(cfg, PEFTConfig(), gen)
    for leaf in tree_leaves(peft):
        leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
    as_list = lambda tree: stacking.in_layout(tree, "list", cfg.num_layers)
    _, _, batches = _client_inputs(cfg, seed=6)
    return cfg, {"stacked": (params, peft), "list": ({**params, "layers": as_list(params["layers"])}, as_list(peft))}, \
        batches


def _equal_trees(got, want):
    assert len(tree_leaves(got)) == len(tree_leaves(want))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


def test_list_layout_local_round_is_the_stacked_round(qwen3_layouts):
    """Two local steps (gates drawn, the clip active) from the list trees
    give the stacked round's PEFT tree, metrics and importances bit for
    bit, under ``unroll`` and ``scan``; the saved list tree loads back to
    the same numbers."""
    cfg, trees, batches = qwen3_layouts
    runs = {}
    for mode in ("unroll", "scan"):
        fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig(grad_clip=1e-3), stack_mode=mode,
                              device="cpu")
        for layout, (params, peft) in trees.items():
            runs[mode, layout] = fns.local_round(params, peft, adamw_init(peft), batches, 0.5,
                                                 torch.Generator().manual_seed(7), 0)
    want = runs["unroll", "stacked"]
    assert float(want[2]["active_layers"]) < cfg.num_layers  # a gate dropped a layer
    for key, got in runs.items():
        _equal_trees(stacking.in_layout(got[0], "list", cfg.num_layers),
                     stacking.in_layout(want[0], "list", cfg.num_layers))
        assert all(torch.equal(got[2][k], want[2][k]) for k in want[2]) and torch.equal(got[3], want[3]), key


def test_list_layout_cohort_and_checkpoint_are_the_stacked_ones(qwen3_layouts, tmp_path):
    """A cohort round of 2 devices from the list trees gives the stacked
    cohort's outputs bit for bit; a list tree saved and loaded holds its
    numbers."""
    cfg, trees, batches = qwen3_layouts
    fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig(), stack_mode="scan", device="cpu")
    batch_stack = {k: np.stack([v, v[:, ::-1]]) for k, v in batches.items()}
    outs = {}
    for layout, (params, peft) in trees.items():
        outs[layout] = fns.cohort_round(params, stack_trees([peft, peft]), batch_stack, [0.5, 0.0],
                                        [torch.Generator().manual_seed(s) for s in (1, 2)], [0, 3])
    (got, got_m, got_i), (want, want_m, want_i) = outs["list"], outs["stacked"]
    for g, w in zip(unstack_tree(got, 2), unstack_tree(want, 2)):
        _equal_trees(g, stacking.in_layout(w, "list", cfg.num_layers))
    assert all(torch.equal(got_m[k], want_m[k]) for k in want_m) and torch.equal(got_i, want_i)
    peft = trees["list"][1]
    path = save_pytree(peft, str(tmp_path), 1)
    _equal_trees(load_pytree(tree_map(torch.zeros_like, peft), path), peft)


# ------------------------------------------------------------- the z-loss
def test_softmax_xent_z_loss_matches_the_reference():
    rng = np.random.default_rng(8)
    logits = 3.0 * rng.standard_normal((2, 2, 5, 11), dtype=np.float32)
    labels = rng.integers(0, 11, (2, 2, 5)).astype(np.int32)
    mask = (rng.random((2, 2, 5)) < 0.8).astype(np.float32)
    for i in range(2):
        loss, metrics = softmax_xent(torch.from_numpy(logits[i]), torch.from_numpy(labels[i]),
                                     torch.from_numpy(mask[i]), z_loss_coef=0.1)
        jloss, jmetrics = jax_softmax_xent(jnp.asarray(logits[i]), jnp.asarray(labels[i]), jnp.asarray(mask[i]),
                                           z_loss_coef=0.1)
        _close(loss, jloss)
        _close(metrics["accuracy"], jmetrics["accuracy"])
        plain, _ = softmax_xent(torch.from_numpy(logits[i]), torch.from_numpy(labels[i]), torch.from_numpy(mask[i]))
        assert float(loss) > float(plain)
    cohort, _ = cohort_softmax_xent(*map(torch.from_numpy, (logits, labels, mask)), z_loss_coef=0.1)
    for i in range(2):
        _close(cohort[i], jax_softmax_xent(jnp.asarray(logits[i]), jnp.asarray(labels[i]), jnp.asarray(mask[i]),
                                           z_loss_coef=0.1)[0])


# ------------------------------------------------------------- encode(drops, peft)
@pytest.fixture(scope="module")
def whisper():
    cfg = get_config("whisper-tiny", smoke=True).replace(dtype="float32")
    jcfg = jax_get_config("whisper-tiny", smoke=True).replace(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen)
    rng = np.random.default_rng(9)
    L, d, r, width = cfg.num_encoder_layers, cfg.d_model, 4, cfg.num_heads * cfg.resolved_head_dim
    peft = {"attn": {t: {"a": torch.from_numpy(0.1 * rng.standard_normal((L, d, r), dtype=np.float32)),
                         "b": torch.from_numpy(0.1 * rng.standard_normal((L, r, width), dtype=np.float32))}
                     for t in ("q", "v")}}
    frames = rng.standard_normal((2, cfg.frontend_seq, d), dtype=np.float32)
    probe = rng.standard_normal((2, cfg.frontend_seq, d), dtype=np.float32)
    jencode = jax.jit(lambda p, f, drops, pf: jax_encdec.encode(p, jcfg, f, drops=drops, peft=pf, lora_scale=2.0))
    return cfg, params, peft, frames, probe, jencode


@pytest.mark.parametrize("drops", [(False, False), (False, True), (True, False)])
def test_encode_with_gates_and_lora_matches_the_reference(whisper, drops):
    """whisper's encoder with STLD gates and a LoRA on ``q``/``v`` against
    the reference's ``encode`` on the same weights: the states at 1e-4 and
    the LoRA's gradients at 2e-5 + 1e-3 rel; a dropped layer's adapter
    takes an exact zero gradient."""
    cfg, params, peft, frames, probe, jencode = whisper
    jparams, jpeft, jdrops = to_jax(params), to_jax(peft), jnp.asarray(drops)
    tpeft = tree_map(lambda t: t.clone().requires_grad_(), peft)
    out = encdec.encode(params, cfg, torch.from_numpy(frames), drops=torch.tensor(drops), peft=tpeft, lora_scale=2.0)
    _close(out, jencode(jparams, jnp.asarray(frames), jdrops, jpeft), ENC_ATOL)
    torch.sum(out * torch.from_numpy(probe)).backward()
    jgrads = jax.grad(lambda pf: jnp.sum(jencode(jparams, jnp.asarray(frames), jdrops, pf) * probe))(jpeft)
    for got, want in zip(tree_leaves(tree_map(lambda t: t.grad, tpeft)), jax.tree.leaves(jgrads)):
        _close(got, want, GRAD_ATOL, GRAD_RTOL)
        for l, dropped in enumerate(drops):
            assert bool(torch.any(got[l] != 0)) != dropped


def test_encode_without_gates_or_peft_is_the_registry_encoder(whisper):
    cfg, params, _, frames, _, _ = whisper
    x = torch.from_numpy(frames)
    with torch.no_grad():
        base = encdec.encode(params, cfg, x)
        assert torch.equal(encdec.encode(params, cfg, x, drops=torch.tensor([False, False]), stack_mode="scan"), base)


# ------------------------------------------------------------- api.serve(model_overrides, stack_mode)
def test_serve_takes_model_overrides_and_stack_mode():
    """``serve(model_overrides=..., stack_mode=...)`` serves the config
    ``serve(cfg=cfg.replace(...))`` serves, token for token (a window of 8
    that the prompts and their tokens outgrow); an unknown mode raises."""
    overrides = {"sliding_window": 8, "dtype": "float32"}
    cfg = get_config("qwen3-1.7b", smoke=True).replace(**overrides)
    gen = torch.Generator().manual_seed(1)
    adapters = {}
    for name in ("t0", "t1"):
        tree = init_peft(cfg, PEFTConfig(), gen)
        adapters[name] = tree_map(lambda t: t + 0.05 * torch.randn(t.shape, generator=gen), tree)
    kw = dict(adapters=adapters, batch=2, max_len=32, cache_dtype="float32", device="cpu")
    served = {}
    for name, batcher in (("overrides", api.serve("qwen3-1.7b", model_overrides=overrides, stack_mode="unroll", **kw)),
                          ("cfg", api.serve(cfg=cfg, **kw))):
        assert batcher.cfg.sliding_window == 8
        for uid, prompt in enumerate(([5, 7, 11, 13, 17, 19, 23, 29, 31, 37], [3, 1, 4, 1, 5, 9])):
            batcher.submit(Request(prompt=prompt, adapter=f"t{uid}", max_new_tokens=8, uid=uid))
        served[name] = {c.uid: c.tokens for c in batcher.run()}
    assert served["overrides"] == served["cfg"] and all(len(t) == 8 for t in served["cfg"].values())
    with pytest.raises(ValueError, match="unknown stack_mode"):
        api.serve("qwen3-1.7b", stack_mode="scanned", **kw)


# ------------------------------------------------------------- the oracle names
def test_kernel_oracles_match_the_reference():
    rng = np.random.default_rng(10)
    f32 = lambda *shape: rng.standard_normal(shape, dtype=np.float32)
    both = lambda *xs: (tuple(map(torch.from_numpy, xs)), tuple(map(jnp.asarray, xs)))
    t, j = both(f32(2, 3, 9, 16), f32(2, 3, 9, 16), f32(2, 3, 9, 16))
    for causal, window in ((True, None), (True, 4), (False, None)):
        _close(ref.attention_ref(*t, causal=causal, window=window), jax_ref.attention_ref(*j, causal=causal,
                                                                                         window=window))
    r, k, v, u = f32(2, 6, 2, 8), f32(2, 6, 2, 8), f32(2, 6, 2, 8), f32(2, 8)
    logw = -np.exp(f32(2, 6, 2, 8))
    t, j = both(r, k, v, logw, u)
    got = ref.wkv6_ref(*t)
    assert got.dtype == torch.float32 and ref.wkv6_ref(*(x.to(torch.bfloat16) for x in t)).dtype == torch.bfloat16
    _close(got, jax_ref.wkv6_ref(*j))
    dt, x, bm, cm = np.abs(f32(2, 5, 6)) * 0.1, f32(2, 5, 6), f32(2, 5, 4), f32(2, 5, 4)
    t, j = both(dt, x, bm, cm, -np.exp(f32(6, 4)), f32(6))
    _close(ref.mamba_scan_ref(*t), jax_ref.mamba_scan_ref(*j))
    t, j = both(f32(5, 12), f32(12, 7), f32(12, 3), f32(3, 7))
    _close(ref.lora_matmul_ref(*t, alpha=2.0), jax_ref.lora_matmul_ref(*j, alpha=2.0))
    assert ref.lora_matmul_ref(*(x.to(torch.bfloat16) for x in t)).dtype == torch.bfloat16
    idx, ranks = np.array([1, 0, 1, 1, 0], np.int32), np.array([2, 4], np.int32)
    t, j = both(f32(5, 12), f32(12, 7), f32(2, 12, 4), f32(2, 4, 7), idx, ranks)
    _close(ref.segmented_lora_ref(*t), jax_ref.segmented_lora_ref(*j))
