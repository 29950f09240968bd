"""The port's jamba-v0.1-52b local-training slice against the JAX package,
on the CPU (the kernels' plain twins), at the smoke size (2 layers: layer 0
Mamba + MLP, layer 1 attention + MoE; d_model 128, d_in 256, N 8) in
float32.

Inputs are made with numpy and handed to both frameworks.  The JAX params
(a per-layer list, as the JAX package keeps a heterogeneous stack) go
through ``repro_torch.convert`` with the LoRA ``b`` moved off zero, so that
every path carries a signal and dA is not zero.  JAX's STLD gates are
handed to the port (its sampler is patched), as in
``tests/test_torch_training.py``.

Tolerances, each with its reason:
* scan outputs 2e-5 abs + 1e-2 rel in float32 against ``mamba_scan_ref``
  and the Pallas kernel (``tests/test_kernels.py``'s sweep), 3e-2 in
  bfloat16 (one bf16 rounding of an O(1) output);
* scan gradients and PEFT gradients 2e-5 abs + 1e-3 rel: float32 sums in
  another order (``tests/test_torch_training.py``'s GRAD_ATOL/GRAD_RTOL),
  dA 1e-4 abs, a sum of S * B terms of up to ~600;
* the Mamba block against JAX's associative scan, the MoE block and the
  logits 1e-4 abs (the associative scan multiplies the decays in another
  order); the aux loss and losses and metrics 1e-5 rel;
* the PEFT tree after AdamW steps: every element within 2 * (sum of the
  step sizes) + 1e-6, 99% within 1e-6 (AdamW's first steps move an element
  by about lr * sign(g), which may flip for a gradient near 0);
* gates, routing, twin call counts, active-layer counts and accuracies
  exactly.
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
from repro.core.schedules import unit_shape as jax_unit_shape
from repro.federated.client import make_client_fns as jax_make_client_fns
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import init_params as jax_init_params
from repro.models.registry import model_apply as jax_model_apply
from repro.nn import mamba as jax_mamba
from repro.nn import moe as jax_moe
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import clip_by_global_norm as jax_clip_by_global_norm
from repro_torch import convert
from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import ptls, stld
from repro_torch.core.peft import init_peft
from repro_torch.data.synthetic import make_task
from repro_torch.federated.client import make_client_fns
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import stacking
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import init_params, model_apply, place_params
from repro_torch.models.transformer import lm_apply
from repro_torch.nn import mamba, moe
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, make_lr_schedule

BLOCK_ATOL = LOGIT_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
SEQ = 20
ARCH = "jamba-v0.1-52b"


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _flat(tree, prefix=()):
    """{key path: float32 numpy leaf} of a tree of dicts and lists (torch or JAX)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], prefix + (key,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, node in enumerate(tree):
            out.update(_flat(node, prefix + (i,)))
        return out
    return {prefix: _np(tree)}


def _close_trees(got, want, atol, rtol=0.0):
    got, want = _flat(got), _flat(want)
    assert sorted(got, key=str) == sorted(want, key=str)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol, rtol=rtol, err_msg=str(path))


def _close_after_adamw(got, want, lr_sum):
    got, want = _flat(got), _flat(want)
    diffs = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    assert diffs.max() <= 2 * lr_sum + 1e-6, diffs.max()
    assert np.mean(diffs <= 1e-6) >= 0.99, np.mean(diffs <= 1e-6)


def _scan_inputs(rng, b, s, d, n):
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d), dtype=np.float32)))  # softplus: dt > 0
    x, bm, cm = (rng.standard_normal(shape, dtype=np.float32) for shape in ((b, s, d), (b, s, n), (b, s, n)))
    a = -np.exp(rng.standard_normal((d, n), dtype=np.float32))
    dv = rng.standard_normal((d,), dtype=np.float32)
    return dt, x, bm, cm, a, dv


# --------------------------------------------------------------- the scan
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,n,chunk,dblk", [(2, 70, 32, 8, 16, 16), (1, 64, 64, 16, 64, 32)])
def test_mamba_scan_plain_matches_jax_ref_and_pallas(dtype, b, s, d, n, chunk, dblk):
    """``mamba_scan_plain`` and ``ops.mamba_scan`` (its CPU path) against
    JAX's ``mamba_scan_ref`` and the Pallas kernel in interpret mode, at
    ``tests/test_kernels.py``'s shapes (S 70 is off every chunk).  In
    bfloat16 both sides get the same bf16 dt, x, B and C; the port holds B
    and C in float32, as the model path gives them."""
    dt, x, bm, cm, a, dv = _scan_inputs(np.random.default_rng(50 + s), b, s, d, n)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jin = [jnp.asarray(v, jdt) for v in (dt, x, bm, cm)] + [jnp.asarray(a), jnp.asarray(dv)]
    want_ref = np.asarray(jax_ref.mamba_scan_ref(*jin), np.float32)
    want_pallas = np.asarray(jax_ops.mamba_scan(*jin, chunk=chunk, d_block=dblk), np.float32)
    tin = [torch.from_numpy(np.array(v.astype(jnp.float32))) for v in jin]
    tin = [t.to(getattr(torch, dtype)) for t in tin[:2]] + tin[2:]
    got, state = ref.mamba_scan_plain(*tin)
    got_ops, state_ops = ops.mamba_scan(*tin)
    assert got.dtype == getattr(torch, dtype) and state.dtype == torch.float32 and tuple(state.shape) == (b, d, n)
    assert torch.equal(got, got_ops) and torch.equal(state, state_ops)
    atol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), want_ref, atol=atol, rtol=1e-2)
    np.testing.assert_allclose(_np(got), want_pallas, atol=atol, rtol=1e-2)


@pytest.mark.parametrize("b,s,d,n", [(2, 70, 32, 8), (1, 37, 24, 16)])
def test_mamba_scan_backward_matches_jax_vjp(b, s, d, n):
    """``ops.mamba_scan``'s CPU backward (``mamba_scan_bwd_plain``) against
    ``jax.vjp`` of ``mamba_scan_ref``: d_dt, dx, dB, dC, dA, dD."""
    rng = np.random.default_rng(51)
    arrays = _scan_inputs(rng, b, s, d, n)
    dy = rng.standard_normal((b, s, d), dtype=np.float32)
    _, vjp = jax.vjp(jax_ref.mamba_scan_ref, *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dy))
    leaves = [torch.from_numpy(v).requires_grad_(True) for v in arrays]
    y, state = ops.mamba_scan(*leaves)
    assert not state.requires_grad
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves)
    for name, g, w in zip(("d_dt", "dx", "dB", "dC", "dA", "dD"), got, want):
        atol = 1e-4 if name == "dA" else GRAD_ATOL
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=atol, rtol=GRAD_RTOL, err_msg=name)


def test_mamba_scan_backward_twin_matches_autograd_in_float64():
    """The backward twin's formulas against autograd through the forward
    recurrence written in float64; the final state is the forward's."""
    rng = np.random.default_rng(52)
    arrays = _scan_inputs(rng, 2, 23, 16, 8)
    dy = rng.standard_normal((2, 23, 16), dtype=np.float32)
    dt, x, bm, cm, a, dv = leaves = [torch.from_numpy(v).double().requires_grad_(True) for v in arrays]
    h, ys = torch.zeros(2, 16, 8, dtype=torch.float64), []
    for t in range(23):
        h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None, :]
        ys.append((h * cm[:, t, None, :]).sum(-1) + dv * x[:, t])
    want = torch.autograd.grad((torch.stack(ys, 1) * torch.from_numpy(dy).double()).sum(), leaves)
    tin = [torch.from_numpy(v) for v in arrays]
    got = ref.mamba_scan_bwd_plain(*tin, torch.from_numpy(dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w.numpy(), atol=1e-4, rtol=GRAD_RTOL)
    np.testing.assert_allclose(_np(ref.mamba_scan_plain(*tin)[1]), h.detach().numpy(), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    jparams = jax.jit(jax_init_params, static_argnums=1)(key, jcfg)
    jpeft = jax.jit(jax_peft.init_peft, static_argnums=(1, 2))(jax.random.fold_in(key, 1), jcfg, JaxPEFTConfig())
    jpeft = jax.tree.map(lambda x: x + 0.02 * jax.random.normal(jax.random.fold_in(key, 2), x.shape), jpeft)
    cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    peft = convert.peft_from_jax(jax.tree.map(np.asarray, jpeft), "cpu")
    task = make_task(vocab_size=cfg.vocab_size, seq_len=SEQ, num_examples=64, seed=3)
    return jcfg, jparams, jpeft, cfg, params, peft, task


def test_config_matches_the_jax_package():
    for smoke in (False, True):
        ours, theirs = get_config(ARCH, smoke=smoke), jax_get_config(ARCH, smoke=smoke)
        for field in ours.__dataclass_fields__:
            if field != "mamba":
                assert getattr(ours, field) == getattr(theirs, field), field
        for field in ours.mamba.__dataclass_fields__:
            assert getattr(ours.mamba, field) == getattr(theirs.mamba, field), field
        assert ours.mamba.resolved_dt_rank(ours.d_model) == theirs.mamba.resolved_dt_rank(theirs.d_model)
        assert ours.layer_period == theirs.layer_period
        for l in range(ours.num_layers):
            assert ours.is_attention_layer(l) == theirs.is_attention_layer(l)
            assert ours.is_moe_layer(l) == theirs.is_moe_layer(l)
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.num_heads, full.num_kv_heads) == ("hybrid", 32, 4096, 32, 8)
    assert (full.d_ff, full.vocab_size, full.num_experts, full.top_k, full.rope_theta) == (14336, 65536, 16, 2, 0.0)
    assert (full.mamba.d_state, full.mamba.expand, full.mamba.resolved_dt_rank(4096), full.layer_period) == (16, 2, 256, 8)


def test_init_params_and_peft_have_jax_layout_and_convert(setup):
    """``init_params`` / ``init_peft`` give JAX's per-layer lists, shapes and
    dtypes; a JAX jamba tree survives ``params_from_jax`` leaf by leaf;
    ``place_params`` casts the projections, router and experts alone; and
    ``init_params(..., place=True)`` draws the same placed tree."""
    jcfg, jparams, jpeft, cfg, params, peft, _ = setup
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    assert isinstance(ours["layers"], list) and isinstance(params["layers"], list)
    ours, theirs, converted = _flat(ours), _flat(jparams), _flat(params)
    assert sorted(ours, key=str) == sorted(theirs, key=str) == sorted(converted, key=str)
    for path, leaf in theirs.items():
        assert ours[path].shape == leaf.shape, path
        np.testing.assert_array_equal(converted[path], leaf)
    tree = init_peft(cfg, PEFTConfig(), torch.Generator().manual_seed(0))
    assert isinstance(tree, list) and sorted(tree[0]) == ["mamba"] and sorted(tree[1]) == ["attn"]
    want = _flat(jax_peft.init_peft(jax.random.PRNGKey(0), jcfg, JaxPEFTConfig()))
    assert {p: a.shape for p, a in _flat(tree).items()} == {p: a.shape for p, a in want.items()}
    assert not tree[0]["mamba"]["in"]["b"].any() and tree[0]["mamba"]["in"]["a"].std() > 0
    bf16 = cfg.replace(dtype="bfloat16")
    placed = place_params(params, bf16, "cpu")
    m, att = placed["layers"][0]["mamba"], placed["layers"][1]
    for node in (m["in_proj"]["w"], m["x_proj"]["w"], m["dt_proj"]["w"], m["dt_proj"]["b"], m["out_proj"]["w"],
                 att["attn"]["wq"]["w"], att["moe"]["router"]["w"], att["moe"]["experts"]["down"]["w"]):
        assert node.dtype == torch.bfloat16
    for node in (m["A_log"], m["D"], m["conv_w"], m["conv_b"], att["norm1"]["scale"]):
        assert node.dtype == torch.float32
    drawn = place_params(init_params(bf16, torch.Generator().manual_seed(5)), bf16, "cpu")
    at_once = init_params(bf16, torch.Generator().manual_seed(5), place=True)
    for path, leaf in _flat(drawn).items():
        np.testing.assert_array_equal(_flat(at_once)[path], leaf, err_msg=str(path))


def test_maybe_stack_keeps_a_heterogeneous_list():
    same = [{"a": torch.zeros(2, 3)}, {"a": torch.ones(2, 3)}]
    stacked = stacking.maybe_stack(same)
    assert stacking.is_stacked(stacked) and tuple(stacked["a"].shape) == (2, 2, 3)
    mixed = [{"a": torch.zeros(2, 3)}, {"b": torch.zeros(2, 3)}]
    assert stacking.maybe_stack(mixed) == mixed and not stacking.is_stackable(mixed)
    assert stacking.stack_size(mixed) == 2 and stacking.layer_view(mixed, 1) is mixed[1]


def test_mamba_apply_matches_jax_associative_scan(setup):
    """One Mamba block with its LoRA on ``in`` and ``out``: output, final
    conv history and SSM state against ``repro.nn.mamba.mamba_apply``,
    whose scan is ``jax.lax.associative_scan``."""
    jcfg, jparams, jpeft, cfg, params, peft, _ = setup
    x = np.random.default_rng(53).standard_normal((2, SEQ, cfg.d_model), dtype=np.float32)
    want, want_state = jax_mamba.mamba_apply(jparams["layers"][0]["mamba"], jcfg, jnp.asarray(x),
                                             peft=jpeft[0]["mamba"], lora_scale=2.0)
    got, got_state = mamba.mamba_apply(params["layers"][0]["mamba"], cfg, torch.from_numpy(x),
                                       peft=peft[0]["mamba"], lora_scale=2.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=BLOCK_ATOL, rtol=0)
    np.testing.assert_allclose(_np(got_state["conv"]), np.asarray(want_state["conv"]), atol=BLOCK_ATOL, rtol=0)
    np.testing.assert_allclose(_np(got_state["ssm"]), np.asarray(want_state["ssm"]), atol=BLOCK_ATOL, rtol=1e-4)


@pytest.mark.parametrize("group_size,router_scale", [(None, 1.0), (16, 8.0)])
def test_moe_apply_matches_jax(setup, group_size, router_scale):
    """The MoE block (einsum dispatch) and its aux loss against
    ``repro.nn.moe.moe_apply``; with groups of 16 tokens (a capacity of 10)
    and a sharpened router, some tokens overflow their expert's capacity
    and are dropped."""
    jcfg, jparams, _, cfg, params, _, _ = setup
    x = np.random.default_rng(54).standard_normal((4, SEQ, cfg.d_model), dtype=np.float32)
    jmoe = dict(jparams["layers"][1]["moe"], router={"w": jparams["layers"][1]["moe"]["router"]["w"] * router_scale})
    tmoe = dict(params["layers"][1]["moe"], router={"w": params["layers"][1]["moe"]["router"]["w"] * router_scale})
    want, want_aux = jax_moe.moe_apply(jmoe, jcfg, jnp.asarray(x), group_size=group_size)
    got, got_aux = moe.moe_apply(tmoe, cfg, torch.from_numpy(x), group_size=group_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=BLOCK_ATOL, rtol=0)
    np.testing.assert_allclose(_np(got_aux), np.asarray(want_aux), rtol=1e-5)
    roomy, _ = moe.moe_apply(tmoe, cfg.replace(capacity_factor=100.0), torch.from_numpy(x), group_size=group_size)
    assert torch.equal(roomy, got) != bool(group_size)  # with groups of 16, some tokens overflowed


def test_moe_unported_dispatches_raise(setup):
    """Every dispatch of the reference is ported (``gather`` and the shared
    expert are held in ``tests/test_torch_moe.py``); a dispatch the
    reference does not know raises ``ValueError``, as its ``moe_apply``
    does."""
    _, _, _, cfg, params, _, _ = setup
    p = params["layers"][1]["moe"]
    with pytest.raises(ValueError, match="sparse"):
        moe.moe_apply(p, cfg, torch.zeros(2, 16, cfg.d_model), dispatch_mode="sparse")
    assert moe.DISPATCH_MODES == ("einsum", "einsum_forced", "gather")


@pytest.mark.parametrize("stack_mode", ["unroll", "group"])
@pytest.mark.parametrize("drops", [None, [False, True], [True, False]])
def test_lm_apply_matches_jax(setup, stack_mode, drops):
    """Logits and the summed aux loss of the whole model against JAX's
    ``unroll`` and ``group`` (a scan over periods of the layer pattern)
    stack modes, with and without dropped layers (a dropped MoE layer
    adds no aux)."""
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    tokens = task.tokens[:3]
    jd = None if drops is None else jnp.asarray(drops)
    want, want_aux, _ = jax.jit(
        lambda p, pf, t, d: jax_model_apply(p, jcfg, {"tokens": t}, drops=d, peft=pf, lora_scale=2.0,
                                            stack_mode=stack_mode)
    )(jparams, jpeft, jnp.asarray(tokens), jd)
    got, aux, caches = lm_apply(params, cfg, torch.from_numpy(tokens), drops=drops, peft=peft, lora_scale=2.0)
    assert caches is None
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(_np(aux), np.asarray(want_aux), rtol=1e-5)
    assert (float(aux) == 0.0) == bool(drops and drops[1])


def _jloss(jcfg, jparams, batch, drops):
    def loss(pf):
        logits, aux, _ = jax_model_apply(jparams, jcfg, {"tokens": jnp.asarray(batch["tokens"])},
                                         drops=jnp.asarray(drops), peft=pf, lora_scale=2.0, stack_mode="unroll")
        ce, metrics = jax_softmax_xent(logits, jnp.asarray(batch["targets"]), jnp.asarray(batch["mask"]))
        return ce + jcfg.router_aux_coef * aux, metrics

    return loss


@pytest.mark.parametrize("drops", [[False, False], [True, False], [False, True]])
def test_peft_grads_match_jax_value_and_grad(setup, drops):
    """The loss (with the router's aux term) and every PEFT gradient; the
    gradient of layer 0's LoRA flows back through layer 1's attention and
    MoE, its router's aux loss included, and through layer 0's own scan."""
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    batch = task.lm_batch(np.arange(4))
    (jl, _), jgrads = jax.jit(jax.value_and_grad(_jloss(jcfg, jparams, batch, drops), has_aux=True))(jpeft)

    def tloss(pf):
        logits, aux, _ = model_apply(params, cfg, {"tokens": torch.from_numpy(batch["tokens"])}, drops=drops,
                                     peft=pf, lora_scale=2.0)
        ce, metrics = softmax_xent(logits, torch.from_numpy(batch["targets"]), torch.from_numpy(batch["mask"]))
        return ce + cfg.router_aux_coef * aux, metrics

    (tl, _), tgrads = value_and_grad(tloss)(peft)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    _close_trees(tgrads, jgrads, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    for l, dropped in enumerate(drops):  # a dropped layer's leaves get exactly zero, an active one's do not
        assert all(bool(g.any()) != dropped for g in stacking.tree_leaves(tgrads[l]))


def test_list_tree_norms_clip_and_adamw_match_jax(setup):
    """PTLS layer norms and the global-norm clip take the reference's list
    branches (per-leaf sums); AdamW walks the per-layer list."""
    _, _, jpeft, _, _, peft, _ = setup
    norms = ptls.layer_grad_norms(peft)
    np.testing.assert_allclose(_np(norms), np.asarray(jax_ptls.layer_grad_norms(jpeft)), rtol=1e-6)
    clipped, gnorm = clip_by_global_norm(peft, 0.5)
    jclipped, jgnorm = jax_clip_by_global_norm(jpeft, 0.5)
    np.testing.assert_allclose(_np(gnorm), np.asarray(jgnorm), rtol=1e-6)
    _close_trees(clipped, jclipped, atol=1e-7, rtol=1e-6)
    grads = stacking.tree_map(lambda t: 0.1 * torch.sin(7.0 * t), peft)
    jgrads = jax.tree.map(lambda t: 0.1 * jnp.sin(7.0 * t), jpeft)
    new, state = adamw_update(grads, adamw_init(peft), peft, lr=1e-3)
    jnew, _ = jax_adamw_update(jgrads, jax_adamw_init(jpeft), jpeft, lr=1e-3)
    assert isinstance(new, list) and isinstance(state["m"], list) and state["count"] == 1
    _close_trees(new, jnew, atol=1e-7, rtol=1e-6)


def _jax_gates(seed, rates, steps, min_active=1):
    """The gates ``local_round`` draws: one key split per step."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, kd = jax.random.split(rng)
        out.append(np.asarray(jax_stld.sample_drops(kd, rates, min_active)))
    return out


def test_train_step_off_matches_jax(setup):
    """``make_train_step`` adds the router's aux term to its loss, as the
    reference's step does; its metrics' loss stays the cross-entropy."""
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


class _Counting:
    """Wraps a twin and counts its calls (the CPU runs no kernel, so
    ``ops.launch_counts`` stays 0 here)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def test_local_round_with_jax_gates_matches_jax(setup, monkeypatch):
    """Two local steps (step 0 runs both layers, step 1 drops layer 1, the
    attention + MoE layer): PEFT tree, metrics and Eq.-6 importances
    against JAX's, then ``evaluate``.  The scan twins run once forward and
    once backward per active Mamba layer (the LoRA on ``in`` sits before
    the scan, so even a step's first active layer needs the backward), the
    attention twin once per active attention layer, and the LoRA twin
    twice per active layer: the kernels' launch counts on the card."""
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
    it = iter(gates)
    monkeypatch.setattr(stld, "sample_drops", lambda generator, rates, min_active=1: torch.from_numpy(next(it).copy()))
    counts = {name: _Counting(getattr(ref, name)) for name in
              ("mamba_scan_plain", "mamba_scan_bwd_plain", "attention_plain", "lora_matmul_plain")}
    for name, counter in counts.items():
        monkeypatch.setattr(ref, name, counter)
    fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig(), device="cpu")
    tp, tstate, tm, timp = fns.local_round(
        params, peft, adamw_init(peft), batches, mean_rate, torch.Generator().manual_seed(seed), 3
    )
    calls = lambda: tuple(c.calls for c in counts.values())  # noqa: E731
    assert calls() == (2, 2, 1, 2 * 3)
    assert float(tm["active_layers"]) == float(jm["active_layers"]) == 1.5
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(timp), np.asarray(jimp), rtol=1e-4)
    sched = make_lr_schedule("cosine", 2e-4, 20, 1000)
    _close_after_adamw(tp, jp, sched(3) + sched(4))
    assert tstate["count"] == steps and isinstance(tp, list)

    labels, toks = task.labels[8:16], task.tokens[8:16]
    want = jfns.evaluate(jparams, jp, jnp.asarray(toks), jnp.asarray(labels), jnp.arange(task.num_classes))
    got = fns.evaluate(params, tp, toks, labels, np.arange(task.num_classes))
    assert float(got) == float(want)
    assert calls() == (2 + 1, 2, 1 + 1, 2 * 3 + 2 * 2)
