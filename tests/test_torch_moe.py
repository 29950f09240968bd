"""The port's ``moe`` family (granite-moe-3b-a800m: 40 experts top-8;
llama4-scout-17b-a16e: 16 experts top-1 and a shared expert) against the
JAX package, on the CPU (the kernels' plain twins), at the smoke size (2
layers, attention and MoE in each; granite 4 experts top-2, llama4 4
experts top-1) in float32.

Inputs are made from seeds and handed to both frameworks: the port's
parameters and LoRA (``b`` moved off zero, so that every path carries a
signal), stacked ``(L, ...)`` as the reference stacks a homogeneous stack,
go to JAX as the same numbers.  JAX's STLD gates are handed to the port (its
sampler is patched), as in ``tests/test_torch_jamba.py``.

Tolerances, each with its reason:
* MoE outputs 1e-5 abs: float32 sums in another order (the combine's k
  terms, the experts' products); the aux loss 1e-6;
* logits 1e-4 abs (2 layers of float32 attention and MoE, a 512-way head);
* gradients 2e-5 abs + 1e-3 rel: float32 sums in another order
  (``tests/test_torch_training.py``'s GRAD_ATOL/GRAD_RTOL);
* the PEFT tree after AdamW steps: every element within 2 * (sum of the
  step sizes) + 1e-6, 99% within 1e-6 (AdamW's first steps move an element
  by about lr * sign(g), which may flip for a gradient near 0);
* routing, drops, gates, twin call counts, tokens and accuracies exactly.
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
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import transformer as jax_transformer
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import init_params as jax_init_params
from repro.nn import moe as jax_moe
from repro.optim import adamw_init as jax_adamw_init
from repro.serving.adapters import AdapterPoolCache as JaxAdapterPoolCache
from repro.serving.adapters import AdapterRegistry as JaxAdapterRegistry
from repro.serving.batcher import ContinuousBatcher as JaxContinuousBatcher
from repro.serving.batcher import Request as JaxRequest
from repro_torch import api, convert
from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import stld
from repro_torch.core.peft import init_peft
from repro_torch.data.synthetic import make_task
from repro_torch.federated.client import make_client_fns
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.models import stacking, transformer
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import init_params, place_params
from repro_torch.nn import moe
from repro_torch.nn.norms import apply_norm
from repro_torch.optim import adamw_init, make_lr_schedule
from repro_torch.serving.batcher import Request

MOE_ATOL, AUX_ATOL, LOGIT_ATOL = 1e-5, 1e-6, 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
SEQ = 16
ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")
_MODELS = {}
# the reference's functions, jitted with the config (and the dispatch's
# static arguments) static: one XLA program a shape compiles faster than
# the eager ops one by one
_jax_moe_apply = jax.jit(jax_moe.moe_apply, static_argnums=(1, 3, 4))
_jax_lm_apply = jax.jit(jax_transformer.lm_apply, static_argnums=1)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _flat(tree, prefix=()):
    """{key path: leaf} of a tree of dicts and lists (torch or JAX)."""
    if isinstance(tree, dict):
        return {p: v for key in sorted(tree) for p, v in _flat(tree[key], prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, node in enumerate(tree) for p, v in _flat(node, prefix + (i,)).items()}
    return {prefix: tree}


def _close_trees(got, want, atol, rtol=0.0):
    got, want = _flat(got), _flat(want)
    assert sorted(got, key=str) == sorted(want, key=str)
    for path in want:
        np.testing.assert_allclose(_np(got[path]), _np(want[path]), atol=atol, rtol=rtol, err_msg=str(path))


def _to_jax(tree):
    """A torch tree (stacked leaves, the reference's layout) as JAX arrays."""
    return stacking.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _model(arch):
    """(jcfg, jparams, jpeft, cfg, params, peft) at the smoke size, float32:
    the port's draws from seeded generators (their layout is the
    reference's: ``test_init_params_and_peft_have_the_jax_layout``), handed
    to JAX as the same numbers; the LoRA (q, v) with ``b`` off zero."""
    if arch not in _MODELS:
        jcfg = jax_get_config(arch, smoke=True).replace(dtype="float32")
        cfg = get_config(arch, smoke=True).replace(dtype="float32")
        gen = torch.Generator().manual_seed(0)
        params = init_params(cfg, gen)
        peft = init_peft(cfg, PEFTConfig(), gen)
        for leaf in stacking.tree_leaves(peft):
            leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
        _MODELS[arch] = (jcfg, _to_jax(params), _to_jax(peft), cfg, params, peft)
    return _MODELS[arch]


def _layer_moe(arch, l=0):
    jcfg, jparams, _, cfg, params, _ = _model(arch)
    return jcfg, jax.tree.map(lambda x: x[l], jparams["layers"]["moe"]), cfg, stacking.layer_view(params["layers"], l)["moe"]


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_jax_package(arch):
    for smoke in (False, True):
        ours, theirs = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
        for field in ours.__dataclass_fields__:
            assert getattr(ours, field) == getattr(theirs, field), field
        assert ours.param_counts() == theirs.param_counts()
        assert all(ours.is_moe_layer(l) and ours.is_attention_layer(l) for l in range(ours.num_layers))
    full = get_config(arch)
    want = {"granite-moe-3b-a800m": (32, 1536, 24, 8, 64, 512, 49_155, 40, 8, False),
            "llama4-scout-17b-a16e": (48, 5120, 40, 8, 128, 8192, 202_048, 16, 1, True)}[arch]
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.resolved_head_dim, full.d_ff,
            full.vocab_size, full.num_experts, full.top_k, full.shared_expert) == want


# ------------------------------------------------------------- the MoE
# (mode, case): the weight gather (at most 8 tokens a device) takes no
# capacity, so it has no overflow case
MOE_CASES = [(mode, case) for mode in ("einsum", "einsum_forced", "gather") for case in ("default", "overflow", "devices")]
MOE_CASES += [("weight_gather", "default"), ("weight_gather", "devices")]


@pytest.mark.parametrize("mode,case", MOE_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_jax(arch, mode, case):
    """One MoE layer and its aux loss against ``repro.nn.moe.moe_apply``:
    at the default capacity; at a capacity factor of 0.5 in groups of 16,
    where tokens overflow and the same tokens drop (the output differs from
    a roomy capacity's); and as a cohort of 2 devices (``devices``), each
    device's rows as the reference gives them alone, its aux loss its own.
    The weight gather runs at 8 tokens (a decode step), the others at 40."""
    jcfg, jmoe, cfg, tmoe = _layer_moe(arch)
    dispatch = "einsum" if mode == "weight_gather" else mode
    shape = (2, 4) if mode == "weight_gather" else (2, 20)
    n_dev = 2 if case == "devices" else 1
    x = np.random.default_rng(60).standard_normal((n_dev * shape[0], shape[1], cfg.d_model), dtype=np.float32)
    group, cf = (16, 0.5) if case == "overflow" else (None, cfg.capacity_factor)
    got, aux = moe.moe_apply(tmoe, cfg.replace(capacity_factor=cf), torch.from_numpy(x), group_size=group,
                             dispatch_mode=dispatch, devices=n_dev if case == "devices" else None)
    for i, block in enumerate(np.split(x, n_dev)):
        want, want_aux = _jax_moe_apply(jmoe, jcfg.replace(capacity_factor=cf), jnp.asarray(block), group, dispatch)
        rows = slice(i * shape[0], (i + 1) * shape[0])
        np.testing.assert_allclose(_np(got[rows]), np.asarray(want), atol=MOE_ATOL, rtol=0)
        np.testing.assert_allclose(_np(aux[i] if case == "devices" else aux), np.asarray(want_aux), atol=AUX_ATOL)
    assert got.dtype == torch.float32 and tuple(aux.shape) == ((n_dev,) if case == "devices" else ())
    if case == "overflow":  # some tokens dropped: a roomy capacity gives another output
        roomy, _ = moe.moe_apply(tmoe, cfg.replace(capacity_factor=100.0), torch.from_numpy(x), group_size=group,
                                 dispatch_mode=dispatch)
        assert (roomy - got).abs().max() > 1e-3
    if mode == "gather":  # as tests/test_perf_variants.py holds the reference's
        einsum, einsum_aux = moe.moe_apply(tmoe, cfg.replace(capacity_factor=cf), torch.from_numpy(x),
                                           group_size=group, dispatch_mode="einsum",
                                           devices=n_dev if case == "devices" else None)
        np.testing.assert_allclose(_np(got), _np(einsum), atol=MOE_ATOL, rtol=0)
        np.testing.assert_allclose(_np(aux), _np(einsum_aux), atol=AUX_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_gather_row_is_batch_invariant(arch):
    """A decode step's row does not depend on the other rows: every chosen
    expert runs on all 8 tokens, so the products' shapes do not follow the
    routing of the others (the batched serving checks rest on it)."""
    _, _, cfg, tmoe = _layer_moe(arch)
    rng = np.random.default_rng(61)
    x = torch.from_numpy(rng.standard_normal((8, 1, cfg.d_model), dtype=np.float32))
    other = x.clone()
    other[1:] = torch.from_numpy(rng.standard_normal((7, 1, cfg.d_model), dtype=np.float32))
    a, _ = moe.moe_apply(tmoe, cfg, x)
    b, _ = moe.moe_apply(tmoe, cfg, other)
    assert torch.equal(a[0], b[0])


def test_einsum_backward_saves_no_per_choice_one_hot():
    """Autograd's saved tensors on the einsum path at E 16, top-8 (C = 0.625
    g, so a (G, g, E, C) tensor is 10 g^2 a group and E·C = 400 ≫ d = 32):
    at most two of that size (none, by design), where a one-hot per choice
    and the dispatch and combine tensors were saved before; and the
    gradient of x equals the gather path's."""
    cfg = get_config(ARCHS[0], smoke=True).replace(dtype="float32", num_experts=16, top_k=8, d_model=32, d_ff=16)
    params = moe.init_moe(cfg, torch.Generator().manual_seed(0))
    x0 = torch.randn((2, 64, cfg.d_model), generator=torch.Generator().manual_seed(1))
    g, e = 64, 16
    cap = int(g / e * cfg.capacity_factor * cfg.top_k)
    big = 2 * g * e * cap  # G = 2 groups
    grads = {}
    for mode in ("einsum", "gather"):
        sizes = []

        def pack(t, sizes=sizes):
            sizes.append(t.numel())
            return t

        x = x0.clone().requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out, aux = moe.moe_apply(params, cfg, x, group_size=g, dispatch_mode=mode)
        grads[mode] = torch.autograd.grad((out * out).sum() + aux, x)[0]
        if mode == "einsum":
            assert sum(n >= big for n in sizes) <= 2, sorted(sizes)[-6:]
            assert sum(n >= big for n in sizes) == 0
    torch.testing.assert_close(grads["einsum"], grads["gather"], atol=1e-5, rtol=1e-4)


# -------------------------------------------------------------- gradients
def _jax_loss(jcfg, jparams, tokens, targets):
    def loss(pf, h0):
        h, aux, _ = jax_transformer.stack_apply(jparams["layers"], jcfg, h0, positions=jnp.arange(h0.shape[1]),
                                                peft=pf, lora_scale=2.0)
        logits = jax_transformer._norm_apply(jcfg, jparams["final_norm"], h) @ jparams["lm_head"]
        ce, _ = jax_softmax_xent(logits, targets)
        return ce + jcfg.router_aux_coef * aux

    return loss


_JAX_GRADS = {}


def _jax_grads(arch, tokens):
    """The reference's loss and gradients (its einsum dispatch) at a
    capacity factor of 0.5, once an arch."""
    if arch not in _JAX_GRADS:
        jcfg, jparams, jpeft, _, _, _ = _model(arch)
        jcfg = jcfg.replace(capacity_factor=0.5)
        h0 = np.asarray(jparams["embed"])[tokens[:, :-1]]
        _JAX_GRADS[arch] = h0, jax.jit(jax.value_and_grad(
            _jax_loss(jcfg, jparams, jnp.asarray(tokens[:, :-1]), jnp.asarray(tokens[:, 1:])), argnums=(0, 1)))(
            jpeft, jnp.asarray(h0))
    return _JAX_GRADS[arch]


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_jax(arch, dispatch):
    """The loss (cross-entropy plus ``router_aux_coef`` times the aux loss)
    of the 2-layer model and its gradients with respect to the PEFT tree
    and the input embeddings, against ``jax.value_and_grad`` of the
    reference's einsum dispatch (``tests/test_perf_variants.py`` holds its
    gather dispatch equal to it), at a capacity factor of 0.5, where some
    of a group's choices are kept and some drop (a dropped choice's gate
    takes no gradient): the port's einsum dispatch, whose backward rebuilds
    the one-hots and carries the gates' gradient through the slots, and its
    gather dispatch."""
    _, _, _, cfg, params, peft = _model(arch)
    cfg = cfg.replace(capacity_factor=0.5, moe_dispatch=dispatch)
    tokens = np.random.default_rng(62).integers(0, cfg.vocab_size, (3, SEQ + 1))
    h0, (want_loss, (want_dpeft, want_dh)) = _jax_grads(arch, tokens)

    def loss(pf, h):
        out, aux, _ = transformer.stack_apply(params["layers"], cfg, h, positions=torch.arange(SEQ), peft=pf,
                                              lora_scale=2.0)
        logits = apply_norm(params["final_norm"], out, cfg.norm_eps) @ params["lm_head"]
        ce, _ = softmax_xent(logits, torch.from_numpy(tokens[:, 1:]))
        return ce + cfg.router_aux_coef * aux

    h = torch.from_numpy(h0).requires_grad_(True)
    pf = stacking.tree_map(lambda t: t.clone().requires_grad_(True), peft)
    got = loss(pf, h)
    got_grads = torch.autograd.grad(got, [h, *stacking.tree_leaves(pf)])
    np.testing.assert_allclose(_np(got), np.asarray(want_loss), rtol=1e-5)
    np.testing.assert_allclose(_np(got_grads[0]), np.asarray(want_dh), atol=GRAD_ATOL, rtol=GRAD_RTOL)
    dpeft = stacking.tree_map(lambda _, g=iter(got_grads[1:]): next(g), peft)
    _close_trees(dpeft, want_dpeft, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    assert all(bool(g.any()) for g in got_grads)


# ------------------------------------------------------------------- init
PEFT_CASES = {"lora_qv": dict(method="lora"), "lora_mlp": dict(method="lora", lora_targets=("q", "gate", "down")),
              "adapter": dict(method="adapter"), "bitfit": dict(method="bitfit")}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_peft_have_the_jax_layout(arch):
    """``init_params`` gives the reference's stacked tree (norms, attention,
    router ``(L, d, E)``, experts ``(L, E, d, ff)``, llama4's shared expert
    ``(L, d, ff)``; no ``mlp``) and shapes; ``init_params(..., place=True)``
    draws ``place_params(init_params(...))`` layer by layer; ``init_peft``
    gives the reference's trees for LoRA on q, v and on MLP targets (which
    no MoE layer takes), adapter and BitFit."""
    jcfg, _, _, cfg, params, _ = _model(arch)
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    want = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg))
    assert stacking.is_stacked(ours["layers"]) and "mlp" not in ours["layers"]
    assert ("shared" in ours["layers"]["moe"]) == cfg.shared_expert
    assert {p: tuple(a.shape) for p, a in _flat(ours).items()} == {p: a.shape for p, a in _flat(want).items()}
    assert all(a.dtype == torch.float32 for a in _flat(ours).values())
    jax_tree = jax.tree.map(np.asarray, _to_jax(params))  # the reference's tree back through the converter
    for path, leaf in _flat(convert.params_from_jax(jax_tree, "cpu")).items():
        assert torch.equal(leaf, _flat(params)[path]), path
    bf16 = cfg.replace(dtype="bfloat16")
    drawn = place_params(init_params(bf16, torch.Generator().manual_seed(5)), bf16, "cpu")
    at_once = init_params(bf16, torch.Generator().manual_seed(5), place=True)
    assert at_once["layers"]["moe"]["experts"]["gate"]["w"].dtype == torch.bfloat16
    assert at_once["layers"]["norm1"]["scale"].dtype == torch.float32
    for path, leaf in _flat(drawn).items():
        assert torch.equal(_flat(at_once)[path], leaf), path
    for name, kw in PEFT_CASES.items():
        tree = init_peft(cfg, PEFTConfig(**kw), torch.Generator().manual_seed(0))
        want = jax.eval_shape(lambda kw=kw: jax_peft.init_peft(jax.random.PRNGKey(0), jcfg, JaxPEFTConfig(**kw)))
        assert {p: tuple(a.shape) for p, a in _flat(tree).items()} == {p: a.shape for p, a in _flat(want).items()}, name


# ------------------------------------------------------------ a local round
def _jax_gates(seed, rates, steps):
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, kd = jax.random.split(rng)
        out.append(np.asarray(jax_stld.sample_drops(kd, rates, 1)))
    return out


class _Counting:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_local_round_matches_jax(arch, monkeypatch):
    """Two local steps of ``make_client_fns`` with JAX's gates: the PEFT
    tree, metrics and Eq.-6 importances against JAX's, the twins' calls as
    the kernels' launches on the card (attention once and LoRA twice an
    active layer, the q and v dX in all but a step's first), then
    ``evaluate``."""
    jcfg, jparams, jpeft, cfg, params, peft = _model(arch)
    task = make_task(vocab_size=cfg.vocab_size, seq_len=SEQ, num_examples=16, seed=3)
    seed, mean_rate, steps = 11, 0.5, 2
    rates = jnp.clip(jax_unit_shape("incremental", 2) * mean_rate, 0.0, 0.95)
    gates = _jax_gates(seed, rates, steps)
    per_step = [task.lm_batch(np.arange(4 * i, 4 * i + 4)) for i in range(steps)]
    batches = {k: np.stack([b[k] for b in per_step]) for k in ("tokens", "targets", "mask")}
    jfns = jax_make_client_fns(jcfg, JaxPEFTConfig(), JaxSTLDConfig(), JaxTrainConfig())
    jp, _, jm, jimp = jfns.local_round(jparams, jpeft, jax_adamw_init(jpeft), jax.tree.map(jnp.asarray, batches),
                                       mean_rate, jax.random.PRNGKey(seed), 3)
    it = iter(gates)
    monkeypatch.setattr(stld, "sample_drops", lambda generator, rates, min_active=1: torch.from_numpy(next(it).copy()))
    counts = {name: _Counting(getattr(ref, name)) for name in ("attention_plain", "lora_matmul_plain")}
    for name, counter in counts.items():
        monkeypatch.setattr(ref, name, counter)
    fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig(), device="cpu")
    tp, tstate, tm, timp = fns.local_round(params, peft, adamw_init(peft), batches, mean_rate,
                                           torch.Generator().manual_seed(seed), 3)
    active = sum(int((~g).sum()) for g in gates)
    assert [c.calls for c in counts.values()] == [active, 4 * active - 2 * steps]
    assert float(tm["active_layers"]) == float(jm["active_layers"]) == active / steps
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(_np(timp), np.asarray(jimp), rtol=1e-4)
    sched = make_lr_schedule("cosine", 2e-4, 20, 1000)
    got, want = _flat(tp), _flat(jp)
    diffs = np.concatenate([np.abs(_np(got[p]) - _np(want[p])).ravel() for p in want])
    assert diffs.max() <= 2 * (sched(3) + sched(4)) + 1e-6 and np.mean(diffs <= 1e-6) >= 0.99
    assert tstate["count"] == steps
    labels, toks = task.labels[8:16], task.tokens[8:16]
    want_acc = jfns.evaluate(jparams, jp, jnp.asarray(toks), jnp.asarray(labels), jnp.arange(task.num_classes))
    assert float(fns.evaluate(params, tp, toks, labels, np.arange(task.num_classes))) == float(want_acc)


# ---------------------------------------------------------------- serving
@pytest.mark.parametrize("arch", ARCHS)
def test_api_serve_matches_jax(arch):
    """``api.serve`` at batch 2 over two tenants of rank 4 and 8: three
    requests (the third enters a recycled row), the completions equal the
    reference batcher's, and the recycled row's tokens equal the same
    request served alone in a uniform batch."""
    jcfg, jparams, _, cfg, params, _ = _model(arch)
    gen = torch.Generator().manual_seed(3)
    trees = {}
    for i, rank in enumerate((4, 8)):
        trees[f"t{i}"] = init_peft(cfg, PEFTConfig(lora_rank=rank), gen)
        for leaf in stacking.tree_leaves(trees[f"t{i}"]):
            leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
    jtrees = {name: _to_jax(tree) for name, tree in trees.items()}
    requests = [([5, 7, 11], "t0", 4), ([13, 17], "t1", 3), ([19, 23, 29, 31], "t0", 4)]
    jreg = JaxAdapterRegistry()
    for name, tree in jtrees.items():
        jreg.register(name, tree)
    jbatcher = JaxContinuousBatcher(jax_make_serve_step(jcfg, stack_mode="scan"), jparams, jcfg,
                                    JaxAdapterPoolCache(jreg, n_slots=2), batch=2, max_len=16, cache_dtype=jnp.float32)
    batcher = api.serve(cfg=cfg, params=params, adapters=trees, batch=2, max_len=16, cache_dtype="float32",
                        device="cpu")
    for j, (prompt, name, budget) in enumerate(requests):
        jbatcher.submit(JaxRequest(prompt=prompt, adapter=name, max_new_tokens=budget, uid=j))
        batcher.submit(Request(prompt=prompt, adapter=name, max_new_tokens=budget, uid=j))
    want = {c.uid: (c.tokens, c.finish_reason) for c in jbatcher.run()}
    done = {c.uid: (c.tokens, c.finish_reason) for c in batcher.run()}
    assert done == want and sorted(done) == [0, 1, 2]
    solo = api.serve(cfg=cfg, params=params, adapters=trees, batch=2, max_len=16, cache_dtype="float32", device="cpu")
    for z in range(2):
        solo.submit(Request(prompt=requests[2][0], adapter="t0", max_new_tokens=4, uid=z))
    assert {c.uid: c.tokens for c in solo.run()}[0] == done[2][0]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_generate_matches_decode_all(arch):
    """``launch/serve.py``'s ``prefill_and_generate`` (the prompt through
    ``make_prefill_step``, then ``generate``) against the reference's
    ``_decode_all`` over the prompt and the generated tokens: the prompt's
    last logits within 1e-4, and each generated token the argmax of the
    reference's logits at its position."""
    jcfg, jparams, _, cfg, params, _ = _model(arch)
    prompt = serve.random_prompts(cfg, 2, 7, 5)
    out = serve.prefill_and_generate(cfg, params, prompt, 5, "cpu")
    toks = np.concatenate([prompt, out["first"].numpy(), out["tokens"][:, :-1].numpy()], axis=1)
    caches = jax_transformer.init_caches(jcfg, 2, 12, dtype=jnp.float32)
    lp, _, caches = _jax_lm_apply(jparams, jcfg, jnp.asarray(toks[:, :7]), caches=caches)
    want = [lp[:, -1]]
    for t in range(7, toks.shape[1]):
        lt, _, caches = _jax_lm_apply(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]), positions=jnp.array([t]),
                                      caches=caches)
        want.append(lt[:, 0])
    np.testing.assert_allclose(_np(out["last_logits"]), np.asarray(want[0]), atol=LOGIT_ATOL, rtol=0)
    want_tokens = np.stack([np.argmax(np.asarray(w), axis=-1) for w in want], axis=1)
    np.testing.assert_array_equal(np.concatenate([out["first"].numpy(), out["tokens"].numpy()], axis=1), want_tokens)
