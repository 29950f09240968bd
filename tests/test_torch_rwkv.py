"""The port's rwkv6-3b local-training slice against the JAX package, on the
CPU (the kernels' plain twins), at the smoke size (2 layers, d_model 128,
4 heads of 32) in float32.

Inputs are made with numpy and handed to both frameworks.  The JAX params
go through ``repro_torch.convert`` with the zero-initialised low-rank
adjusters (``ts_lora_b``, ``wd_b``) and the LoRA ``b`` moved off zero, so
that every path carries a signal and dA is not zero.  JAX's STLD gates are
handed to the port (its sampler is patched), as in
``tests/test_torch_training.py``.

Tolerances, each with its reason:
* WKV outputs 2e-5 abs + 1e-2 rel in float32 (``tests/test_kernels.py``'s
  sweep), 3e-2 in bfloat16 (one bf16 rounding of an O(1) output); against
  the chunked form of ``repro.nn.rwkv`` 1e-4 abs + 1e-4 rel, since its
  division trick scales terms by up to e^{64} before they cancel;
* WKV gradients and PEFT gradients 2e-5 abs + 1e-3 rel: float32 sums in
  another order (``tests/test_torch_training.py``'s GRAD_ATOL/GRAD_RTOL);
* block outputs and logits 1e-4 abs, losses and metrics 1e-5 rel;
* the PEFT tree after AdamW steps: every element within 2 * (sum of the
  step sizes) + 1e-6, 99% within 1e-6 (AdamW's first steps move an element
  by about lr * sign(g), which may flip for a gradient near 0);
* gates, launch counts, active-layer counts and accuracies exactly.
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
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import init_params as jax_init_params
from repro.models.registry import model_apply as jax_model_apply
from repro.nn import rwkv as jax_rwkv
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import convert
from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import stld
from repro_torch.core.peft import init_peft
from repro_torch.data.synthetic import make_task
from repro_torch.federated.client import make_client_fns
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import value_and_grad
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import init_params, model_apply, place_params
from repro_torch.models.stacking import layer_view
from repro_torch.models.transformer import lm_apply
from repro_torch.nn import rwkv
from repro_torch.optim import adamw_init, make_lr_schedule

LOGIT_ATOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
SEQ = 20  # not a multiple of the 16-token chunk
ARCH = "rwkv6-3b"


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _flat(tree, prefix=()):
    """{key path: float32 numpy leaf} of a tree of dicts (torch or JAX)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flat(tree[key], prefix + (key,)))
        return out
    return {prefix: _np(tree)}


def _close_trees(got, want, atol, rtol=0.0):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=atol, rtol=rtol, err_msg=str(path))


def _close_after_adamw(got, want, lr_sum):
    got, want = _flat(got), _flat(want)
    diffs = np.concatenate([np.abs(got[p] - want[p]).ravel() for p in want])
    assert diffs.max() <= 2 * lr_sum + 1e-6, diffs.max()
    assert np.mean(diffs <= 1e-6) >= 0.99, np.mean(diffs <= 1e-6)


def _wkv_inputs(rng, b, s, h, k, state=False):
    r, kk, v = (0.5 * rng.standard_normal((b, s, h, k), dtype=np.float32) for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((b, s, h, k), dtype=np.float32)), -4.0, -1e-4)
    u = 0.3 * rng.standard_normal((h, k), dtype=np.float32)
    s0 = rng.standard_normal((b, h, k, k), dtype=np.float32) if state else None
    return r, kk, v, logw, u, s0


def _t(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------- (a)-(c) the WKV
WKV_SHAPES = [(2, 50, 3, 16), (1, 16, 1, 32), (2, 33, 2, 64)]  # tests/test_kernels.py's sweep


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,k", WKV_SHAPES)
def test_wkv6_plain_matches_jax_ref_and_pallas(dtype, b, s, h, k):
    """(a) ``wkv6_plain`` and ``ops.wkv6`` (its CPU path) against JAX's
    ``wkv6_ref`` and the Pallas kernel in interpret mode.  In bfloat16 both
    sides get the same bf16 r, k, v, and logw rounded to bf16 (the Pallas
    kernel takes one dtype) but held in float32 on the port's side."""
    r, kk, v, logw, u, _ = _wkv_inputs(np.random.default_rng(40 + s), b, s, h, k)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jin = [jnp.asarray(a, jdt) for a in (r, kk, v, logw, u)]
    want_ref = np.asarray(jax_ref.wkv6_ref(*jin), np.float32)
    want_pallas = np.asarray(jax_ops.wkv6(*jin, chunk=16), np.float32)
    tin = [torch.from_numpy(np.array(a.astype(jnp.float32))) for a in jin]
    tin = [t.to(getattr(torch, dtype)) for t in tin[:3]] + tin[3:]
    got, state = ref.wkv6_plain(*tin)
    got_ops, state_ops = ops.wkv6(*tin)
    assert got.dtype == state.dtype == torch.float32 and tuple(state.shape) == (b, h, k, k)
    assert torch.equal(got, got_ops) and torch.equal(state, state_ops)
    atol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), want_ref, atol=atol, rtol=1e-2)
    np.testing.assert_allclose(_np(got), want_pallas, atol=atol, rtol=1e-2)


@pytest.mark.parametrize("b,s,h,k", [(2, 40, 3, 16), (1, 7, 2, 32)])
def test_wkv6_plain_with_state_matches_jax_chunked(b, s, h, k):
    """(b) The prefill-with-state branch: out and the final state against
    ``_wkv_chunked(..., s0=...)``."""
    arrays = _wkv_inputs(np.random.default_rng(41), b, s, h, k, state=True)
    want_out, want_state = jax_rwkv._wkv_chunked(*map(jnp.asarray, arrays))
    got_out, got_state = ref.wkv6_plain(*_t(arrays))
    np.testing.assert_allclose(_np(got_out), np.asarray(want_out), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(got_state), np.asarray(want_state), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_backward_matches_jax_vjp_of_chunked(with_state):
    """(c) ``ops.wkv6``'s CPU backward (``wkv6_bwd_plain``) against
    ``jax.vjp`` of ``_wkv_chunked``: dr, dk, dv, dlogw, du and, with a
    state in, ds0 (the final state then takes a cotangent too)."""
    rng = np.random.default_rng(42)
    arrays = _wkv_inputs(rng, 2, 37, 3, 16, state=with_state)
    dout = rng.standard_normal((2, 37, 3, 16), dtype=np.float32)
    dstate = rng.standard_normal((2, 3, 16, 16), dtype=np.float32) if with_state else np.zeros((2, 3, 16, 16), np.float32)
    jargs = [jnp.asarray(a) for a in arrays if a is not None]
    fn = (lambda *a: jax_rwkv._wkv_chunked(*a)) if with_state else (lambda *a: jax_rwkv._wkv_chunked(*a, s0=None))
    _, vjp = jax.vjp(fn, *jargs)
    want = vjp((jnp.asarray(dout), jnp.asarray(dstate)))
    leaves = [t.requires_grad_(True) for t in _t(arrays) if t is not None]
    out, state = ops.wkv6(*leaves, *([None] if not with_state else []))
    loss = (out * torch.from_numpy(dout)).sum()
    if with_state:
        loss = loss + (state * torch.from_numpy(dstate)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_wkv6_backward_twin_matches_autograd_in_float64():
    """The backward twin's formulas against autograd through the forward
    twin's recurrence written in float64."""
    rng = np.random.default_rng(43)
    arrays = _wkv_inputs(rng, 2, 21, 2, 16, state=True)
    dout = rng.standard_normal((2, 21, 2, 16), dtype=np.float32)
    dstate = rng.standard_normal((2, 2, 16, 16), dtype=np.float32)
    leaves = [t.double().requires_grad_(True) for t in _t(arrays)]
    r, k, v, logw, u, st = leaves
    outs = []
    for t in range(21):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], st + u[None, :, :, None] * kv))
        st = logw[:, t].exp()[..., None] * st + kv
    loss = (torch.stack(outs, 1) * torch.from_numpy(dout).double()).sum() + (st * torch.from_numpy(dstate).double()).sum()
    want = torch.autograd.grad(loss, leaves)
    got = ref.wkv6_bwd_plain(*_t(arrays), torch.from_numpy(dout), torch.from_numpy(dstate))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), w.numpy(), atol=GRAD_ATOL, rtol=GRAD_RTOL)


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def setup():
    key = jax.random.PRNGKey(0)
    jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
    jparams = jax.jit(jax_init_params, static_argnums=1)(key, jcfg)
    tm = jparams["layers"]["time_mix"]
    for i, name in enumerate(("ts_lora_b", "wd_b")):  # zero at init: give the adjusters a signal
        tm[name] = 0.1 * jax.random.normal(jax.random.fold_in(key, 10 + i), tm[name].shape)
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
            if field != "rwkv":
                assert getattr(ours, field) == getattr(theirs, field), field
        for field in ours.rwkv.__dataclass_fields__:
            assert getattr(ours.rwkv, field) == getattr(theirs.rwkv, field), field
    full = get_config(ARCH)
    assert (full.family, full.num_layers, full.d_model, full.d_model // full.rwkv.head_dim) == ("ssm", 32, 2560, 40)
    assert (full.d_ff, full.vocab_size, full.tie_embeddings) == (8960, 65536, False)


def test_init_params_and_peft_have_jax_shapes_and_convert(setup):
    """(h) ``init_params`` / ``init_peft`` give JAX's tree, shapes and
    dtypes (the rwkv LoRA branch ``{"cm": {"up", "down"}}`` whatever the
    targets); a JAX rwkv tree survives ``params_from_jax`` leaf by leaf; and
    ``place_params`` casts the projections alone."""
    jcfg, jparams, jpeft, cfg, params, peft, _ = setup
    ours = _flat(init_params(cfg, torch.Generator().manual_seed(0)))
    theirs = _flat(jparams)
    converted = _flat(params)
    assert sorted(ours) == sorted(theirs) == sorted(converted)
    for path, leaf in theirs.items():
        assert ours[path].shape == leaf.shape, path
        np.testing.assert_array_equal(converted[path], leaf)
    tree = init_peft(cfg, PEFTConfig(lora_targets=("q",)), torch.Generator().manual_seed(0))
    want = _flat(jax_peft.init_peft(jax.random.PRNGKey(0), jcfg, JaxPEFTConfig()))
    assert {p: a.shape for p, a in _flat(tree).items()} == {p: a.shape for p, a in want.items()}
    assert not tree["cm"]["up"]["b"].any() and tree["cm"]["up"]["a"].std() > 0
    placed = place_params(params, cfg.replace(dtype="bfloat16"), "cpu")
    layers = placed["layers"]
    assert layers["time_mix"]["wr"]["w"].dtype == layers["channel_mix"]["wv"]["w"].dtype == torch.bfloat16
    for name in ("w0", "wd_a", "wd_b", "u", "mu", "ts_lora_a", "ts_lora_b", "wg_a", "ln_out_scale"):
        assert layers["time_mix"][name].dtype == torch.float32, name
    assert placed["lm_head"].dtype == placed["embed"].dtype == torch.bfloat16


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree)


@pytest.mark.parametrize("with_state", [False, True])
def test_time_mix_and_channel_mix_match_jax(setup, with_state):
    """(d) One layer's time-mix and channel-mix (with its LoRA) against
    JAX's, without a state (training) and with one (prefill)."""
    jcfg, jparams, jpeft, cfg, params, peft, _ = setup
    rng = np.random.default_rng(44)
    x = rng.standard_normal((2, SEQ, cfg.d_model), dtype=np.float32)
    hd = cfg.rwkv.head_dim
    state = None
    if with_state:
        state = {"wkv": rng.standard_normal((2, cfg.d_model // hd, hd, hd), dtype=np.float32),
                 "shift_tm": rng.standard_normal((2, cfg.d_model), dtype=np.float32),
                 "shift_cm": rng.standard_normal((2, cfg.d_model), dtype=np.float32)}
    jstate = None if state is None else jax.tree.map(jnp.asarray, state)
    tstate = None if state is None else {k: torch.from_numpy(v) for k, v in state.items()}
    jl, tl = _layer0(jparams["layers"]), layer_view(params["layers"], 0)
    want, want_state = jax_rwkv.time_mix_apply(jl["time_mix"], jcfg, jnp.asarray(x), state=jstate)
    got, got_state = rwkv.time_mix_apply(tl["time_mix"], cfg, torch.from_numpy(x), state=tstate)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    for name in ("wkv", "shift_tm"):
        np.testing.assert_allclose(_np(got_state[name]), np.asarray(want_state[name]), atol=LOGIT_ATOL, rtol=1e-4)
    want, want_state = jax_rwkv.channel_mix_apply(jl["channel_mix"], jcfg, jnp.asarray(x), state=jstate,
                                                  peft=_layer0(jpeft)["cm"], lora_scale=2.0)
    got, got_state = rwkv.channel_mix_apply(tl["channel_mix"], cfg, torch.from_numpy(x), state=tstate,
                                            peft=layer_view(peft, 0)["cm"], lora_scale=2.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(_np(got_state["shift_cm"]), np.asarray(want_state["shift_cm"]), rtol=1e-6)


@pytest.mark.parametrize("drops", [None, [False, True], [True, False]])
def test_lm_apply_with_drops_matches_jax(setup, drops):
    """(e) Logits of the whole model, with and without dropped layers."""
    jcfg, jparams, jpeft, cfg, params, peft, task = setup
    tokens = task.tokens[:3]
    jd = None if drops is None else jnp.asarray(drops)
    want, _, _ = jax.jit(
        lambda p, pf, t, d: jax_model_apply(p, jcfg, {"tokens": t}, drops=d, peft=pf, lora_scale=2.0, stack_mode="unroll")
    )(jparams, jpeft, jnp.asarray(tokens), jd)
    got, _, _ = lm_apply(params, cfg, torch.from_numpy(tokens), drops=drops, peft=peft, lora_scale=2.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_ATOL, rtol=0)


@pytest.mark.parametrize("drops", [[False, False], [True, False]])
def test_peft_grads_match_jax_value_and_grad(setup, drops):
    """(f) The loss and every PEFT gradient; the gradient of layer 0's LoRA
    flows back through layer 1's time-mix and so through the WKV backward."""
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
    if drops[0]:
        assert all(not g[0].any() for g in _flat_tensors(tgrads))


def _flat_tensors(tree):
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _flat_tensors(tree[key])]
    return [tree]


def _jax_gates(seed, rates, steps, min_active=1):
    """The gates ``local_round`` draws: one key split per step."""
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, kd = jax.random.split(rng)
        out.append(np.asarray(jax_stld.sample_drops(kd, rates, min_active)))
    return out


class _Counting:
    """Wraps a twin and counts its calls (the CPU runs no kernel, so
    ``ops.launch_counts`` stays 0 here)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def test_local_round_with_jax_gates_matches_jax(setup, monkeypatch):
    """(g) Two local steps (step 0 runs both layers, step 1 drops layer 1):
    PEFT tree, metrics and Eq.-6 importances against JAX's, then
    ``evaluate``.  The WKV twins run once forward per active layer and once
    backward per active layer but the first of each step, whose inputs
    need no gradient: the kernels' launch counts on the card."""
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
    fwd, bwd = _Counting(ref.wkv6_plain), _Counting(ref.wkv6_bwd_plain)
    monkeypatch.setattr(ref, "wkv6_plain", fwd)
    monkeypatch.setattr(ref, "wkv6_bwd_plain", bwd)
    fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig(), device="cpu")
    tp, tstate, tm, timp = fns.local_round(
        params, peft, adamw_init(peft), batches, mean_rate, torch.Generator().manual_seed(seed), 3
    )
    active = 2 + 1
    assert (fwd.calls, bwd.calls) == (active, active - steps)
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
    assert (fwd.calls, bwd.calls) == (active + cfg.num_layers, active - steps)
