"""``remat``, per-layer recomputation of the training step, against the JAX
package and against the port's own step without it, on the CPU (the
kernels' plain twins), at the smoke sizes (2 layers) in float32.

qwen3-1.7b's parity inputs are ``tests/test_torch_training.py``'s module
fixture (JAX's params and a LoRA with ``b`` off zero, through
``repro_torch.convert``); jamba-v0.1-52b's (layer 0 Mamba + MLP, layer 1
attention + MoE) are drawn by the port and handed to JAX.  JAX's STLD gates are handed to the
port through its patched sampler.

Tolerances, each with its reason (those of ``tests/test_torch_training.py``):
* losses and metrics 1e-5 rel: float32 sums in another order;
* PEFT gradients 2e-5 abs + 1e-3 rel: the same, through the backward;
* the PEFT tree after an AdamW step from each side's own gradients: every
  element within 2 * lr + 1e-6, 99% within 1e-6 (AdamW's first step moves
  an element by about lr * sign(g), which may flip for a gradient near 0);
* ``remat=True`` against ``remat=False`` in the port: bit for bit.  The
  recompute runs the same operations on the same inputs, and nothing in
  a layer draws a random number.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import stld as jax_stld
from repro.core.schedules import unit_shape as jax_unit_shape
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import model_apply as jax_model_apply
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import PEFTConfig, TrainConfig, get_config
from repro_torch.core.peft import init_peft
from repro_torch.data.synthetic import make_task
from repro_torch.kernels import ref
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models.layers import layer_kind
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import init_params, model_apply
from repro_torch.models.stacking import tree_leaves, tree_map
from repro_torch.optim import adamw_init

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_training import GRAD_ATOL, GRAD_RTOL, _close_after_adamw, _close_trees, _feed_gates, _np, setup  # noqa: F401

JAMBA = "jamba-v0.1-52b"
JAMBA_SEQ = 20
GATE_KEY = 3  # JAX's key 3 drops layer 0 of a 2-layer stack at mean rate 0.5 (both archs' rates)


@pytest.fixture(scope="module")
def jamba():
    """jamba's smoke model (the layout of ``tests/test_torch_jamba.py``'s),
    drawn by the port and handed to JAX as it is (a per-layer list, as the
    reference keeps a heterogeneous stack): the reference's own init would
    add a compile of its own."""
    cfg = get_config(JAMBA, smoke=True).replace(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params, peft = init_params(cfg, gen), init_peft(cfg, PEFTConfig(), gen)
    for leaf in tree_leaves(peft):
        leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
    to_jax = lambda tree: tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    jcfg = jax_get_config(JAMBA, smoke=True).replace(dtype="float32")
    task = make_task(vocab_size=cfg.vocab_size, seq_len=JAMBA_SEQ, num_examples=64, seed=3)
    return jcfg, to_jax(params), to_jax(peft), cfg, params, peft, task


PARITY = {"qwen3": "setup", "jamba": "jamba"}


@pytest.mark.parametrize("stld_mode", ["off", "cond"])
@pytest.mark.parametrize("arch", sorted(PARITY))
def test_train_step_remat_matches_jax(request, monkeypatch, arch, stld_mode):
    """The port's ``make_train_step(..., remat=True)`` against the
    reference's jitted ``make_train_step(..., remat=True)``: with every
    layer, and with JAX's gates dropping layer 0 (``cond``)."""
    jcfg, jparams, jpeft, cfg, params, peft, task = request.getfixturevalue(PARITY[arch])
    train_cfg, key = JaxTrainConfig(), jax.random.PRNGKey(GATE_KEY)
    tokens = np.concatenate([task.tokens[:4], task.tokens[4:8, :1]], axis=1)  # (B, S+1)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxPEFTConfig(), train_cfg, stld_mode=stld_mode, remat=True))
    jp, _, jm = jstep(jparams, jpeft, jax_adamw_init(jpeft), {"tokens": jnp.asarray(tokens)}, key)
    if stld_mode == "cond":
        rates = jnp.clip(jax_unit_shape("incremental", jcfg.num_layers) * 0.5, 0.0, 0.95)
        gate = np.asarray(jax_stld.sample_drops(key, rates, 1))
        assert gate.tolist() == [True, False]
        _feed_gates(monkeypatch, [gate])
    step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode=stld_mode, remat=True)
    tp, _, tm = step(params, peft, adamw_init(peft), {"tokens": tokens}, torch.Generator().manual_seed(GATE_KEY))
    for k in ("loss", "accuracy", "grad_norm", "tokens"):
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    _close_after_adamw(tp, jp, train_cfg.learning_rate)


@pytest.mark.parametrize("arch", sorted(PARITY))
def test_value_and_grad_remat_matches_jax(request, arch):
    """The loss (with the router's aux term) and every PEFT gradient under
    ``remat``, against ``jax.value_and_grad`` of the reference's
    ``model_apply(..., remat=True)``."""
    jcfg, jparams, jpeft, cfg, params, peft, task = request.getfixturevalue(PARITY[arch])
    batch = task.lm_batch(np.arange(4))

    def jloss(pf):
        logits, aux, _ = jax_model_apply(jparams, jcfg, {"tokens": jnp.asarray(batch["tokens"])}, peft=pf,
                                         lora_scale=2.0, stack_mode="unroll", remat=True)
        ce, metrics = jax_softmax_xent(logits, jnp.asarray(batch["targets"]), jnp.asarray(batch["mask"]))
        return ce + jcfg.router_aux_coef * aux, metrics

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jpeft)

    def tloss(pf):
        logits, aux, _ = model_apply(params, cfg, {"tokens": torch.from_numpy(batch["tokens"])}, peft=pf,
                                     lora_scale=2.0, remat=True)
        ce, metrics = softmax_xent(logits, torch.from_numpy(batch["targets"]), torch.from_numpy(batch["mask"]))
        return ce + cfg.router_aux_coef * aux, metrics

    (tl, _), tgrads = value_and_grad(tloss)(peft)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    _close_trees(tgrads, jgrads, atol=GRAD_ATOL, rtol=GRAD_RTOL)


# ------------------------------------------------------------- the port against itself
def _smoke(arch, seed=0):
    """The smoke model of ``arch`` in float32, drawn by the port, a LoRA
    with ``b`` off zero, and a batch of 4 x (16 + 1) tokens."""
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    gen = torch.Generator().manual_seed(seed)
    params, peft = init_params(cfg, gen), init_peft(cfg, PEFTConfig(), gen)
    for leaf in tree_leaves(peft):
        leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 17), generator=gen)}
    if cfg.frontend_key is not None:
        batch[cfg.frontend_key] = torch.randn((4, cfg.frontend_seq, cfg.d_model), generator=gen)
    return cfg, params, peft, batch


def _loss_and_grads(cfg, params, peft, batch, remat, **kw):
    inputs = dict(batch, tokens=batch["tokens"][:, :-1])

    def loss(pf):
        logits, aux, _ = model_apply(params, cfg, inputs, peft=pf, lora_scale=2.0, remat=remat, **kw)
        ce, metrics = softmax_xent(logits[:, -inputs["tokens"].shape[1]:], batch["tokens"][:, 1:])
        return ce + cfg.router_aux_coef * aux, metrics

    (value, _), grads = value_and_grad(loss)(peft)
    return value, grads


def _two_steps(cfg, params, peft, batch, remat, stld_mode):
    step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode=stld_mode, remat=remat)
    p, opt, out = peft, adamw_init(peft), []
    for seed in (1, 2):
        p, opt, metrics = step(params, p, opt, batch, torch.Generator().manual_seed(seed))
        out.append(metrics)
    return p, out


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


BIT_CASES = {"qwen3": ("qwen3-1.7b", "cond"), "rwkv6": ("rwkv6-3b", "cond"), "jamba": (JAMBA, "cond"),
             "granite": ("granite-moe-3b-a800m", "cond"), "qwen3-gather": ("qwen3-1.7b", "gather")}


@pytest.mark.parametrize("case", list(BIT_CASES))
def test_remat_is_bit_identical_to_the_plain_step(case):
    """``remat=True`` gives the loss, the gradients (every layer active, and
    layer 0 dropped), and the PEFT tree and metrics of two train steps of
    ``remat=False``, bit for bit; in gather mode the indices come from the
    same generator."""
    arch, stld_mode = BIT_CASES[case]
    cfg, params, peft, batch = _smoke(arch)
    drops_cases = [None, [True] + [False] * (cfg.num_layers - 1)]
    for drops in drops_cases:
        plain = _loss_and_grads(cfg, params, peft, batch, False, drops=drops)
        remat = _loss_and_grads(cfg, params, peft, batch, True, drops=drops)
        assert torch.equal(plain[0], remat[0]) and _same(tree_leaves(plain[1]), tree_leaves(remat[1])), drops
    (p0, m0), (p1, m1) = (_two_steps(cfg, params, peft, batch, remat, stld_mode) for remat in (False, True))
    assert _same(tree_leaves(p0), tree_leaves(p1))
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)


class _Counting:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


@pytest.mark.parametrize("arch,twins", [("qwen3-1.7b", ("attention_plain", "lora_matmul_plain")),
                                        ("rwkv6-3b", ("wkv6_plain", "lora_matmul_plain")),
                                        (JAMBA, ("mamba_scan_plain", "attention_plain", "lora_matmul_plain"))])
def test_remat_runs_each_active_layer_forward_twice(monkeypatch, arch, twins):
    """The recompute in the backward runs each active layer's forward, its
    kernels' twins included, once more (the non-reentrant checkpoint stops
    after a layer's last saved tensor, which follows every kernel of the
    layer); a dropped layer runs nothing.  So under ``remat`` each forward
    twin runs twice as often as without, layer 0 dropped or not."""
    cfg, params, peft, batch = _smoke(arch)
    for drops in (None, [True] + [False] * (cfg.num_layers - 1)):
        calls = {}
        for remat in (False, True):
            counters = {name: _Counting(getattr(ref, name)) for name in twins}
            for name, counter in counters.items():
                monkeypatch.setattr(ref, name, counter)
            _loss_and_grads(cfg, params, peft, batch, remat, drops=drops)
            calls[remat] = {name: c.calls for name, c in counters.items()}
        active = [l for l in range(cfg.num_layers) if drops is None or not drops[l]]
        if "mamba_scan_plain" in twins:
            assert calls[False]["mamba_scan_plain"] == sum(layer_kind(cfg, l) == "mamba" for l in active)
        assert calls[False]["lora_matmul_plain"] == 2 * len(active)
        assert calls[True] == {name: 2 * n for name, n in calls[False].items()}, (drops, calls)


def test_whisper_takes_remat_and_runs_without_it(monkeypatch):
    """The reference's registry never passes ``remat`` to ``encdec.decode``:
    whisper's step with ``remat=True`` is its step without, bit for bit,
    and checkpoints nothing."""
    cfg, params, peft, batch = _smoke("whisper-tiny")
    calls = _Counting(torch.utils.checkpoint.checkpoint)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", calls)
    plain = _loss_and_grads(cfg, params, peft, batch, False)
    remat = _loss_and_grads(cfg, params, peft, batch, True)
    assert torch.equal(plain[0], remat[0]) and _same(tree_leaves(plain[1]), tree_leaves(remat[1]))
    (p0, m0), (p1, m1) = (_two_steps(cfg, params, peft, batch, remat, "cond") for remat in (False, True))
    assert _same(tree_leaves(p0), tree_leaves(p1)) and all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)
    assert calls.calls == 0
    qwen3 = _smoke("qwen3-1.7b")
    _loss_and_grads(*qwen3, True)
    assert calls.calls == qwen3[0].num_layers  # the decoder-only stack checkpoints each active layer


def test_remat_with_a_cohort_raises():
    """The cohort path is the port's form of the reference's vmapped client
    step, which never passes ``remat``."""
    cfg, params, _, _ = _smoke("qwen3-1.7b")
    tokens = torch.zeros((2, 1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="remat"):
        model_apply(params, cfg, {"tokens": tokens}, devices=2, remat=True)
    model_apply(params, cfg, {"tokens": tokens}, devices=2)  # without remat it runs


def _saved_bytes(cfg, params, peft, batch, remat, drops):
    """The bytes autograd saves for the backward while the loss's forward
    runs (a ``saved_tensors_hooks`` pair around it)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    inputs = dict(batch, tokens=batch["tokens"][:, :-1])
    pf = tree_map(lambda t: t.detach().requires_grad_(True), peft)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logits, _, _ = model_apply(params, cfg, inputs, peft=pf, lora_scale=2.0, remat=remat, drops=drops)
        softmax_xent(logits, batch["tokens"][:, 1:])
    return total[0]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", JAMBA])
def test_remat_keeps_only_each_active_layers_input(arch):
    """Under ``remat`` an active layer's saved tensors go to its checkpoint
    and are dropped until the backward recomputes them; the checkpoint
    saves only its tensor arguments, the layer's input ``h`` and the
    positions.  So, with layer 0 active or dropped, the bytes the hook sees
    under ``remat`` differ by exactly those two, and without ``remat`` by
    layer 0's activations.  The bound: those are more than 10 times its
    input at this size (37 times for qwen3's layer, 51 for jamba's Mamba
    layer: every projection's input, the attention's or the scan's
    operands, the MLP's), so the count must fall by more than 9 times the
    input a layer."""
    cfg, params, peft, batch = _smoke(arch)
    one = [True] + [False] * (cfg.num_layers - 1)
    plain = {n: _saved_bytes(cfg, params, peft, batch, False, drops) for n, drops in (("all", None), ("one", one))}
    remat = {n: _saved_bytes(cfg, params, peft, batch, True, drops) for n, drops in (("all", None), ("one", one))}
    seq = batch["tokens"].shape[1] - 1
    layer_input = batch["tokens"].shape[0] * seq * cfg.d_model * 4 + seq * 8  # h (float32), positions (int64)
    assert remat["all"] - remat["one"] == layer_input
    assert plain["all"] - plain["one"] > 10 * layer_input
    assert plain["all"] - remat["all"] > 9 * layer_input * cfg.num_layers


def test_remat_keeps_no_layer_checkpointed_without_gradients(monkeypatch):
    """Under ``torch.no_grad`` (the prefill and serve steps) ``remat``
    checkpoints nothing and gives the same logits."""
    cfg, params, peft, batch = _smoke("qwen3-1.7b")
    calls = _Counting(torch.utils.checkpoint.checkpoint)
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", calls)
    with torch.no_grad():
        plain, _, _ = model_apply(params, cfg, batch, peft=peft, remat=False)
        remat, _, _ = model_apply(params, cfg, batch, peft=peft, remat=True)
    assert torch.equal(plain, remat) and calls.calls == 0
