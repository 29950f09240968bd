"""The port's batched cohort on the CPU: the grouped ``lora_matmul`` twin,
the per-device clip, AdamW and MoE, the cohort layer loop, and the batched
engine against the port's own sequential one.

The grouped twin against the JAX package's ``lora_matmul_pallas``
(interpret mode) and ``jax.grad`` of ``lora_matmul_ref`` group by group,
float32 within 2e-5 (bf16 3e-2), and against the ungrouped twin bit for
bit.  The batched engine against the sequential one device by device, as
``tests/test_cohort_parity.py`` holds the reference's two modes, at its
smoke sizes (qwen3: 4 layers, d_model 32, float32, 6 devices with 4 a
round, 2 local steps, batch 8, LoRA rank 2; rwkv6-3b and jamba at their
smoke configs in float32): PEFT trees within 1e-5, importances 1e-4,
metrics 1e-4, accuracies 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.lora_matmul import lora_matmul_pallas
from repro_torch import api
from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.federated import engine as engine_lib
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as layers_lib
from repro_torch.models import transformer
from repro_torch.models.registry import init_params
from repro_torch.models.stacking import tree_leaves, tree_map
from repro_torch.nn import moe
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm
from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _grouped(rng, g, rows, k, n, r):
    x = rng.standard_normal((g * rows, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) * k**-0.5
    a = rng.standard_normal((g, k, r), dtype=np.float32) * k**-0.5
    b = rng.standard_normal((g, r, n), dtype=np.float32) * r**-0.5
    return x, w, a, b


# ------------------------------------------------------------- grouped lora_matmul
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,rows,k,n,r", [(3, 16, 32, 24, 4), (1, 40, 64, 16, 8), (4, 7, 16, 8, 2)])
def test_grouped_lora_matmul_matches_pallas_group_by_group(dtype, g, rows, k, n, r):
    """Rows of group g through ``ops.lora_matmul`` with a (G, K, r) A and
    (G, r, N) B: the JAX package's Pallas kernel (interpret mode) on those
    rows with A_g and B_g, and the ungrouped twin on them bit for bit."""
    x, w, a, b = _grouped(np.random.default_rng(31), g, rows, k, n, r)
    dt = getattr(torch, dtype)
    tx, tw, ta, tb = (torch.from_numpy(t).to(dt) for t in (x, w, a, b))
    got = ops.lora_matmul(tx, tw, ta, tb, alpha=0.5)
    assert got.shape == (g * rows, n) and got.dtype == dt
    jdt = getattr(jnp, dtype)
    for i in range(g):
        part = slice(i * rows, (i + 1) * rows)
        want = lora_matmul_pallas(jnp.asarray(x[part], jdt), jnp.asarray(w, jdt), jnp.asarray(a[i], jdt),
                                  jnp.asarray(b[i], jdt), alpha=0.5, block_m=8, block_n=8, interpret=True)
        np.testing.assert_allclose(got[part].float().numpy(), np.asarray(want, np.float32), atol=ATOL[dtype], rtol=0)
        assert torch.equal(got[part], ref.lora_matmul_plain(tx[part], tw, ta[i], tb[i], alpha=0.5))


def test_grouped_lora_matmul_grads_match_jax_group_by_group():
    """dX, dA_g and dB_g of the grouped twin against ``jax.grad`` of the
    reference's ``lora_matmul_ref`` summed over the groups."""
    rng = np.random.default_rng(32)
    g, rows, k, n, r = 3, 12, 32, 20, 4
    x, w, a, b = _grouped(rng, g, rows, k, n, r)
    dy = rng.standard_normal((g * rows, n), dtype=np.float32)

    def loss(x, a, b):
        ys = [jax_ref.lora_matmul_ref(x[i * rows:(i + 1) * rows], jnp.asarray(w), a[i], b[i], alpha=2.0)
              for i in range(g)]
        return jnp.sum(jnp.concatenate(ys) * dy)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (x, a, b)]
    y = ops.lora_matmul(leaves[0], torch.from_numpy(w), leaves[1], leaves[2], alpha=2.0)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for gg, wg in zip(got, want):
        np.testing.assert_allclose(gg.numpy(), np.asarray(wg), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("g,rows,r,span,route", [
    (10, 512, 8, 1, "wgmma"),  # phase 5d: 512 rows a device, tiles never span two
    (4, 100, 8, 3, "wgmma"),  # tiles touch up to 3 groups: 3 x 8 ranks staged
    (3, 500, 64, 2, "wmma"),  # 2 x 64 ranks would not fit: refused
    (3, 512, 64, 1, "wgmma"),  # 512 rows: one group a tile, 64 ranks fit
    (1, 100, 64, 1, "wgmma"),  # ungrouped
    (16, 1, 8, 16, "wmma"),  # a row a group: 16 groups a tile
])
def test_grouped_lora_matmul_route(g, rows, r, span, route):
    """The wgmma route stages the B_g of every group a 128-row tile
    touches; it takes a grouped call while those fit ``MAX_LORA_RANK``
    ranks, else the call goes to the WMMA route."""
    assert ops.lora_group_span(g, rows) == span
    x = torch.zeros((g * rows, 64), dtype=torch.bfloat16)
    w = torch.zeros((64, 32), dtype=torch.bfloat16)
    assert ops.lora_matmul_route(x, w, torch.zeros((g, 64, r), dtype=torch.bfloat16)) == route


# ------------------------------------------------------------- clip, AdamW, MoE
def _cohort_tree(rng, n, num_layers):
    """A cohort's per-layer list of LoRA trees with (N, ...) leaves."""
    return [{"attn": {p: {"a": torch.from_numpy(rng.standard_normal((n, 16, 2), dtype=np.float32)),
                          "b": torch.from_numpy(rng.standard_normal((n, 2, 8), dtype=np.float32))}
                      for p in ("q", "v")}} for _ in range(num_layers)]


def _device_tree(tree, i):
    """Device i's tree in the stacked single-device layout, (L, ...) leaves."""
    return tree_map(lambda *xs: torch.stack(xs), *[tree_map(lambda t: t[i], layer) for layer in tree])


def test_cohort_clip_and_adamw_match_each_device_alone():
    """One clip norm and one learning rate per device: each device's
    clipped gradients, norm and AdamW step equal the single-device
    functions' on its own tree (stacked layout)."""
    rng = np.random.default_rng(33)
    n, num_layers = 3, 4
    grads, params = _cohort_tree(rng, n, num_layers), _cohort_tree(rng, n, num_layers)
    grads[1] = tree_map(lambda t: t * 0.01, grads[1])
    lrs = [1e-3, 5e-4, 2e-3]
    clipped, norms = clip_by_global_norm(grads, 2.0, devices=n)
    opt = adamw_init(params)
    new, opt = adamw_update(clipped, opt, params, lr=torch.tensor(lrs, dtype=torch.float32))
    new, _ = adamw_update(clipped, opt, new, lr=torch.tensor(lrs, dtype=torch.float32))
    assert norms.shape == (n,)
    for i in range(n):
        g_i, p_i = _device_tree(grads, i), _device_tree(params, i)
        want_g, want_norm = clip_by_global_norm(g_i, 2.0)
        np.testing.assert_allclose(float(norms[i]), float(want_norm), rtol=1e-6)
        for got, want in zip(tree_leaves(_device_tree(clipped, i)), tree_leaves(want_g)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)
        opt_i = adamw_init(p_i)
        want_p, opt_i = adamw_update(_device_tree(clipped, i), opt_i, p_i, lr=lrs[i])
        want_p, _ = adamw_update(_device_tree(clipped, i), opt_i, want_p, lr=lrs[i])
        for got, want in zip(tree_leaves(_device_tree(new, i)), tree_leaves(want_p)):
            assert torch.equal(got, want)


@pytest.fixture(scope="module")
def jamba_moe():
    cfg = get_config("jamba-v0.1-52b", smoke=True).replace(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(5))
    layer = next(p for p in params["layers"] if "moe" in p)
    return cfg, layer["moe"]


@pytest.mark.parametrize("seq,group_size,factor", [(24, 32, 1.0), (32, 32, 0.5), (16, None, 1.0)])
def test_moe_with_a_device_axis_routes_each_device_alone(jamba_moe, seq, group_size, factor):
    """``moe_apply`` over 3 devices' folded tokens equals a call per
    device: outputs, drops and the per-device aux loss.  48 tokens a device
    in groups of 32 make one group of 48 each (144 folded tokens would have
    made one group for all three); 64 tokens make two groups each, at a
    capacity that drops tokens."""
    cfg, params = jamba_moe
    cfg = cfg.replace(capacity_factor=factor)
    params = dict(params, router={"w": params["router"]["w"] * 8.0})  # a sharp router: full experts
    n, b = 3, 2
    x = torch.from_numpy(np.random.default_rng(34).standard_normal((n * b, seq, cfg.d_model), dtype=np.float32))
    got, got_aux = moe.moe_apply(params, cfg, x, group_size=group_size, devices=n)
    assert got_aux.shape == (n,)
    roomy, _ = moe.moe_apply(params, cfg.replace(capacity_factor=100.0), x, group_size=group_size, devices=n)
    for i in range(n):
        part = slice(i * b, (i + 1) * b)
        want, want_aux = moe.moe_apply(params, cfg, x[part], group_size=group_size)
        assert torch.equal(got[part], want)
        assert torch.equal(got_aux[i], want_aux)
    if factor < 1.0:
        assert not torch.equal(roomy, got)  # some tokens overflowed their expert


# ------------------------------------------------------------- the layer loop
def test_cohort_stack_runs_each_layer_once_on_its_open_devices(monkeypatch):
    """Per step a layer runs once, on the devices whose gate is open, and
    not at all when no gate is; each device's rows equal its own forward
    with its own gates and adapters."""
    cfg = get_config("qwen3-1.7b", smoke=True).replace(num_layers=4, d_model=32, d_ff=64, num_heads=2,
                                                       num_kv_heads=2, vocab_size=128, dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(6))
    rng = np.random.default_rng(35)
    n = 3
    cohort = [{"attn": {p: {"a": torch.from_numpy(rng.standard_normal((n, 32, 2), dtype=np.float32) * 0.2),
                            "b": torch.from_numpy(rng.standard_normal((n, 2, 32), dtype=np.float32) * 0.2)}
                        for p in ("q", "v")}} for _ in range(cfg.num_layers)]
    drops = torch.tensor([[False, True, True, False], [True, True, False, False], [False, True, True, True]])
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n, 2, 8)))
    calls, layer_apply = [], layers_lib.layer_apply

    def counted(params_l, cfg_, h, **kw):
        calls.append(kw["devices"])
        return layer_apply(params_l, cfg_, h, **kw)

    monkeypatch.setattr(transformer, "layer_apply", counted)
    logits, aux, _ = transformer.lm_apply(params, cfg, tokens, drops=drops, peft=cohort, lora_scale=2.0, devices=n)
    monkeypatch.setattr(transformer, "layer_apply", layer_apply)
    assert calls == [2, 1, 2]  # layer 1 is dropped by every device
    assert aux == 0.0
    for i in range(n):
        own = tree_map(lambda *xs: torch.stack(xs), *[tree_map(lambda t: t[i], layer) for layer in cohort])
        want, _, _ = transformer.lm_apply(params, cfg, tokens[i], drops=drops[i], peft=own, lora_scale=2.0)
        np.testing.assert_allclose(logits[2 * i:2 * i + 2].numpy(), want.numpy(), atol=1e-6, rtol=0)


# ------------------------------------------------------------- batched == sequential
_QWEN_KW = dict(num_layers=4, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, vocab_size=128, dtype="float32")
_FED = FederatedConfig(num_devices=6, devices_per_round=4, local_steps=2, batch_size=8)
_TRAIN = TrainConfig(learning_rate=5e-3, total_steps=100, warmup_steps=2)


def _runner(mode, arch, method="droppeft"):
    cfg = get_config(arch, smoke=True).replace(**(_QWEN_KW if arch == "qwen3-1.7b" else {"dtype": "float32"}))
    return api.build(method, cfg=cfg, peft_cfg=PEFTConfig(lora_rank=2),
                     stld_cfg=STLDConfig(mode="cond", mean_rate=0.5), fed_cfg=_FED, train_cfg=_TRAIN, seed=3,
                     cohort_mode=mode, device="cpu")


def _tree_close(a, b, atol=1e-5):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize("arch,method,depth", [
    ("qwen3-1.7b", "droppeft", None), ("qwen3-1.7b", "fedadaopt", 2), ("rwkv6-3b", "droppeft", None),
    ("jamba-v0.1-52b", "droppeft", None),
])
def test_batched_cohort_equals_sequential(arch, method, depth):
    """Per-device PEFT trees, metrics, importances and accuracies of one
    cohort, batched against sequential from the same keys; ``depth`` 2 of
    4 layers runs FedAdaOPT's truncation between the round and the
    evaluation."""
    outs = {}
    for mode in ("sequential", "batched"):
        runner = _runner(mode, arch, method)
        assert runner.cohort_mode == mode
        state, num_layers = runner.state, runner.ctx.cfg.num_layers
        cohort, rates = [0, 1, 2, 3], [0.25, 0.5, 0.25, 0.7]
        _, gstep, outs[mode] = runner.ctx.engine.run_cohort(
            state.key, 5, cohort, rates, [state.global_peft] * 4, runner.ctx.num_classes, depth or num_layers)
        assert gstep == 5 + 4 * _FED.local_steps
    for (p_s, m_s, imp_s, acc_s), (p_b, m_b, imp_b, acc_b) in zip(outs["sequential"], outs["batched"]):
        _tree_close(p_s, p_b)
        np.testing.assert_allclose(imp_s, imp_b, atol=1e-4, rtol=1e-4)
        for k in ("loss", "accuracy", "grad_norm", "active_layers"):
            assert float(m_s[k]) == pytest.approx(float(m_b[k]), abs=1e-4)
        assert acc_s == pytest.approx(acc_b, abs=1e-5)
    if depth is not None:  # the truncated layers kept the start tree, in both modes
        start = tree_leaves(_runner("batched", arch, method).state.global_peft)
        for mode in outs:
            for peft_i, *_ in outs[mode]:
                assert all(torch.equal(got[depth:], init[depth:]) for got, init in zip(tree_leaves(peft_i), start))


def test_batched_final_accuracy_runs_in_chunks(monkeypatch):
    """``final_accuracy`` over 6 devices in chunks of ``devices_per_round``
    (4 then 2) equals the sequential mean over the devices."""
    run_s, run_b = _runner("sequential", "qwen3-1.7b"), _runner("batched", "qwen3-1.7b")
    state = run_b.state
    _, _, outs = run_b.ctx.engine.run_cohort(state.key, 0, [1, 4], [0.5, 0.2], [state.global_peft] * 2,
                                             run_b.ctx.num_classes, 4)
    device_peft = {1: outs[0][0], 4: outs[1][0]}
    sizes, evaluate = [], run_b.ctx.engine.client.cohort_evaluate

    def counted(base, peft_stack, tokens, *args):
        sizes.append(len(tokens))
        return evaluate(base, peft_stack, tokens, *args)

    monkeypatch.setattr(run_b.ctx.engine, "client", run_b.ctx.engine.client._replace(cohort_evaluate=counted))
    got = run_b.ctx.engine.final_accuracy(state.global_peft, device_peft, run_b.ctx.num_classes)
    want = run_s.ctx.engine.final_accuracy(state.global_peft, device_peft, run_s.ctx.num_classes)
    assert sizes == [4, 2]
    assert got == pytest.approx(want, abs=1e-5)


def test_cohort_stacking_round_trips_both_layouts():
    """Stacked and per-layer list trees stack on a leading device axis and
    come back as views equal to the inputs."""
    rng = np.random.default_rng(36)
    stacked = [{"q": {"a": torch.from_numpy(rng.standard_normal((4, 8, 2), dtype=np.float32))}} for _ in range(3)]
    listed = [[{"in": {"b": torch.from_numpy(rng.standard_normal((2, 8), dtype=np.float32))}} for _ in range(2)]
              for _ in range(3)]
    for trees, shape in ((stacked, (3, 4, 8, 2)), (listed, (3, 2, 8))):
        cohort = engine_lib.stack_trees(trees)
        assert tree_leaves(cohort)[0].shape == shape
        for got, want in zip(engine_lib.unstack_tree(cohort, 3), trees):
            assert all(torch.equal(x, y) for x, y in zip(tree_leaves(got), tree_leaves(want)))
