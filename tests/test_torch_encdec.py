"""The port's ``audio`` family (whisper-tiny's encoder-decoder) against the
JAX package, on the CPU (the kernels' plain twins), at the smoke size (2
encoder and 2 decoder layers, d 128, 64 frames) in float32.

JAX's weights and LoRA (``b`` moved off zero, so that every path carries a
signal) go to the port through ``repro_torch.convert``; JAX's STLD gates
are handed to the port (its sampler patched), as in
``tests/test_torch_dense_archs.py``; frames and tokens come from numpy
seeds.

Tolerances, each with its reason:
* the attention twin 2e-5 abs (``tests/test_kernels.py``'s float32 bound);
* encoder states, cross K/V and logits 1e-4 abs (float32 sums in another
  order over two stacks and a 512-way head);
* gradients 2e-5 abs + 1e-3 rel (``tests/test_torch_training.py``);
* the PEFT tree after AdamW steps: every element within 2 * (sum of the
  step sizes) + 1e-6, 99% within 1e-6 (AdamW's first steps move an element
  by about lr * sign(g), which may flip for a gradient near 0);
* the federated history as ``tests/_torch_fed_parity.assert_follows_jax``;
* gates, tokens and accuracies exactly.
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
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models import encdec as jax_encdec
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import init_params as jax_init_params
from repro.models.registry import model_apply as jax_model_apply
from repro.nn import attention as jax_attention
from repro.optim import adamw_init as jax_adamw_init
from repro.serving.decode import generate as jax_generate
from repro_torch import convert
from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import stld
from repro_torch.core.peft import init_peft, merge_lora_into_base
from repro_torch.data.synthetic import make_task
from repro_torch.federated.client import make_client_fns
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step, value_and_grad
from repro_torch.models import encdec
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import init_params, model_apply, place_params
from repro_torch.models.stacking import tree_leaves
from repro_torch.optim import adamw_init, make_lr_schedule

from _torch_fed_parity import CFG_KW, FED_KW, assert_follows_jax, jax_run, one_torch_thread, port_run  # noqa: F401

ARCH = "whisper-tiny"
KERNEL_ATOL, ATOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-3
SEQ = 16
_MODELS = {}
_jax_decode = jax.jit(jax_encdec.decode, static_argnums=1)
# JAX's PEFT tree moved off its init (``b`` off zero), jitted: eager, each leaf's
# shape compiles its own ops
_moved_off_init = jax.jit(lambda key, tree: jax.tree.map(lambda x: x + 0.02 * jax.random.normal(key, x.shape), tree))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _flat(tree, prefix=()):
    """(path, leaf) pairs, dict keys sorted: one order for both packages."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _flat(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree) for p in _flat(t, prefix + (i,))]
    return [(prefix, tree)]


def _close_trees(got, want, atol, rtol=0.0):
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32), atol=atol, rtol=rtol, err_msg=str(path))


def _model(method="lora"):
    """JAX's smoke model and a PEFT tree of ``method`` (off its init), and
    the same numbers in the port."""
    if method not in _MODELS:
        key = jax.random.PRNGKey(0)
        jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
        cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
        jparams = jax.jit(jax_init_params, static_argnums=1)(key, jcfg)
        jpeft = jax.jit(jax_peft.init_peft, static_argnums=(1, 2))(jax.random.fold_in(key, 1), jcfg,
                                                                    JaxPEFTConfig(method=method))
        jpeft = _moved_off_init(jax.random.fold_in(key, 2), jpeft)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        peft = convert.peft_from_jax(jax.tree.map(np.asarray, jpeft), "cpu")
        _MODELS[method] = (jcfg, jparams, jpeft, cfg, params, peft)
    return _MODELS[method]


def _frames(cfg, b, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((b, cfg.frontend_seq, cfg.d_model))).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))


# ------------------------------------------------------- the attention twin
@pytest.mark.parametrize("sq,skv,h,kv", [(5, 13, 4, 4), (16, 64, 4, 2), (1, 30, 6, 6)])
def test_attention_plain_with_a_key_length_of_its_own_matches_jax_sdpa(sq, skv, h, kv):
    """``ref.attention_plain`` (what ``ops.flash_attention`` runs on a CPU
    tensor) at S_kv != S_q against the reference's ``_sdpa`` with the
    bidirectional mask of ``cross_attention_apply``."""
    rng = np.random.default_rng(sq * 100 + skv)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, sq, h, 16), (2, skv, kv, 16), (2, skv, kv, 16)))
    bias = jax_attention._mask_bias(jnp.arange(sq), jnp.arange(skv), False, None)
    want = jax_attention._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias)
    got = ops.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=KERNEL_ATOL, rtol=0)
    np.testing.assert_array_equal(got.numpy(), ref.attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                                                   causal=False).numpy())


@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False, "window": 4}])
def test_flash_attention_key_length_of_its_own_is_bidirectional_only(kw):
    q, k = torch.zeros((1, 4, 2, 16)), torch.zeros((1, 6, 2, 16))
    with pytest.raises(ValueError, match="bidirectional only"):
        ops.flash_attention(q, k, k, **kw)


# ------------------------------------------------------------- the model
def test_init_params_and_peft_have_the_jax_layout():
    """The same leaves, shapes and dtypes as JAX's ``init_encdec`` and its
    PEFT trees (LoRA with the ``cross`` group, adapter, BitFit); drawn with
    and without placing each part as it is drawn; placed, the matmul
    weights and learned positions in bf16 and the LayerNorms float32."""
    jcfg, jparams, _, cfg, _, _ = _model()
    shapes = lambda tree: [(p, tuple(np.shape(x)), str(np.asarray(x).dtype) if not isinstance(x, torch.Tensor)
                            else str(x.dtype).replace("torch.", "")) for p, x in _flat(tree)]
    drawn = init_params(cfg, torch.Generator().manual_seed(0))
    assert shapes(drawn) == shapes(jax.tree.map(np.asarray, jparams))
    placed = init_params(cfg.replace(dtype="bfloat16"), torch.Generator().manual_seed(0), place=True)
    by_path = dict(_flat(placed))
    assert by_path[("decoder", "pos_embed")].dtype == torch.bfloat16
    assert by_path[("encoder", "layers", "mlp", "up", "b")].dtype == torch.bfloat16
    assert by_path[("decoder", "layers", "norm_cross", "bias")].dtype == torch.float32
    for a, b in zip(tree_leaves(place_params(drawn, cfg.replace(dtype="bfloat16"), "cpu")), tree_leaves(placed)):
        assert torch.equal(a, b)
    for method in ("lora", "adapter", "bitfit"):
        want = jax.tree.map(np.asarray, _model(method)[2])  # JAX's init_peft tree (moved off its init)
        got = init_peft(cfg, PEFTConfig(method=method), torch.Generator().manual_seed(1))
        assert shapes(got) == shapes(want), method
    assert ("cross", "q", "a") in dict(_flat(init_peft(cfg, PEFTConfig(), torch.Generator())))


def test_encode_cross_kvs_and_decode_match_jax():
    jcfg, jparams, jpeft, cfg, params, peft = _model()
    frames, toks = _frames(cfg, 2, 1), _tokens(cfg, 2, SEQ, 2)
    jenc = jax.jit(jax_encdec.encode, static_argnums=1)(jparams, jcfg, jnp.asarray(frames))
    enc = encdec.encode(params, cfg, torch.from_numpy(frames))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), atol=ATOL, rtol=0)
    jkv = jax.jit(jax_encdec.encoder_cross_kvs, static_argnums=1)(jparams, jcfg, jenc)
    kvs = encdec.encoder_cross_kvs(params, cfg, enc)
    assert len(kvs) == cfg.num_layers
    for l, kv in enumerate(kvs):
        for name in ("k", "v"):
            np.testing.assert_allclose(kv[name].numpy(), np.asarray(jkv[name][l]), atol=ATOL, rtol=0)
    want, _, _ = _jax_decode(jparams, jcfg, jnp.asarray(toks), jkv, drops=jnp.asarray([True, False]), peft=jpeft,
                             lora_scale=2.0)
    got, _, _ = encdec.decode(params, cfg, torch.from_numpy(toks), kvs, drops=[True, False], peft=peft,
                              lora_scale=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    # float32 sin and cos of arguments up to 49, whose ulp is 3.8e-6
    np.testing.assert_allclose(_np(encdec.sinusoidal_positions(50, 128)),
                               np.asarray(jax_encdec.sinusoidal_positions(50, 128)), atol=8e-6, rtol=0)


@pytest.mark.parametrize("drops", [None, [False, True]])
def test_model_apply_logits_match_jax(drops):
    jcfg, jparams, jpeft, cfg, params, peft = _model()
    frames, toks = _frames(cfg, 2, 3), _tokens(cfg, 2, SEQ, 4)
    jd = None if drops is None else jnp.asarray(drops)
    want, _, _ = jax.jit(lambda p, pf, b: jax_model_apply(p, jcfg, b, drops=jd, peft=pf, lora_scale=2.0))(
        jparams, jpeft, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    got, aux, _ = model_apply(params, cfg, {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames)},
                              drops=drops, peft=peft, lora_scale=2.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert aux == 0.0


@pytest.mark.parametrize("method", ["lora", "adapter", "bitfit"])
def test_peft_grads_match_jax_value_and_grad(method):
    """The gradient of every PEFT leaf: LoRA's self and cross groups (the
    cross ``v`` LoRA is never read, so its gradient is zero in both),
    the adapters, the BitFit biases."""
    jcfg, jparams, jpeft, cfg, params, peft = _model(method)
    task = make_task(vocab_size=cfg.vocab_size, seq_len=SEQ, num_examples=4, seed=5)
    batch = task.lm_batch(np.arange(2))
    frames = _frames(cfg, 2, 6)

    def jloss(pf):
        logits, _, _ = jax_model_apply(jparams, jcfg, {"tokens": jnp.asarray(batch["tokens"]),
                                                       "frames": jnp.asarray(frames)}, peft=pf, lora_scale=2.0)
        return jax_softmax_xent(logits, jnp.asarray(batch["targets"]), jnp.asarray(batch["mask"]))

    (jl, _), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jpeft)

    def tloss(pf):
        logits, _, _ = model_apply(params, cfg, {"tokens": torch.from_numpy(batch["tokens"]),
                                                 "frames": torch.from_numpy(frames)}, peft=pf, lora_scale=2.0)
        return softmax_xent(logits, torch.from_numpy(batch["targets"]), torch.from_numpy(batch["mask"]))

    (tl, _), tgrads = value_and_grad(tloss)(peft)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    _close_trees(tgrads, jgrads, atol=GRAD_ATOL, rtol=GRAD_RTOL)
    if method == "lora":
        assert float(tgrads["cross"]["v"]["a"].abs().max()) == 0.0 == float(tgrads["cross"]["v"]["b"].abs().max())
        assert float(tgrads["cross"]["q"]["b"].abs().max()) > 0.0


# ---------------------------------------------------- training, federation
def _jax_gates(rates, seed, steps):
    rng, gates = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        rng, kd = jax.random.split(rng)
        gates.append(np.asarray(jax_stld.sample_drops(kd, rates, 1)))
    return gates


def test_local_round_with_jax_gates_matches_jax(monkeypatch):
    """Two cond-mode local steps of batch 4 with JAX's gates, then
    ``evaluate``: metrics, importances, the LoRA tree and the accuracy."""
    jcfg, jparams, jpeft, cfg, params, peft = _model()
    task = make_task(vocab_size=cfg.vocab_size, seq_len=SEQ, num_examples=16, seed=3)
    seed, mean_rate, steps = 7, 0.5, 2
    rates = jnp.clip(jax_unit_shape("incremental", cfg.num_layers) * mean_rate, 0.0, 0.95)
    gates = _jax_gates(rates, seed, steps)
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
    diffs = np.concatenate([np.abs(_np(a) - np.asarray(b)).ravel() for (_, a), (_, b) in zip(_flat(tp), _flat(jp))])
    assert diffs.max() <= 2 * (sched(3) + sched(4)) + 1e-6 and np.mean(diffs <= 1e-6) >= 0.99
    toks, labels = task.tokens[8:16], task.labels[8:16]
    want = jfns.evaluate(jparams, jp, jnp.asarray(toks), jnp.asarray(labels), jnp.arange(task.num_classes))
    assert float(fns.evaluate(params, tp, toks, labels, np.arange(task.num_classes))) == float(want)


def test_gather_mode_drops_no_decoder_layer():
    """The reference's registry maps ``gather`` to ``unroll`` on an
    encoder-decoder and drops ``active_idx`` (its client passes no gates
    then), so every decoder layer runs; the port does the same."""
    jcfg, jparams, jpeft, cfg, params, peft = _model()
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, SEQ, 8)), "frames": torch.from_numpy(_frames(cfg, 2, 9))}
    full, _, _ = model_apply(params, cfg, batch, peft=peft, lora_scale=2.0)
    gathered, _, _ = model_apply(params, cfg, batch, peft=peft, lora_scale=2.0, stack_mode="gather",
                                 drops=[True, False], active_idx=torch.tensor([1]))
    assert torch.equal(gathered, full)
    want, _, _ = jax.jit(lambda p, pf, b: jax_model_apply(p, jcfg, b, peft=pf, lora_scale=2.0, stack_mode="gather",
                                                          active_idx=jnp.asarray([1])))(
        jparams, jpeft, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    np.testing.assert_allclose(gathered.numpy(), np.asarray(want), atol=ATOL, rtol=0)


WHISPER_KW = dict(CFG_KW, num_layers=2, num_encoder_layers=1, frontend_seq=8)
WHISPER_FED_KW = dict(FED_KW, local_steps=1, batch_size=4)


def test_api_build_two_rounds_follow_jax(monkeypatch):
    """Two droppeft rounds through ``api.build``, the port's batched cohort
    (a layer that some devices drop takes the others' rows of the cross
    K/V) against the reference's sequential run on JAX's key stream."""
    want = jax_run("droppeft", 2, arch=ARCH, cfg_kw=WHISPER_KW, fed_kw=WHISPER_FED_KW)
    got = port_run(monkeypatch, "droppeft", 2, want["base"], want["peft0"], arch=ARCH, cfg_kw=WHISPER_KW,
                   fed_kw=WHISPER_FED_KW)
    assert_follows_jax(got, want, fed_kw=WHISPER_FED_KW, rounds=2)
    assert any(len(set(d["active"])) > 1 for d in got["rec"]["dispatch"])  # some layer ran on some devices only
    assert "cross" in got["runner"].state.global_peft


# ------------------------------------------------------------- serving
def test_decode_matches_the_full_forward():
    """A prompt of 6 through ``make_prefill_step``, then 6 tokens one at a
    time through ``make_serve_step`` with the prefill's cross K/V: the
    logits of every position against ``model_apply`` over all 12, as
    ``tests/test_decode_consistency.py`` holds the reference."""
    _, _, _, cfg, params, _ = _model()
    frames, toks = torch.from_numpy(_frames(cfg, 2, 10)), torch.from_numpy(_tokens(cfg, 2, 12, 11))
    full, _, _ = model_apply(params, cfg, {"tokens": toks, "frames": frames})
    caches = encdec.init_decoder_caches(cfg, 2, 32, dtype=torch.float32)
    last, caches, enc_kvs = make_prefill_step(cfg)(params, {"tokens": toks[:, :6], "frames": frames}, caches)
    step, got = make_serve_step(cfg), [last]
    for t in range(6, 12):
        logits, _, caches = step(params, toks[:, t:t + 1], t, caches, enc_kvs)
        got.append(logits)
    np.testing.assert_allclose(torch.stack(got, dim=1).numpy(), full[:, 5:].numpy(), atol=2e-4, rtol=0)
    # without the cross K/V the decoder skips cross-attention: other logits
    skipped, _, _ = step(params, toks[:, 11:12], 11, caches)
    assert float((skipped - got[-1]).abs().max()) > 1e-3


def test_prefill_and_generate_match_jax():
    """``prefill_and_generate`` against the reference's prefill and
    ``generate`` (frames from a seed), the tokens exactly; and ``generate``
    against a hand-rolled ``serve_step`` loop."""
    jcfg, jparams, _, cfg, params, _ = _model()
    prompt, frames = _tokens(cfg, 2, 7, 12), _frames(cfg, 2, 13)
    caches = jax_encdec.init_decoder_caches(jcfg, 2, 12, dtype=jnp.float32)
    last, caches, jkv = jax.jit(jax_make_prefill_step(jcfg))(
        jparams, {"tokens": jnp.asarray(prompt), "frames": jnp.asarray(frames)}, caches)
    first = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
    want = np.asarray(jax_generate(jax.jit(jax_make_serve_step(jcfg)), jparams, caches, first, 7, 5, enc_kvs=jkv)[0])
    out = serve.prefill_and_generate(cfg, params, prompt, 5, "cpu", frontend=torch.from_numpy(frames))
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    step, tok, manual, caches = make_serve_step(cfg), out["first"], [], None
    caches = encdec.init_decoder_caches(cfg, 2, 12, dtype=torch.float32)
    _, caches, enc_kvs = make_prefill_step(cfg)(params, {"tokens": prompt, "frames": torch.from_numpy(frames)}, caches)
    for i in range(5):
        _, tok, caches = step(params, tok, 7 + i, caches, enc_kvs)
        manual.append(tok[:, 0])
    assert torch.equal(torch.stack(manual, dim=1), out["tokens"])


def test_serve_cli_runs_and_merge_lora_raises(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen-len", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"arch={ARCH}-smoke batch=2 prompt=6 gen=3"
    assert lines[2].startswith("sample tokens: [") and len(eval(lines[2].split(": ", 1)[1])) == 3
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--merge-lora"])


def test_merge_lora_skips_cross():
    """``merge_lora_into_base`` over the decoder's layers folds the self
    attention's LoRA and leaves the cross-attention's weights as they are,
    as the reference's merge does."""
    _, _, _, cfg, params, peft = _model()
    layers = params["decoder"]["layers"]
    merged = merge_lora_into_base(layers, peft, 2.0)
    assert torch.equal(merged["cross"]["wq"]["w"], layers["cross"]["wq"]["w"])
    want = layers["attn"]["wq"]["w"] + 2.0 * peft["attn"]["q"]["a"] @ peft["attn"]["q"]["b"]
    assert torch.equal(merged["attn"]["wq"]["w"], want)
