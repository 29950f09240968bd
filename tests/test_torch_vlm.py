"""The port's ``vlm`` family (internvl2-76b: a dense decoder behind a
prefix of patch embeddings, the vision frontend a stub) against the JAX
package, on the CPU (the kernels' plain twins), at the smoke size (2
layers, d 128, 16 patches) in float32.

JAX's weights and LoRA (``b`` moved off zero) go to the port through
``repro_torch.convert``; JAX's STLD gates are handed to the port; patches
and tokens come from numpy seeds.

Tolerances: logits 1e-4 abs (float32 sums in another order over 2 layers
and a 512-way head); loss and metrics 1e-5 rel; the PEFT tree after AdamW
steps every element within 2 * (sum of the step sizes) + 1e-6 and 99%
within 1e-6 (``tests/test_torch_training.py``); gates, tokens and
accuracies exactly.
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
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.registry import init_params as jax_init_params
from repro.models.registry import model_apply as jax_model_apply
from repro.models.transformer import init_caches as jax_init_caches
from repro.optim import adamw_init as jax_adamw_init
from repro.serving.decode import generate as jax_generate
from repro_torch import api, convert
from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import stld
from repro_torch.data.synthetic import make_task
from repro_torch.federated.client import make_client_fns
from repro_torch.launch import serve
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import model_apply
from repro_torch.models.transformer import init_caches
from repro_torch.optim import adamw_init, make_lr_schedule
from repro_torch.serving.batcher import Request

from _torch_fed_parity import one_torch_thread  # noqa: F401

ARCH = "internvl2-76b"
ATOL = 1e-4
SEQ = 12
_MODEL = {}
# JAX's PEFT tree moved off its init (``b`` off zero), jitted: eager, each leaf's
# shape compiles its own ops
_moved_off_init = jax.jit(lambda key, tree: jax.tree.map(lambda x: x + 0.02 * jax.random.normal(key, x.shape), tree))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _leaves(tree):
    """Leaves, dict keys sorted: one order for both packages."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _model():
    if not _MODEL:
        key = jax.random.PRNGKey(0)
        jcfg = jax_get_config(ARCH, smoke=True).replace(dtype="float32")
        cfg = get_config(ARCH, smoke=True).replace(dtype="float32")
        jparams = jax.jit(jax_init_params, static_argnums=1)(key, jcfg)
        jpeft = jax.jit(jax_peft.init_peft, static_argnums=(1, 2))(jax.random.fold_in(key, 1), jcfg, JaxPEFTConfig())
        jpeft = _moved_off_init(jax.random.fold_in(key, 2), jpeft)
        _MODEL.update(jcfg=jcfg, jparams=jparams, jpeft=jpeft, cfg=cfg,
                      params=convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
                      peft=convert.peft_from_jax(jax.tree.map(np.asarray, jpeft), "cpu"))
    m = _MODEL
    return m["jcfg"], m["jparams"], m["jpeft"], m["cfg"], m["params"], m["peft"]


def _patches(cfg, b, seed):
    return (0.1 * np.random.default_rng(seed).standard_normal((b, cfg.frontend_seq, cfg.d_model))).astype(np.float32)


def _close_after_adamw(got, want, steps):
    sched = make_lr_schedule("cosine", 2e-4, 20, 1000)
    diffs = np.concatenate([np.abs(_np(a) - np.asarray(b)).ravel() for a, b in zip(_leaves(got), _leaves(want))])
    assert diffs.max() <= 2 * sum(sched(s) for s in steps) + 1e-6 and np.mean(diffs <= 1e-6) >= 0.99


@pytest.mark.parametrize("drops", [None, [True, False]])
def test_logits_with_patches_match_jax(drops):
    """The patch prefix at positions 0 .. P-1, the tokens after it: the
    logits of every position (prefix included) against the reference's."""
    jcfg, jparams, jpeft, cfg, params, peft = _model()
    toks, patches = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, SEQ)), _patches(cfg, 2, 2)
    jd = None if drops is None else jnp.asarray(drops)
    want, _, _ = jax.jit(lambda p, pf, b: jax_model_apply(p, jcfg, b, drops=jd, peft=pf, lora_scale=2.0))(
        jparams, jpeft, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)})
    got, _, _ = model_apply(params, cfg, {"tokens": torch.from_numpy(toks), "patches": torch.from_numpy(patches)},
                            drops=drops, peft=peft, lora_scale=2.0)
    assert got.shape == (2, cfg.frontend_seq + SEQ, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_train_step_strips_the_prefix_and_matches_jax():
    """``make_train_step`` (STLD off) on tokens with patches: the loss over
    the token positions alone, and the PEFT tree after the AdamW step, as
    the reference's step."""
    jcfg, jparams, jpeft, cfg, params, peft = _model()
    tokens, patches = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, SEQ + 1)), _patches(cfg, 2, 4)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxPEFTConfig(), JaxTrainConfig()))
    jp, _, jm = jstep(jparams, jpeft, jax_adamw_init(jpeft), {"tokens": jnp.asarray(tokens),
                                                              "patches": jnp.asarray(patches)}, jax.random.PRNGKey(0))
    step = make_train_step(cfg, PEFTConfig(), TrainConfig())
    tp, _, tm = step(params, peft, adamw_init(peft), {"tokens": tokens, "patches": patches},
                     torch.Generator().manual_seed(0))
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(_np(tm[k]), np.asarray(jm[k]), rtol=1e-5, err_msg=k)
    _close_after_adamw(tp, jp, [0])


def test_local_round_with_zero_patches_and_jax_gates_matches_jax(monkeypatch):
    """Two cond-mode local steps (the client's zero patches, the prefix
    stripped) with JAX's gates, then ``evaluate``."""
    jcfg, jparams, jpeft, cfg, params, peft = _model()
    task = make_task(vocab_size=cfg.vocab_size, seq_len=SEQ, num_examples=16, seed=3)
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
    _close_after_adamw(tp, jp, [3, 4])
    toks, labels = task.tokens[8:16], task.labels[8:16]
    want = jfns.evaluate(jparams, jp, jnp.asarray(toks), jnp.asarray(labels), jnp.arange(task.num_classes))
    assert float(fns.evaluate(params, tp, toks, labels, np.arange(task.num_classes))) == float(want)


def test_prefill_and_generate_with_the_prefix_in_the_cache_match_jax():
    """``prefill_and_generate`` with patches from a seed against the
    reference's CLI path: caches ``frontend_seq`` slots longer, the decode
    starting at P + S; the tokens exactly, and the patches matter."""
    jcfg, jparams, _, cfg, params, _ = _model()
    prompt, patches = serve.random_prompts(cfg, 2, 7, 5), _patches(cfg, 2, 6)
    p = cfg.frontend_seq
    caches = jax_init_caches(jcfg, 2, p + 12, dtype=jnp.float32)
    last, caches = jax.jit(jax_make_prefill_step(jcfg))(jparams, {"tokens": jnp.asarray(prompt),
                                                                  "patches": jnp.asarray(patches)}, caches)
    first = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
    want = np.asarray(jax_generate(jax.jit(jax_make_serve_step(jcfg)), jparams, caches, first, p + 7, 5)[0])
    out = serve.prefill_and_generate(cfg, params, prompt, 5, "cpu", frontend=torch.from_numpy(patches))
    np.testing.assert_array_equal(out["tokens"].numpy(), want)
    assert out["caches"][0]["k"].shape[1] == p + 12 and int(out["caches"][0]["pos"]) == p + 12
    np.testing.assert_allclose(_np(out["last_logits"]), np.asarray(last), atol=ATOL, rtol=0)
    zero = serve.prefill_and_generate(cfg, params, prompt, 5, "cpu")  # the CLI's zero patches
    assert float((zero["last_logits"] - out["last_logits"]).abs().max()) > 1e-3
    assert init_caches(cfg, 2, 4)[0]["k"].shape == (2, 4, cfg.num_kv_heads, cfg.resolved_head_dim)


def test_api_serve_serves_text_prompts():
    """``api.serve`` takes the ``vlm`` family and serves text prompts with
    no patches, as the reference's batcher: every request completes with
    its budget of tokens."""
    _, _, _, cfg, params, peft = _model()
    batcher = api.serve(cfg=cfg, params=params, adapters={"t0": peft}, batch=2, max_len=16, cache_dtype="float32",
                        device="cpu")
    for j, prompt in enumerate(([5, 7, 11], [13, 17], [19, 23, 29])):
        batcher.submit(Request(prompt=prompt, adapter="t0", max_new_tokens=3, uid=j))
    done = batcher.run()
    assert sorted(c.uid for c in done) == [0, 1, 2] and all(len(c.tokens) == 3 for c in done)


def test_serve_cli_runs_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen-len", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"arch={ARCH}-smoke batch=2 prompt=6 gen=3"
    assert lines[2].startswith("sample tokens: [") and len(eval(lines[2].split(": ", 1)[1])) == 3
