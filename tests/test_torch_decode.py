"""The port's decode path against the JAX package, on the CPU (the kernels'
plain twins), at the smoke size with 2 layers in float32: the RWKV6 and
Mamba decode states, ``mamba_scan`` from an entering state, the MoE weight
gather, the scalar-position KV cache, ``init_caches`` in both layouts,
``make_prefill_step``, ``generate`` and the ``launch.serve`` CLI.

The JAX params go through ``repro_torch.convert``; inputs and states are
made with numpy and handed to both frameworks.  jamba runs at
``capacity_factor`` 8.0, as ``tests/test_decode_consistency.py`` runs it,
so that the cache-free forward drops no token that decode keeps.

Tolerances, each with its reason: the blocks, the states and the logits
1e-4 abs (float32 sums in another order; the Mamba block against JAX's
associative and ``lax.scan`` forms); the scan's twin against
``mamba_scan_ref`` 2e-5 abs + 1e-2 rel (``tests/test_kernels.py``'s
sweep); tokens, positions, shapes and dtypes exactly; the aux loss of the
weight gather exactly 0.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.configs import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro.launch.steps import make_prefill_step as jax_make_prefill_step
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro.models.registry import init_params as jax_init_params
from repro.models.transformer import init_caches as jax_init_caches
from repro.models.transformer import lm_apply as jax_lm_apply
from repro.nn import attention as jax_attention
from repro.nn import mamba as jax_mamba
from repro.nn import moe as jax_moe
from repro.nn import rwkv as jax_rwkv
from repro.serving.decode import generate as jax_generate
from repro_torch import api, convert
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.launch import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models.stacking import layer_view
from repro_torch.models.transformer import init_caches, lm_apply
from repro_torch.nn import attention, mamba, moe, rwkv
from repro_torch.serving.decode import generate

ATOL = 1e-4
_MODELS = {}
# the reference's functions, jitted with the config static: one XLA program
# a shape compiles faster than the eager ops one by one
_jax_lm_apply = jax.jit(jax_lm_apply, static_argnums=1)
_jax_attention_apply = jax.jit(jax_attention.attention_apply, static_argnums=1)
_jax_mamba_apply = jax.jit(jax_mamba.mamba_apply, static_argnums=1)
_jax_time_mix_apply = jax.jit(jax_rwkv.time_mix_apply, static_argnums=1)
_jax_moe_apply = jax.jit(jax_moe.moe_apply, static_argnums=(1, 3, 4))


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _model(arch):
    """(jcfg, jparams, cfg, params) at the smoke size, 2 layers, float32."""
    if arch not in _MODELS:
        kw = {"num_layers": 2, "dtype": "float32"}
        if arch == "jamba-v0.1-52b":
            kw["capacity_factor"] = 8.0
        jcfg = jax_get_config(arch, smoke=True).replace(**kw)
        jparams = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
        cfg = get_config(arch, smoke=True).replace(**kw)
        params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
        _MODELS[arch] = (jcfg, jparams, cfg, params)
    return _MODELS[arch]


def _close_states(got, want, atol=ATOL):
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(_np(got[name]), np.asarray(want[name], np.float32), atol=atol, rtol=0,
                                   err_msg=name)
        assert got[name].dtype == torch.float32


# ------------------------------------------------------------- Mamba
def _mamba_state(rng, cfg, b):
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    return {"conv": rng.standard_normal((b, m.d_conv - 1, d_in), dtype=np.float32),
            "ssm": 0.5 * rng.standard_normal((b, d_in, m.d_state), dtype=np.float32)}


@pytest.mark.parametrize("s", [1, 5])
def test_mamba_apply_with_state_matches_jax(s):
    """The Mamba block from a carried state (the one-token step and a short
    chunk) against ``repro.nn.mamba.mamba_apply``: out, conv and ssm."""
    jcfg, jparams, cfg, params = _model("jamba-v0.1-52b")
    rng = np.random.default_rng(60 + s)
    x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
    state = _mamba_state(rng, cfg, 2)
    want, want_state = _jax_mamba_apply(jparams["layers"][0]["mamba"], jcfg, jnp.asarray(x),
                                        state=jax.tree.map(jnp.asarray, state))
    got, got_state = mamba.mamba_apply(params["layers"][0]["mamba"], cfg, _t(x),
                                       state={k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)
    _close_states(got_state, want_state)


def test_init_mamba_and_rwkv_states_match_jax():
    for arch, jax_init, init in (("jamba-v0.1-52b", jax_mamba.init_mamba_state, mamba.init_mamba_state),
                                 ("rwkv6-3b", jax_rwkv.init_rwkv_state, rwkv.init_rwkv_state)):
        jcfg, _, cfg, _ = _model(arch)
        want, got = jax_init(jcfg, 3), init(cfg, 3)
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == \
               {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in got.items()}
        assert all(not v.any() for v in got.values())


@pytest.mark.parametrize("s", [1, 9])
def test_mamba_scan_plain_from_h0_matches_jax_ref(s):
    """``ref.mamba_scan_plain`` from ``h0``: a prefix's final state is the
    entering state of the rest, whose y must be ``mamba_scan_ref``'s over
    the whole sequence from zero; ``ops.mamba_scan``'s CPU path the same,
    and its backward raises with an ``h0``."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(70 + s)
    b, pre, d, n = 2, 7, 24, 8
    dt = np.log1p(np.exp(rng.standard_normal((b, pre + s, d), dtype=np.float32)))
    x, bm, cm = (rng.standard_normal(shape, dtype=np.float32) for shape in ((b, pre + s, d), (b, pre + s, n),
                                                                           (b, pre + s, n)))
    a = -np.exp(rng.standard_normal((d, n), dtype=np.float32))
    dv = rng.standard_normal((d,), dtype=np.float32)
    want = np.asarray(jax_ref.mamba_scan_ref(*(jnp.asarray(v) for v in (dt, x, bm, cm, a, dv))))
    _, h0 = ref.mamba_scan_plain(*(_t(v[:, :pre]) for v in (dt, x, bm, cm)), _t(a), _t(dv))
    rest = [_t(v[:, pre:]) for v in (dt, x, bm, cm)]
    y, _ = ref.mamba_scan_plain(*rest, _t(a), _t(dv), h0)
    np.testing.assert_allclose(_np(y), want[:, pre:], atol=2e-5, rtol=1e-2)
    leaves = [t.clone().requires_grad_(True) for t in rest]
    y2, st2 = ops.mamba_scan(*leaves, _t(a), _t(dv), h0)
    assert torch.equal(y2.detach(), y) and st2.dtype == torch.float32
    with pytest.raises(NotImplementedError):
        y2.sum().backward()


# -------------------------------------------------------------- RWKV6
def test_time_mix_decode_step_matches_jax():
    """The one-token time-mix (the ``wkv6`` path at S = 1 from the state)
    against the reference's ``_wkv_step`` branch: out, wkv and shift_tm."""
    jcfg, jparams, cfg, params = _model("rwkv6-3b")
    rng = np.random.default_rng(80)
    hd = cfg.rwkv.head_dim
    x = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
    state = {"wkv": 0.3 * rng.standard_normal((3, cfg.d_model // hd, hd, hd), dtype=np.float32),
             "shift_tm": rng.standard_normal((3, cfg.d_model), dtype=np.float32)}
    jl = jax.tree.map(lambda v: v[0], jparams["layers"])["time_mix"]
    want, want_state = _jax_time_mix_apply(jl, jcfg, jnp.asarray(x), state=jax.tree.map(jnp.asarray, state))
    got, got_state = rwkv.time_mix_apply(layer_view(params["layers"], 0)["time_mix"], cfg, _t(x),
                                         state={k: _t(v) for k, v in state.items()})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)
    _close_states(got_state, want_state)


# ---------------------------------------------------------------- MoE
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (4, 2)])
def test_moe_weight_gather_matches_jax(shape):
    """At most 8 tokens (1, 2 and 8 here) take the weight gather, as the
    reference's ``moe_apply``: out within 1e-4, aux exactly 0; with
    ``einsum_forced`` both run the einsum dispatch."""
    jcfg, jparams, cfg, params = _model("jamba-v0.1-52b")
    x = np.random.default_rng(90 + shape[0]).standard_normal((*shape, cfg.d_model), dtype=np.float32)
    jp, tp = jparams["layers"][1]["moe"], params["layers"][1]["moe"]
    for mode in (None, "einsum_forced"):
        want, want_aux = _jax_moe_apply(jp, jcfg, jnp.asarray(x), None, mode)
        got, got_aux = moe.moe_apply(tp, cfg, _t(x), dispatch_mode=mode)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)
        np.testing.assert_allclose(_np(got_aux), np.asarray(want_aux), rtol=1e-5)
        if mode is None:
            assert float(got_aux) == 0.0 and got_aux.dtype == torch.float32
    gathered = moe._moe_weight_gather(tp, cfg, _t(x))
    assert torch.equal(gathered, moe.moe_apply(tp, cfg, _t(x))[0])


# ------------------------------------------- the scalar-position cache
@pytest.mark.parametrize("arch,writes,max_len", [
    ("qwen3-1.7b", [6, 3, 1, 1], 16),  # a prefill, a second write at pos > 0, single tokens
    ("h2o-danube-1.8b", [70, 1, 2], 80),  # a prefill past the smoke window of 64, then the ring wraps
])
def test_scalar_pos_attention_matches_jax(arch, writes, max_len):
    """``attention_apply`` with the scalar-position cache, write after
    write, against the reference's: out, the ring's K and V, pos."""
    jcfg, jparams, cfg, params = _model(arch)
    jl = jax.tree.map(lambda v: v[0], jparams["layers"])["attn"]
    tl = layer_view(params["layers"], 0)["attn"]
    jcache = jax_init_caches(jcfg, 2, max_len, dtype=jnp.float32)[0]
    cache = init_caches(cfg, 2, max_len, dtype=torch.float32)[0]
    assert cache["k"].shape[1] == min(max_len, cfg.sliding_window or max_len)
    rng, pos = np.random.default_rng(100), 0
    for s in writes:
        x = rng.standard_normal((2, s, cfg.d_model), dtype=np.float32)
        positions = np.arange(pos, pos + s)
        want, jcache = _jax_attention_apply(jl, jcfg, jnp.asarray(x), jnp.asarray(positions), cache=jcache)
        got, cache = attention.attention_apply(tl, cfg, _t(x), torch.from_numpy(positions), cache=cache)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0, err_msg=f"write of {s} at {pos}")
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]), atol=ATOL, rtol=0)
        pos += s
        assert int(cache["pos"]) == int(jcache["pos"]) == pos and cache["pos"].device.type == "cpu"


def test_scalar_pos_write_may_not_wrap():
    _, _, cfg, params = _model("qwen3-1.7b")
    cache = init_caches(cfg, 1, 8, dtype=torch.float32)[0]
    cache["pos"] += 6
    with pytest.raises(ValueError, match="wrap"):
        attention.attention_apply(layer_view(params["layers"], 0)["attn"], cfg, torch.zeros(1, 3, cfg.d_model),
                                  torch.arange(6, 9), cache=cache)


# --------------------------------------------------------- init_caches
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("layout", ["list", "stacked"])
def test_init_caches_match_jax(arch, layout):
    """Shapes and dtypes of every leaf in both layouts (a heterogeneous
    stack has no stacked layout, in either package)."""
    jcfg, _, cfg, _ = _model(arch)
    if layout == "stacked" and arch == "jamba-v0.1-52b":
        with pytest.raises(ValueError):
            init_caches(cfg, 2, 24, dtype=torch.bfloat16, layout=layout)
        return
    want = jax_init_caches(jcfg, 2, 24, dtype=jnp.bfloat16, layout=layout)
    got = init_caches(cfg, 2, 24, dtype=torch.bfloat16, layout=layout)

    def sig(tree, name):
        return {k: (tuple(v.shape), name(v.dtype)) for k, v in tree.items()}

    def jname(d):
        return str(jnp.dtype(d))

    def tname(d):
        return str(d).replace("torch.", "")

    if layout == "list":
        assert [sig(c, tname) for c in got] == [sig(c, jname) for c in want]
    else:
        assert sig(got, tname) == sig(want, jname)


# ------------------------------------------- decode against the reference
def _jax_decode_all(jcfg, jparams, toks, max_len, prefill_len):
    """``tests/test_decode_consistency.py``'s ``_decode_all``: the prompt,
    then one token at a time."""
    caches = jax_init_caches(jcfg, toks.shape[0], max_len, dtype=jnp.float32)
    lp, _, caches = _jax_lm_apply(jparams, jcfg, toks[:, :prefill_len], caches=caches)
    outs = [lp[:, i] for i in range(prefill_len)]
    for t in range(prefill_len, toks.shape[1]):
        lt, _, caches = _jax_lm_apply(jparams, jcfg, toks[:, t : t + 1], positions=jnp.array([t]), caches=caches)
        outs.append(lt[:, 0])
    return np.asarray(jnp.stack(outs, axis=1))


def _decode_all(cfg, params, toks, max_len, prefill_len, layout="list", drops=None):
    caches = init_caches(cfg, toks.shape[0], max_len, dtype=torch.float32, layout=layout)
    lp, _, caches = lm_apply(params, cfg, toks[:, :prefill_len], caches=caches, drops=drops)
    outs = [lp[:, i] for i in range(prefill_len)]
    for t in range(prefill_len, toks.shape[1]):
        lt, _, caches = lm_apply(params, cfg, toks[:, t : t + 1], positions=torch.tensor([t]), caches=caches,
                                 drops=drops)
        outs.append(lt[:, 0])
    return torch.stack(outs, dim=1), caches


@pytest.mark.parametrize("arch,layout", [("qwen3-1.7b", "stacked"), ("qwen3-1.7b", "list"), ("yi-6b", "list"),
                                         ("rwkv6-3b", "stacked"), ("rwkv6-3b", "list"),
                                         ("jamba-v0.1-52b", "list")])
def test_decode_all_matches_jax(arch, layout):
    """Prefill 6 tokens, then decode 6 one at a time: the logits of every
    position against the reference's ``_decode_all``, in both cache
    layouts where the stack is homogeneous."""
    jcfg, jparams, cfg, params = _model(arch)
    toks = np.random.default_rng(110).integers(0, cfg.vocab_size, (2, 12))
    want = _jax_decode_all(jcfg, jparams, jnp.asarray(toks), 32, 6)
    with torch.no_grad():
        got, _ = _decode_all(cfg, params, torch.from_numpy(toks), 32, 6, layout)
    np.testing.assert_allclose(_np(got), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b"])
def test_dropped_layer_passes_its_cache_through(arch):
    """A dropped layer leaves its cache as it was, in both layouts, and
    the logits match the reference's gated decode."""
    jcfg, jparams, cfg, params = _model(arch)
    toks = np.random.default_rng(111).integers(0, cfg.vocab_size, (2, 8))
    caches = jax_init_caches(jcfg, 2, 16, dtype=jnp.float32)
    jd = jnp.asarray([False, True])
    want, _, _ = _jax_lm_apply(jparams, jcfg, jnp.asarray(toks), caches=caches, drops=jd)
    for layout in ("list", "stacked"):
        with torch.no_grad():
            got, caches_got = _decode_all(cfg, params, torch.from_numpy(toks), 16, 8, layout, drops=[False, True])
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL, rtol=0)
        fresh = init_caches(cfg, 2, 16, dtype=torch.float32, layout="list")
        dropped = caches_got[1] if layout == "list" else layer_view(caches_got, 1)
        assert all(torch.equal(dropped[k].cpu(), fresh[1][k]) for k in fresh[1])


# --------------------------------------------- prefill + generate, the CLI
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b"])
def test_prefill_and_generate_match_jax(arch):
    """``make_prefill_step`` then ``generate`` against the reference's, the
    tokens exactly: the unconditional loop, and the loop with an
    ``eos_id`` (a token the first loop emits) and per-row
    ``max_new_tokens``; and ``generate`` against a hand-rolled
    ``serve_step`` loop."""
    jcfg, jparams, cfg, params = _model(arch)
    prompt = np.random.default_rng(120).integers(0, cfg.vocab_size, (2, 7))
    jprefill, jserve = jax.jit(jax_make_prefill_step(jcfg)), jax.jit(jax_make_serve_step(jcfg))
    prefill, step = make_prefill_step(cfg), make_serve_step(cfg)

    def run_jax(**kw):
        caches = jax_init_caches(jcfg, 2, 12, dtype=jnp.float32)
        last, caches = jprefill(jparams, {"tokens": jnp.asarray(prompt)}, caches)
        first = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
        return np.asarray(jax_generate(jserve, jparams, caches, first, 7, 5, **kw)[0])

    def run(**kw):
        caches = init_caches(cfg, 2, 12, dtype=torch.float32)
        last, caches = prefill(params, {"tokens": prompt}, caches)
        first = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
        return first, caches, generate(step, params, caches, first, 7, 5, **kw)[0]

    first, caches, got = run()
    want = run_jax()
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    first, caches = run()[:2]
    tok, manual = first, []
    for i in range(5):
        _, tok, caches = step(params, tok, 7 + i, caches)
        manual.append(tok[:, 0])
    assert torch.equal(torch.stack(manual, dim=1), got)

    kw = {"eos_id": int(want[0, 1]), "max_new_tokens": np.array([5, 3]), "pad_id": -1}
    stopped = run(**{**kw, "max_new_tokens": torch.tensor([5, 3])})[2]
    np.testing.assert_array_equal(stopped.numpy(), run_jax(**{**kw, "max_new_tokens": jnp.asarray([5, 3])}))
    assert (stopped[0, 2:] == -1).all() and (stopped[1, 3:] == -1).all()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b"])
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "6", "--gen-len", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"arch={arch}-smoke batch=2 prompt=6 gen=3"
    assert lines[1].startswith("prefill: ") and "decode: " in lines[1] and lines[1].endswith("tok/s)")
    assert lines[2].startswith("sample tokens: [") and len(eval(lines[2].split(": ", 1)[1])) == 3


def test_serve_cli_multi_tenant_and_merge(capsys):
    serve.main(["--smoke", "--device", "cpu", "--adapters", "2", "--batch", "2", "--prompt-len", "4",
                "--gen-len", "2"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=qwen3-1.7b-smoke tenants=2 requests=2") and out[1].startswith("decode: ")
    serve.main(["--smoke", "--device", "cpu", "--merge-lora", "--batch", "1", "--prompt-len", "4", "--gen-len", "2"])
    assert capsys.readouterr().out.splitlines()[0] == "merged LoRA into base weights"


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b", "whisper-tiny"])
def test_api_serve_raises_for_recurrent_families(arch):
    """The recurrent families, and whisper's ``audio`` family, whose
    decoder the batcher would run without the encoder's cross K/V."""
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match=cfg.family):
        api.serve(arch, adapters={"a": {}}, device="cpu")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "jamba-v0.1-52b", "qwen3-1.7b"])
def test_chip_smoke_phase_5h_rehearses_on_the_cpu(arch):
    """``chip_smoke.py``'s phase 5h at the smoke size on the CPU: generate
    against a second run and a hand-rolled loop, the stops, the float32
    decode against the cache-free forward and its zeroed-state mutation
    all hold (the card's launch counts and timings are left out)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # chip_smoke.py sits at the repo's root
    import chip_smoke
    from repro_torch.kernels import ops

    stats, _ = chip_smoke.recurrent_serving_full(ops, "cpu", 0, arch, device="cpu", smoke=True)
    f32 = stats["decode_vs_forward_float32"]
    assert f32["max_abs_err"] <= f32["limit"] < f32["zeroed_state_max_abs_err"]
    assert stats["generate_equals_hand_rolled_loop"] and stats["smoke_cuda_vs_cpu"] is None
