"""The reference's public surface in the port: every name of the JAX
package's ``__all__``s; every public function and class defined in each of
its modules, with every keyword and public method, in the port's module of
the same path (the signature walk, with its table of deliberate absences);
the step factories' ``stack_mode``, the dry run passing it through, and the
examples' counterparts, on the CPU.

The stack modes run on one Python layer loop in the port, so a step under
``scan`` or ``group`` is the ``unroll`` step bit for bit; where the
reference raises (a ``scan`` of a heterogeneous stack, a ``group`` whose
period does not divide the depth, gather-mode STLD of a heterogeneous
stack) the port raises ``ValueError`` too, each checked on both.
"""
import importlib
import inspect
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import PEFTConfig, TrainConfig, get_config
from repro_torch.core.peft import init_peft
from repro_torch.launch import dryrun
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.encdec import init_decoder_caches
from repro_torch.models.registry import init_params
from repro_torch.models.stacking import tree_leaves, tree_map
from repro_torch.models.transformer import init_caches
from repro_torch.optim import adamw_init

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parents[1]

# names of the reference's __all__s that the port leaves out on purpose
ABSENT = {
    ("repro.analysis", "walk_eqns"): "walks a jaxpr's equations: the port has no jaxpr (its contracts record the "
                                     "aten ops a step runs on meta, analysis.trace.MetaRecorder)",
    ("repro.analysis", "estimate_flops"): "sums a jaxpr's dot FLOPs: the port counts FLOPs with FlopCounterMode "
                                          "and each kernel's own work (analysis.trace.run_on_meta)",
}


# the reference's modules whose counterpart in the port lies at another path
PORT_MODULE = {
    "repro.analysis.jaxpr_contracts": (
        "repro_torch.analysis.contracts", "checks a jaxpr's equations: the port's contracts check the aten ops a "
                                          "step records on meta (ROADMAP §3, the dry run has no HLO)"),
    "repro.analysis.lint_jax": (
        "repro_torch.analysis.lint_torch", "lints JAX idioms: the port lints its own (no JXH003; TXH005 and TXH006 "
                                           "take JXH005's place, ROADMAP §3)"),
    **{f"repro.kernels.{name}": ("repro_torch.kernels.ops", "a Pallas kernel's module: the port's kernel is CUDA "
                                                             "under kernels/csrc, launched from kernels.ops")
       for name in ("flash_attention", "flash_decode", "lora_matmul", "mamba_scan", "rwkv6_scan", "segmented_lora")},
}

# public names defined in the reference's modules that the port leaves out on purpose
ABSENT_NAMES = {
    **{(f"repro.kernels.{module}", f"{name}_pallas"): f"the Pallas kernel itself: the port launches csrc/{cu} "
                                                       f"through kernels.ops.{name}"
       for module, name, cu in (("flash_attention", "flash_attention", "flash_attention.cu"),
                                ("flash_decode", "flash_decode", "flash_decode.cu"),
                                ("lora_matmul", "lora_matmul", "lora_matmul.cu"),
                                ("mamba_scan", "mamba_scan", "mamba_scan.cu"),
                                ("segmented_lora", "segmented_lora", "segmented_lora.cu"))},
    ("repro.kernels.rwkv6_scan", "wkv6_pallas"): "the Pallas kernel itself: the port launches csrc/wkv6.cu through "
                                                 "kernels.ops.wkv6",
    ("repro.kernels.ops", "is_cpu_backend"): "asks JAX's default backend: the port chooses by each tensor's device",
    ("repro.analysis.jaxpr_contracts", "walk_eqns"): ABSENT[("repro.analysis", "walk_eqns")],
    ("repro.analysis.jaxpr_contracts", "estimate_flops"): ABSENT[("repro.analysis", "estimate_flops")],
    ("repro.analysis.jaxpr_contracts", "make_trace"): "makes a trace from a jaxpr: the port's trace_program records "
                                                      "the step itself on meta",
    **{("repro.analysis.fixtures", name): "a JAX-only fixture: its fault (a reused PRNG key, jit's static "
                                          "arguments, an env query or a host callback inside jit) has no torch "
                                          "counterpart for the port's lint to catch"
       for name in ("key_reuse", "stale_static_argnames", "env_query_in_jit", "host_callback_in_body",
                    "static_arg_churn")},
    ("repro.launch.dryrun", "lower_cell"): "lowers a cell to HLO: the port lowers nothing, and run_cell has its "
                                           "signature and record (ROADMAP §3)",
}

# keywords of the reference's signatures that the port leaves out on purpose;
# "*" stands for every function of the module
ABSENT_KEYWORDS = {
    ("repro.federated.client", "make_client_fns", "donate"): "XLA buffer donation: eager torch frees a round's "
                                                             "buffers when their last reference goes",
    ("repro.launch.dryrun", "collective_bytes", "hlo_text"): "the dry run has no HLO: a cell's collectives are what "
                                                             "the port itself sends (ROADMAP §3)",
    **{("repro.analysis.jaxpr_contracts", "stacking_concats", kw): "walks a jaxpr's concatenates against the "
                                                                   "shapes given: the port's takes a ProgramTrace, "
                                                                   "whose stacked_shapes are the targets"
       for kw in ("jaxpr", "target_shapes")},
    ("repro.kernels.ops", "*", "impl"): "Pallas or XLA: the port chooses by the tensors' device",
    **{("repro.kernels.ops", "*", tile): "a Pallas tile: each CUDA kernel plans its own tiles"
       for tile in ("block_q", "block_k", "block_m", "block_n", "chunk", "d_block")},
}

# a JAX PRNG key: the port draws from a torch generator, given as ``generator``
# (ROADMAP §3, "Random streams")
KEY_KEYWORDS = ("key", "_key")


def _reference_modules(with_all: bool = True):
    """Every module of the JAX package (``with_all``: those that assign
    ``__all__``)."""
    src = ROOT / "src"
    return sorted(
        ".".join(p.relative_to(src).with_suffix("").parts).removesuffix(".__init__")
        for p in (src / "repro").rglob("*.py")
        if not with_all or re.search(r"^__all__\s*=", p.read_text(), re.M)
    )


def _defined(module):
    """The public functions and classes a module defines (jitted and cached
    functions included), by name."""
    return {name: obj for name, obj in vars(module).items()
            if not name.startswith("_") and callable(obj) and not inspect.ismodule(obj)
            and getattr(obj, "__module__", None) == module.__name__}


def _missing_keywords(module: str, name: str, ref_fn, port_fn) -> list:
    """The keywords of ``ref_fn`` that ``port_fn`` lacks and the table does
    not name; a ``key`` needs a ``generator`` in its place."""
    port_params = inspect.signature(port_fn).parameters
    if any(p.kind == p.VAR_KEYWORD for p in port_params.values()):
        return []
    missing = []
    for kw, p in inspect.signature(ref_fn).parameters.items():
        if kw in port_params or p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        if kw in KEY_KEYWORDS and "generator" in port_params:
            continue
        if (module, name, kw) not in ABSENT_KEYWORDS and (module, "*", kw) not in ABSENT_KEYWORDS:
            missing.append(f"{name}({kw})")
    return missing


def test_the_walk_covers_the_subpackages():
    assert {"repro.models", "repro.federated", "repro.serving", "repro.data", "repro.nn", "repro.core"} <= set(
        _reference_modules())


@pytest.mark.parametrize("module", _reference_modules())
def test_every_reference_export_resolves_in_the_port(module):
    """Each name of the reference module's ``__all__`` is an attribute of
    the port's module of the same path and in its ``__all__``, unless
    ``ABSENT`` gives the reason it is not."""
    ref = importlib.import_module(module)
    port = importlib.import_module("repro_torch" + module.removeprefix("repro"))
    missing = [name for name in ref.__all__
               if (module, name) not in ABSENT and not (hasattr(port, name) and name in port.__all__)]
    assert not missing, missing
    assert all(not hasattr(port, name) for (mod, name) in ABSENT if mod == module)


def test_the_signature_walk_covers_every_module():
    modules = _reference_modules(with_all=False)
    assert set(_reference_modules()) < set(modules) and len(modules) > 80
    assert set(PORT_MODULE) <= set(modules)
    assert {mod for mod, _ in ABSENT_NAMES} | {mod for mod, _, _ in ABSENT_KEYWORDS} <= set(modules)


@pytest.mark.parametrize("module", _reference_modules(with_all=False))
def test_every_reference_name_and_keyword_is_in_the_port(module):
    """Each public function and class defined in the reference module
    resolves in the port's module of the same path (or the one
    ``PORT_MODULE`` names) with every keyword of its signature, and each
    class with every public method and the methods' keywords, unless
    ``ABSENT_NAMES`` or ``ABSENT_KEYWORDS`` gives the reason it is not."""
    ref = importlib.import_module(module)
    port_name = PORT_MODULE.get(module, ("repro_torch" + module.removeprefix("repro"),))[0]
    port = importlib.import_module(port_name)
    missing = []
    for name, obj in _defined(ref).items():
        if (module, name) in ABSENT_NAMES:
            assert not hasattr(port, name), f"{port_name}.{name} exists: take it out of ABSENT_NAMES"
            continue
        if not hasattr(port, name):
            missing.append(name)
            continue
        counterpart = getattr(port, name)
        if not inspect.isclass(obj):
            missing += _missing_keywords(module, name, obj, counterpart)
            continue
        for meth, fn in vars(obj).items():
            if meth.startswith("_"):
                continue
            if not hasattr(counterpart, meth):
                missing.append(f"{name}.{meth}")
            elif inspect.isfunction(fn) and callable(getattr(counterpart, meth)):
                missing += _missing_keywords(module, f"{name}.{meth}", fn, getattr(counterpart, meth))
    assert not missing, f"{port_name} lacks {missing}"


def test_stacking_converters_round_trip():
    """``stack_params``/``unstack_params`` over ``from_layer_list``/``layer_list``,
    as the reference's: a stacked tree and a list pass through, a
    heterogeneous list raises."""
    from repro_torch.models import stack_params, unstack_params

    cfg = get_config("qwen3-1.7b", smoke=True).replace(dtype="float32")
    stacked = init_params(cfg, torch.Generator().manual_seed(0))["layers"]
    layers = unstack_params(stacked)
    assert len(layers) == cfg.num_layers and unstack_params(layers) == layers
    again = stack_params(layers)
    assert stack_params(again) is again
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(stacked)))
    jamba = init_params(get_config("jamba-v0.1-52b", smoke=True), torch.Generator().manual_seed(0))["layers"]
    with pytest.raises(ValueError, match="heterogeneous"):
        stack_params(jamba)
    with pytest.raises(ValueError, match="leafless"):
        unstack_params({})
    assert unstack_params({}, num_layers=2) == [{}, {}]


def test_small_helpers_match_the_reference():
    """The ``nn`` and ``models`` helpers the reference exports, on one input."""
    from repro.models.losses import lm_shift_labels as jax_lm_shift_labels
    from repro.nn import init_layernorm as jax_init_layernorm
    from repro.nn import lora_delta as jax_lora_delta
    from repro_torch.models import build_model, init_params as port_init_params, model_apply
    from repro_torch.models.losses import lm_shift_labels
    from repro_torch.nn import init_layernorm, init_linear, init_rmsnorm, lora_delta, zeros_init

    rng = np.random.default_rng(0)
    x, a, b = (rng.standard_normal(s, dtype=np.float32) for s in ((3, 8), (8, 2), (2, 5)))
    np.testing.assert_allclose(lora_delta(torch.from_numpy(x), {"a": torch.from_numpy(a), "b": torch.from_numpy(b)},
                                          2.0).numpy(),
                               np.asarray(jax_lora_delta(jnp.asarray(x), {"a": jnp.asarray(a), "b": jnp.asarray(b)},
                                                         2.0)), rtol=1e-6)
    tokens = np.arange(12, dtype=np.int32).reshape(2, 6)
    for got, want in zip(lm_shift_labels(torch.from_numpy(tokens)), jax_lm_shift_labels(jnp.asarray(tokens))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {k: v.tolist() for k, v in init_layernorm(4).items()} == {
        k: np.asarray(v).tolist() for k, v in jax_init_layernorm(4).items()}
    assert init_rmsnorm(3)["scale"].tolist() == [1.0, 1.0, 1.0]
    gen = torch.Generator().manual_seed(0)
    lin = init_linear(gen, 8, 4, bias=True)
    assert lin["w"].shape == (8, 4) and not lin["b"].any() and float(lin["w"].abs().max()) <= 2 * 8 ** -0.5
    assert not zeros_init(gen, (2, 3)).any()
    assert build_model(get_config("qwen3-1.7b", smoke=True)) == (port_init_params, model_apply)


# ------------------------------------------------------------- stack_mode on the step factories
def _smoke(arch="qwen3-1.7b", **replace):
    cfg = get_config(arch, smoke=True).replace(dtype="float32", **replace)
    gen = torch.Generator().manual_seed(0)
    params, peft = init_params(cfg, gen), init_peft(cfg, PEFTConfig(), gen)
    for leaf in tree_leaves(peft):
        leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
    tokens = torch.randint(0, cfg.vocab_size, (2, 13), generator=gen)
    return cfg, params, peft, tokens


def _step(cfg, params, peft, tokens, **kw):
    step = make_train_step(cfg, PEFTConfig(), TrainConfig(), **kw)
    return step(params, peft, adamw_init(peft), {"tokens": tokens}, torch.Generator().manual_seed(4))


@pytest.mark.parametrize("stack_mode", ["scan", "group"])
def test_train_step_stack_modes_are_the_unroll_step(stack_mode):
    cfg, params, peft, tokens = _smoke()
    want = _step(cfg, params, peft, tokens, stld_mode="cond", stack_mode="unroll")
    got = _step(cfg, params, peft, tokens, stld_mode="cond", stack_mode=stack_mode)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(want[0]), tree_leaves(got[0])))
    assert all(torch.equal(want[2][k], got[2][k]) for k in want[2])


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "whisper-tiny"])
def test_prefill_and_serve_steps_take_stack_mode(arch):
    """``make_prefill_step``/``make_serve_step`` under ``scan`` give the
    ``unroll`` logits and caches (whisper's encoder and decoder stacks
    too)."""
    cfg, params, _, tokens = _smoke(arch)
    batch = {"tokens": tokens[:, :8]}
    if cfg.frontend_key is not None:
        batch[cfg.frontend_key] = torch.randn((2, cfg.frontend_seq, cfg.d_model), generator=torch.Generator())
    out = {}
    for mode in ("unroll", "scan"):
        caches = (init_decoder_caches if cfg.is_encoder_decoder else init_caches)(cfg, 2, 16, dtype=torch.float32)
        first = make_prefill_step(cfg, stack_mode=mode)(params, batch, caches)
        logits, caches = first[0], first[1]
        serve = make_serve_step(cfg, stack_mode=mode)
        token = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        step_logits, _, caches = serve(params, token, 8, caches, *first[2:])
        out[mode] = [logits, step_logits] + tree_leaves(caches)
    assert all(torch.equal(a, b) for a, b in zip(out["unroll"], out["scan"]))


def test_unknown_stack_mode_raises_at_the_factory():
    cfg = get_config("qwen3-1.7b", smoke=True)
    for factory in (lambda: make_train_step(cfg, PEFTConfig(), TrainConfig(), stack_mode="scanned"),
                    lambda: make_prefill_step(cfg, stack_mode="scanned"),
                    lambda: make_serve_step(cfg, stack_mode="scanned")):
        with pytest.raises(ValueError, match="unknown stack_mode"):
            factory()


@pytest.mark.parametrize("case", ["scan of a hybrid stack", "group off the period", "gather of a hybrid stack"])
def test_stack_mode_raises_where_the_reference_raises(case):
    """jamba's smoke stack (Mamba, then attention + MoE: a period of 2):
    the reference's jitted step raises ``ValueError`` while tracing, and
    the port's step raises ``ValueError``."""
    replace, kw = {"scan of a hybrid stack": ({}, {"stack_mode": "scan"}),
                   "group off the period": ({"num_layers": 3}, {"stack_mode": "group"}),
                   "gather of a hybrid stack": ({}, {"stld_mode": "gather", "stack_mode": "group"})}[case]
    cfg, params, peft, tokens = _smoke("jamba-v0.1-52b", **replace)
    to_jax = lambda tree: tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    jcfg = jax_get_config("jamba-v0.1-52b", smoke=True).replace(dtype="float32", **replace)
    jstep = jax.jit(jax_make_train_step(jcfg, JaxPEFTConfig(), JaxTrainConfig(), **kw))
    with pytest.raises(ValueError):
        jstep(to_jax(params), to_jax(peft), jax_adamw_init(to_jax(peft)), {"tokens": jnp.asarray(tokens.numpy())},
              jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        _step(cfg, params, peft, tokens, **kw)


def test_dry_run_passes_stack_mode_to_the_factories(monkeypatch):
    """``run_cell`` hands its ``stack_mode`` to the step factory, as the
    reference's ``lower_cell`` does."""
    seen = {}

    class Stop(Exception):
        pass

    def factory(*args, **kw):
        seen.update(kw)
        raise Stop

    for name in ("make_train_step", "make_prefill_step", "make_serve_step"):
        monkeypatch.setattr(dryrun, name, factory)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        seen.clear()
        with pytest.raises(Stop):
            dryrun.run_cell("jamba-v0.1-52b", shape, multi_pod=False, stack_mode="group")
        assert seen["stack_mode"] == "group", shape


# ------------------------------------------------------------- the examples
EXAMPLES = ("torch_quickstart.py", "torch_federated_finetune.py", "torch_serving_decode.py",
            "torch_bandit_configurator.py")


def test_every_example_has_its_port_counterpart():
    originals = {p.name for p in (ROOT / "examples").glob("*.py") if not p.name.startswith("torch_")}
    assert {f"torch_{name}" for name in originals} == set(EXAMPLES)
    for name in EXAMPLES:
        text = (ROOT / "examples" / name).read_text()
        assert "--device" in text and 'default="cuda"' in text, name


def test_quickstart_runs_on_the_cpu_as_a_process():
    """``examples/torch_quickstart.py --device cpu`` as users start it:
    exit 0 within 15 s, its lines those of the reference's quickstart,
    and the ``remat`` steps equal to the plain ones."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "examples" / "torch_quickstart.py"), "--device", "cpu"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=60)
    seconds = time.perf_counter() - t0
    assert out.returncode == 0, out.stderr[-3000:]
    assert seconds < 15.0, seconds
    lines = out.stdout.splitlines()
    for prefix in ("model: qwen3-1.7b-smoke", "dropout rates:", "expected active layers:", "base params:",
                   "step 0: loss=", "step 4: loss=", "federated (repro_torch.api): 2 rounds, acc=", "OK"):
        assert any(line.startswith(prefix) for line in lines), (prefix, lines)
    assert "remat=True gives the same LoRA after 5 steps: True" in lines
