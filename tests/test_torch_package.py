"""The port's package boundary: it loads neither JAX, the JAX package nor
``ml_dtypes`` (the card's machine has none), its sources never import them, its entry points run on the card unless
the caller asks for the CPU, and its configs are the JAX package's."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import FederatedConfig as JaxFederatedConfig
from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import STLDConfig as JaxSTLDConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.federated.algorithms import registered_methods as jax_registered_methods
from repro_torch import api
from repro_torch.configs import ARCH_IDS, FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.core import ptls
from repro_torch.core.peft import init_peft
from repro_torch.data.synthetic import make_task
from repro_torch.federated.client import make_client_fns

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro\b|from\s+repro\.|import\s+ml_dtypes\b"
    r"|from\s+ml_dtypes\b)", re.M)


def _modules():
    return sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py")
    )


def test_import_loads_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this one has JAX loaded by the test suite)."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.') or m == 'ml_dtypes' or m.startswith('ml_dtypes.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


EXAMPLES = sorted((ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"] + EXAMPLES,
                         ids=lambda p: p.name)
def test_sources_never_import_jax_or_the_jax_package(path):
    assert not _FORBIDDEN.findall(path.read_text()), path


def test_serve_without_device_runs_on_the_card_or_raises():
    """``device=None`` means the card: on a machine without one, torch raises
    before any work, and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: serve() would run on it")
    cfg = get_config("qwen3-1.7b", smoke=True)
    tree = {"attn": {"q": {"a": torch.zeros(2, 128, 4), "b": torch.zeros(2, 4, 128)}}}
    with pytest.raises((RuntimeError, AssertionError)):
        api.serve(cfg=cfg, adapters={"t0": tree})


def test_scan_covers_the_training_modules():
    """The import and source checks above walk every module of the package,
    the training slices' (qwen3-1.7b, rwkv6-3b, jamba), the federated
    slice's and the analysis and dry-run slice's included."""
    modules = set(_modules())
    for name in ("core.stld", "core.ptls", "core.schedules", "optim.adamw", "optim.schedules", "models.losses",
                 "data.synthetic", "federated.client", "launch.steps", "kernels.ops", "nn.rwkv", "nn.mamba",
                 "nn.moe", "configs.jamba_v0_1_52b", "core.configurator", "data.partition", "data.pipeline",
                 "federated.system_model", "federated.server", "federated.state", "federated.engine",
                 "federated.scheduler", "federated.runner", "federated.algorithms", "federated.algorithms.base",
                 "federated.algorithms.droppeft", "federated.algorithms.baselines", "api", "launch.train",
                 "launch.mesh", "federated.simulator", "sharding.specs", "serving.decode", "analysis",
                 "analysis.__main__", "analysis.contracts", "analysis.fixtures", "analysis.lint_torch",
                 "analysis.recompile_guard", "analysis.report", "analysis.trace", "launch.dryrun",
                 "launch.input_specs"):
        assert f"repro_torch.{name}" in modules, name


def test_package_boundary_lint_is_clean():
    """The port's own lint rule TXH006 (an import of jax, jaxlib or repro)
    finds nothing in the package, nor in ``chip_smoke.py`` and the port's
    examples."""
    from repro_torch.analysis import lint_torch

    found = lint_torch.lint_paths((str(PACKAGE), str(ROOT / "chip_smoke.py"), *map(str, EXAMPLES)),
                                  rules=("TXH006",))
    assert found == [], [v.render() for v in found]


def _train_cli(tmp_path):
    from repro_torch.launch import train

    train.main(["--smoke", "--rounds", "1", "--ckpt-dir", str(tmp_path / "ckpt"), "--out", str(tmp_path / "h.json")])


def _simulator():
    from repro_torch.federated.simulator import FederatedSimulator

    with pytest.warns(DeprecationWarning):
        FederatedSimulator(get_config("qwen3-1.7b", smoke=True), PEFTConfig(), STLDConfig(), FederatedConfig(),
                           TrainConfig())


@pytest.mark.parametrize("entry", ["build", "experiment", "train_cli", "simulator"])
def test_federated_entry_points_without_device_run_on_the_card_or_raise(monkeypatch, tmp_path, entry):
    """``api.build``/``experiment``, the training CLI (``launch.train``,
    whose ``--device`` defaults to ``cuda``) and ``FederatedSimulator`` with
    ``device=None`` mean the card: on a machine without one they raise
    before any work (no task is drawn, nothing is written), and nothing
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the experiment would run on it")
    from repro_torch.federated import runner

    tasks = []
    monkeypatch.setattr(runner, "make_task", lambda **kw: tasks.append(kw))
    with pytest.raises((RuntimeError, AssertionError)):
        if entry == "train_cli":
            _train_cli(tmp_path)
        elif entry == "simulator":
            _simulator()
        else:
            getattr(api, entry)("droppeft", "qwen3-1.7b", smoke=True)
    assert tasks == [] and not any(tmp_path.iterdir())


def test_list_methods_is_the_jax_registry():
    assert api.list_methods() == jax_registered_methods()


def test_client_fns_without_device_run_on_the_card_or_raise():
    """``make_client_fns``' tensors default to the card: on a machine
    without one, a round raises before any work, with no CPU fall-back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the round would run on it")
    cfg = get_config("qwen3-1.7b", smoke=True)
    fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig())
    task = make_task(vocab_size=cfg.vocab_size, seq_len=8, num_examples=4)
    batch = {k: v[None] for k, v in task.lm_batch(np.arange(4)).items()}
    peft = init_peft(cfg, PEFTConfig(), torch.Generator())
    with pytest.raises((RuntimeError, AssertionError)):
        fns.local_round({}, peft, {}, batch, 0.5, torch.Generator(), 0)
    with pytest.raises((RuntimeError, AssertionError)):
        fns.evaluate({}, peft, task.tokens, task.labels, np.arange(4))
    with pytest.raises((RuntimeError, AssertionError)):
        ptls.ImportanceAccumulator.init(cfg.num_layers)


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_the_jax_package(smoke):
    ours, theirs = get_config("qwen3-1.7b", smoke=smoke), jax_get_config("qwen3-1.7b", smoke=smoke)
    for field in ours.__dataclass_fields__:
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.resolved_head_dim == theirs.resolved_head_dim
    for ours_cls, theirs_cls in ((PEFTConfig, JaxPEFTConfig), (STLDConfig, JaxSTLDConfig),
                                 (TrainConfig, JaxTrainConfig), (FederatedConfig, JaxFederatedConfig)):
        for field in ours_cls.__dataclass_fields__:
            assert getattr(ours_cls(), field) == getattr(theirs_cls(), field), (ours_cls.__name__, field)


def test_full_config_is_qwen3_1_7b_width():
    cfg = get_config("qwen3-1.7b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim) == (28, 2048, 16, 8, 128)
    assert (cfg.d_ff, cfg.vocab_size, cfg.qk_norm, cfg.rope_theta, cfg.tie_embeddings) == (6144, 151_936, True, 1e6, True)
    # the port runs the reference's ten archs, each config field for field
    # (its parameter counts too) as the reference's
    assert ARCH_IDS == JAX_ARCH_IDS
    for arch in ARCH_IDS:
        for smoke in (False, True):
            ours, theirs = get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)
            assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), (arch, smoke)  # nested configs too
            assert ours.param_counts() == theirs.param_counts(), (arch, smoke)
    with pytest.raises(KeyError):
        get_config("whisper-large")  # an arch neither package knows
