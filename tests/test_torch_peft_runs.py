"""The federated runs of the adapter and BitFit PEFT kinds against the JAX
package's, on the CPU: ``fedadapter`` and ``droppeft`` with
``peft="adapter"`` (bottlenecks of 8) and ``droppeft`` with
``peft="bitfit"``, 2 rounds of 4 devices with 3 a round, 2 local steps of
batch 4, in both cohort modes at the smoke size of
``tests/test_torch_federated.py`` (qwen3-1.7b cut to 4 layers, d_model 32;
jamba's runs are in ``tests/test_torch_peft_runs_jamba.py``).  The port
gets JAX's base weights, initial tree and STLD draws
(``_torch_fed_parity``) and follows its run round by round
(``assert_follows_jax``: cohorts, rates, masks, accuracies equal, the
global tree within the after-AdamW bound, the history's loss within 1e-5);
no LoRA is in the tree.
"""
import pytest

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from _torch_fed_parity import CFG_KW, assert_follows_jax, jax_run, leaves, port_run

RUN_FED = dict(num_devices=4, devices_per_round=3, local_steps=2, batch_size=4)
RUNS = [(method, kind, mode) for method, kind in (("fedadapter", "adapter"), ("droppeft", "adapter"),
                                                  ("droppeft", "bitfit"))
        for mode in ("batched", "sequential")]


def check_peft_run(jax_runs, monkeypatch, method, kind, arch, cohort_mode):
    """The port's run of ``method`` with PEFT ``kind`` on ``arch`` follows
    JAX's (``jax_runs`` caches JAX's run across cohort modes)."""
    kw = dict(arch=arch, fed_kw=RUN_FED, peft_kw={"method": kind, "adapter_dim": 8},
              cfg_kw=CFG_KW if arch == "qwen3-1.7b" else {"dtype": "float32"})
    if (method, kind, arch) not in jax_runs:
        jax_runs[(method, kind, arch)] = jax_run(method, 2, **kw)
    want = jax_runs[(method, kind, arch)]
    got = port_run(monkeypatch, method, 2, want["base"], want["peft0"], cohort_mode=cohort_mode, **kw)
    assert_follows_jax(got, want, RUN_FED, rounds=2)
    names = {k for path, _ in leaves(got["runner"].state.global_peft) for k in path if isinstance(k, str)}
    assert names == {"adapter": {"adapter_attn", "adapter_mlp", "down", "up", "w"},
                     "bitfit": {"bias_attn", "bias_mlp"}}[kind]


@pytest.fixture(scope="module")
def jax_runs():
    return {}


@pytest.mark.parametrize("method,kind,cohort_mode", RUNS, ids=["-".join(r) for r in RUNS])
def test_peft_kind_runs_follow_jax(jax_runs, monkeypatch, method, kind, cohort_mode):
    check_peft_run(jax_runs, monkeypatch, method, kind, "qwen3-1.7b", cohort_mode)
