"""The adapter and BitFit runs of ``tests/test_torch_peft_runs.py`` at
jamba's smoke config, batched: ``droppeft`` with ``peft="adapter"`` (a
per-layer adapter list: its Mamba layer has no ``adapter_attn``) and with
``peft="bitfit"`` (stacked), against the JAX package's runs.  fedadapter
differs from droppeft's adapter run only by full depth, which its qwen3
runs hold.
"""
import pytest

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_peft_runs import check_peft_run


@pytest.mark.parametrize("kind", ["adapter", "bitfit"])
def test_jamba_peft_kind_runs_follow_jax(monkeypatch, kind):
    check_peft_run({}, monkeypatch, "droppeft", kind, "jamba-v0.1-52b", "batched")
