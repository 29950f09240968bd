"""The port's checkpoints against the JAX package's, on the CPU.

The format (``repro_torch.checkpoint``): a directory written by JAX's
``save_state`` loads into the port and saves back byte-equal (both files),
and one written by the port loads into JAX's ``load_state`` with equal
values, bf16, bool, uint32 and tuple leaves included; ``save_pytree``
writes JAX's manifest and bytes.  A torn newest snapshot falls back to the
previous one.

The runner: a run saved at round 2 and resumed to round 3 equals the
uninterrupted run bit for bit (history, global LoRA, ``final_accuracy``)
in both cohort modes, also from the snapshot before a torn one; an early
stop still saves; a resume with another device count raises, as
``tests/test_api.py`` holds the reference's.

Serving: the port's ``AdapterRegistry.load_checkpoint`` of a JAX runner's
checkpoint registers JAX's adapters, exactly, and JAX's registry reads the
port runner's checkpoint; ``api.serve(checkpoint_dir=...)`` gives JAX's
tokens (float32, 2 layers of qwen3-1.7b's smoke config).
"""
import filecmp
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.checkpoint import ckpt as jax_ckpt
from repro.configs import FederatedConfig as JaxFederatedConfig
from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import STLDConfig as JaxSTLDConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.models.registry import init_params as jax_init_params
from repro.serving.adapters import AdapterRegistry as JaxAdapterRegistry
from repro.serving.batcher import Request as JaxRequest
from repro_torch import api, convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.models.stacking import tree_leaves
from repro_torch.serving.adapters import AdapterRegistry
from repro_torch.serving.batcher import Request
from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)

_CFG_KW = dict(num_layers=4, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, vocab_size=128, dtype="float32")
_FED_KW = dict(num_devices=4, devices_per_round=2, local_steps=1, batch_size=4)
_TRAIN_KW = dict(learning_rate=5e-3, total_steps=100, warmup_steps=2)
_HISTORY = ("cum_time_s", "accuracy", "loss", "rates", "active_fraction", "traffic_mb", "energy_j", "memory_gb",
            "arrivals")


def _same_files(a, b):
    return all(filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False)
               for f in ("arrays.npz", "manifest.json"))


def _jax_tree():
    rng = np.random.default_rng(0)
    return {
        "key": np.arange(2, dtype=np.uint32),
        "w": jnp.asarray(rng.standard_normal((3, 4), dtype=np.float32), jnp.bfloat16),
        "nested": {"mask": [np.asarray([True, False, True]), np.float32(2.5)],
                   "pair": (np.arange(3), jnp.asarray(rng.standard_normal(5, dtype=np.float32)))},
        "empty": {},
    }


# ------------------------------------------------------------- the format
def test_jax_state_loads_into_the_port_and_saves_back_byte_equal(tmp_path):
    meta = {"round": 3, "history": [{"acc": 0.25}], "rng": {"state": 2**100}}
    jdir = jax_ckpt.save_state(str(tmp_path / "jax"), 3, _jax_tree(), meta)
    tree, got_meta = ckpt.load_state(jdir)
    assert got_meta == meta
    assert tree["w"].dtype == torch.bfloat16 and tree["key"].dtype == torch.uint32
    assert tree["nested"]["mask"][0].dtype == torch.bool and isinstance(tree["nested"]["pair"], tuple)
    want_w = np.asarray(_jax_tree()["w"]).view(np.uint16)
    np.testing.assert_array_equal(tree["w"].view(torch.int16).numpy().view(np.uint16), want_w)
    assert _same_files(jdir, ckpt.save_state(str(tmp_path / "port"), 3, tree, got_meta))


def test_port_state_loads_into_jax_with_equal_values(tmp_path):
    tree = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16),
            "mask": [torch.tensor([True, False]), np.int64(7)], "pair": (torch.arange(3), torch.zeros(()))}
    pdir = ckpt.save_state(str(tmp_path / "port"), 5, tree, {"x": [1, 2]})
    jtree, jmeta = jax_ckpt.load_state(pdir)
    assert jmeta == {"x": [1, 2]} and isinstance(jtree["pair"], tuple)
    assert str(jtree["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jtree["w"], np.float32), tree["w"].float().numpy())
    np.testing.assert_array_equal(jtree["mask"][0], np.asarray([True, False]))
    assert jtree["mask"][1] == 7 and jtree["mask"][1].dtype == np.int64
    assert _same_files(pdir, jax_ckpt.save_state(str(tmp_path / "jax"), 5, jtree, jmeta))


def test_save_pytree_writes_jax_manifest_and_bytes(tmp_path):
    jtree = _jax_tree()
    jdir = jax_ckpt.save_pytree(jtree, str(tmp_path / "jax"), 2)
    tree, _ = ckpt.load_state(jax_ckpt.save_state(str(tmp_path / "state"), 0, jtree))
    pdir = ckpt.save_pytree(tree, str(tmp_path / "port"), 2)
    assert _same_files(jdir, pdir)
    restored, step = ckpt.restore_latest(tree, str(tmp_path / "jax"))
    assert step == 2
    assert [p for p, _ in ckpt._flatten(restored)] == [p for p, _ in ckpt._flatten(tree)]
    for (_, a), (_, b) in zip(ckpt._flatten(restored), ckpt._flatten(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_truncated_snapshot_falls_back_to_the_previous(tmp_path):
    d = str(tmp_path / "ck")
    for step in (1, 2):
        ckpt.save_state(d, step, {"x": torch.full((1000,), float(step))})
    npz = os.path.join(d, "step_00000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    assert ckpt.latest_state_dir(d) == os.path.join(d, "step_00000001")
    assert jax_ckpt.latest_state_dir(d) == ckpt.latest_state_dir(d)
    assert float(ckpt.load_state(ckpt.latest_state_dir(d))[0]["x"][0]) == 1.0


# ------------------------------------------------------------- the runner
def _build(**kw):
    return api.build("droppeft", cfg=get_config("qwen3-1.7b", smoke=True).replace(**_CFG_KW),
                     peft_cfg=PEFTConfig(lora_rank=2), stld_cfg=STLDConfig(mode="cond", mean_rate=0.5),
                     fed_cfg=FederatedConfig(**{**_FED_KW, **kw.pop("fed_kw", {})}),
                     train_cfg=TrainConfig(**_TRAIN_KW), seed=7, device="cpu", **kw)


def _assert_same_run(got_runner, got, want_runner, want):
    for field in _HISTORY:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.final_accuracy == want.final_accuracy
    for a, b in zip(tree_leaves(got_runner.state.global_peft), tree_leaves(want_runner.state.global_peft)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cohort_mode", ["sequential", "batched"])
def test_resume_matches_uninterrupted(tmp_path, cohort_mode):
    """Saved at round 2, resumed by a fresh runner to round 3: the same
    history, global LoRA and final accuracy as one run of 3 rounds; also
    from round 1 after the round-2 snapshot is torn."""
    full_runner = _build(cohort_mode=cohort_mode)
    full = full_runner.run(rounds=3)
    d = str(tmp_path / "state")
    _build(cohort_mode=cohort_mode, checkpoint_dir=d).run(rounds=2)
    assert sorted(os.listdir(d)) == ["step_00000001", "step_00000002"]
    torn = str(tmp_path / "torn")
    shutil.copytree(d, torn)
    resumed_runner = _build(cohort_mode=cohort_mode, checkpoint_dir=d, resume=True)
    assert resumed_runner.state.round_index == 2
    _assert_same_run(resumed_runner, resumed_runner.run(rounds=3), full_runner, full)
    npz = os.path.join(torn, "step_00000002", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    from_one = _build(cohort_mode=cohort_mode, checkpoint_dir=torn, resume=True)
    assert from_one.state.round_index == 1
    _assert_same_run(from_one, from_one.run(rounds=3), full_runner, full)


def test_early_stop_still_checkpoints_final_round(tmp_path):
    d = str(tmp_path / "state")
    res = _build(checkpoint_dir=d, checkpoint_every=10).run(rounds=4, target_accuracy=0.0)
    assert res.rounds == 1
    _, meta = ckpt.load_state(ckpt.latest_state_dir(d))
    assert meta["round_index"] == 1 and meta["meta_version"] == 3


def test_resume_rejects_mismatched_device_count(tmp_path):
    d = str(tmp_path / "state")
    _build(checkpoint_dir=d).run(rounds=1)
    with pytest.raises(ValueError, match="devices"):
        _build(checkpoint_dir=d, resume=True, fed_kw={"num_devices": 5})


# ------------------------------------------------------------- serving from checkpoints
@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX runner's checkpoint after one round (2 client adapters and
    the global one) and the base weights it serves with."""
    d = str(tmp_path_factory.mktemp("jax_run") / "state")
    jcfg = jax_get_config("qwen3-1.7b", smoke=True).replace(**_CFG_KW)
    jax_api.build("droppeft", cfg=jcfg, peft_cfg=JaxPEFTConfig(method="lora", lora_rank=2),
                  stld_cfg=JaxSTLDConfig(mode="cond", mean_rate=0.5), fed_cfg=JaxFederatedConfig(**_FED_KW),
                  train_cfg=JaxTrainConfig(**_TRAIN_KW), seed=7, checkpoint_dir=d).run(rounds=1)
    return d, jcfg, jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


def _leaves(tree):
    """Numpy leaves of a JAX or torch tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def _registered(registry):
    return {name: (registry.get(name)["rank"], _leaves(registry.get(name)["peft"])) for name in registry.names()}


def test_registry_loads_the_other_packages_checkpoints(jax_checkpoint, tmp_path):
    d, _, _ = jax_checkpoint
    want = _registered(JaxAdapterRegistry().load_checkpoint(d))
    got = _registered(AdapterRegistry().load_checkpoint(d))
    assert list(got) == list(want) and len(got) == 3 and "client_global" in got
    for name in want:
        assert got[name][0] == want[name][0]
        for a, b in zip(got[name][1], want[name][1]):
            np.testing.assert_array_equal(a, b)
    pd = str(tmp_path / "port")
    _build(checkpoint_dir=pd).run(rounds=1)
    want = _registered(AdapterRegistry().load_checkpoint(pd))
    got = _registered(JaxAdapterRegistry().load_checkpoint(pd))
    assert list(got) == list(want)
    for name in want:
        for a, b in zip(got[name][1], want[name][1]):
            np.testing.assert_array_equal(a, b)


def test_serve_from_checkpoint_matches_jax_tokens(jax_checkpoint):
    d, jcfg, jparams = jax_checkpoint
    prompts = [([5, 7, 11], "client_global"), ([13, 17], "client1"), ([19, 23, 29, 31], "client_global")]
    jb = jax_api.serve(cfg=jcfg, params=jparams, checkpoint_dir=d, batch=2, max_len=16, cache_dtype="float32")
    b = api.serve(cfg=get_config("qwen3-1.7b", smoke=True).replace(**_CFG_KW),
                  params=convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"), checkpoint_dir=d,
                  batch=2, max_len=16, cache_dtype="float32", device="cpu")
    assert sorted(b.pool.registry.names()) == sorted(jb.pool.registry.names())
    for j, (p, name) in enumerate(prompts):
        jb.submit(JaxRequest(prompt=p, adapter=name, max_new_tokens=5, uid=j))
        b.submit(Request(prompt=p, adapter=name, max_new_tokens=5, uid=j))
    want = {c.uid: (c.tokens, c.finish_reason) for c in jb.run()}
    assert {c.uid: (c.tokens, c.finish_reason) for c in b.run()} == want
