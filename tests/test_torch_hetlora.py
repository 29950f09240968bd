"""The port's FedHetLoRA against the JAX package, on the CPU.

* Server pieces on seeded numpy trees in both layouts (stacked ``(L, ...)``
  leaves and a per-layer list with a Mamba-like group): ``_pad_layer`` and
  ``truncate_lora_rank`` equal to JAX's, truncating a padded tree gives it
  back bit for bit; ``hetlora_aggregate`` of ranks 4, 8, 16 and 8 within
  1e-6 of JAX's, without and with ``extra_weights`` (the schedules'
  staleness weights), a NaN element screened to zero in both.
* The runner: ``fedhetlora`` (sequential, pinned tiers ``tx2``, ``nx``,
  ``agx``: ranks 4, 8, 16) for 3 rounds at the smoke size of
  ``tests/test_torch_federated.py``, with JAX's weights, JAX's rank-16
  global tree (``bind`` draws it anew from the PEFT key) and JAX's STLD
  draws, follows JAX's run round by round (``assert_follows_jax``), under
  sync and under ``deadline`` + ``carry`` (staleness weights times the rank
  shares); every device's tree at its tier's rank.
* Its checkpoint: JAX's loads into the port and saves back byte-equal, the
  port's has JAX's skeleton (every leaf's path, dtype and shape but the
  seed key's) and meta keys, and a run resumed from the port's round 2
  equals the uninterrupted run bit for bit.
* Serving: ``api.serve(checkpoint_dir=...)`` of JAX's checkpoint registers
  tenants of rank 4, 8 and 16 (``r_max`` 16) and gives JAX's tokens.
"""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import api as jax_api
from repro.checkpoint import ckpt as jax_ckpt
from repro.federated import server as jax_server
from repro.models.registry import init_params as jax_init_params
from repro.serving.batcher import Request as JaxRequest
from repro_torch import api, convert
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.core import peft as peft_lib
from repro_torch.federated import server
from repro_torch.models.stacking import tree_leaves
from repro_torch.serving.batcher import Request
from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from _torch_fed_parity import CFG_KW, SEED, assert_follows_jax, assert_trees_equal, jax_kwargs, jax_run, leaves, port_run

PROFILE = ["tx2", "nx", "agx", "agx", "nx", "tx2"]
RANKS = [4, 8, 16, 16, 8, 4]
DEADLINE = 0.0022  # tests/test_torch_schedules.py's: some of a round's devices miss it


def _tree(rng, layout, rank, num_layers=3):
    def lora(d_in, d_out, lead):
        return {"a": rng.standard_normal((*lead, d_in, rank), dtype=np.float32),
                "b": rng.standard_normal((*lead, rank, d_out), dtype=np.float32)}

    if layout == "stacked":
        return {"attn": {"q": lora(16, 24, (num_layers,)), "v": lora(16, 8, (num_layers,))}}
    return [{"attn": {"q": lora(16, 24, ())}, "mlp": {"up": lora(16, 32, ())}} if l % 2
            else {"mamba": {"in": lora(16, 64, ()), "out": lora(32, 16, ())}} for l in range(num_layers)]


def _torch(tree):
    return convert.peft_from_jax(tree, "cpu")


# ------------------------------------------------------------- server pieces
@pytest.mark.parametrize("layout", ["stacked", "list"])
def test_pad_and_truncate_round_trip(layout):
    rng = np.random.default_rng(1)
    for rank in (4, 8, 16):
        tree = _tree(rng, layout, rank)
        pad = (lambda t: [server._pad_layer(x, 16) for x in t]) if layout == "list" else (
            lambda t: server._pad_layer(t, 16))
        jpad = (lambda t: [jax_server._pad_layer(x, 16) for x in t]) if layout == "list" else (
            lambda t: jax_server._pad_layer(t, 16))
        padded = pad(_torch(tree))
        assert_trees_equal(padded, jpad(jax.tree.map(np.asarray, tree)))
        assert_trees_equal(server.truncate_lora_rank(padded, rank), tree)
        big = _tree(rng, layout, 16)
        assert_trees_equal(server.truncate_lora_rank(_torch(big), rank), jax_server.truncate_lora_rank(big, rank))
        assert all(t.is_contiguous() for t in tree_leaves(server.truncate_lora_rank(_torch(big), rank)))


@pytest.mark.parametrize("weights", [None, [0.4, 0.1, 0.3, 0.2]], ids=["rank-shares", "staleness-weighted"])
@pytest.mark.parametrize("layout", ["stacked", "list"])
def test_hetlora_aggregate_matches_jax(layout, weights):
    rng = np.random.default_rng(2)
    ranks = [4, 8, 16, 8]
    clients = [_tree(rng, layout, r) for r in ranks]
    first = clients[1][0]["mamba"]["in"]["a"] if layout == "list" else clients[1]["attn"]["q"]["a"]
    first[0, 0] = np.nan  # one client's non-finite element: screened to zero
    want = jax_server.hetlora_aggregate(clients, ranks, 16, extra_weights=weights)
    got = server.hetlora_aggregate([_torch(c) for c in clients], ranks, 16, extra_weights=weights)
    g, w = leaves(got), leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.shape[-1] == 16 or a.shape[-2] == 16, path
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=str(path))
    assert np.isfinite(np.concatenate([a.ravel() for _, a in g])).all()


# ------------------------------------------------------------- the runner
SCHEDULES = {"sync": {}, "deadline-carry": dict(schedule="deadline", deadline_s=DEADLINE, straggler="carry",
                                                staleness_alpha=0.5)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per schedule: JAX's 3-round run and the port's, both checkpointed
    every round (sync only)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, kw in SCHEDULES.items():
            dirs = {}
            if name == "sync":
                root = tmp_path_factory.mktemp("hetlora")
                dirs = {pkg: str(root / pkg) for pkg in ("jax", "port")}
            want = jax_run("fedhetlora", 3, device_profile=PROFILE,
                           **({"checkpoint_dir": dirs["jax"]} if dirs else {}), **kw)
            mp.setattr(peft_lib, "init_peft", lambda cfg, peft_cfg, gen, want=want: _torch(want["global0"]))
            got = port_run(mp, "fedhetlora", 3, want["base"], want["peft0"], cohort_mode="sequential",
                           device_profile=PROFILE, **({"checkpoint_dir": dirs["port"]} if dirs else {}), **kw)
            mp.undo()
            out[name] = (want, got, dirs)
    return out


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_fedhetlora_runner_follows_jax(runs, schedule):
    want, got, _ = runs[schedule]
    runner = got["runner"]
    assert runner.cohort_mode == "sequential" and runner.algorithm.device_rank == RANKS
    assert sorted(runner.ctx.engine._het_fns) == [4, 8, 16]
    assert_follows_jax(got, want, rounds=3)
    for dev, tree in runner.state.device_peft.items():
        assert {t["a"].shape[-1] for t in tree["attn"].values()} == {RANKS[dev]}, dev
    assert {t["a"].shape[-1] for t in runner.state.global_peft["attn"].values()} == {16}
    if schedule == "deadline-carry":
        history = got["history"]
        assert any(row["arrivals"] < len(d["cohort"]) for row, d in zip(history, got["rec"]["dispatch"]))
        assert any(a["weights"] is not None for a in got["rec"]["aggregate"])


def test_fedhetlora_checkpoint_is_the_reference_format(runs, tmp_path):
    _, got, dirs = runs["sync"]
    jdir, pdir = ckpt.latest_state_dir(dirs["jax"]), ckpt.latest_state_dir(dirs["port"])
    tree, meta = ckpt.load_state(jdir)
    saved = ckpt.save_state(str(tmp_path / "resaved"), 3, tree, meta)
    for f in ("arrays.npz", "manifest.json"):
        with open(os.path.join(jdir, f), "rb") as a, open(os.path.join(saved, f), "rb") as b:
            assert a.read() == b.read(), f
    with open(os.path.join(jdir, "manifest.json")) as a, open(os.path.join(pdir, "manifest.json")) as b:
        jman, pman = json.load(a), json.load(b)
    key = jman["skeleton"]["k"].index("key")
    for man in (jman, pman):  # the seed key is JAX's uint32 pair there, the port's int64 here
        man["skeleton"]["v"][key] = None
    assert pman["skeleton"] == jman["skeleton"]
    assert sorted(pman["meta"]) == sorted(jman["meta"]) and pman["meta"]["configurator"] is None
    jarr, parr = jax_ckpt.load_state(jdir)[0], ckpt.load_state(pdir)[0]
    assert [(p, a.shape, a.dtype) for p, a in leaves({k: v for k, v in jarr.items() if k != "key"})] == \
        [(p, a.shape, a.dtype) for p, a in leaves({k: v for k, v in parr.items() if k != "key"})]
    # a fresh port runner resumed from round 2 runs round 3 as the uninterrupted run did
    rdir = str(tmp_path / "resume")
    os.makedirs(rdir)
    shutil.copytree(os.path.join(dirs["port"], "step_00000002"), os.path.join(rdir, "step_00000002"))
    runner = got["runner"]
    resumed = api.build("fedhetlora", cfg=runner.ctx.cfg, peft_cfg=runner.ctx.peft_cfg, stld_cfg=runner.ctx.stld_cfg,
                        fed_cfg=runner.ctx.fed_cfg, train_cfg=runner.ctx.train_cfg, seed=SEED,
                        params=convert.params_from_jax(runs["sync"][0]["base"], "cpu"), device="cpu",
                        device_profile=PROFILE, checkpoint_dir=rdir, resume=True)
    assert resumed.state.round_index == 2
    result = resumed.run(rounds=3)
    assert list(resumed.state.history) == list(runner.state.history)
    assert result.final_accuracy == got["result"].final_accuracy
    assert_trees_equal(resumed.state.global_peft, runner.state.global_peft)
    for dev in runner.state.device_peft:
        assert_trees_equal(resumed.state.device_peft[dev], runner.state.device_peft[dev])


def test_serving_a_hetlora_checkpoint_matches_jax(runs):
    _, _, dirs = runs["sync"]
    jcfg = jax_kwargs({}, {}, "qwen3-1.7b", CFG_KW)["cfg"]
    jparams = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    jb = jax_api.serve(cfg=jcfg, params=jparams, checkpoint_dir=dirs["jax"], batch=3, max_len=24, cache_dtype="float32")
    b = api.serve(cfg=get_config("qwen3-1.7b", smoke=True).replace(**CFG_KW),
                  params=convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"), checkpoint_dir=dirs["jax"],
                  batch=3, max_len=24, cache_dtype="float32", device="cpu")
    ranks = {name: b.pool.registry.get(name)["rank"] for name in b.pool.registry.names()}
    assert ranks == {name: jb.pool.registry.get(name)["rank"] for name in jb.pool.registry.names()}
    assert set(ranks.values()) == {4, 8, 16} and ranks["client_global"] == 16 and b.pool.r_max == 16
    tenants = [min(n for n, r in ranks.items() if r == want and n != "client_global") for want in (4, 8, 16)]
    tenants.append("client_global")
    rng = np.random.default_rng(3)
    for j in range(8):
        prompt = rng.integers(0, jcfg.vocab_size, int(rng.integers(2, 6))).tolist()
        jb.submit(JaxRequest(prompt=prompt, adapter=tenants[j % 4], max_new_tokens=5, uid=j))
        b.submit(Request(prompt=prompt, adapter=tenants[j % 4], max_new_tokens=5, uid=j))
    want = {c.uid: (c.tokens, c.finish_reason) for c in jb.run()}
    assert {c.uid: (c.tokens, c.finish_reason) for c in b.run()} == want and len(want) == 8
