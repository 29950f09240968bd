"""The port's sharded train step (``make_train_step(mesh=...,
regather_specs=...)``) against the JAX package's, on the CPU: gloo ranks
in processes of their own (``tests/_torch_tp_rank.py``), float32, the smoke
configs of qwen3-1.7b and glm4-9b at 2 layers, STLD ``cond`` with the
gates of JAX's keys ``GATE_KEYS`` fed to every rank.

Meshes: ``1 x 2`` (tensor parallelism over ``model``), ``1 x 4`` (``wk``'s
64 columns in shards of 16 for heads of 32: each pair of ranks gathers its
KV head; glm4-9b with LoRA on every projection there, the row-parallel
``o`` and ``down`` and the gathered ``k`` too) and ``2 x 2`` with FSDP (base params also cut over ``data`` and
gathered back by ``regather_specs``; qwen3's also with its base tree in
the list layout, its specs built from that tree).  The FSDP cases widen
``d_ff``, glm4-9b's to 4 096 and qwen3's to 8 192: ``param_specs`` cuts
over the data axes only leaves of at least 2**20 elements, at the smoke
width none is, and a layer's own (128, 8 192) MLP weight of the list
layout is.

Each is held against the reference's ``make_train_step`` on the same
weights (drawn by the port, handed to JAX), batch and gates: the
``1 x 2`` and ``1 x 4`` runs against its unsharded jitted step, the
``2 x 2`` FSDP runs against its own sharded step with ``regather_specs``,
jitted with ``in_shardings`` on a 2 x 2 host mesh
(``tests/_jax_tp_reference.py``).  Tolerances, each with its reason:

* losses and gradient norms of both steps, rtol 1e-5: float32 sums in
  another order (partial products summed over ranks);
* the first step's PEFT gradients, within 1e-5 of each leaf's largest
  element: the same, through the backward;
* the PEFT tree after two steps: every element within 2·Σlr + 1e-6 and
  99 % within 1e-6 (AdamW's first steps move an element by about lr ·
  sign(g), which may flip for a gradient within float error of 0);
* every rank's gradients, PEFT tree and AdamW state bit-identical: they
  come out of one ``all_reduce``.

Ranks that draw other gates raise.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import peft as jax_peft
from repro.core import stld as jax_stld
from repro.core.schedules import unit_shape as jax_unit_shape
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import model_apply as jax_model_apply
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import PEFTConfig, TrainConfig
from repro_torch.core.peft import init_peft
from repro_torch.models.registry import init_params
from repro_torch.models.stacking import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_tp_rank import case_config, flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GATE_KEYS = (3, 0)  # as tests/_jax_tp_reference.py
BATCH, SEQ = 4, 16
ALL_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")  # LoRA on every projection, row-parallel ones too
CASES = {"qwen3": ("qwen3-1.7b", None), "glm4": ("glm4-9b", None), "glm4-all": ("glm4-9b", None),
         "qwen3-fsdp": ("qwen3-1.7b", 8192), "glm4-fsdp": ("glm4-9b", 4096)}
TARGETS = {"glm4-all": ALL_TARGETS}
RUNS = [{"case": case, "mesh": mesh, "fsdp": fsdp} for case, mesh, fsdp in (
    ("qwen3", [1, 2], False), ("glm4", [1, 2], False), ("qwen3", [1, 4], False), ("glm4-all", [1, 4], False),
    ("qwen3-fsdp", [2, 2], True), ("glm4-fsdp", [2, 2], True))]
RUNS.append({"case": "qwen3-fsdp", "mesh": [2, 2], "fsdp": True, "layout": "list"})  # specs of the list layout
RUNS.append({"case": "qwen3", "mesh": [1, 2], "fsdp": False, "mismatch": True})
METRICS = ("loss", "accuracy", "grad_norm", "tokens")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _inputs(tmp):
    """Every case's trees, tokens and gates (numpy), into ``in.npz``."""
    data = {"runs": np.array(json.dumps([dict(r, arch=CASES[r["case"]][0], d_ff=CASES[r["case"]][1],
                                              targets=TARGETS.get(r["case"])) for r in RUNS]))}
    for case, (arch, d_ff) in CASES.items():
        cfg = case_config({"arch": arch, "d_ff": d_ff})
        gen = torch.Generator().manual_seed(0)
        params = init_params(cfg, gen)
        peft = init_peft(cfg, PEFTConfig(lora_targets=TARGETS.get(case, PEFTConfig().lora_targets)), gen)
        for leaf in tree_leaves(peft):  # b off zero, so that dA is not zero
            leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
        flatten(params, f"{case}/params/", data)
        flatten(peft, f"{case}/peft/", data)
        data[f"{case}/tokens"] = np.random.default_rng(1).integers(0, cfg.vocab_size, (BATCH, SEQ + 1), dtype=np.int32)
        rates = jnp.clip(jax_unit_shape("incremental", cfg.num_layers) * 0.5, 0.0, 0.95)
        data[f"{case}/gates"] = np.stack([np.asarray(jax_stld.sample_drops(jax.random.PRNGKey(k), rates, 1))
                                          for k in GATE_KEYS])
        data[f"{case}/arch"] = np.array(arch)
    np.savez(tmp / "in.npz", **data)
    return np.load(tmp / "in.npz")


def _tree(data, prefix):
    tree = {}
    for key in data.files:
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            at = tree
            for p in path:
                at = at.setdefault(p, {})
            at[last] = jnp.asarray(data[key])
    return tree


def _jax_reference(data, case):
    """The reference's two unsharded steps (metrics, PEFT leaves) and the
    first step's PEFT gradients."""
    arch, d_ff = CASES[case]
    jcfg = jax_get_config(arch, smoke=True).replace(num_layers=2, dtype="float32")
    params, peft, tokens = _tree(data, f"{case}/params/"), _tree(data, f"{case}/peft/"), jnp.asarray(data[f"{case}/tokens"])
    pcfg = JaxPEFTConfig(lora_targets=TARGETS.get(case, JaxPEFTConfig().lora_targets))
    step = jax.jit(jax_make_train_step(jcfg, pcfg, JaxTrainConfig(), stld_mode="cond"))
    p, opt, rows = peft, jax_adamw_init(peft), []
    for k in GATE_KEYS:
        p, opt, m = step(params, p, opt, {"tokens": tokens}, jax.random.PRNGKey(k))
        rows.append([float(m[name]) for name in METRICS])

    def loss(pf):
        logits, _, _ = jax_model_apply(params, jcfg, {"tokens": tokens[:, :-1]}, drops=jnp.asarray(data[f"{case}/gates"][0]),
                                       peft=pf, lora_scale=jax_peft.lora_scale(pcfg), stack_mode="unroll")
        return jax_softmax_xent(logits, tokens[:, 1:])

    (_, _), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(peft)
    return np.array(rows), [np.asarray(x) for x in jax.tree.leaves(p)], [np.asarray(x) for x in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the gloo worlds (2 and 4 ranks) and the reference's sharded
    run, compute the unsharded references meanwhile, then gather every
    result: (inputs, per-run rank outputs, references by case)."""
    tmp = tmp_path_factory.mktemp("tp")
    data = _inputs(tmp)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    procs = {}
    for world in (2, 4):
        port = str(_free_port())
        for r in range(world):
            procs[world, r] = subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_tp_rank.py"), str(r), str(world), port,
                 str(tmp / "in.npz"), str(tmp / f"w{world}r{r}.npz")], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    fsdp_cases = [f"{c}:{CASES[c][1]}" for c in CASES if CASES[c][1]]
    procs["jax"] = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_tp_reference.py"), str(tmp / "in.npz"),
                                     str(tmp / "jax.npz"), *fsdp_cases], env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    refs = {case: _jax_reference(data, case) for case in CASES if not CASES[case][1]}
    logs = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
    failed = {k: logs[k][-3000:] for k, p in procs.items() if p.returncode != 0}
    assert not failed, failed
    jx = np.load(tmp / "jax.npz")
    for case in CASES:
        if CASES[case][1]:
            n = sum(k.startswith(f"{case}/peft/") for k in jx.files)
            refs[case] = (jx[f"{case}/metrics"], [jx[f"{case}/peft/{i}"] for i in range(n)],
                          [jx[f"{case}/grads/{i}"] for i in range(n)])
    outs = {}
    for i, run in enumerate(RUNS):
        world = run["mesh"][0] * run["mesh"][1]
        outs[i] = [np.load(tmp / f"w{world}r{r}.npz") for r in range(world)]
    return data, outs, refs


def _name(run) -> str:
    return f"{run['case']}-{run['mesh'][0]}x{run['mesh'][1]}" + (f"-{run['layout']}" if run.get("layout") else "")


def _leaves(out, i, name):
    n = sum(k.startswith(f"{i}/{name}/") for k in out.files)
    return [out[f"{i}/{name}/{j}"] for j in range(n)]


@pytest.mark.parametrize("i", [i for i, r in enumerate(RUNS) if not r.get("mismatch")],
                         ids=[_name(r) for r in RUNS if not r.get("mismatch")])
def test_sharded_step_matches_the_reference(runs, i):
    data, outs, refs = runs
    metrics, peft, grads = refs[RUNS[i]["case"]]
    rank0 = outs[i][0]
    got = rank0[f"{i}/metrics"]
    for col in (0, 2):  # loss, grad_norm
        np.testing.assert_allclose(got[:, col], metrics[:, col], rtol=1e-5, err_msg=METRICS[col])
    np.testing.assert_array_equal(got[:, 3], metrics[:, 3])  # tokens of the global batch
    np.testing.assert_allclose(got[:, 1], metrics[:, 1], atol=1e-6)
    mine = _leaves(rank0, i, "grads")
    assert len(mine) == len(grads)
    for g, w in zip(mine, grads):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), np.abs(g - w).max() / np.abs(w).max()
    diffs = np.concatenate([np.abs(g - w).ravel() for g, w in zip(_leaves(rank0, i, "peft"), peft)])
    lr = TrainConfig().learning_rate
    assert diffs.max() <= 2 * (2 * lr) + 1e-6, diffs.max()
    assert np.mean(diffs <= 1e-6) >= 0.99
    # every rank's trees bit for bit, and each step's collectives counted alike
    for other in outs[i][1:]:
        for name in ("grads", "peft", "m", "v"):
            for a, b in zip(_leaves(rank0, i, name), _leaves(other, i, name)):
                np.testing.assert_array_equal(a, b, err_msg=name)
        assert str(other[f"{i}/counts"]) == str(rank0[f"{i}/counts"])


def test_head_gather_and_regather_are_counted(runs):
    """``1 x 4``: each step gathers ``wk`` and ``wv``'s halves of a head
    (2 layers of (d 128, 32) float32 each, among 2 ranks); ``2 x 2`` FSDP:
    each step gathers the leaves cut over ``data``."""
    _, outs, _ = runs
    by_name = {_name(r): i for i, r in enumerate(RUNS) if not r.get("mismatch")}
    for name in ("qwen3-1x4", "glm4-all-1x4"):
        counts = json.loads(str(outs[by_name[name]][0][f"{by_name[name]}/counts"]))
        assert all(c["all-gather"] == 2 * 2 * 128 * 32 * 4 for c in counts), counts
    for name in ("qwen3-1x2", "glm4-1x2"):
        counts = json.loads(str(outs[by_name[name]][0][f"{by_name[name]}/counts"]))
        assert all(c["all-gather"] == 0 and c["all-reduce"] > 0 for c in counts), counts
    for name in ("qwen3-fsdp-2x2", "glm4-fsdp-2x2", "qwen3-fsdp-2x2-list"):
        counts = json.loads(str(outs[by_name[name]][0][f"{by_name[name]}/counts"]))
        # gate, up and down (2, 128, 4096 / 2) float32 regathered from halves over data
        assert all(c["all-gather"] >= 3 * 2 * 128 * 2048 * 4 for c in counts), counts


def test_ranks_that_draw_other_gates_raise(runs):
    _, outs, _ = runs
    i = next(i for i, r in enumerate(RUNS) if r.get("mismatch"))
    assert all(bool(out[f"{i}/raised"]) for out in outs[i])


@pytest.mark.parametrize("fsdp", [False, True])
def test_shard_tree_cuts_as_distribute_tensor_and_unshard_tree_puts_back(fsdp):
    """Every rank's part of qwen3's wide smoke params on a 2 x 2 mesh is
    the block its spec names, in the order of a tuple of mesh axes (the
    first major); ``unshard_tree`` of the four parts is the whole tree."""
    from repro_torch.sharding import specs as S

    cfg = case_config({"arch": "qwen3-1.7b", "d_ff": 4096})
    whole = init_params(cfg, torch.Generator().manual_seed(0))
    sizes = {"data": 2, "model": 2}

    class Mesh:
        shape = sizes

    S.set_mesh_axis_sizes(Mesh)
    spec = S.param_specs(whole, 2, fsdp_axes=("data",) if fsdp else ())
    parts = {(d, m): S.shard_tree(whole, spec, sizes, {"data": d, "model": m}) for d in range(2) for m in range(2)}
    gate = whole["layers"]["mlp"]["gate"]["w"]  # (2, 128, 4096): columns over model, FSDP rows over data
    assert tuple(spec["layers"]["mlp"]["gate"]["w"]) == (None, "data" if fsdp else None, "model")
    for (d, m), part in parts.items():
        rows = slice(d * 64, (d + 1) * 64) if fsdp else slice(None)
        assert torch.equal(part["layers"]["mlp"]["gate"]["w"], gate[:, rows, m * 2048:(m + 1) * 2048])
        assert torch.equal(part["embed"], whole["embed"][m * 256:(m + 1) * 256])
    back = S.unshard_tree(parts, spec, sizes)

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
        return torch.equal(a, b)

    assert same(back, whole)


@pytest.mark.parametrize("field,value", [("num_heads", 3), ("vocab_size", 513), ("d_ff", 257)])
def test_a_config_that_does_not_split_over_model_raises(field, value):
    """Query heads, the vocabulary and ``d_ff`` each split over ``model``,
    or the step raises before it runs (the specs would replicate the leaf
    where the step reads a shard of it)."""
    from repro_torch.launch.input_specs import MeshShape
    from repro_torch.launch.steps import make_train_step

    cfg = case_config({"arch": "qwen3-1.7b"}).replace(**{field: value})
    with pytest.raises(NotImplementedError, match="split over model"):
        make_train_step(cfg, PEFTConfig(), TrainConfig(), mesh=MeshShape({"data": 1, "model": 2}))
