"""The port's sharded prefill and decode steps (``make_prefill_step`` and
``make_serve_step`` with ``mesh=...``) against the JAX package's own steps
jitted with ``in_shardings`` on the same (data, model) host mesh, on the
CPU: gloo ranks in processes of their own (``tests/_torch_tp_rank.py``'s
``serve_one``), the reference in one process of four host devices
(``tests/_jax_tp_reference.py``'s ``serve``), float32 (weights, compute
and caches), smoke configs at 2 layers, a prompt then ``STEPS`` greedy
decode steps.

Runs, by how ``cache_specs`` cuts the caches:

* qwen3-1.7b (H 4, KV 2, hd 32) on ``1 x 2``: the KV heads over
  ``model``, with both ``pos`` forms (the scalar of ``init_caches`` and
  one a row), a pool of 4 tenants (ranks 4 and 8 on ``q`` and ``v``,
  ``segmented_lora`` on the rank's columns) and a plain LoRA tree;
* qwen3-1.7b on ``2 x 2``: the rows over ``data`` too, both ``pos`` forms;
* qwen3-1.7b on ``1 x 4``: KV 2 under ``model`` 4, so the head dim, 8 a
  rank (the ``all_to_all`` of the prefill's K/V, the split pair at decode);
* qwen3-1.7b at head dim 30 on ``1 x 4``: neither divides, the caches
  whole on every rank;
* h2o-danube-1.8b (window 64) on ``1 x 4``, the head dim cut, a prompt of
  70 past the ring;
* h2o-danube-1.8b on ``2 x 2`` at batch 1 with the sequence over
  ``data`` (32 slots a rank): a prompt of 30, whose decode crosses from
  rank 0's slots to rank 1's, and one of 70 past the ring.

Tolerances, each with its reason (float32 sums in another order: the
row-parallel products and the scores summed over ranks, the decode's
log-sum-exp combine):

* every step's last logits, gathered from the ranks' vocabulary slices,
  within 1e-5 of the largest |logit|;
* the tokens equal, and bit-identical on every ``model`` rank;
* the caches put back by ``unshard_tree`` within 1e-5 of the largest
  |element|.
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import PEFTConfig
from repro_torch.core.peft import init_peft
from repro_torch.kernels import ops, ref
from repro_torch.launch.input_specs import MeshShape
from repro_torch.models.registry import init_params
from repro_torch.models.stacking import tree_leaves
from repro_torch.models.transformer import init_caches
from repro_torch.sharding import specs as S

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_tp_rank import case_config, flatten  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
STEPS = 4
TOL = 1e-5
# case: (arch, head_dim, batch, prompt length)
CASES = {"qwen3": ("qwen3-1.7b", None, 4, 12), "qwen3-pool": ("qwen3-1.7b", None, 4, 12),
         "qwen3-lora": ("qwen3-1.7b", None, 4, 12), "qwen3-whole": ("qwen3-1.7b", 30, 4, 12),
         "danube": ("h2o-danube-1.8b", None, 2, 70), "danube-seq": ("h2o-danube-1.8b", None, 1, 30),
         "danube-seq-long": ("h2o-danube-1.8b", None, 1, 70)}
RUNS = [dict(kind="serve", steps=STEPS, **r) for r in (
    {"case": "qwen3", "mesh": [1, 2]}, {"case": "qwen3", "mesh": [1, 2], "pos": "rows"},
    {"case": "qwen3-pool", "mesh": [1, 2], "peft": "pool", "pos": "rows"},
    {"case": "qwen3-lora", "mesh": [1, 2], "peft": "lora"},
    {"case": "qwen3", "mesh": [2, 2]}, {"case": "qwen3", "mesh": [2, 2], "pos": "rows"},
    {"case": "qwen3", "mesh": [1, 4]}, {"case": "qwen3-whole", "mesh": [1, 4]},
    {"case": "danube", "mesh": [1, 4]}, {"case": "danube-seq", "mesh": [2, 2], "seq": True},
    {"case": "danube-seq-long", "mesh": [2, 2], "seq": True})]
POOL_RANKS = (4, 8, 4, 8)  # the tenants' LoRA ranks, r_max 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pools(cfg, gen, batch: int) -> dict:
    """Stacked tenant pools on ``q`` and ``v``: a and b drawn, each tenant's
    rank tail zero, row i at tenant i."""
    hd, layers, n, r_max = cfg.resolved_head_dim, cfg.num_layers, len(POOL_RANKS), max(POOL_RANKS)
    out = {}
    for name, width in (("q", cfg.num_heads * hd), ("v", cfg.num_kv_heads * hd)):
        a = 0.1 * torch.randn((layers, n, cfg.d_model, r_max), generator=gen)
        b = 0.1 * torch.randn((layers, n, r_max, width), generator=gen)
        for t, r in enumerate(POOL_RANKS):
            a[:, t, :, r:] = 0
            b[:, t, r:] = 0
        out[name] = {"a": a, "b": b, "idx": torch.arange(batch, dtype=torch.int32).expand(layers, batch).contiguous(),
                     "ranks": torch.tensor(POOL_RANKS, dtype=torch.int32).expand(layers, n).contiguous()}
    return {"attn": out}


def _run_config(run):
    arch, head_dim, _, _ = CASES[run["case"]]
    return case_config({"arch": arch, "head_dim": head_dim})


def _inputs(tmp):
    runs = [dict(r, arch=CASES[r["case"]][0], head_dim=CASES[r["case"]][1]) for r in RUNS]
    data = {"runs": np.array(json.dumps(runs))}
    for case, (arch, head_dim, batch, prompt) in CASES.items():
        cfg = case_config({"arch": arch, "head_dim": head_dim})
        gen = torch.Generator().manual_seed(0)
        flatten(init_params(cfg, gen), f"{case}/params/", data)
        data[f"{case}/prompt"] = np.random.default_rng(1).integers(0, cfg.vocab_size, (batch, prompt), dtype=np.int32)
        if case == "qwen3-lora":
            peft = init_peft(cfg, PEFTConfig(), gen)
            for leaf in tree_leaves(peft):  # b off zero
                leaf.add_(0.05 * torch.randn(leaf.shape, generator=gen))
            flatten(peft, f"{case}/peft/", data)
        if case == "qwen3-pool":
            flatten(_pools(cfg, gen, batch), f"{case}/pool/", data)
    np.savez(tmp / "in.npz", **data)
    return np.load(tmp / "in.npz")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Start the gloo worlds (2 and 4 ranks) and the reference's process,
    then gather: (per-run rank outputs, the reference's outputs)."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    _inputs(tmp)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
    procs = {}
    for world in (2, 4):
        port = str(_free_port())
        for r in range(world):
            procs[world, r] = subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "_torch_tp_rank.py"), str(r), str(world), port,
                 str(tmp / "in.npz"), str(tmp / f"w{world}r{r}.npz")], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    procs["jax"] = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_tp_reference.py"), str(tmp / "in.npz"),
                                     str(tmp / "jax.npz"), *(f"serve:{i}" for i in range(len(RUNS)))], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
    failed = {k: logs[k][-3000:] for k, p in procs.items() if p.returncode != 0}
    assert not failed, failed
    outs = {i: [np.load(tmp / f"w{r['mesh'][0] * r['mesh'][1]}r{k}.npz") for k in range(r["mesh"][0] * r["mesh"][1])]
            for i, r in enumerate(RUNS)}
    return outs, np.load(tmp / "jax.npz")


def _name(run) -> str:
    extra = [run[k] if k != "seq" else "seq" for k in ("peft", "pos", "seq") if run.get(k)]
    return "-".join([run["case"], f"{run['mesh'][0]}x{run['mesh'][1]}", *extra])


def _cache_spec(run):
    """The ``cache_specs`` of the run's whole caches, K and V only."""
    cfg, (_, _, batch, prompt) = _run_config(run), CASES[run["case"]]
    sizes = dict(zip(("data", "model"), run["mesh"]))
    S.set_mesh_axis_sizes(MeshShape(sizes))
    caches = init_caches(cfg, batch, prompt + STEPS, dtype=torch.float32, device="meta")
    spec = S.cache_specs(caches, ("data",), sizes["model"], shard_seq_on_data=bool(run.get("seq")))
    return [{"k": s["k"], "v": s["v"]} for s in spec], sizes


@pytest.mark.parametrize("i", range(len(RUNS)), ids=[_name(r) for r in RUNS])
def test_sharded_serving_matches_the_reference(served, i):
    outs, jx = served
    run = RUNS[i]
    seq = bool(run.get("seq"))
    ranks = outs[i]
    coords = [tuple(int(c) for c in out[f"{i}/coords"]) for out in ranks]
    for k in range(STEPS + 1):
        want = jx[f"serve{i}/logits/{k}"]
        got = np.zeros_like(want)
        for (d, m), out in zip(coords, ranks):
            part = out[f"{i}/logits/{k}"]
            rows = 0 if seq else d * part.shape[0]
            got[rows:rows + part.shape[0], m * part.shape[1]:(m + 1) * part.shape[1]] = part
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= TOL, (k, err)
    want_tokens = jx[f"serve{i}/tokens"]
    for (d, m), out in zip(coords, ranks):
        tokens = out[f"{i}/tokens"]
        rows = 0 if seq else d * tokens.shape[1]
        np.testing.assert_array_equal(tokens, want_tokens[:, rows:rows + tokens.shape[1]])
        twin = next(o for c, o in zip(coords, ranks) if c[0] == d)  # every model rank's tokens, bit for bit
        np.testing.assert_array_equal(tokens, twin[f"{i}/tokens"])
    spec, sizes = _cache_spec(run)
    parts = {c: [{"k": torch.from_numpy(out[f"{i}/caches/{l}/k"]), "v": torch.from_numpy(out[f"{i}/caches/{l}/v"])}
                 for l in range(len(spec))] for c, out in zip(coords, ranks)}
    whole = S.unshard_tree(parts, spec, sizes)
    for l, cache in enumerate(whole):
        for name in ("k", "v"):
            want = jx[f"serve{i}/caches/{l}/{name}"]
            assert np.abs(cache[name].numpy() - want).max() <= TOL * np.abs(want).max(), (l, name)


def _counts(outs, i) -> list:
    return json.loads(str(outs[i][0][f"{i}/counts"]))


def test_serving_collectives_are_counted(served):
    """Each step's bytes by kind, from the shapes (float32, 2 layers, d
    128): qwen3 on ``1 x 4`` cuts its caches on the head dim (8 of hd 32 a
    rank, one query head and one KV head computed a rank), danube's
    ``2 x 2`` sequence run combines its decodes over ``data``."""
    outs, _ = served
    by_name = {_name(r): i for i, r in enumerate(RUNS)}
    f, layers, d, b, h, kv, hd = 4, 2, 128, 4, 4, 2, 32
    counts = _counts(outs, by_name["qwen3-1x4"])
    # the prefill's K and V of 12 tokens into the cut: one all_to_all a layer, KV x (2, B, 12, 8) sent
    assert counts[0]["all-to-all"] == layers * kv * 2 * b * 12 * 8 * f
    s = 12 + STEPS  # the ring's slots
    head_gather = 2 * 2 * (layers * d * hd // 2 * f)  # wk and wv's halves of a head, among 2 ranks, each step
    for c in counts[1:]:
        assert c["all-to-all"] == 0
        # q, k and v of the rank's heads over model, then every head's 8 dims back
        assert c["all-gather"] == head_gather + layers * (4 * b * (1 + 2) * hd * f + 4 * b * h * 8 * f)
        # the scores, wo, down, the embedding, the argmax's max (float32) and min (int64)
        assert c["all-reduce"] == layers * (b * h * s * f + 2 * b * d * f) + b * d * f + b * (4 + 8)
    counts = _counts(outs, by_name["danube-seq-2x2-seq"])
    for c in counts[1:]:  # wo, down, the lse's max and the weighted sum (2 local heads, hd + 1), embed, argmax
        assert c["all-reduce"] == layers * (2 * d * f + 2 * f + 2 * (hd + 1) * f) + d * f + 4 + 8
        assert c["all-gather"] == 0


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("dr", [5, 8, 32])
def test_split_pair_twins_match_decode_attention(dr, window):
    """The head-dim split's twins (``flash_decode_scores`` summed over the
    slices of hd 160, then ``flash_decode_combine`` on each slice) give
    ``decode_attention_plain``'s output and ``flash_decode``'s log-sum-exp,
    within 1e-5 in float32 (sums in another order); rows with every slot
    dead take the mean of V, as there."""
    g = torch.Generator().manual_seed(dr)
    b, h, kv, hd, s = 3, 8, 2, 160, 40
    q, k, v = (torch.randn(shape, generator=g) for shape in ((b, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    q_pos = torch.tensor([30, 10, -1], dtype=torch.int32)  # the last row sees no slot
    k_pos = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    want, want_lse = ops.flash_decode(q, k, v, q_pos, k_pos, window=window, return_lse=True)
    cuts = [(lo, lo + dr) for lo in range(0, hd, dr)]
    scores = sum(ops.flash_decode_scores(q[..., lo:hi].contiguous(), k[..., lo:hi].contiguous(), scale=hd**-0.5)
                 for lo, hi in cuts)
    parts = [ops.flash_decode_combine(scores, v[..., lo:hi].contiguous(), q_pos, k_pos, window=window)
             for lo, hi in cuts]
    got = torch.cat([out for out, _ in parts], dim=-1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(want, ref.decode_attention_plain(q, k, v, q_pos, k_pos, window=window))
    for _, lse in parts:
        torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=0)
    assert (want_lse[2] == -1e30).all()


def test_sharded_prefill_not_from_position_0_raises():
    cfg = case_config({"arch": "qwen3-1.7b"})
    from repro_torch.launch.steps import make_prefill_step

    mesh = MeshShape({"data": 1, "model": 2})
    S.set_mesh_axis_sizes(mesh)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    local = S.shard_tree(params, S.param_specs(params, 2), {"data": 1, "model": 2}, {"data": 0, "model": 0})
    whole = init_caches(cfg, 2, 16, dtype=torch.float32)
    caches = S.shard_tree(whole, S.cache_specs(whole, ("data",), 2), {"data": 1, "model": 2}, {"data": 0, "model": 0})
    for cache in caches:
        cache["pos"] = torch.tensor(3, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="starts at position 0"):
        make_prefill_step(cfg, mesh=mesh)(local, {"tokens": torch.zeros((2, 4), dtype=torch.int32)}, caches)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "whisper-tiny", "internvl2-76b"])
def test_sharded_serving_of_another_family_raises(arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    cfg, mesh = get_config(arch, smoke=True), MeshShape({"data": 1, "model": 2})
    for factory in (make_prefill_step, make_serve_step):
        with pytest.raises(NotImplementedError, match="dense family"):
            factory(cfg, mesh=mesh)
