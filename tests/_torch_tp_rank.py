"""One gloo rank of the port's sharded train step, or of its sharded
prefill and decode steps, on the CPU, for ``tests/test_torch_tp.py``,
``tests/test_torch_tp_serve.py`` and ``tests/test_torch_dryrun.py``::

    python tests/_torch_tp_rank.py RANK WORLD PORT INPUTS.npz OUT.npz

``INPUTS.npz`` holds each case's whole trees (``<case>/params/<path>``,
``<case>/peft/<path>``), its tokens (``<case>/tokens``, (B, S+1)) and the
STLD gates of its two steps (``<case>/gates``, (2, L)), and ``runs``, a
JSON list of ``{"case", "arch", "d_ff", "mesh": [data, model], "fsdp",
"stld", "targets", "layout"}`` (the LoRA targets, default the config's; the
base tree's layer layout, default stacked).  The rank runs every run whose mesh has ``WORLD`` ranks: the
first step's gradients (``loss_and_grads``) and two steps from the whole
trees cut to its part (``sharding.specs.shard_tree``), the gates fed to
``stld.sample_drops`` in turn, and saves per run (``<i>/...``) the
gradients, the PEFT tree and AdamW state after the two steps, each step's
metrics and the collectives' counts of each step.  With ``"mismatch": true`` a run feeds
each rank other gates and saves whether the step raised.

A run with ``"kind": "serve"`` (``serve_one``) takes the case's whole
params, its prompt (``<case>/prompt``, (B, P)) and, with ``"peft"``, its
plain LoRA tree (``<case>/peft/...``) or its tenant pools
(``<case>/pool/<proj>/{a,b,idx,ranks}``, stacked), cuts them and the
caches (``init_caches``, float32 or ``"cache_dtype"``) by the reference's specs
(``cache_specs``, the sequence over ``data`` with ``"seq"``), runs the
sharded prefill and ``"steps"`` greedy decode steps (``"pos": "rows"``
turns the caches' scalar positions into one a row after the prefill and
decodes at ``(B,)`` positions) and saves the rank's last logits of each
step, its tokens, its caches and each step's counts.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import PEFTConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core import stld  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step  # noqa: E402
from repro_torch.models.losses import vocab_parallel_argmax  # noqa: E402
from repro_torch.models.transformer import init_caches  # noqa: E402
from repro_torch.nn.linear import AdapterPool  # noqa: E402
from repro_torch.models.stacking import in_layout, tree_leaves  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.sharding import specs as S  # noqa: E402

AXES = ("data", "model")
METRICS = ("loss", "accuracy", "grad_norm", "tokens")


def flatten(tree, prefix: str, out: dict):
    """A tree of dicts of arrays (or tensors) into ``out[prefix + path]``,
    the keys sorted (the order of ``jax.tree.leaves``)."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            flatten(v, f"{prefix}{k}/", out)
        else:
            out[prefix + k] = np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
    return out


def unflatten(data, prefix: str) -> dict:
    """The tree of tensors under ``prefix`` of an npz."""
    tree = {}
    for key in data.files:
        if key.startswith(prefix):
            node, *path = key[len(prefix):].split("/")
            parts = [node, *path]
            at = tree
            for p in parts[:-1]:
                at = at.setdefault(p, {})
            at[parts[-1]] = torch.from_numpy(np.array(data[key]))
    return tree


def case_config(run: dict):
    cfg = get_config(run["arch"], smoke=True).replace(num_layers=2, dtype="float32")
    if run.get("head_dim"):
        cfg = cfg.replace(head_dim=run["head_dim"])
    return cfg.replace(d_ff=run["d_ff"]) if run.get("d_ff") else cfg


def serve_peft(data, case: str, kind):
    """The serve run's PEFT tree: None, the plain LoRA tree, or a tree of
    :class:`AdapterPool` nodes (``<case>/pool/<proj>/...``)."""
    if kind == "lora":
        return unflatten(data, f"{case}/peft/")
    if kind == "pool":
        pools = unflatten(data, f"{case}/pool/")
        return {"attn": {name: AdapterPool(**{f: node[f] for f in ("a", "b", "idx", "ranks")})
                         for name, node in pools["attn"].items()}}
    return None


def serve_one(data, run: dict, out: dict, i: int):
    """A serve run (the module docstring), its outputs under ``<i>/``."""
    cfg = case_config(run)
    case = run["case"]
    params = unflatten(data, f"{case}/params/")
    prompt = torch.from_numpy(data[f"{case}/prompt"])
    b, p = prompt.shape
    shape = tuple(run["mesh"])
    mesh = make_mesh(shape, AXES, device_type="cpu")
    sizes, coords = dict(zip(AXES, shape)), dict(zip(AXES, mesh.get_coordinate()))
    S.set_mesh_axis_sizes(mesh)
    seq = bool(run.get("seq"))
    local = S.shard_tree(params, S.param_specs(params, sizes["model"]), sizes, coords)
    caches = init_caches(cfg, b, p + run["steps"], dtype=getattr(torch, run.get("cache_dtype", "float32")))
    cache_spec = S.cache_specs(caches, ("data",), sizes["model"], shard_seq_on_data=seq)
    caches = S.shard_tree(caches, cache_spec, sizes, coords)
    rows = b if seq else b // sizes["data"]
    lo = 0 if seq else coords["data"] * rows
    peft = serve_peft(data, case, run.get("peft"))
    if isinstance(peft, dict) and run.get("peft") == "pool":  # the rank's rows of each pool's slot map
        peft = {"attn": {k: AdapterPool(v.a, v.b, v.idx[..., lo:lo + rows].contiguous(), v.ranks)
                         for k, v in peft["attn"].items()}}
    prefill = make_prefill_step(cfg, mesh=mesh, shard_seq=seq)
    serve = make_serve_step(cfg, mesh=mesh, shard_seq=seq)
    counts = []
    logits, caches = prefill(local, {"tokens": prompt[lo:lo + rows]}, caches)
    counts.append(dict(prefill.comm.counts))
    token = vocab_parallel_argmax(logits, prefill.comm)[:, None].to(torch.int32)
    out[f"{i}/logits/0"], tokens = logits.numpy(), []
    if run.get("pos") == "rows":
        for cache in caches:
            cache["pos"] = torch.full((b,), p, dtype=torch.int32)
    for k in range(run["steps"]):
        serve.comm.reset()
        pos = torch.full((b,), p + k, dtype=torch.int32) if run.get("pos") == "rows" else p + k
        logits, token, caches = serve(local, token, pos, caches, peft=peft)
        counts.append(dict(serve.comm.counts))
        out[f"{i}/logits/{k + 1}"] = logits.numpy()
        tokens.append(token[:, 0].numpy())
    out[f"{i}/tokens"] = np.stack(tokens)
    for l, cache in enumerate(caches):
        out[f"{i}/caches/{l}/k"], out[f"{i}/caches/{l}/v"] = cache["k"].float().numpy(), cache["v"].float().numpy()
    out[f"{i}/coords"] = np.array([coords[a] for a in AXES])
    out[f"{i}/counts"] = np.array(json.dumps(counts))


def run_one(data, run: dict, rank: int, out: dict, i: int):
    cfg = case_config(run)
    case = run["case"]
    params, peft = unflatten(data, f"{case}/params/"), unflatten(data, f"{case}/peft/")
    if run.get("layout"):
        params["layers"] = in_layout(params["layers"], run["layout"], cfg.num_layers)
    tokens, gates = torch.from_numpy(data[f"{case}/tokens"]), data[f"{case}/gates"]
    shape = tuple(run["mesh"])
    mesh = make_mesh(shape, AXES, device_type="cpu")
    sizes, coords = dict(zip(AXES, shape)), dict(zip(AXES, mesh.get_coordinate()))
    S.set_mesh_axis_sizes(mesh)
    tp = sizes["model"]
    local = S.shard_tree(params, S.param_specs(params, tp, fsdp_axes=("data",) if run["fsdp"] else ()), sizes, coords)
    regather = S.param_specs(params, tp) if run["fsdp"] else None
    pcfg = PEFTConfig(lora_targets=tuple(run["targets"])) if run.get("targets") else PEFTConfig()
    step = make_train_step(cfg, pcfg, TrainConfig(), stld_mode=run.get("stld", "cond"), mesh=mesh,
                           regather_specs=regather)
    rows = tokens.shape[0] // sizes["data"]
    batch = {"tokens": tokens[coords["data"] * rows:(coords["data"] + 1) * rows]}
    if run.get("mismatch"):
        stld.sample_drops = lambda generator, rates, min_active=1: torch.from_numpy(gates[rank % 2].copy())
        try:
            step(local, peft, adamw_init(peft), batch, torch.Generator())
            out[f"{i}/raised"] = np.array(False)
        except RuntimeError as e:
            out[f"{i}/raised"] = np.array("different STLD gates" in str(e))
        return
    feed = iter([gates[0], gates[0], gates[1]])
    stld.sample_drops = lambda generator, rates, min_active=1: torch.from_numpy(next(feed).copy())
    _, grads = step.loss_and_grads(local, peft, batch, torch.Generator())
    p, opt = peft, adamw_init(peft)
    metrics, counts = [], []
    for _ in range(2):
        step.comm.reset()
        p, opt, m = step(local, p, opt, batch, torch.Generator())
        metrics.append([float(m[k]) for k in METRICS])
        counts.append(step.comm.counts)
    for name, tree in (("grads", grads), ("peft", p), ("m", opt["m"]), ("v", opt["v"])):
        for j, leaf in enumerate(tree_leaves(tree)):
            out[f"{i}/{name}/{j}"] = leaf.detach().numpy()
    out[f"{i}/metrics"] = np.array(metrics)
    out[f"{i}/counts"] = np.array(json.dumps(counts))


def main():
    rank, world, port = (int(a) for a in sys.argv[1:4])
    inputs, out_path = sys.argv[4:6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    data = np.load(inputs)
    out = {}
    for i, run in enumerate(json.loads(str(data["runs"]))):
        if run["mesh"][0] * run["mesh"][1] != world:
            continue
        if run.get("kind") == "serve":
            serve_one(data, run, out, i)
        else:
            run_one(data, run, rank, out, i)
    np.savez(out_path, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
