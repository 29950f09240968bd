"""Dry run of every (architecture x input shape x mesh) cell on the
``meta`` device, as ``repro.launch.dryrun``::

    python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]

Where the reference lowers and compiles each cell with XLA, the port runs
its real step (``launch.steps.make_train_step``, ``make_prefill_step``,
``make_serve_step``) on ``meta`` tensors, which carry shapes and no data
(``launch.input_specs``), under ``analysis.trace.run_on_meta``, and writes
one JSON per cell under ``--out-dir``:

* ``flops``: ``FlopCounterMode``'s count of the aten ops plus the
  hand-written kernels' counted work (``kernels.ops.kernel_work``);
* ``bytes_accessed``: the bytes of each recorded device op's inputs and
  outputs plus the kernels' bytes;
* ``memory``: ``argument_bytes`` per device, from each argument leaf's
  ``PartitionSpec`` and the mesh's axis sizes; ``local_argument_bytes``,
  those of the arguments the rank's step took (equal to ``argument_bytes``
  where the step is sharded); ``peak_bytes``, the peak of
  live ``meta`` bytes during one rank's step; ``output_bytes`` and
  ``temp_bytes`` (the peak of the step's allocations less its outputs).
  A ``dense`` arch's cells run rank 0 of the mesh's sharded step
  (``make_train_step``, ``make_prefill_step`` or ``make_serve_step`` with
  ``mesh=...``: its part of the weights, tensor-parallel over ``model``,
  its rows of the batch and its part of the caches by ``cache_specs``,
  their sequence at ``long_500k``; ``--fsdp`` cuts the train step's
  weights over the data axes too and the step gathers them back, as the
  reference's ``regather_specs``).  The other families' cells run one
  data rank's slice of the batch (and, at ``long_500k``, of the cache's
  sequence) with the weights whole, and their ``notes`` say so: their
  sharded steps are later slices;
* ``collectives``: the bytes the port itself communicates, by the
  reference's kinds: a sharded step's, as its
  ``sharding.collectives.Comm`` counted them (each collective's bytes, not
  one run on the card more or less); for another family's
  sequence-sharded long-context decode,
  ``serving.decode.sharded_decode_attention``'s three ``all_reduce``s
  (max, sum, sum of (B, H), (B, H), (B, H, D) float32) per attention
  layer, counted from the shapes; elsewhere 0 (there is no HLO to
  parse);
* ``kernel_launches`` and ``trace_s`` (the step's seconds on ``meta``).

A step that reads device data on the host (``.item()``, ``.cpu()``: on
``meta`` it would read zeros) fails its cell.

A MoE decode step's weight gather cannot read its routing on ``meta``, so
there every expert runs on every token, the upper bound; the record's
``notes`` say so.  An inapplicable cell gets the reference's skip record.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from repro_torch.analysis.trace import run_on_meta, tree_tensors
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, PEFTConfig, TrainConfig, get_config, shape_applicable
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.layers import layer_kind
from repro_torch.nn import moe
from repro_torch.sharding.collectives import COLLECTIVES
from repro_torch.sharding.specs import PartitionSpec, ways


def _pairs(tree, spec_tree):
    """(tensor, spec) pairs of an argument tree and its spec tree, walked
    together; leaves that are not tensors (a generator, a position, a step
    count) carry no bytes."""
    if isinstance(spec_tree, PartitionSpec):
        return [(tree, spec_tree)] if isinstance(tree, torch.Tensor) else []
    if isinstance(spec_tree, dict):
        return [p for k in spec_tree for p in _pairs(tree[k], spec_tree[k])]
    return [p for sub, spec in zip(tree, spec_tree) for p in _pairs(sub, spec)]


def argument_bytes(args, specs, mesh) -> int:
    """Bytes of the arguments on one device: each leaf's bytes over the
    ways its ``PartitionSpec`` shards it on the mesh."""
    sizes = axis_sizes(mesh)
    total = 0
    for t, spec in _pairs(args, specs):
        total += t.numel() * t.element_size() // math.prod(ways(entry, sizes) for entry in spec)
    return total


def collective_bytes(cfg, sharded_seq: bool, batch: int) -> dict:
    """The bytes the step communicates, per collective kind (the
    reference's keys), with ``count`` and ``total``."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    if sharded_seq:
        attn_layers = sum(layer_kind(cfg, l) == "attn" for l in range(cfg.num_layers))
        h, d = cfg.num_heads, cfg.resolved_head_dim
        out["all-reduce"] = attn_layers * 4 * batch * h * (2 + d)  # m, l (B, H) and acc (B, H, D), float32
        out["count"] = 3 * attn_layers
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def _local_args(kind: str, args, specs, mesh, sharded_seq: bool):
    """One data rank's arguments: the batch, token and caches sliced, the
    weights, PEFT and optimizer state whole.  With ``sharded_seq`` the rank
    decodes at the last slot of its slice of the caches."""
    if kind == "train":
        base, peft, opt, batch, rng = args
        return base, peft, opt, ispec.rank_slice(batch, specs[3], mesh), rng
    if kind == "prefill":
        params, batch, caches = args
        return params, ispec.rank_slice(batch, specs[1], mesh), ispec.rank_slice(caches, specs[2], mesh)
    params, token, pos, caches, *enc = args
    token, caches = ispec.rank_slice(token, specs[1], mesh), ispec.rank_slice(caches, specs[3], mesh)
    enc = [ispec.rank_slice(e, s, mesh) for e, s in zip(enc, specs[4:])]
    kv_lens = [t.shape[1] for t in tree_tensors(caches) if t.ndim == 4]
    if sharded_seq and kv_lens:  # the last slot of the rank's (B, S, KV, hd) caches
        pos = max(kv_lens) - 1
        ispec.set_cache_position(caches, pos)
    return (params, token, pos, caches, *enc)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, stld_mode: str = "off", stack_mode: str = "unroll",
             extra_tags: str = "", moe_dispatch: str = "einsum", weights_dtype: str = "float32", fsdp: bool = False,
             mean_rate: float = 0.5, expert_shard: str = "auto") -> dict:
    """Run one cell's step on ``meta``; returns its record.  ``stack_mode``
    goes to the step factories, as the reference's does: the port runs
    every stack mode on one Python layer loop, raising where the
    reference raises, so it changes no count.  ``weights_dtype`` casts the served weights as the
    reference's does; the train step takes the float32 tree as the
    reference's does, unless ``placed`` asks for the card's placement
    (``models.registry.place_params``), which every step then takes."""
    cfg = get_config(arch).replace(moe_dispatch=moe_dispatch)
    rec = run_config(cfg, INPUT_SHAPES[shape_name], ispec.production_mesh(multi_pod=multi_pod), stld_mode=stld_mode,
                     stack_mode=stack_mode, weights_dtype=weights_dtype, fsdp=fsdp, mean_rate=mean_rate,
                     expert_shard=expert_shard)
    return {"arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else "16x16", **rec,
            "tags": extra_tags}


def run_config(cfg, shape, mesh, *, stld_mode: str = "off", stack_mode: str = "unroll",
               weights_dtype: str = "float32", fsdp: bool = False, mean_rate: float = 0.5,
               expert_shard: str = "auto") -> dict:
    """``run_cell``'s record (less the cell's names) for any config, input
    shape and mesh (``input_specs.MeshShape``)."""
    peft_cfg = PEFTConfig(method="lora", lora_rank=8)
    sharded = cfg.family == "dense"
    sharded_seq = shape.kind == "decode" and ispec.serve_shards_seq(shape, mesh)
    if shape.kind == "train":
        train_dtype = "placed" if weights_dtype == "placed" else "float32"
        regather = None
        if sharded:
            args, specs, local, regather = ispec.rank_train_inputs(cfg, peft_cfg, shape, mesh, fsdp=fsdp,
                                                                   weights_dtype=train_dtype)
        else:
            args, specs = ispec.train_inputs(cfg, peft_cfg, shape, mesh, fsdp=fsdp, weights_dtype=train_dtype)
        step = make_train_step(cfg, peft_cfg, TrainConfig(), stld_mode=stld_mode, stack_mode=stack_mode,
                               mean_rate=mean_rate, mesh=mesh if sharded else None, regather_specs=regather)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, stack_mode=stack_mode, mesh=mesh if sharded else None)
        if sharded:
            args, specs, local = ispec.rank_prefill_inputs(cfg, shape, mesh, weights_dtype=weights_dtype)
        else:
            args, specs = ispec.prefill_inputs(cfg, shape, mesh, weights_dtype=weights_dtype)
    else:
        step = make_serve_step(cfg, stack_mode=stack_mode, mesh=mesh if sharded else None,
                               shard_seq=sharded and sharded_seq)
        if sharded:
            args, specs, local = ispec.rank_serve_inputs(cfg, shape, mesh, weights_dtype=weights_dtype,
                                                         expert_shard=expert_shard)
        else:
            args, specs = ispec.serve_inputs(cfg, shape, mesh, weights_dtype=weights_dtype,
                                             expert_shard=expert_shard)
    if not sharded:
        local = _local_args(shape.kind, args, specs, mesh, sharded_seq)
    if shape.kind == "train":
        local[4].manual_seed(0)
    moe.meta_upper_bounds["weight_gather"] = 0
    run = run_on_meta(step, *local)
    if run.host_reads:
        raise RuntimeError(f"the step read device data on the host: {sorted(set(run.host_reads))}")
    notes = []
    if moe.meta_upper_bounds["weight_gather"]:
        notes.append(f"{moe.meta_upper_bounds['weight_gather']} MoE weight gather(s) ran every expert on every "
                     "token (the routing cannot be read on meta): an upper bound")
    if sharded_seq:
        notes.append("the cache's sequence is sharded over the data axes: each rank's step decodes over its slice")
    if sharded:
        collectives = dict(step.comm.counts, total=sum(step.comm.counts[k] for k in COLLECTIVES))
    else:
        notes.append("the weights are whole on one data rank: this step does not yet run sharded over model")
        collectives = collective_bytes(cfg, sharded_seq, local[1].shape[0] if shape.kind == "decode" else 0)
    n_chips = 1
    for v in axis_sizes(mesh).values():
        n_chips *= v
    return {
        "chips": n_chips, "stld_mode": stld_mode, "stack_mode": stack_mode, "ok": True,
        "trace_s": round(run.seconds, 2),
        "flops": run.flops, "aten_flops": run.aten_flops, "kernel_flops": run.kernel_flops,
        "bytes_accessed": run.bytes_accessed,
        "collectives": collectives,
        "memory": {
            "argument_bytes": argument_bytes(args, specs, mesh),
            # with the caches' scalar positions, which live on the host, as argument_bytes counts them
            "local_argument_bytes": run.argument_bytes + sum(t.numel() * t.element_size() for t in tree_tensors(local)
                                                             if t.device.type == "cpu"),
            "output_bytes": run.output_bytes,
            "temp_bytes": run.temp_bytes,
            "peak_bytes": run.peak_bytes,
        },
        "kernel_launches": run.kernel_launches,
        "notes": notes,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="input shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true", help="2x16x16 mesh (else 16x16)")
    ap.add_argument("--stld", default="off", choices=["off", "cond", "gather"])
    ap.add_argument("--stack-mode", default="unroll", choices=["unroll", "scan", "group", "auto"],
                    help="the steps' stack mode ('auto': group for a hybrid stack, else scan); the port runs "
                         "every stack mode on one Python layer loop")
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--moe-dispatch", default="einsum", choices=["einsum", "gather"])
    ap.add_argument("--weights-dtype", default="float32", choices=list(ispec.WEIGHTS_DTYPES),
                    help="the served weights' dtype; 'placed' puts every step's weights as the card holds them "
                         "(matmul weights in the config's dtype, norms float32)")
    ap.add_argument("--fsdp", action="store_true", help="ZeRO-3-shard base params over data axes")
    ap.add_argument("--mean-rate", type=float, default=0.5, help="STLD mean dropout rate")
    ap.add_argument("--expert-shard", default="auto", choices=["auto", "ff"],
                    help="shard stacked expert weights on E (auto) or within-expert ff")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out_dir, exist_ok=True)
    failed = 0
    t0 = time.perf_counter()
    for arch in archs:
        for shape_name in shapes:
            mesh_tag = "2x16x16" if args.multi_pod else "16x16"
            name = f"{arch}__{shape_name}__{mesh_tag}"
            if args.stld != "off":
                name += f"__stld-{args.stld}"
            if args.tag:
                name += f"__{args.tag}"
            out_path = os.path.join(args.out_dir, name + ".json")
            if not shape_applicable(arch, shape_name):
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "ok": False, "skipped": True,
                       "reason": "long-context decode inapplicable (DESIGN.md skip matrix)"}
                with open(out_path, "w") as f:
                    json.dump(rec, f, indent=2)
                print(f"SKIP {name}", flush=True)
                continue
            stack_mode = args.stack_mode
            if stack_mode == "auto":
                stack_mode = "group" if get_config(arch).family == "hybrid" else "scan"
            try:
                rec = run_cell(arch, shape_name, multi_pod=args.multi_pod, stld_mode=args.stld, stack_mode=stack_mode,
                               extra_tags=args.tag, moe_dispatch=args.moe_dispatch, weights_dtype=args.weights_dtype,
                               fsdp=args.fsdp, mean_rate=args.mean_rate, expert_shard=args.expert_shard)
                print(f"OK   {name}: flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                      f"coll={rec['collectives']['total']:.3e} peak/dev={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
                      f"trace={rec['trace_s']:.1f}s", flush=True)
            except Exception as e:  # noqa: BLE001 - record the failure
                failed += 1
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "ok": False,
                       "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-4000:]}
                print(f"FAIL {name}: {type(e).__name__}: {e}", flush=True)
            with open(out_path, "w") as f:
                json.dump(rec, f, indent=2)
    print(f"dry run: {len(archs) * len(shapes)} cells, {failed} failed, {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
