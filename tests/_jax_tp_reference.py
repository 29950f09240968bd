"""The reference's own sharded steps on host meshes of four CPU devices,
for ``tests/test_torch_tp.py`` and ``tests/test_torch_tp_serve.py``: run
as a process of its own, since the four host devices must be asked for
before JAX starts::

    python tests/_jax_tp_reference.py INPUTS.npz OUT.npz CASE...

For each case of ``tests/_torch_tp_rank.py``'s inputs (its ``d_ff``
given as ``<case>:<d_ff>``): ``repro.launch.steps.make_train_step`` with
``regather_specs`` (the TP-only ``NamedSharding`` tree), jitted with
``in_shardings`` from ``repro.sharding.specs`` (the base params FSDP over
``data``, the PEFT tree and AdamW state replicated, the batch over
``data``), two steps from the inputs' trees with the gates of the JAX keys
``GATE_KEYS``; and, unsharded, the first step's loss and PEFT gradients
(``jax.value_and_grad`` of the reference's loss).  Saves ``<case>/metrics``
(2 x loss, accuracy, grad_norm, tokens), ``<case>/peft/<i>`` and
``<case>/grads/<i>`` in leaf order.

A ``CASE`` of the form ``serve:<i>`` runs the serve run ``i`` of the
inputs' ``runs`` (``tests/_torch_tp_rank.py``'s ``serve_one``): the
reference's ``make_prefill_step`` and ``make_serve_step`` jitted with
``in_shardings`` from ``repro.sharding.specs`` on the run's (data, model)
host mesh (``param_specs``, ``batch_spec``, ``cache_specs`` with the
sequence over ``data`` for a ``"seq"`` run, the PEFT tree replicated), the
prompt into float32 caches and greedy decode steps; saves
``serve<i>/logits/<k>`` (each step's last logits, whole),
``serve<i>/tokens`` and ``serve<i>/caches/<l>/{k,v}``.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

from repro.configs import PEFTConfig, TrainConfig, get_config  # noqa: E402
from repro.core import peft as peft_lib  # noqa: E402
from repro.launch.steps import make_prefill_step, make_serve_step, make_train_step  # noqa: E402
from repro.models.losses import softmax_xent  # noqa: E402
from repro.models.registry import model_apply  # noqa: E402
from repro.models.transformer import init_caches  # noqa: E402
from repro.nn.linear import AdapterPool  # noqa: E402
from repro.optim import adamw_init  # noqa: E402
from repro.sharding import specs  # noqa: E402

GATE_KEYS = (3, 0)
METRICS = ("loss", "accuracy", "grad_norm", "tokens")


def tree_under(data, prefix):
    tree = {}
    for key in data.files:
        if key.startswith(prefix):
            *path, last = key[len(prefix):].split("/")
            at = tree
            for p in path:
                at = at.setdefault(p, {})
            at[last] = jnp.asarray(data[key])
    return tree


def loss_and_grads(cfg, params, peft, tokens, drops):
    def loss(pf):
        logits, _, _ = model_apply(params, cfg, {"tokens": tokens[:, :-1]}, drops=drops, peft=pf,
                                   lora_scale=peft_lib.lora_scale(PEFTConfig()), stack_mode="unroll")
        return softmax_xent(logits, tokens[:, 1:])

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(peft)


def named(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree, is_leaf=lambda x: isinstance(x, PartitionSpec))


def serve_peft(data, case, kind):
    """The serve run's PEFT tree, as ``_torch_tp_rank.serve_peft``."""
    if kind == "lora":
        return tree_under(data, f"{case}/peft/")
    if kind == "pool":
        pools = tree_under(data, f"{case}/pool/")
        return {"attn": {name: AdapterPool(**node) for name, node in pools["attn"].items()}}
    return None


def serve(data, run, i, out):
    """Serve run ``i`` (the module docstring) into ``out``."""
    case = run["case"]
    cfg = get_config(run["arch"], smoke=True).replace(num_layers=2, dtype="float32")
    if run.get("head_dim"):
        cfg = cfg.replace(head_dim=run["head_dim"])
    n_data, tp = run["mesh"]
    mesh = Mesh(np.array(jax.devices()[:n_data * tp]).reshape(n_data, tp), ("data", "model"))
    specs.set_mesh_axis_sizes(mesh)
    seq = bool(run.get("seq"))
    params, prompt = tree_under(data, f"{case}/params/"), jnp.asarray(data[f"{case}/prompt"])
    b, p = prompt.shape
    caches = init_caches(cfg, b, p + run["steps"], jnp.float32)
    params_s = specs.param_specs(params, tp)
    caches_s = specs.cache_specs(caches, ("data",), tp, shard_seq_on_data=seq)
    rows_s = PartitionSpec() if seq else specs.batch_spec(("data",), 2)
    pre_s = named(mesh, (params_s, {"tokens": rows_s}, caches_s))
    logits, caches = jax.jit(make_prefill_step(cfg), in_shardings=pre_s)(
        *jax.device_put((params, {"tokens": prompt}, caches), pre_s))
    peft = serve_peft(data, case, run.get("peft"))
    step = make_serve_step(cfg)
    args_s = (params_s, rows_s, PartitionSpec(), specs.cache_specs(caches, ("data",), tp, shard_seq_on_data=seq))
    if peft is None:
        args_s = named(mesh, args_s)
        jstep = jax.jit(lambda pr, t, pos, c: step(pr, t, pos, c), in_shardings=args_s)
    else:
        args_s = named(mesh, (*args_s, specs.peft_specs(peft)))
        jstep = jax.jit(lambda pr, t, pos, c, pf: step(pr, t, pos, c, None, pf), in_shardings=args_s)
    token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out[f"serve{i}/logits/0"], tokens = np.asarray(logits), []
    if run.get("pos") == "rows":
        caches = [dict(c, pos=jnp.full((b,), p, jnp.int32)) for c in caches]
    for k in range(run["steps"]):
        pos = jnp.full((b,), p + k, jnp.int32) if run.get("pos") == "rows" else jnp.int32(p + k)
        logits, token, caches = jstep(*jax.device_put((params, token, pos, caches,
                                                       *(() if peft is None else (peft,))), args_s))
        out[f"serve{i}/logits/{k + 1}"] = np.asarray(logits)
        tokens.append(np.asarray(token[:, 0]))
    out[f"serve{i}/tokens"] = np.stack(tokens)
    for l, cache in enumerate(caches):
        out[f"serve{i}/caches/{l}/k"], out[f"serve{i}/caches/{l}/v"] = np.asarray(cache["k"]), np.asarray(cache["v"])


def main():
    inputs, out_path, *cases = sys.argv[1:]
    data = np.load(inputs)
    out = {}
    for spec in cases:
        if spec.startswith("serve:"):
            i = int(spec.split(":")[1])
            serve(data, json.loads(str(data["runs"]))[i], i, out)
            continue
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))  # Auto axes: GSPMD places
        specs.set_mesh_axis_sizes(mesh)
        case, d_ff = spec.split(":")
        cfg = get_config(data[f"{case}/arch"].item(), smoke=True).replace(num_layers=2, dtype="float32",
                                                                          d_ff=int(d_ff))
        params, peft = tree_under(data, f"{case}/params/"), tree_under(data, f"{case}/peft/")
        tokens = jnp.asarray(data[f"{case}/tokens"])
        regather = named(mesh, specs.param_specs(params, 2))
        step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="cond", regather_specs=regather)
        in_specs = (specs.param_specs(params, 2, fsdp_axes=("data",)), specs.peft_specs(peft),
                    {"m": specs.peft_specs(peft), "v": specs.peft_specs(peft), "count": PartitionSpec()},
                    {"tokens": specs.batch_spec(("data",), 2)}, PartitionSpec())
        shardings = named(mesh, in_specs)
        jstep = jax.jit(step, in_shardings=shardings)
        p, opt, rows = peft, adamw_init(peft), []
        for k in GATE_KEYS:  # each step's outputs placed as its inputs are
            args = jax.device_put((params, p, opt, {"tokens": tokens}, jax.random.PRNGKey(k)), shardings)
            p, opt, m = jstep(*args)
            rows.append([float(m[name]) for name in METRICS])
        out[f"{case}/metrics"] = np.array(rows)
        for i, leaf in enumerate(jax.tree.leaves(p)):
            out[f"{case}/peft/{i}"] = np.asarray(leaf)
        drops = jnp.asarray(data[f"{case}/gates"][0])
        (_, _), grads = loss_and_grads(cfg, params, peft, tokens, drops)
        for i, leaf in enumerate(jax.tree.leaves(grads)):
            out[f"{case}/grads/{i}"] = np.asarray(leaf)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main()
