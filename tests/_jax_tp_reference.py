"""The reference's own sharded train step on a 2 x 2 host mesh, for
``tests/test_torch_tp.py``: run as a process of its own, since the four
host devices must be asked for before JAX starts::

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
"""
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
from repro.launch.steps import make_train_step  # noqa: E402
from repro.models.losses import softmax_xent  # noqa: E402
from repro.models.registry import model_apply  # noqa: E402
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


def main():
    inputs, out_path, *cases = sys.argv[1:]
    data = np.load(inputs)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))  # Auto axes: GSPMD places
    specs.set_mesh_axis_sizes(mesh)
    named = lambda tree: jax.tree.map(lambda s: NamedSharding(mesh, s), tree,  # noqa: E731
                                      is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for spec in cases:
        case, d_ff = spec.split(":")
        cfg = get_config(data[f"{case}/arch"].item(), smoke=True).replace(num_layers=2, dtype="float32",
                                                                          d_ff=int(d_ff))
        params, peft = tree_under(data, f"{case}/params/"), tree_under(data, f"{case}/peft/")
        tokens = jnp.asarray(data[f"{case}/tokens"])
        regather = named(specs.param_specs(params, 2))
        step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="cond", regather_specs=regather)
        in_specs = (specs.param_specs(params, 2, fsdp_axes=("data",)), specs.peft_specs(peft),
                    {"m": specs.peft_specs(peft), "v": specs.peft_specs(peft), "count": PartitionSpec()},
                    {"tokens": specs.batch_spec(("data",), 2)}, PartitionSpec())
        shardings = named(in_specs)
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
