"""Quickstart of the PyTorch/CUDA port: the DropPEFT core in ~70 lines.

Builds a small qwen3-family model, attaches LoRA, and runs a few STLD
training steps (the paper's Eq. 3 layer gating end to end), all through
``repro_torch``; the same steps again under ``remat``, then two federated
rounds through ``repro_torch.api``.  Runs on the card unless asked for the
CPU (the kernels' plain twins):

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import FederatedConfig, PEFTConfig, TrainConfig, get_config
from repro_torch.core import peft as peft_lib
from repro_torch.core import stld
from repro_torch.core.schedules import drop_rates
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.models.stacking import tree_leaves
from repro_torch.optim import adamw_init

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda", help="the device to run on (default: the card)")
device = torch.device(parser.parse_args().device)

gen = torch.Generator(device=device).manual_seed(0)
cfg = get_config("qwen3-1.7b", smoke=True).replace(dtype="float32")
print(f"model: {cfg.name}  L={cfg.num_layers} d={cfg.d_model}  device: {device}")

# 1. per-layer dropout rates: the paper recommends the incremental shape
rates = drop_rates("incremental", 0.5, cfg.num_layers)
print("dropout rates:", [round(float(r), 2) for r in rates])
print("expected active layers:", float(stld.expected_active_layers(rates)))

# 2. frozen base + trainable LoRA
base = init_params(cfg, gen)
peft_cfg = PEFTConfig(method="lora", lora_rank=4)
peft = peft_lib.init_peft(cfg, peft_cfg, gen)
print(f"base params: {peft_lib.count_params(base):,}   trainable (LoRA): {peft_lib.count_params(peft):,}")

# 3. STLD training steps (paper-faithful cond mode); the gates draw from a
#    CPU generator, and remat=True recomputes each active layer in the
#    backward: the same steps, bit for bit
batches = [torch.randint(0, cfg.vocab_size, (4, 33), generator=gen, device=device) for _ in range(5)]
final = {}
for remat in (False, True):
    step = make_train_step(cfg, peft_cfg, TrainConfig(learning_rate=1e-3), stld_mode="cond", mean_rate=0.5,
                           remat=remat)
    p, opt = peft, adamw_init(peft)
    for i, tokens in enumerate(batches):
        p, opt, metrics = step(base, p, opt, {"tokens": tokens}, torch.Generator().manual_seed(100 + i))
        if not remat:  # one host read a step, as the reference's quickstart prints
            # repro-lint: disable=TXH002
            print(f"step {i}: loss={float(metrics['loss']):.3f} grad_norm={float(metrics['grad_norm']):.3f}")
    final[remat] = p
same = all(torch.equal(a, b) for a, b in zip(tree_leaves(final[False]), tree_leaves(final[True])))
print(f"remat=True gives the same LoRA after 5 steps: {same}")

# 4. the full federated system is one facade call away
from repro_torch import api

res = api.experiment(
    "droppeft",
    model_overrides=dict(num_layers=4, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, vocab_size=128,
                         dtype="float32"),
    lora_rank=2,
    fed_cfg=FederatedConfig(num_devices=4, devices_per_round=2, local_steps=2, batch_size=8),
    train_cfg=TrainConfig(learning_rate=5e-3, total_steps=100, warmup_steps=2),
    rounds=2,
    device=device,
)
print(f"federated (repro_torch.api): 2 rounds, acc={res.accuracy[-1]:.3f}")
print("OK — see examples/torch_federated_finetune.py for the full federated system")
