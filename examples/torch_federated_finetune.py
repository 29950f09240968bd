"""End-to-end federated fine-tuning (the paper's full system) on the
PyTorch/CUDA port.

Runs DropPEFT vs FedLoRA on a non-IID synthetic task through the
``repro_torch.api`` facade and prints the time-to-accuracy comparison, a
miniature of paper Table 3.  Runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_federated_finetune.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import api
from repro_torch.configs import FederatedConfig, TrainConfig

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda", help="the device to run on (default: the card)")
device = parser.parse_args().device

fed = FederatedConfig(num_devices=10, devices_per_round=4, local_steps=4, batch_size=16, dirichlet_alpha=1.0)
ROUNDS = 10

results = {}
for method in ("fedlora", "droppeft"):
    res = api.experiment(
        method,
        model="qwen3-1.7b",
        model_overrides=dict(num_layers=4, d_model=64, d_ff=128, num_heads=4, num_kv_heads=2, vocab_size=512,
                             dtype="float32"),
        peft="lora",
        lora_rank=4,
        fed_cfg=fed,
        train_cfg=TrainConfig(learning_rate=5e-3, total_steps=400, warmup_steps=5),
        cost_model="qwen3-1.7b",  # time accounting at 1.7B scale
        seed=0,
        rounds=ROUNDS,
        device=device,
    )
    results[method] = res
    print(f"\n== {method} ==")
    for r in range(res.rounds):
        print(f"  round {r}: acc={res.accuracy[r]:.3f} "
              f"active={res.active_fraction[r]:.2f} t={res.cum_time_s[r] / 3600:.2f}h")
    print(f"  final acc={res.final_accuracy:.3f} "
          f"total sim-time={res.cum_time_s[-1] / 3600:.2f}h "
          f"traffic={np.sum(res.traffic_mb):.0f}MB")

target = min(r.accuracy.max() for r in results.values()) * 0.95
t_base = results["fedlora"].time_to_accuracy(target)
t_drop = results["droppeft"].time_to_accuracy(target)
if t_base and t_drop:
    print(f"\nDropPEFT speedup to acc {target:.2f}: {t_base / t_drop:.2f}x (paper: 1.3-6.3x)")
