"""The online dropout-rate configurator (paper Algorithm 1) in isolation,
on the PyTorch/CUDA port.

Simulates an environment where reward = accuracy-gain/time peaks at a
"sweet spot" dropout rate that DRIFTS over time (paper Fig. 7), and shows
the bandit tracking it.  The configurator is the one a DropPEFT experiment
on ``device`` (the card unless asked for the CPU) would use:

    PYTHONPATH=src python examples/torch_bandit_configurator.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch import api
from repro_torch.configs import FederatedConfig

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda", help="the device to run on (default: the card)")
device = parser.parse_args().device

rng = np.random.default_rng(0)
# the exact configurator a DropPEFT experiment would use: built by the
# algorithm from the federated config, pulled out of the runner's RoundState
runner = api.build(
    "droppeft",
    model_overrides=dict(num_layers=4, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, vocab_size=128,
                         dtype="float32"),
    lora_rank=2,
    fed_cfg=FederatedConfig(
        num_devices=4,
        devices_per_round=4,
        rate_grid=(0.1, 0.3, 0.5, 0.7, 0.9),
        num_candidates=3,
        explore_rate=0.34,
        explore_interval=4,
        window_size=6,
    ),
    device=device,
)
cfgor = runner.state.configurator


def sweet_spot(round_idx: int) -> float:
    # early training tolerates aggressive dropout; later rounds need more depth
    return 0.7 if round_idx < 20 else 0.3


for rnd in range(40):
    rates = cfgor.next_round(n_devices=4)
    spot = sweet_spot(rnd)
    gains = [max(0.0, 0.05 - 0.08 * (r - spot) ** 2 + 0.004 * rng.standard_normal()) for r in rates]
    times = [1.0 - 0.5 * r for r in rates]  # higher dropout -> faster rounds
    cfgor.report(rates, gains, times)
    if rnd % 5 == 0:
        phase = "explore" if cfgor.is_explore else "exploit"
        print(f"round {rnd:2d} [{phase:7s}] spot={spot:.1f} best_arm={cfgor.best_rate():.1f} "
              f"used={sorted(set(rates))}")

print("\nfinal best arm:", cfgor.best_rate(), "(sweet spot moved 0.7 -> 0.3)")
