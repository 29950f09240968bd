"""Serving examples on the PyTorch/CUDA port: (1) multi-tenant adapter
serving, two federated clients' LoRA adapters answering interleaved
requests through one decode step; (2) LoRA-merged single-tenant
deployment; (3) the sequence-sharded LSE-combined attention math used for
long_500k decode.  Runs on the card unless asked for the CPU:

    PYTHONPATH=src python examples/torch_serving_decode.py [--device cpu]
"""
import argparse

import torch

from repro_torch import api
from repro_torch.configs import PEFTConfig, get_config
from repro_torch.core import peft as peft_lib
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import init_params
from repro_torch.models.registry import place_params
from repro_torch.models.stacking import tree_map
from repro_torch.models.transformer import init_caches
from repro_torch.serving import Request
from repro_torch.serving.decode import _partial_attention, generate

parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
parser.add_argument("--device", default="cuda", help="the device to run on (default: the card)")
device = torch.device(parser.parse_args().device)
gen = torch.Generator(device=device).manual_seed(0)

# --- multi-tenant: two clients' adapters, one decode batch ---------------
# In a real deployment the adapters come out of a federated run's
# checkpoint: api.serve(checkpoint_dir="ckpts") registers every client's
# adapter as "client<id>". Here we build two hetlora clients in-process
# (different ranks: they still share one pooled kernel).
cfg = get_config("qwen3-1.7b", smoke=True).replace(num_layers=2, dtype="float32")
adapters = {}
for i, rank in enumerate((4, 8)):
    pcfg = PEFTConfig(method="lora", lora_rank=rank, lora_targets=("q", "v"))
    tree = peft_lib.init_peft(cfg, pcfg, gen)  # LoRA init keeps b=0; perturb
    adapters[f"client{i}"] = tree_map(lambda x: x + 0.02 * torch.randn(x.shape, generator=gen, device=device), tree)

batcher = api.serve(cfg=cfg, adapters=adapters, batch=3, max_len=32, cache_dtype="float32", device=device)
requests = [
    Request(prompt=[5, 7, 11], adapter="client0", max_new_tokens=6, uid="a"),
    Request(prompt=[13, 17], adapter="client1", max_new_tokens=6, uid="b"),
    Request(prompt=[19, 23, 29], adapter="client0", max_new_tokens=4, uid="c"),
]
for r in requests:
    batcher.submit(r)
for c in sorted(batcher.run(), key=lambda c: c.uid):
    print(f"req {c.uid} [{c.adapter}] {c.finish_reason}: {c.tokens}")
print(f"pool: {batcher.pool.n_slots} slots, {batcher.pool.swaps} swaps")

# --- single-tenant deployment: fold one LoRA into the base weights -------
cfg = get_config("h2o-danube-1.8b", smoke=True).replace(dtype="float32", sliding_window=32)
params = init_params(cfg, gen)
peft_cfg = PEFTConfig(method="lora", lora_rank=4)
lora = peft_lib.init_peft(cfg, peft_cfg, gen)
params = dict(params, layers=peft_lib.merge_lora_into_base(params["layers"], lora, peft_lib.lora_scale(peft_cfg)))
params = place_params(params, cfg, device)

prefill = make_prefill_step(cfg)
serve = make_serve_step(cfg)

B, PROMPT, GEN = 2, 24, 12
prompt = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen, device=device)
caches = init_caches(cfg, B, PROMPT + GEN, dtype=torch.float32, device=device)
last, caches = prefill(params, {"tokens": prompt}, caches)
first = torch.argmax(last, dim=-1)[:, None].to(torch.int32)
tokens, _ = generate(serve, params, caches, first, PROMPT, GEN)
print("generated:", tokens[0].tolist())

# --- long-context decode math: shard the KV cache, combine with LSE ------
h, d, S = 4, 16, 64
q = torch.randn((1, h, d), generator=gen, device=device)
k = torch.randn((1, S, h, d), generator=gen, device=device)
v = torch.randn((1, S, h, d), generator=gen, device=device)
kpos = torch.arange(S, device=device)

acc, m, l = _partial_attention(q, k, v, kpos, S - 1, None)
mono = acc / l[..., None]

parts = [
    _partial_attention(q, k[:, i * 16:(i + 1) * 16], v[:, i * 16:(i + 1) * 16], kpos[i * 16:(i + 1) * 16], S - 1,
                       None)
    for i in range(4)  # 4 "devices", each holding a 16-token cache shard
]
m_glob = torch.stack([p[1] for p in parts]).amax(dim=0)
l_glob = sum(p[2] * torch.exp(p[1] - m_glob) for p in parts)
acc_glob = sum(p[0] * torch.exp(p[1] - m_glob)[..., None] for p in parts)
sharded = acc_glob / l_glob[..., None]
print("sharded-decode max err vs monolithic:", float((sharded - mono).abs().max()))
