"""Serving driver: prefill a prompt batch, then greedy-decode with the
decode caches, as ``repro.launch.serve``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --smoke \\
        --prompt-len 64 --gen-len 32 --batch 4 --device cpu

Runs ``make_prefill_step`` over the prompt into ``init_caches``'s caches
(the per-layer list), then ``serving.decode.generate``, for any arch of the
port: the dense and MoE decoders' KV rings, RWKV6's and Mamba's recurrent
states, internvl2's rings behind its patch prefix (``frontend_seq`` slots
longer, the decode starting that much later) and whisper's decoder rings
with its encoder's cross K/V, computed once in the prefill.  The stub
frontends' inputs are zeros, as the reference's CLI gives them::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny --smoke --device cpu

With ``--merge-lora`` a LoRA tree is folded into the base weights first
(the deployment path; an encoder-decoder raises ``ValueError``: the
reference's merge reads a decoder-only tree).  The weights are random,
from ``--seed``, drawn on the device and cast to the config's dtype as they
are drawn.

Multi-tenant mode -- ``--adapters N`` serves N tenants' LoRA adapters
(ranks 4 and 8 in turn) through ``repro_torch.api.serve``'s continuous
batcher and the segmented kernel; ``--checkpoint-dir`` serves a federated
run's client adapters instead.  It takes the ``dense`` and ``moe``
families, whose layers carry no recurrent state (``api.serve``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --adapters 3 \\
        --batch 4 --gen-len 16

``--device`` defaults to the CUDA card; ``--device cpu`` runs the kernels'
plain twins.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, PEFTConfig, get_config
from repro_torch.core import peft as peft_lib
from repro_torch.launch.steps import frontend_batch, make_prefill_step, make_serve_step
from repro_torch.models.registry import init_params
from repro_torch.models.transformer import init_caches
from repro_torch.serving.decode import generate


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def init_model(cfg, seed: int, device, merge_lora: bool = False):
    """Random weights for ``cfg`` from ``seed``, drawn on ``device`` and
    cast to ``cfg.dtype`` part by part (``init_params(place=True)``);
    ``merge_lora`` folds a fresh LoRA tree (``PEFTConfig()``) into them
    (a decoder-only model; an encoder-decoder raises ``ValueError``)."""
    if merge_lora and cfg.is_encoder_decoder:
        raise ValueError(f"--merge-lora folds LoRA into a decoder-only model's layers; {cfg.name} is an "
                         "encoder-decoder")
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    params = init_params(cfg, generator, place=True)
    if merge_lora:
        peft_cfg = PEFTConfig(method="lora")
        tree = peft_lib.init_peft(cfg, peft_cfg, generator)
        params = dict(params, layers=peft_lib.merge_lora_into_base(params["layers"], tree,
                                                                   peft_lib.lora_scale(peft_cfg)))
    return params


def random_prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """(batch, prompt_len) int64 tokens from ``seed``."""
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, prompt_len))


def prefill_and_generate(cfg, params, prompt, gen_len: int, device, *, serve_step=None, frontend=None,
                         **generate_kw):
    """Prefill ``prompt`` (B, S) into fresh caches of S + ``gen_len``
    slots (KV rings in ``cfg.dtype``), then ``generate`` ``gen_len`` tokens
    from the prompt's argmax.  A vision model's patch prefix (``frontend``,
    or zeros) goes before the prompt: the caches hold ``frontend_seq`` more
    slots and the decode starts that much later.  An encoder-decoder's
    frames (``frontend``, or zeros) run its encoder in the prefill, whose
    cross K/V go to every decode step.
    ``serve_step`` replaces ``make_serve_step(cfg)`` (to wrap it);
    ``generate_kw`` goes to ``generate``.  Returns a dict: ``tokens`` (B,
    gen_len), ``first`` (B, 1), ``last_logits`` (B, V) of the prompt,
    ``caches``, ``enc_kvs`` (None but for an encoder-decoder), and the host
    seconds of the two parts, ``prefill_s`` and ``decode_s`` (each ending
    in a synchronize on the card)."""
    batch, prompt_len = prompt.shape
    start_pos = prompt_len + cfg.prefix_len
    caches = init_caches(cfg, batch, start_pos + gen_len, dtype=getattr(torch, cfg.dtype), device=device)
    serve_step = serve_step or make_serve_step(cfg)
    _sync(device)
    t0 = time.perf_counter()
    enc_kvs = None
    out = make_prefill_step(cfg)(params, frontend_batch(cfg, prompt, frontend), caches)
    if cfg.is_encoder_decoder:
        last_logits, caches, enc_kvs = out
    else:
        last_logits, caches = out
    _sync(device)
    prefill_s = time.perf_counter() - t0
    first = torch.argmax(last_logits, dim=-1)[:, None].to(torch.int32)
    t0 = time.perf_counter()
    tokens, caches = generate(serve_step, params, caches, first, start_pos, gen_len, enc_kvs, **generate_kw)
    _sync(device)
    return {"tokens": tokens, "first": first, "last_logits": last_logits, "caches": caches, "enc_kvs": enc_kvs,
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0}


def _serve_multi_adapter(cfg, params, args, device):
    """Continuous-batching decode over per-tenant adapters (``api.serve``)."""
    from repro_torch import api
    from repro_torch.serving.batcher import Request

    adapters = None
    if args.checkpoint_dir is None:  # synthetic tenants with alternating ranks
        generator = torch.Generator(device=device)
        generator.manual_seed(args.seed + 100)
        adapters = {f"tenant{i}": peft_lib.init_peft(
            cfg, PEFTConfig(method="lora", lora_rank=(4, 8)[i % 2], lora_targets=("q", "v")), generator)
            for i in range(args.adapters)}
    batcher = api.serve(cfg=cfg, params=params, checkpoint_dir=args.checkpoint_dir, adapters=adapters,
                        batch=args.batch, max_len=args.prompt_len + args.gen_len, cache_dtype=cfg.dtype,
                        device=device)
    names = batcher.pool.registry.names()
    rng = np.random.default_rng(args.seed)
    for j in range(max(args.batch, len(names))):
        # repro-lint: disable=TXH002 — a numpy draw, on the host
        batcher.submit(Request(prompt=rng.integers(0, cfg.vocab_size, args.prompt_len).tolist(),
                               adapter=names[j % len(names)], max_new_tokens=args.gen_len, uid=j))
    t0 = time.perf_counter()
    done = batcher.run()
    _sync(device)
    dt = time.perf_counter() - t0
    total = sum(len(c.tokens) for c in done)
    print(f"arch={cfg.name} tenants={len(names)} requests={len(done)} "
          f"slots={batcher.pool.n_slots} swaps={batcher.pool.swaps}")
    print(f"decode: {dt * 1e3:.1f} ms ({total / max(dt, 1e-9):.1f} tok/s)")
    for c in done[: args.batch]:
        print(f"  req {c.uid} [{c.adapter}] {c.finish_reason}: {c.tokens[:8]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--merge-lora", action="store_true")
    ap.add_argument("--adapters", type=int, default=0, help="serve N synthetic tenant adapters (multi-tenant mode)")
    ap.add_argument("--checkpoint-dir", default=None, help="serve the client adapters of a federated checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (the default, the card) or cpu (the plain twins)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    multi_tenant = args.adapters > 0 or args.checkpoint_dir is not None
    params = init_model(cfg, args.seed, device, merge_lora=args.merge_lora and not multi_tenant)
    if multi_tenant:
        _serve_multi_adapter(cfg, params, args, device)
        return
    if args.merge_lora:
        print("merged LoRA into base weights")
    out = prefill_and_generate(cfg, params, random_prompts(cfg, args.batch, args.prompt_len, args.seed),
                               args.gen_len, device)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen_len}")
    print(f"prefill: {out['prefill_s'] * 1e3:.1f} ms   decode: {out['decode_s'] * 1e3:.1f} ms "
          f"({args.gen_len * args.batch / max(out['decode_s'], 1e-9):.1f} tok/s)")
    print("sample tokens:", out["tokens"][0, :16].tolist())


if __name__ == "__main__":
    main()
