#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of the checkout, on a machine with a CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py [--seed 0]

With ``--scans-of SRC`` it runs only the scan kernels' timed cases of phase
3 (wkv6 and mamba_scan, or those ``--scans`` names, forward and backward,
bf16, held against their twins; ``--scans flash_decode`` times
flash_decode at qwen3-1.7b's decode step) with the ``repro_torch`` under SRC,
another tree's ``src``, and prints no result: two trees (the parent's
unpacked under the git-ignored ``build/``, and this one's ``src``) are
compared on one card by running it for each in turns, parent, change,
change, parent.

Phases, one line each before the last:

1. the card's name and power limit (``nvidia-smi``);
2. build of every CUDA kernel from the sources in the checkout, in parallel,
   and the registers, spills and shared memory of the attention kernels,
   lora_matmul's, flash_decode's, segmented_lora's, the wkv6 and the
   mamba_scan kernels' (their ``ptxas -v`` logs, any wgmma serialization
   warning, and the bytes the launchers ask for);
3. each kernel held against its plain PyTorch twin on the card at the
   shapes of its path (serving: the decode step; training: batch 16 x 512
   tokens of qwen3-1.7b, of rwkv6-3b for wkv6 and the channel-mix
   lora_matmul, and of jamba-v0.1-52b for mamba_scan and the Mamba
   projections' lora_matmul; the federated rounds: batch 16 x 32 tokens
   of qwen3-1.7b for flash_attention and lora_matmul), forward and backward, with its time (CUDA
   events, L2 flushed, median of repeats) beside the twin's, the library
   call's and the bound; ``torch.profiler``'s device times of the kernels
   of attention (also at jamba-v0.1-52b's 32 heads; its backward's two
   kernels apart), flash_decode (split and merge passes apart),
   lora_matmul and segmented_lora (bottleneck and main kernels apart, and
   lora_matmul's route), the wkv6 backward (its three kernels apart), the
   wkv6 forward and the mamba_scan forward and backward (its four kernels
   apart) beside their yardsticks' (SDPA, cuBLAS's x @ W); and lora_matmul
   on the fixed draw that failed its first bf16 design, on the route it
   takes and on the WMMA route, with the bf16 roundings of the bottleneck t
   that differ from the twin's, both routes checked; the grouped
   lora_matmul of the batched cohort (one adapter per group of rows)
   against its twin, forward, dX, dA and dB, on the wgmma route at phase
   5d's shape (10 groups of 512 rows, q and v), off the 128-row tile, on
   the WMMA route and in float32, each group's rows and G = 1 bit-equal to
   ungrouped launches, timed beside ten ungrouped launches, cuBLAS's x @ W
   at M 5 120 and its bound; and at the other dense decoders' shapes:
   flash_decode at glm4-9b's serving step (32 heads over 2 KV heads) and
   h2o-danube-1.8b's (head dim 80, its window; another over a wrapped
   ring), flash_attention forward and backward at their training shapes
   (batch 16 x 512), both dtypes, and the q and v projections'
   lora_matmul (batch 16 x 512) and segmented_lora (8 rows) at glm4-9b's,
   h2o-danube-1.8b's and yi-6b's widths; and FedHetLoRA's shapes:
   lora_matmul at ranks 4 and 16 (scales 4 and 1) at the federated rounds'
   16 x 32 tokens on the wgmma route, forward, dX, dA and dB, and
   segmented_lora over tenants of rank 4, 8, 16 and 16 (r_max 16); and
   serving's scans from a state: mamba_scan from an entering state h0 at
   jamba's decode step (B 8, S 1, D 8192, N 16) and prefill (S 128), and
   wkv6 at S 1 from s0 (B 8, 40 heads of 64), bf16 and float32, each
   timed beside its twin and its bound (the state's bytes read and
   written, where S is 1), and flash_decode over phase 5h's ring of 160
   slots and flash_attention over its 128-token prompts at batch 8, at
   qwen3-1.7b's heads and jamba-v0.1-52b's; and the moe family's shapes:
   flash_attention forward and backward at the training shape (batch 16 x
   512) with granite-moe-3b-a800m's 24 heads of 64 over 8 KV heads and
   llama4-scout-17b-a16e's 40 heads of 128 over 8, flash_decode at their
   serving step, both also in float32, and the q and v projections'
   lora_matmul (batch 16 x 512) and segmented_lora (8 rows) at their
   widths (d 1 536 and 5 120); and the stub-frontend families' shapes
   (``stub_frontend_shapes``): flash_attention with a key length of its
   own at whisper-tiny's encoder (batch 16, 1 500 frames, bidirectional)
   and cross-attention (512 queries over 1 500 frames, its backward dQ
   alone, bit-equal to the full backward's dQ), both also in float32,
   flash_decode over whisper's ring, over its 1 500 encoder slots (every
   slot live) and at internvl2-76b's serving step, lora_matmul at
   whisper's 384-wide projections and internvl's q and v (batch 16 x
   (256 + 512)), segmented_lora at internvl's q and v;
4. full-width qwen3-1.7b (28 layers, random weights from ``--seed``)
   served through ``repro_torch.api.serve``: 12 requests over 4 LoRA
   tenants of rank 4/8 at batch 8, rows recycling mid-run; every completion
   arrives, every logit is finite, one request's batched tokens equal its
   tokens served in a uniform batch, every segmented_lora call of the
   profiled steps runs both of its kernels, and the smoke-size model on the
   card agrees with the same model on the CPU twins;
5. one client's DropPEFT local training of full-width qwen3-1.7b through
   ``repro_torch.federated.client.make_client_fns``: ``local_round`` of 4
   steps at batch 16 x 512 (the synthetic task) and STLD mean rate 0.5,
   then ``evaluate``; every loss and norm finite, each kernel launched as
   often as the active layers say (every bf16 lora_matmul call on the
   wgmma route), two rounds from the same state bit-identical; step time,
   idle share and peak memory at rates 0.0 and 0.5; and one smoke-size
   round on the card against the CPU twins;
5b. the same for full-width rwkv6-3b (32 layers, LoRA on the channel-mix
   up and down), whose time-mix runs the wkv6 kernels;
5c. the same for full-width jamba-v0.1-52b cut to 8 layers (one period of
   its interleave: 7 Mamba and 1 attention layer, 4 MoE and 4 MLP layers;
   LoRA on the Mamba in and out and the attention q and v), drawn and
   placed layer by layer, whose Mamba layers run the mamba_scan kernels;
5d. two federated rounds of droppeft on full-width qwen3-1.7b through
   ``repro_torch.api.build`` at its defaults (100 devices with their
   Dirichlet shards, 10 a round, 4 local steps of batch 16 x 32 tokens,
   the rate bandit, PTLS), in its default batched cohort mode: 2 finite
   history rows, the first round's rates the bandit's start-up arms
   round-robin, 14 shared layers per device, layers shared by nobody kept
   bit for bit, each kernel launched as often as the gates say (per cohort
   step a layer once if any device's gate opens it, one fused evaluate a
   cohort, final_accuracy once per chunk of 10 devices), every lora_matmul
   on wgmma, two runs from one seed bit-identical; then the sequential
   mode from the same seed (its own launch checks); for each, seconds per
   round and their split, the idle share and launches of one profiled
   round, peak memory and final_accuracy's seconds; and smoke-size runs
   of qwen3-1.7b, rwkv6-3b and jamba, batched on the card against
   sequential on the card and batched on the CPU twins; and checkpoints:
   the batched run saved after 1 round and resumed by a fresh runner to
   round 2 gives the uninterrupted run's bits, and ``api.serve`` from the
   checkpoint serves the global and two clients' adapters with the tokens
   of ``api.serve`` given the same trees;
5e. full-width glm4-9b, h2o-danube-1.8b and yi-6b, each served as phase 4
   (glm4-9b and yi-6b at half their depth, ``DENSE_SERVE_LAYERS``; and its
   smoke model on the card against the CPU twins) and trained
   for one local round as phase 5, at full depth where the round fits the
   card (else at three quarters of the layers, again, until it fits; the
   cut printed), with the smoke round on the card against the CPU twins;
5f. the straggler-tolerant federation on full-width qwen3-1.7b: one
   client's local round in gather mode at rate 0.5 (16 of 28 layers a
   step) beside cond at the same rate (launches from the indices, every
   lora_matmul on wgmma, two rounds bit-identical, seconds a step, peak
   memory); gather-mode federated rounds through ``api.build``: sync and
   ``deadline_s=inf`` bit-identical, then 3 rounds under
   ``schedule="deadline"``, ``straggler="carry"``,
   ``compression="int8+topk"`` at a deadline of the first sync round's
   median modelled device time (finite rows, stragglers, uplink ratios
   below 1 and less traffic, launches from the indices, two runs and a run
   resumed from its save after round 2 with jobs in flight bit-identical,
   compression's seconds), 3 aggregations of ``async-buffer``; and
   smoke-size deadline, carry with compression and faults, and async runs
   on the card against the CPU twins;
5g. the rest of the paper's method grid on full-width qwen3-1.7b at
   ``api.build``'s defaults (2 rounds, then ``final_accuracy``): FedHetLoRA
   (sequential; device ranks by tier, each device's tree at its rank,
   launches from the gates, all on wgmma) checkpointed, then 12 requests
   served from its checkpoint over tenants of rank 4, 8 and 16 and the
   global adapter with the tokens of serving the same trees (2 x layers
   segmented_lora calls a step); droppeft with adapter and with BitFit
   (batched, no lora_matmul, two runs bit-identical); fedadapter (every
   layer every step); droppeft with ``compression="auto"`` (the joint
   bandit's start-up arms round-robin, each device's uplink ratio 1 at
   ``none`` and below 1 otherwise, saved after round 1 and resumed
   bit-identical with the bandit's state); ``merge_lora_into_base`` on
   its global LoRA and on that LoRA amplified past the tolerance
   (``merge_check``); seconds a round, idle share and peak
   memory of each method; and smoke-size runs of each (rwkv6-3b and jamba
   with adapter and BitFit) on the card against the CPU twins;
5h. recurrent-state serving through ``repro_torch.launch.serve``'s
   functions (``make_prefill_step``, then ``generate``) of full-width
   rwkv6-3b, jamba-v0.1-52b cut to 8 layers as in phase 5c (the cut
   printed) and qwen3-1.7b, random weights from ``--seed``, batch 8,
   128-token prompts, 32 new tokens, bf16: each kernel's launches in the
   prefill and in every decode step (a wkv6 per RWKV6 layer, a mamba_scan
   from its state per Mamba layer, a flash_decode per attention layer;
   flash_attention in the prefill), generate's tokens equal to a second
   run's and to a hand-rolled serve_step loop's, ``eos_id`` and per-row
   ``max_new_tokens`` freezing the rows they should; float32 decode (16
   prompt tokens, then 8 one at a time, 2 rows) against the cache-free
   forward within 1e-3 max|logit|, which the same decode with its carried
   state zeroed must fail (rwkv6-3b at 8 layers, where float32 reproduces
   itself, its 32 layers reported beside: ``F32_CHECK_LAYERS``); the smoke
   models through the same functions on
   the card against the CPU twins (tokens equal, logits within 1e-4); and
   prefill ms, ms a decode step, a profiled step's device time and idle
   share, launches a step and peak memory;
5i. the moe family: one client's local round as phase 5 of full-width
   granite-moe-3b-a800m (32 layers, 40 experts top-8; its rate-0.0 round
   at half the batch if batch 16 does not fit, the error printed) and of
   llama4-scout-17b-a16e (16 experts top-1 and a shared expert) at the
   deepest depth cut at which both rates' rounds fit at batch 16 (from
   ``LLAMA4_TRAIN_LAYERS`` down, the cut printed), each with the MoE's
   share of a layer's device time and the peak while drawing the weights;
   granite's rate-0.5 round again with the gather dispatch (launches, two
   rounds bit-identical, the loss within 3e-2 of the einsum dispatch's,
   seconds a step and peak beside einsum's); both served as phase 4
   (granite at ``GRANITE_SERVE_LAYERS``, llama4 at
   ``LLAMA4_SERVE_LAYERS``; every MoE call takes the decode
   step's weight gather, flash_decode once and segmented_lora twice a
   layer a step) and through ``launch.serve``'s prefill and generate as
   phase 5h (llama4's float32 check at ``LLAMA4_F32_LAYERS``, an MoE's at a
   capacity that drops no token); and ``api.build("droppeft",
   "granite-moe-3b-a800m", smoke=False)`` batched for 2 rounds with phase
   5d's checks, then its smoke-size run on the card against sequential
   and the CPU twins;
5j. the stub-frontend families (``stub_frontends_full``): whisper-tiny
   uncut (4 + 4 layers, d 384, 6 heads of 64, vocab 51 865, 1 500 frames):
   one client's local round as phase 5 (launches from the gates with the
   encoder's attention and the cross-attention's dQ-only backward, whose
   kernels one profiled step counts), prefill and generate as phase 5h
   (frames from the seed; the float32 check's mutation zeroes the cross
   K/V), ``api.serve`` raising for the ``audio`` family, and
   ``api.build("droppeft", "whisper-tiny", smoke=False)`` batched for 2
   rounds with phase 5d's checks and its smoke run; internvl2-76b, widths
   whole, depth-cut: local rounds at the deepest cut from
   ``INTERNVL_TRAIN_LAYERS`` down whose rounds fit at batch 16 with 256
   patches, serving through ``api.serve`` (text prompts) and through
   ``launch.serve``'s prefill and generate (patches from the seed) at the
   deepest cut from ``INTERNVL_SERVE_LAYERS`` down that fits, the float32
   check at ``INTERNVL_F32_LAYERS``, every cut printed; the smoke models
   on the card against the CPU twins;
5k. the training CLI and the sharding layer (``train_cli_full``):
   ``python -m repro_torch.launch.train --arch qwen3-1.7b`` at the parser's
   defaults (16 devices, 4 a round, 4 local steps of batch 16 x 32,
   droppeft, batched, full width) as a process of its own for 2 rounds
   with ``--state-dir`` (2 finite rows, the reference's history keys, the
   saved global tree loading with ``load_pytree``), resumed in this
   process to 3 rounds bit for bit against an uninterrupted 3-round run
   (history JSON and saved LoRA), whose launches (the ``ops`` counters)
   equal ``api.build``'s with the same arguments, every lora_matmul on
   wgmma; its set-up seconds, seconds a round, wall time and peak memory;
   deadline + carry + ``int8+topk`` with ``--fault-dropout`` and
   ``--fault-nan`` (finite rows, a fault summary) against ``--fault-plan``
   with the same fields (the same JSON and LoRA); the CLI at ``--smoke``
   on the card against ``--device cpu`` for qwen3-1.7b, rwkv6-3b and jamba
   (the wkv6 and mamba_scan kernels and their backwards), in bf16 as users
   run it and in float32, from the same base weights (cohorts, rates,
   modelled time, traffic and energy equal; LoRA within phase 5d's bound;
   accuracy within ``CLI_SMOKE_ACC_LIMIT``); ``FederatedSimulator`` at
   smoke size on the card against ``api.experiment``, bit for bit; and
   ``serving.decode.sharded_decode_attention`` over 2 gloo ranks on the
   card, each with half of a qwen3-1.7b-shaped bf16 cache of 4 096 slots,
   against flash_decode and its twin over the whole cache (no window, a
   window of 1 024 and a query in the first half: one rank wholly masked
   in each of the last two), its ms a call beside flash_decode's; phase 3
   times flash_attention (batch 64 x 32) and the grouped lora_matmul (G 4
   x 512 rows) at the CLI's shapes (``cli_shapes``);
5l. the dry run and the analysis passes (``dryrun_and_analysis_full``):
   (a) ``python -m repro_torch.launch.dryrun --arch all --shape <shape>``
   for each input shape on the 16 x 16 and the 2 x 16 x 16 mesh, each a
   process of its own (eight, on the host's cores side by side): every
   cell ``ok`` or the reference's skip record, a line per cell (FLOPs,
   bytes, peak GiB a device, trace seconds); (b) qwen3-1.7b's train step
   at 16 x 512 at rates 0.0 and 0.5, jamba-v0.1-52b cut to 8 layers and
   rwkv6-3b trained likewise, a qwen3-1.7b decode step over 512 slots and
   one ``api.serve`` multi-tenant step, each on the card and on ``meta``
   with the card's gates: launches equal kernel for kernel (the steps
   together launch every kernel), the dry run's argument bytes at a 1 x 1
   mesh equal to the card's trees, the train steps' meta peak within 10 %
   of ``max_memory_allocated`` (``meta_vs_card_steps``); (c) the
   steady-state guard on the card under sync, deadline and async-buffer
   (set-ups within ``DEFAULT_BUDGETS``, the allocator's new segments
   reported); (d) ``python -m repro_torch.analysis`` and ``--self-test``,
   each a process, exit 0;
5m. ``remat``, per-layer recomputation of the train step (``remat_full``):
   the four ``examples/torch_*.py``, each a process on the card, exit 0
   (the quickstart's remat steps equal to its plain ones); full-width
   qwen3-1.7b at full depth, two ``make_train_step`` steps at 16 x 512 at
   rates 0.0 and 0.5 with and without ``remat``: the same PEFT tree and
   metrics bit for bit, each step's launches as ``remat_step_launches``
   derives them (every forward kernel of an active layer twice under
   ``remat``), every lora_matmul on wgmma, the remat peak below the plain
   one at both rates, the remat step on ``meta`` with the card's launches
   and its peak within 10 %, seconds a step, idle share and peaks;
   rwkv6-3b, jamba-v0.1-52b (layers 2-5 of its period: attention and two
   MoE layers) and granite-moe-3b-a800m at full width cut to 4 layers, two
   steps at rate 0.0 with and without ``remat``: bit identity, launches,
   and every MoE layer's recomputed routing equal to its forward's bit
   for bit; internvl2-76b (patches drawn from the seed: ``remat_batches``)
   at the deepest cut whose ``remat`` step at rate 0.0 ``run_on_meta`` puts
   under 76 GiB: one step on the card (one layer less at a time where the
   card runs out: meta sees the allocated bytes, not the allocator's
   fragmentation), deeper than phase 5j's 9 layers, its launches and peak
   against meta's;
5n. the last of the reference's public names (``public_names_full``):
   ``multi_head_attention`` at qwen3-1.7b's heads (batch 8, bf16) in its
   four cases, each against ``plain_mha`` (3e-2 + 1e-2 |ref| and a
   relative L2 of 6e-3) with its launches exactly: (a) a causal run of 512
   with window 256 and (b) 512 queries over 1 500 keys bidirectional, one
   ``flash_attention`` each, whose backward is one ``flash_attention_bwd``
   against the plain version's autograd; (c) 16 queries at 496-511 over
   512 keys and (d) per-row positions with window 128, one ``flash_decode``
   a query, raising for an input that requires a gradient; whisper-tiny's
   encoder uncut (16 x 1 500 frames) through ``encode`` with gates at rate
   0.5 and a LoRA of rank 8 on q and v: launches from the kept layers (a
   dropped layer launches nothing and its adapter's gradient is zero),
   every lora_matmul on wgmma, states and LoRA gradients against the plain
   twins on the card in bf16 and float32; ``api.serve("qwen3-1.7b",
   smoke=False, model_overrides={"sliding_window": 256, "num_layers": 8},
   stack_mode="unroll")`` over requests that outgrow the 256-slot ring,
   token for token as ``api.serve(cfg=...)``, its launches as phase 4's;
   full-width qwen3-1.7b's local round (16 x 512, rate 0.5, 2 steps) from
   ``layout="list"`` trees under ``unroll`` and ``scan``, bit for bit the
   stacked round, launches from its gates;
5o. the sharded train step (``tensor_parallel_full``): full-width
   qwen3-1.7b (28 layers, cond at rate 0.5, LoRA r 8 on q and v, bf16,
   16 x 512) through ``make_train_step(mesh=...)`` on gloo ranks spawned
   on the one card, a 1 x 2 mesh (model 2) and a 2 x 2 mesh (data 2 x
   model 2, FSDP with ``regather_specs``), each rank's part cut from the
   same draws, 2 steps twice, against the one-rank step on the card:
   losses within 3e-2, the PEFT trees within 2·Σlr + 1e-6, the first
   step's gradients in float32 within 1e-4 of each leaf's largest element
   and in bf16 within 1.5 x the one-rank bf16 step's distance from its
   float32 step's, every rank bit-identical, a
   second run bit-identical, launches a, a and 4a − 2s all on wgmma, and
   the dry run's path on meta: launches and collective bytes exactly,
   peaks within 10 %;
5p. the sharded prefill and decode steps (``tensor_parallel_serve_full``):
   ``make_prefill_step``/``make_serve_step`` with ``mesh=...``, bf16 and
   float32, a prompt then greedy tokens: qwen3-1.7b inside 5o's ranks
   (8 x 512, 16 tokens; 1 x 2 with a pool of 4 tenants through
   ``segmented_lora``, 2 x 2 with rows over data), then 8 tokens of
   glm4-9b at 8 of 40 layers on 1 x 4 (its caches cut on the head dim, 32
   a rank: ``flash_decode_scores`` and ``flash_decode_combine``) and of
   h2o-danube-1.8b at 8 of 24 layers on 2 x 2 at batch 1 (its 4 096-slot
   window ring cut over data, ``flash_decode``'s log-sum-exp combined),
   each against the one-rank steps on the card from the same draws:
   float32 tokens equal and logits within 1e-4 of the largest, bf16's
   first decode step within 1.5 x the one-rank bf16 step's gap (both fed
   the float32 run's tokens), every model rank's tokens alike, launches
   and collective bytes as the dry run's path on meta gives them, peaks
   within 10 %; the split pair and the log-sum-exp against their twins
   at the runs' shapes, timed;
6. the ``kernels`` JSON line: launches of each kernel in its own path's
   run (serving: phase 4's run; training: phase 5's round at rate 0.5,
   phase 5b's for wkv6 and wkv6_bwd, phase 5c's for mamba_scan and
   mamba_scan_bwd), and for the training kernels also phase 5d's rounds,
   phase 5f's deadline rounds and gather round, phase 5g's runs, and for
   every kernel of the dense path phase 5e's runs, and phase 5h's serving
   runs for flash_decode, flash_attention, wkv6 and mamba_scan, and phases
   5i's, 5j's, 5k's, 5l's (b), 5m's, 5n's, 5o's and 5p's runs (``launches_by_path``; the
   head-dim split's two entries from 5p's glm4-9b run), the other dense
   decoders' shapes, FedHetLoRA's, the scans' from a state, the moe
   family's, the stub-frontend families' and the training CLI's beside.

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero before it; without a CUDA card, or outside the checkout, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
# exp on the special function units: 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0) on 132 SMs at the H100 SXM's 1.98 GHz boost clock.
SFU_EXP_PER_S = 16 * 132 * 1.98e9
REPEATS = 30
FLUSH_BYTES = 256 << 20  # > 50 MB L2; also keeps the card busy while the host enqueues


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


class Timer:
    """Median device time of a callable: each repeat runs after an L2 flush,
    between two CUDA events."""

    def __init__(self):
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, repeats: int = REPEATS) -> float:
        fn()  # warm: first launch loads the library
        times = []
        for _ in range(repeats):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def device_kernels(prof) -> list:
    """The device events of a finished ``torch.profiler`` run summed by
    name, as ``prof.key_averages()`` gives those of ``DeviceType.CUDA``:
    each with ``key``, ``count`` and ``self_device_time_total`` (us).  Read
    from the profiler's raw events, since key_averages builds an object for
    every host event as well: minutes for a round of ~2e5 launches.
    ``device_ms`` holds the two against each other on every profile it
    takes."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or getattr(e, "is_hidden_event", lambda: False)():
            continue
        k = by_name.setdefault(e.name(), SimpleNamespace(key=e.name(), count=0, self_device_time_total=0.0))
        k.count += 1
        if not e.is_async() and e.start_thread_id() == e.end_thread_id():  # key_averages counts async time as 0
            k.self_device_time_total += e.duration_ns() / 1e3
    return list(by_name.values())


SPIN_KERNELS = 64


def device_ms(fn, flush, keys=None, repeats: int = 10):
    """Mean device time per call of ``fn`` from ``torch.profiler`` over
    ``repeats`` calls, each after an L2 flush (left out of the sums): of
    every kernel ``fn`` launches, or with ``keys`` a dict of the kernels
    whose names match each key (a regular expression).  ``SPIN_KERNELS``
    spin kernels go first in the window (what the profiler drops at a
    window's start falls on them; left out too), and each kernel's time is
    its mean over the launches recorded times its launches a call.  None
    where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SPIN_KERNELS):
            torch.cuda._sleep(1000)
        for _ in range(repeats):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    averaged = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}
    events = device_kernels(prof)
    check({e.key: e.count for e in events} == {k: c for k, (c, _) in averaged.items()}
          and all(abs(e.self_device_time_total - averaged[e.key][1]) <= 1e-3 * averaged[e.key][1] + 1e-3
                  for e in events),
          "device_kernels disagrees with the profiler's key_averages")
    events = [e for e in events if e.count and not re.search("fill|spin", e.key.lower())]
    per_call = lambda e: e.self_device_time_total / e.count * max(1, round(e.count / repeats))  # noqa: E731
    mean = lambda us: us / 1e3 if us > 0 else None  # noqa: E731
    if keys is None:
        return mean(sum(per_call(e) for e in events))
    return {key: mean(sum(per_call(e) for e in events if re.search(key, e.key))) for key in keys}


def device_span_ms(fn, flush, repeats: int = 10):
    """Median device time per call of ``fn`` from ``torch.profiler``: from
    its first kernel's start to its last kernel's end, each call after an
    L2 flush.  Unlike a sum of kernel times it counts once the time in
    which a kernel launched as a programmatic dependent overlaps the kernel
    before it.  None where the profiler saw fewer than half the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    spans, cur = [], None
    for e in kernels:
        if "fill" in e.name.lower():  # the flush: a call ends
            if cur is not None:
                spans.append(cur[1] - cur[0])
            cur = None
        elif cur is None:
            cur = [e.time_range.start, e.time_range.end]
        else:
            cur[1] = max(cur[1], e.time_range.end)
    if cur is not None:
        spans.append(cur[1] - cur[0])
    spans = [x for x in spans if x > 0]
    return statistics.median(spans) / 1e3 if 2 * len(spans) >= repeats else None


def kernel_name(mangled: str) -> str:
    """``name<first template int>`` of a mangled ``..._kernel`` symbol: the
    name is the length-prefixed component that ends in ``_kernel``."""
    for m in re.finditer(r"\d+", mangled):
        for k in range(len(m.group())):
            n = int(m.group()[k:])
            name = mangled[m.end():m.end() + n]
            if len(name) == n and name.endswith("_kernel"):
                arg = re.match(r"ILi(\d+)E", mangled[m.end() + n:])
                return name + (f"<{arg.group(1)}>" if arg else "")
    return mangled


def ptxas_resources(log_text: str) -> list:
    """Registers, spill bytes and static shared memory of each entry
    function in a ``ptxas -v`` log, by the kernel's short name and its
    integer and bool template arguments."""
    out, cur = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"kernel": kernel_name(m.group(1)), "bf16": "__nv_bfloat16" in m.group(1),
                   "template_ints": [int(v) for v in re.findall(r"Li(\d+)E", m.group(1))],
                   "template_bools": [v == "1" for v in re.findall(r"Lb([01])E", m.group(1))]}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(smem.group(1)) if smem else 0
    return out


def build_log(_build, name: str) -> str:
    return _build.library_path(name).with_name(_build.library_path(name).name + ".log").read_text()


def serialization_warnings(log_text: str) -> list:
    """ptxas's wgmma serialization warnings (C7510-C7515) in a build log."""
    return [ln.strip() for ln in log_text.splitlines() if re.search(r"C751[0-5]", ln)]


def kernel_resources(_build) -> dict:
    """The registers and spills (from the build logs) of the attention
    kernels, lora_matmul's, flash_decode's, segmented_lora's, the wkv6 and
    the mamba_scan kernels', the dynamic shared memory the attention,
    lora_matmul, segmented_lora (at the decode step's q and v), wkv6 (each
    head dim), wkv6_bwd (K 64) and mamba_scan (each state dim) launchers ask
    for, and any wgmma serialization warning."""
    import ctypes

    fwd = _build.load("flash_attention").flash_attention_fwd_smem_bytes
    bwd = _build.load("flash_attention_bwd").flash_attention_bwd_smem_bytes
    lora = _build.load("lora_matmul").lora_matmul_wgmma_smem_bytes
    seg = _build.load("segmented_lora").segmented_lora_smem_bytes
    wkv = _build.load("wkv6_bwd").wkv6_bwd_smem_bytes
    wkv_fwd = _build.load("wkv6").wkv6_fwd_smem_bytes
    mamba_bwd = _build.load("mamba_scan_bwd").mamba_scan_bwd_smem_bytes
    fwd.argtypes, bwd.argtypes, lora.argtypes = [ctypes.c_int] * 2, [ctypes.c_int] * 3, []
    seg.argtypes, wkv.argtypes = [ctypes.c_int] * 3, [ctypes.c_int] * 3
    wkv_fwd.argtypes, mamba_bwd.argtypes = [ctypes.c_int] * 2, [ctypes.c_int] * 3
    out = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        rows = [r for r in ptxas_resources(build_log(_build, name)) if "probe" not in r["kernel"]]
        for r in rows:
            bf16 = "bf16" in r["kernel"]
            dtype, d = (1, int(r["kernel"].split("<")[1].rstrip(">"))) if bf16 else (0, 128)
            if name == "flash_attention":
                r["dynamic_smem"] = fwd(dtype, d)
            else:
                r["dynamic_smem"] = bwd(dtype, d, 0 if "_dq_" in r["kernel"] else 1)
            r["at_head_dim"] = d
        out[name] = rows
    out["lora_matmul"] = ptxas_resources(build_log(_build, "lora_matmul"))
    for r in out["lora_matmul"]:
        if "wgmma" in r["kernel"]:
            r["dynamic_smem"] = lora()
    out["flash_decode"] = ptxas_resources(build_log(_build, "flash_decode"))
    out["segmented_lora"] = ptxas_resources(build_log(_build, "segmented_lora"))
    for r in out["segmented_lora"]:
        if "stream" in r["kernel"] and r["bf16"]:
            r["dynamic_smem_q_v"] = [seg(1, 2048, 2048), seg(1, 2048, 1024)]
    out["wkv6"] = ptxas_resources(build_log(_build, "wkv6"))
    for r in out["wkv6"]:
        r["dynamic_smem"] = wkv_fwd(int(r["bf16"]), r["template_ints"][0])
    out["wkv6_bwd"] = ptxas_resources(build_log(_build, "wkv6_bwd"))
    for r in out["wkv6_bwd"]:
        if r["bf16"] and r["template_ints"] == [64]:
            r["dynamic_smem"] = wkv(1, 64, int("fused" in r["kernel"]))
    out["mamba_scan"] = ptxas_resources(build_log(_build, "mamba_scan"))
    for r in out["mamba_scan"]:
        r.update(mamba_fwd_occupancy(_build, int(r["bf16"]), r["template_ints"][0]))
    out["mamba_scan_bwd"] = ptxas_resources(build_log(_build, "mamba_scan_bwd"))
    for r in out["mamba_scan_bwd"]:
        which = {"mamba_chunk_states_kernel": 0, "mamba_bwd_kernel": 1}.get(r["kernel"])
        r["dynamic_smem"] = 0 if which is None else mamba_bwd(int(r["bf16"]), r["template_ints"][0], which)
    out["wgmma_serialization_warnings"] = {
        name: serialization_warnings(build_log(_build, name))
        for name in ("flash_attention", "flash_attention_bwd", "lora_matmul")
    }
    return out


def mamba_fwd_occupancy(_build, dtype: int, n: int) -> dict:
    """The dynamic shared memory of the mamba_scan forward kernel at
    (dtype code, state dim n) and the blocks an SM holds, as its launcher
    reports them; None for a tree whose library does not report them (the
    earlier design, 128 threads a block and no dynamic shared memory)."""
    import ctypes

    lib = _build.load("mamba_scan")
    if not hasattr(lib, "mamba_scan_fwd_blocks_per_sm"):
        return {"dynamic_smem": None, "blocks_per_sm": None}
    out = {"dynamic_smem": lib.mamba_scan_fwd_smem_bytes, "blocks_per_sm": lib.mamba_scan_fwd_blocks_per_sm}
    for key, fn in out.items():
        fn.argtypes = [ctypes.c_int] * 2
        out[key] = fn(dtype, n)
    return out


def mamba_fwd_resources(dtype, n: int, from_h0: bool = False) -> dict:
    """The mamba_scan forward kernel's registers and spills at (dtype, n),
    from zero or (``from_h0``) from an entering state, from its ptxas log,
    and the blocks an SM holds (of the zero-state instantiation): what sets
    its waves.  A tree whose kernel has no such template argument (before
    the entering state) counts as from zero."""
    from repro_torch.kernels import _build

    bf16 = dtype == torch.bfloat16
    rows = [r for r in ptxas_resources(build_log(_build, "mamba_scan"))
            if r["bf16"] == bf16 and r["template_ints"][:1] == [n]
            and (r["template_bools"][:1] or [False]) == [from_h0]]
    check(len(rows) == 1, f"mamba_scan forward: {len(rows)} kernels at {dtype} N={n} in the ptxas log")
    row = rows[0]
    return {"kernel": row["kernel"], "registers": row["registers"], "spill_stores": row["spill_stores"],
            "spill_loads": row["spill_loads"], **mamba_fwd_occupancy(_build, int(bf16), n)}


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segmented_case(ops, ref, timer, gen, *, dtype, n, m=8, k=2048, ranks=(4, 8, 4, 8), r_max=8):
    """One segmented_lora shape: kernel vs twin, with times and bound."""
    na = len(ranks)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=gen, device="cuda") * k**-0.5).to(dtype)
    a = (torch.randn((na, k, r_max), generator=gen, device="cuda") * k**-0.5).to(dtype)
    b = (torch.randn((na, r_max, n), generator=gen, device="cuda") * 0.08).to(dtype)
    # slots of rank 4 keep a stale rank-8 tail (a recycled slot): the mask
    # must make it inert, which the twin checks by zeroing it
    idx = (torch.arange(m, device="cuda") % na).to(torch.int32)
    rk = torch.tensor(ranks, dtype=torch.int32, device="cuda")
    got = ops.segmented_lora(x, w, a, b, idx, rk)
    want = ref.segmented_lora_plain(x, w, a, b, idx, rk)
    a_clean, b_clean = a.clone(), b.clone()
    for s, r in enumerate(ranks):
        a_clean[s, :, r:] = 0
        b_clean[s, r:, :] = 0
    clean = ops.segmented_lora(x, w, a_clean, b_clean, idx, rk)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol, rtol = (3e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-5)
    check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
          f"segmented_lora {dtype} N={n}: max abs err {err} vs twin")
    check(torch.equal(got, clean), f"segmented_lora {dtype} N={n}: stale rank tail not inert")
    fn = lambda: ops.segmented_lora(x, w, a, b, idx, rk)  # noqa: E731
    ms = timer(fn)
    plain_ms = timer(lambda: ref.segmented_lora_plain(x, w, a, b, idx, rk))
    elt = x.element_size()
    distinct = len(set(idx.tolist()))
    nbytes = elt * (m * k + k * n + distinct * (k * r_max + r_max * n) + m * n) + 4 * (m + na)
    ops_count = 2 * m * k * n + 2 * m * k * r_max + 2 * m * r_max * n
    bound_ms, bound_by = bound(nbytes, ops_count, str(dtype).split(".")[-1])
    case = {
        "shape": f"M={m} K={k} N={n} r_max={r_max} {str(dtype).split('.')[-1]}",
        "max_abs_err": err, "atol": atol, "rtol": rtol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "splits": ops._segmented_plan(ops._DTYPE_CODE[dtype], k, n, x.device)[0],
    }
    if dtype == torch.bfloat16:
        # device time alone: the call's span (the stream kernel, the
        # bottleneck's programmatic dependent, starts before it ends), the
        # two kernels apart, and cuBLAS's x @ W at M 8 as a yardstick
        parts = device_ms(fn, timer.flush, ("segmented_bottleneck_kernel", "segmented_stream_kernel"))
        case["kernel_ms"] = device_span_ms(fn, timer.flush)
        case["bottleneck_kernel_ms"] = parts["segmented_bottleneck_kernel"]
        case["stream_kernel_ms"] = parts["segmented_stream_kernel"]
        case["cublas_x_at_w_ms"] = timer(lambda: x @ w)
        case["cublas_x_at_w_kernel_ms"] = device_ms(lambda: x @ w, timer.flush)
    return case


def decode_case(ops, ref, ring_positions, timer, gen, *, q_dtype, b=8, h=16, kv=8, d=128, s=512, window=None,
                all_live=False):
    """One flash_decode shape: kernel vs twin, with times, bound and SDPA.
    ``all_live``: every slot live, slot j at position j and the query at
    s - 1, as whisper's cross-attention decodes over its encoder's K/V."""
    import torch.nn.functional as F

    q = torch.randn((b, h, d), generator=gen, device="cuda").to(q_dtype)
    kc = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(torch.bfloat16)
    # per-row depths: a fresh row, mid-ring rows, a full ring, two wrapped
    # rings, and a recycled row (small position over a ring full of stale
    # K/V from the previous tenant)
    pos = torch.tensor([0, 17, 130, s - 1, s + 100, 3 * s + 7, 5, 300], dtype=torch.int32, device="cuda")[:b]
    kpos = ring_positions(pos, s)
    if all_live:
        pos = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
        kpos = torch.arange(s, dtype=torch.int32, device="cuda").expand(b, s).contiguous()
    fn = lambda: ops.flash_decode(q, kc, vc, pos, kpos, window=window)  # noqa: E731
    got = fn()
    want = ref.decode_attention_plain(q, kc, vc, pos, kpos, window=window)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol, rtol = (3e-2, 1e-2) if q_dtype == torch.bfloat16 else (2e-5, 1e-5)
    check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
          f"flash_decode q {q_dtype} H={h} KV={kv} D={d} window={window}: max abs err {err} vs twin")
    rel = rel_l2(got, want) if all_live else None
    check(rel is None or rel <= BF16_REL_L2,
          f"flash_decode q {q_dtype} H={h} KV={kv} D={d} S={s}, every slot live: relative L2 error {rel} vs twin, "
          f"over {BF16_REL_L2}")
    ms = timer(fn)
    plain_ms = timer(lambda: ref.decode_attention_plain(q, kc, vc, pos, kpos, window=window))
    # device time alone: the call's span, and the split pass and the merge
    # pass apart (the merge, launched as the split pass's programmatic
    # dependent, waits inside its own time for the split pass to end)
    split = device_ms(fn, timer.flush, ("flash_decode_split_kernel", "flash_decode_combine_kernel"))
    span = device_span_ms(fn, timer.flush)
    live_mask = (kpos <= pos[:, None]) & ((kpos > pos[:, None] - window) if window else True)
    library_ms = library_kernel_ms = None
    if q_dtype == kc.dtype:
        # the yardstick: one SDPA call on the same inputs (never used by the port)
        mask = live_mask[:, None, None, :]
        q4, k4, v4 = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
        library_ms = timer(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True))
        library_kernel_ms = device_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True), timer.flush)
    live = int(live_mask.sum().item())
    nbytes = (q.numel() * 2 * q.element_size() + live * kv * d * 2 * kc.element_size()
              + 4 * (b + b * s))
    ops_count = 4 * live * h * d
    bound_ms, bound_by = bound(nbytes, ops_count, str(q_dtype).split(".")[-1])
    return {
        "shape": f"B={b} H={h} KV={kv} D={d} S={s} window={window} q {str(q_dtype).split('.')[-1]} cache bfloat16, "
                 f"{live} live slots" + (" (every slot: cross-attention)" if all_live else ""),
        "max_abs_err": err, "atol": atol, "rtol": rtol,
        **({"rel_l2_err": rel, "rel_l2_limit": BF16_REL_L2} if all_live else {}),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "splits": ops._decode_splits(s, q.device), "kernel_ms": span,
        "split_kernel_ms": split["flash_decode_split_kernel"],
        "combine_kernel_ms": split["flash_decode_combine_kernel"], "library_kernel_ms": library_kernel_ms,
    }


def visible_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the attention mask lets through at length s."""
    total = 0
    for i in range(s):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else s
        total += hi - lo
    return total


# bf16 attention without the causal mask, and flash_decode over every slot,
# held to the output's own scale: ||got - want|| / ||want||.  Over 1 500
# keys a typical |out| is ~0.04, as small as the 3e-2 allclose limit, so a
# key past S_kv left visible (~1.4e-2 of every output and gradient) passes
# that check.  This limit sits ~2.2x over the sound kernels' 2.3e-3 - 2.8e-3
# and ~2.4x under that fault's 1.4e-2 (bf16, N(0, 1) inputs, S_kv 77 - 1 500;
# ``tests/cuda_tail_mask_check.py`` measures both).
BF16_REL_L2 = 6e-3


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in float32."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def grads_close(got, want, dtype):
    """Kernel gradients against the twin's autograd: float32 within
    1e-4 + 1e-4 |ref|; bf16 within 2% of the gradient's largest element
    (the kernels round P and dS, or the bottleneck, to bf16)."""
    errs = []
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        if dtype == torch.float32:
            ok = torch.allclose(g, w, atol=1e-4, rtol=1e-4)
        else:
            ok = err <= 2e-2 * w.float().abs().max().item()
        errs.append(err)
        if not ok:
            return False, errs
    return True, errs


def attention_case(ops, ref, timer, gen, *, dtype, b=16, s=512, h=16, kv=8, d=128, window=None, time_it=True,
                   causal=True, skv=None, dq_only=False):
    """flash_attention forward and backward against the twin (and autograd
    through it) on the card; with ``time_it`` the times of both passes, the
    twin's, SDPA's and the bounds.  ``skv``: keys of a length of their own
    (bidirectional only); ``dq_only``: the backward times and bounds are
    those of dQ alone (K and V take no gradient, as a frozen encoder's
    cross K/V: the dK/dV kernel is not launched)."""
    import torch.nn.functional as F

    skv = skv or s
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                  for shape in ((b, s, h, d), (b, skv, kv, d), (b, skv, kv, d), (b, s, h, d)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    twins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
    want = ref.attention_plain(*twins, causal=causal, window=window)
    want_grads = torch.autograd.grad(want, twins, g, retain_graph=True)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    what = f"S={s} S_kv={skv} causal={causal} window={window}"
    err = (out.float() - want.float()).abs().max().item()
    atol, rtol = (3e-2, 1e-2) if dtype == torch.bfloat16 else (2e-5, 1e-5)
    check(torch.allclose(out.float(), want.float(), atol=atol, rtol=rtol),
          f"flash_attention {name} {what}: max abs err {err} vs twin")
    ok, grad_errs = grads_close(grads, want_grads, dtype)
    check(ok, f"flash_attention backward {name} {what}: dq/dk/dv max abs errs {grad_errs}")
    mask = "causal" if causal else "bidirectional"
    case = {"shape": f"B={b} S={s}{f' S_kv={skv}' if skv != s else ''} H={h} KV={kv} D={d} {mask} window={window} "
                     f"{name}{', backward dQ alone' if dq_only else ''}",
            "max_abs_err": err, "atol": atol, "rtol": rtol, "bwd_max_abs_err": max(grad_errs)}
    if dtype == torch.bfloat16 and not causal:
        rels = [rel_l2(out, want)] + [rel_l2(gg, wg) for gg, wg in zip(grads, want_grads)]
        check(max(rels) <= BF16_REL_L2,
              f"flash_attention {name} {what}: relative L2 errors (out, dq, dk, dv) {rels} vs twin, over {BF16_REL_L2}")
        case.update(rel_l2_err=rels[0], bwd_rel_l2_err=max(rels[1:]), rel_l2_limit=BF16_REL_L2)
    if dq_only:  # K and V without a gradient: dQ alone, bit-equal to the full backward's
        q_leaf = q.clone().requires_grad_(True)
        out = ops.flash_attention(q_leaf, k, v, causal=causal, window=window)
        check(torch.equal(torch.autograd.grad(out, [q_leaf], g, retain_graph=True)[0], grads[0]),
              f"flash_attention {name} {what}: the dQ-only backward's dQ differs from the full backward's")
        leaves, twins = [q_leaf], [twins[0]]
        want = ref.attention_plain(twins[0], k, v, causal=causal, window=window)
    if not time_it:
        return case
    with torch.no_grad():
        case["ms"] = timer(lambda: ops.flash_attention(q, k, v, causal=causal, window=window))
        case["plain_ms"] = timer(lambda: ref.attention_plain(q, k, v, causal=causal, window=window))
    case["bwd_ms"] = timer(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True))
    if dtype == torch.bfloat16:  # device time alone (no host gaps), the backward's two kernels apart
        with torch.no_grad():
            case["kernel_ms"] = device_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window),
                                          timer.flush)
        split = device_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), timer.flush,
                          ("flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel"))
        case["bwd_dq_ms"], case["bwd_dkv_ms"] = split["flash_bwd_dq_bf16_kernel"], split["flash_bwd_dkv_bf16_kernel"]
        if dq_only:
            check(case["bwd_dkv_ms"] is None, f"flash_attention {what}: the dQ-only backward ran the dK/dV kernel")
    case["plain_bwd_ms"] = timer(lambda: torch.autograd.grad(want, twins, g, retain_graph=True))
    case["library_ms"] = case["library_bwd_ms"] = None
    if window is None or window >= s:  # the yardstick: SDPA on the same inputs (never used by the port)
        lib = [t.transpose(1, 2).detach() for t in (q, k, v)]
        lib = [t.requires_grad_(True) if i == 0 or not dq_only else t for i, t in enumerate(lib)]
        sdpa = lambda: F.scaled_dot_product_attention(*lib, is_causal=causal, enable_gqa=True)  # noqa: E731
        with torch.no_grad():
            case["library_ms"] = timer(sdpa)
        lib_out = sdpa()
        g_t = g.transpose(1, 2)
        lib_leaves = lib[:1] if dq_only else lib
        case["library_bwd_ms"] = timer(lambda: torch.autograd.grad(lib_out, lib_leaves, g_t, retain_graph=True))
        with torch.no_grad():
            case["library_kernel_ms"] = device_ms(sdpa, timer.flush)
        case["library_bwd_kernel_ms"] = device_ms(
            lambda: torch.autograd.grad(lib_out, lib_leaves, g_t, retain_graph=True), timer.flush)
    elt = q.element_size()
    pairs = b * h * (visible_pairs(s, True, window) if causal else s * skv)
    qo_bytes, kv_bytes, lse_bytes = 2 * q.numel() * elt, 2 * k.numel() * elt, 4 * b * h * s
    case["bound_ms"], case["bound_by"] = bound(qo_bytes + kv_bytes + lse_bytes, 4 * d * pairs, name)
    if dq_only:  # read q, k, v, out, dout, lse; write dq; three products (S, dP, dQ)
        case["bwd_bound_ms"], case["bwd_bound_by"] = bound(2 * qo_bytes + kv_bytes + lse_bytes, 6 * d * pairs, name)
    else:  # read q, k, v, out, dout, lse; write dq, dk, dv; five products
        case["bwd_bound_ms"], case["bwd_bound_by"] = bound(2 * qo_bytes + 2 * kv_bytes + lse_bytes, 10 * d * pairs,
                                                           name)
    return case


def lora_case(ops, ref, timer, gen, *, dtype, n, m=8192, k=2048, r=8, alpha=2.0):
    """lora_matmul forward, dX, dA and dB against the twin on the card, with
    the forward's and dX's times, the twin's, cuBLAS's x @ W and the bounds."""
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=gen, device="cuda") * k**-0.5).to(dtype)
    a = (torch.randn((k, r), generator=gen, device="cuda") * k**-0.5).to(dtype)
    b = (torch.randn((r, n), generator=gen, device="cuda") * r**-0.5).to(dtype)
    g = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, b)]
    twins = [t.clone().requires_grad_(True) for t in (x, a, b)]
    y = ops.lora_matmul(leaves[0], w, leaves[1], leaves[2], alpha=alpha)
    grads = torch.autograd.grad(y, leaves, g)
    want = ref.lora_matmul_plain(twins[0], w, twins[1], twins[2], alpha=alpha)
    want_grads = torch.autograd.grad(want, twins, g)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    err = (y.float() - want.float()).abs().max().item()
    atol, rtol = (3e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-5)
    check(torch.allclose(y.float(), want.float(), atol=atol, rtol=rtol),
          f"lora_matmul {name} N={n}: max abs err {err} vs twin")
    ok, grad_errs = grads_close(grads, want_grads, dtype)
    check(ok, f"lora_matmul backward {name} N={n}: dx/da/db max abs errs {grad_errs}")
    with torch.no_grad():
        ms = timer(lambda: ops.lora_matmul(x, w, a, b, alpha=alpha))
        plain_ms = timer(lambda: ref.lora_matmul_plain(x, w, a, b, alpha=alpha))
        cublas_ms = timer(lambda: x @ w)
    xl = x.clone().requires_grad_(True)
    yl = ops.lora_matmul(xl, w, a, b, alpha=alpha)  # a, b take no grad: the backward is dX alone
    dx_ms = timer(lambda: torch.autograd.grad(yl, xl, g, retain_graph=True))
    elt = x.element_size()
    nbytes = elt * (m * k + k * n + k * r + r * n + m * n)
    bound_ms, bound_by = bound(nbytes, 2 * m * k * n + 2 * m * k * r + 2 * m * r * n, name)
    case = {
        "shape": f"M={m} K={k} N={n} r={r} {name}", "max_abs_err": err, "atol": atol, "rtol": rtol,
        "bwd_max_abs_err": max(grad_errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "cublas_x_at_w_ms": cublas_ms, "dx_ms": dx_ms,
        "dx_bound_ms": bound(nbytes, 2 * m * n * k + 2 * m * n * r + 2 * m * r * k, name)[0],
        "route": ops.lora_matmul_route(x, w), "dx_route": ops.lora_matmul_route(g, w.t()),
    }
    if dtype == torch.bfloat16:
        # the first design's WMMA route on the same inputs, for the change on one card
        with torch.no_grad():
            case["wmma_route_ms"] = timer(lambda: ops._lora_matmul_launch(x, w, a, b, alpha, "wmma"))
        # device time alone: the call's span, and the bottleneck and main
        # kernels apart (the main kernel, the bottleneck's programmatic
        # dependent, may start before the bottleneck ends)
        keys = ("lora_bottleneck_kernel", "lora_matmul_wgmma_kernel", "lora_matmul_wmma_kernel")
        fwd_fn = lambda: ops.lora_matmul(x, w, a, b, alpha=alpha)  # noqa: E731
        dx_fn = lambda: torch.autograd.grad(yl, xl, g, retain_graph=True)  # noqa: E731
        with torch.no_grad():
            fwd = device_ms(fwd_fn, timer.flush, keys)
            fwd["span"] = device_span_ms(fwd_fn, timer.flush)
            case["cublas_x_at_w_kernel_ms"] = device_ms(lambda: x @ w, timer.flush)
        dxk = device_ms(dx_fn, timer.flush, keys)
        dxk["span"] = device_span_ms(dx_fn, timer.flush)
        for prefix, parts in (("", fwd), ("dx_", dxk)):
            case[prefix + "kernel_ms"] = parts["span"]
            case[prefix + "bottleneck_kernel_ms"] = parts["lora_bottleneck_kernel"]
            case[prefix + "main_kernel_ms"] = parts["lora_matmul_wgmma_kernel"] or parts["lora_matmul_wmma_kernel"]
    return case


def bottleneck_of(ops, x, a, route=None):
    """The rounded t = T(x @ A) that a lora_matmul route computes, read
    through its own launch: with W = 0, B the identity and alpha 2, y =
    T(2 t) = 2 t exactly."""
    k, r = a.shape
    n = -(-r // 8) * 8
    eye = torch.zeros((r, n), dtype=x.dtype, device=x.device)
    eye[:, :r] = torch.eye(r, dtype=x.dtype, device=x.device)
    y = ops._lora_matmul_launch(x, torch.zeros((k, n), dtype=x.dtype, device=x.device), a, eye, 2.0, route)
    return y[:, :r].float() / 2


LORA_FAULT_OFFSET = 1100  # Philox offset of the card's generator seeded 0 at the failing draw


def lora_fault_case(ops, ref, *, m=8192, k=2560, n=8960, r=8, alpha=2.0):
    """The draw on which lora_matmul's first bf16 design failed its check
    (max abs error 0.0625 at the rwkv6-3b channel-mix up shape), pinned by
    a generator of its own: the card's generator seeded 0 at Philox offset
    1100, drawn as ``lora_case`` draws.  On the route the launcher picks
    and on the WMMA route, each checked (3e-2 + 1e-2 |ref|, and the
    bottleneck t within one bf16 ulp of the twin's, the ulp floored at
    2^-19): the error, the elements out of tolerance and the bf16 roundings
    of t that differ from the twin's."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    gen.set_offset(LORA_FAULT_OFFSET)
    rn = lambda shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x = rn((m, k)).to(torch.bfloat16)
    w = (rn((k, n)) * k**-0.5).to(torch.bfloat16)
    a = (rn((k, r)) * k**-0.5).to(torch.bfloat16)
    b = (rn((r, n)) * r**-0.5).to(torch.bfloat16)
    want = ref.lora_matmul_plain(x, w, a, b, alpha=alpha).float()
    t_ref = (x.float() @ a.float()).to(torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(t_ref.abs().clamp_min(2.0**-12))) - 7)
    out = {"shape": f"M={m} K={k} N={n} r={r} bfloat16, alpha {alpha}"}
    for route in (ops.lora_matmul_route(x, w), "wmma"):
        y = ops._lora_matmul_launch(x, w, a, b, alpha, route).float()
        t = bottleneck_of(ops, x, a, route)
        torch.cuda.synchronize()
        err = (y - want).abs()
        out[route] = {"max_abs_err": err.max().item(),
                      "n_out_of_tolerance": int((err > 3e-2 + 1e-2 * want.abs()).sum()),
                      "t_roundings_differing": int((t != t_ref).sum()),
                      "t_beyond_one_ulp": int(((t - t_ref).abs() > ulp).sum())}
    for route in (ops.lora_matmul_route(x, w), "wmma"):
        check(out[route]["n_out_of_tolerance"] == 0, f"lora_matmul {route} route on the fixed draw: {out[route]}")
        check(out[route]["t_beyond_one_ulp"] == 0,
              f"lora_matmul {route} route's bottleneck on the fixed draw: {out[route]}")
    out["route"] = ops.lora_matmul_route(x, w)
    return out


def grouped_lora_case(ops, ref, timer, gen, *, dtype, g=10, rows=512, k=2048, n=2048, r=8, alpha=2.0,
                      time_it=True):
    """The grouped lora_matmul (A (G, K, r), B (G, r, N): the rows of group
    g take A_g and B_g, as the batched cohort's G devices do) against its
    twin on the card: forward and dX as ``lora_matmul`` checks them, dA and
    dB (batched products, summed in another order than the twin's
    per-group ones) in float32 within 1e-5 of the gradient's largest
    element, on the route ``lora_matmul_route`` names; G = 1 against the
    ungrouped kernel, and every group's rows against an ungrouped launch on
    them with A_g and B_g on the same route, bit for bit, forward and dX.
    With ``time_it``: the grouped launch beside G ungrouped launches (one
    a group), one ungrouped launch over all M = G x rows rows (one
    adapter: the same tiles without the groups' epilogue), cuBLAS's x @ W
    at M, the twin and the bound; device times by ``torch.profiler``."""
    m = g * rows
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((k, n), generator=gen, device="cuda") * k**-0.5).to(dtype)
    a = (torch.randn((g, k, r), generator=gen, device="cuda") * k**-0.5).to(dtype)
    b = (torch.randn((g, r, n), generator=gen, device="cuda") * r**-0.5).to(dtype)
    dy = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
    name, route = str(dtype).split(".")[-1], ops.lora_matmul_route(x, w, a)
    shape = f"G={g} x {rows} rows, K={k} N={n} r={r} {name}"
    leaves = [t.clone().requires_grad_(True) for t in (x, a, b)]
    twins = [t.clone().requires_grad_(True) for t in (x, a, b)]
    ops.reset_launch_counts()
    y = ops.lora_matmul(leaves[0], w, leaves[1], leaves[2], alpha=alpha)
    grads = torch.autograd.grad(y, leaves, dy)
    routes = dict(ops.lora_matmul_routes)
    want = ref.lora_matmul_plain(twins[0], w, twins[1], twins[2], alpha=alpha)
    want_grads = torch.autograd.grad(want, twins, dy)
    torch.cuda.synchronize()
    check(routes[route] == 2 == sum(routes.values()), f"grouped lora_matmul {shape}: routes {routes}, 2 on {route}")
    err = (y.float() - want.float()).abs().max().item()
    atol, rtol = (3e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-5)
    check(torch.allclose(y.float(), want.float(), atol=atol, rtol=rtol),
          f"grouped lora_matmul {shape}: max abs err {err} vs twin")
    ok, grad_errs = grads_close(grads[:1], want_grads[:1], dtype)
    for got, ref_grad in zip(grads[1:], want_grads[1:]):
        grad_err = (got.float() - ref_grad.float()).abs().max().item()
        grad_errs.append(grad_err)
        ok = ok and grad_err <= (1e-5 if dtype == torch.float32 else 2e-2) * ref_grad.float().abs().max().item()
    check(ok, f"grouped lora_matmul backward {shape}: dx/da/db max abs errs {grad_errs}")

    dx_route = ops.lora_matmul_route(dy, w.t(), b.transpose(-1, -2))

    def launches(x_, a_, b_, dy_):  # forward and dX on the grouped call's routes
        return (ops._lora_matmul_launch(x_, w, a_, b_, alpha, route),
                ops._lora_matmul_launch(dy_, w.t(), b_.transpose(-1, -2), a_.transpose(-1, -2), alpha, dx_route))

    xl = x.clone().requires_grad_(True)
    y_all = ops.lora_matmul(xl, w, a, b, alpha=alpha)
    dx_all = torch.autograd.grad(y_all, xl, dy)[0]
    for i in range(g):
        part = slice(i * rows, (i + 1) * rows)
        y_i, dx_i = launches(x[part], a[i], b[i], dy[part])
        check(torch.equal(y_all[part], y_i) and torch.equal(dx_all[part], dx_i),
              f"grouped lora_matmul {shape}: group {i}'s rows differ from an ungrouped launch on them")
    one, alone = launches(x[:rows], a[:1], b[:1], dy[:rows]), launches(x[:rows], a[0], b[0], dy[:rows])
    check(all(torch.equal(p, q) for p, q in zip(one, alone)), f"grouped lora_matmul {shape}: G = 1 differs")
    case = {"shape": shape, "route": route, "max_abs_err": err, "atol": atol, "rtol": rtol,
            "bwd_max_abs_err": max(grad_errs), "groups_bit_equal_to_ungrouped": True, "g1_bit_equal": True}
    if not time_it:
        return case
    xs = [x[i * rows:(i + 1) * rows] for i in range(g)]
    grouped_fn = lambda: ops.lora_matmul(x, w, a, b, alpha=alpha)  # noqa: E731
    ungrouped_fn = lambda: [ops.lora_matmul(xs[i], w, a[i], b[i], alpha=alpha) for i in range(g)]  # noqa: E731
    with torch.no_grad():
        case["ms"] = timer(grouped_fn)
        case["ungrouped_launches_ms"] = timer(ungrouped_fn)
        case["cublas_x_at_w_ms"] = timer(lambda: x @ w)
        case["plain_ms"] = timer(lambda: ref.lora_matmul_plain(x, w, a, b, alpha=alpha), repeats=3)
        case["kernel_ms"] = device_span_ms(grouped_fn, timer.flush)
        case["kernels_device_ms"] = device_ms(grouped_fn, timer.flush)
        case["ungrouped_launches_device_ms"] = device_ms(ungrouped_fn, timer.flush)
        case["one_adapter_kernel_ms"] = device_span_ms(lambda: ops.lora_matmul(x, w, a[0], b[0], alpha=alpha),
                                                       timer.flush)
        case["cublas_x_at_w_kernel_ms"] = device_ms(lambda: x @ w, timer.flush)
    nbytes = x.element_size() * (m * k + k * n + g * k * r + g * r * n + m * n)
    case["bound_ms"], case["bound_by"] = bound(nbytes, 2 * m * k * n + 2 * m * k * r + 2 * m * r * n, name)
    case["library_ms"] = None  # no single PyTorch call computes x @ W plus a LoRA per group
    return case


def wkv6_case(ops, ref, timer, gen, *, dtype, b=16, s=512, h=40, k=64, state=False, time_it=True):
    """wkv6 forward and backward against their twins on the card: out and
    the final state, then dr, dk, dv, dlogw, du (and ds0 with a state in,
    with a cotangent on the final state too).  With ``time_it`` the times
    of both passes, the twins' (3 repeats: they loop over tokens) and the
    bounds; no single PyTorch call computes WKV6, so there is no library
    time.  Float32 outputs within 1e-4 abs + 1e-3 rel; bf16 dr, dk, dv
    within 3e-2 abs + 1e-2 rel (one bf16 rounding of the same float32)."""
    shape = (b, s, h, k)
    r, kk, v = ((0.5 * torch.randn(shape, generator=gen, device="cuda")).to(dtype) for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn(shape, generator=gen, device="cuda")), -4.0, -1e-4)
    u = 0.3 * torch.randn((h, k), generator=gen, device="cuda")
    s0 = torch.randn((b, h, k, k), generator=gen, device="cuda") if state else None
    dout = torch.randn(shape, generator=gen, device="cuda")
    dstate = torch.randn((b, h, k, k), generator=gen, device="cuda") if state else None
    inputs = [r, kk, v, logw, u] + ([s0] if state else [])
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out, st = ops.wkv6(*leaves, *([] if state else [None]))
    loss = (out * dout).sum() + ((st * dstate).sum() if state else 0.0)
    grads = torch.autograd.grad(loss, leaves, retain_graph=True)
    want_out, want_st = ref.wkv6_plain(r, kk, v, logw, u, s0)
    want_grads = [g for g in ref.wkv6_bwd_plain(r, kk, v, logw, u, s0, dout, dstate) if g is not None]
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    err = max((out - want_out).abs().max().item(), (st - want_st).abs().max().item())
    check(torch.allclose(out, want_out, atol=1e-4, rtol=1e-3) and torch.allclose(st, want_st, atol=1e-4, rtol=1e-3),
          f"wkv6 {name} {shape} state={state}: max abs err {err} vs twin")
    grad_errs = []
    for gname, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), grads, want_grads):
        grad_errs.append((g.float() - w.float()).abs().max().item())
        atol, rtol = (3e-2, 1e-2) if g.dtype == torch.bfloat16 else (1e-4, 1e-3)
        check(g.dtype == w.dtype and torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol),
              f"wkv6 backward {name} {shape} state={state}: {gname} max abs err {grad_errs[-1]} vs twin")
    again = torch.autograd.grad(loss, leaves, retain_graph=True)
    check(all(torch.equal(x, y) for x, y in zip(grads, again)), f"wkv6 backward {name} {shape}: two runs differ")
    case = {"shape": f"B={b} S={s} H={h} K={k} r/k/v {name} state={state}", "max_abs_err": err,
            "atol": 1e-4, "rtol": 1e-3, "bwd_max_abs_err": max(grad_errs), "bwd_errs": grad_errs}
    if not time_it:
        return case
    with torch.no_grad():
        case["ms"] = timer(lambda: ops.wkv6(r, kk, v, logw, u, s0))
        case["plain_ms"] = timer(lambda: ref.wkv6_plain(r, kk, v, logw, u, s0), repeats=3)
    # the backward alone, its scratch included, as _WKV6.backward calls it
    bwd_fn = lambda: ops._wkv6_bwd(r, kk, v, logw, u, s0, dout, dstate)  # noqa: E731
    case["bwd_ms"] = timer(bwd_fn)
    # device time alone: the forward kernel; the backward's span and its
    # three kernels apart
    with torch.no_grad():
        case["kernel_ms"] = device_ms(lambda: ops.wkv6(r, kk, v, logw, u, s0), timer.flush)
    case["bwd_kernel_ms"] = device_span_ms(bwd_fn, timer.flush)
    keys = ("wkv6_bwd_sweep_kernel", "wkv6_bwd_fused_kernel", "wkv6_du_reduce_kernel")
    case["bwd_kernels_ms"] = dict(zip(("sweep", "fused", "du_reduce"), device_ms(bwd_fn, timer.flush, keys).values()))
    case["plain_bwd_ms"] = timer(lambda: ref.wkv6_bwd_plain(r, kk, v, logw, u, s0, dout, dstate), repeats=3)
    case["library_ms"] = case["library_bwd_ms"] = None
    elt, n, state_bytes = r.element_size(), r.numel(), 4 * b * h * k * k
    cells = n * k  # (token, head, k, v) state elements touched per pass
    # forward: read r, k, v, logw (and s0), write out and the final state;
    # per state element and token out += r S (2 operations), S = w S + k v (3)
    case["bound_ms"], case["bound_by"] = bound(
        3 * elt * n + 4 * n + 4 * n + state_bytes * (2 if state else 1), 5 * cells, "float32")
    # backward: read r, k, v, logw, dout (and s0, dstate), write dr, dk, dv,
    # dlogw (and ds0); per state element and token S again (3), G (3),
    # dr', dk', dv (2 each); dlogw is stepped back from dr' and dk' per row,
    # O(K) per token, not per state element
    case["bwd_bound_ms"], case["bwd_bound_by"] = bound(
        6 * elt * n + 3 * 4 * n + state_bytes * (3 if state else 0), 12 * cells, "float32")
    return case


def mamba_case(ops, ref, timer, gen, *, dtype, b=16, s=512, d=8192, n=16, time_it=True):
    """mamba_scan forward and backward against their twins on the card: y
    and the final state, then d_dt, dx, dB, dC, dA, dD, and a second
    backward bit-identical to the first.  With ``time_it`` the times of
    both passes, the twins' (3 repeats: they loop over tokens) and the
    bounds, whose terms are bytes, float32 operations and exp on the
    special function units; no single PyTorch call computes the scan, so
    there is no library time.  y, d_dt, dx within 1e-4 + 1e-3 |ref| in
    float32 and 3e-2 + 1e-2 |ref| in bf16 (one bf16 rounding); the final
    state within 1e-4 + 1e-3 |ref|; dB, dC, dA, dD (float32 sums over
    channels, rows and time, in another order) within 1e-3 |ref| + 1e-5 of
    their largest element."""
    dt = torch.nn.functional.softplus(torch.randn((b, s, d), generator=gen, device="cuda") - 1.0).to(dtype)
    x = torch.randn((b, s, d), generator=gen, device="cuda").to(dtype)
    bm, cm = (torch.randn((b, s, n), generator=gen, device="cuda") for _ in range(2))
    a = -torch.exp(torch.randn((d, n), generator=gen, device="cuda"))
    dv = torch.randn((d,), generator=gen, device="cuda")
    dy = torch.randn((b, s, d), generator=gen, device="cuda").to(dtype)
    inputs = [dt, x, bm, cm, a, dv]
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y, st = ops.mamba_scan(*leaves)
    grads = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    again = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    want_y, want_st = ref.mamba_scan_plain(*inputs)
    want = ref.mamba_scan_bwd_plain(*inputs, dy)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    shape = f"B={b} S={s} D={d} N={n} dt/x {name}"
    atol, rtol = (3e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-3)
    err = (y.float() - want_y.float()).abs().max().item()
    check(torch.allclose(y.float(), want_y.float(), atol=atol, rtol=rtol)
          and torch.allclose(st, want_st, atol=1e-4, rtol=1e-3),
          f"mamba_scan {shape}: max abs err {err} (y), {(st - want_st).abs().max().item()} (state) vs twin")
    grad_errs = []
    for gname, g, w in zip(("d_dt", "dx", "dB", "dC", "dA", "dD"), grads, want):
        grad_errs.append((g.float() - w.float()).abs().max().item())
        if gname in ("d_dt", "dx"):
            ok = torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol)
        else:
            ok = torch.allclose(g, w, atol=1e-5 * w.abs().max().item() + 1e-6, rtol=1e-3)
        check(g.dtype == w.dtype and ok, f"mamba_scan backward {shape}: {gname} max abs err {grad_errs[-1]} vs twin")
    check(all(torch.equal(p, q) for p, q in zip(grads, again)), f"mamba_scan backward {shape}: two runs differ")
    case = {"shape": shape, "max_abs_err": err, "atol": atol, "rtol": rtol, "bwd_max_abs_err": max(grad_errs),
            "bwd_errs": grad_errs}
    if not time_it:
        return case
    with torch.no_grad():
        case["ms"] = timer(lambda: ops.mamba_scan(*inputs))
        case["plain_ms"] = timer(lambda: ref.mamba_scan_plain(*inputs), repeats=3)
    # the backward alone, its scratch included, as _MambaScan.backward calls it
    bwd_fn = lambda: ops._mamba_bwd(*inputs, dy)  # noqa: E731
    case["bwd_ms"] = timer(bwd_fn)
    # device time alone: the forward kernel, also by its name (and by the
    # earlier design's, for a tree compared by --scans-of) with its
    # registers, spills and blocks an SM; the backward's span and its four
    # kernels apart
    with torch.no_grad():
        case["kernel_ms"] = device_ms(lambda: ops.mamba_scan(*inputs), timer.flush)
        fwd_key = "mamba_scan_fwd_kernel|mamba_forward_kernel"
        case["fwd_kernel_ms"] = device_ms(lambda: ops.mamba_scan(*inputs), timer.flush, (fwd_key,))[fwd_key]
    case["fwd_resources"] = mamba_fwd_resources(dtype, n)
    case["bwd_kernel_ms"] = device_span_ms(bwd_fn, timer.flush)
    # (mamba_forward_sweep, mamba_bwd_sweep: the earlier design's names, for
    # a tree compared by --scans-of)
    keys = ("mamba_chunk_states|mamba_forward_sweep", "mamba_bwd_", "mamba_bc_reduce", "mamba_ad_reduce")
    case["bwd_kernels_ms"] = dict(zip(("chunk_states", "walk", "bc_reduce", "ad_reduce"),
                                      device_ms(bwd_fn, timer.flush, keys).values()))
    # the scratch: the allocator's requested bytes at the peak of one
    # backward, less what it returns
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    got = bwd_fn()
    torch.cuda.synchronize()
    outputs = sum(g.numel() * g.element_size() for g in got)
    case["bwd_scratch_bytes"] = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before - outputs
    del got
    case["plain_bwd_ms"] = timer(lambda: ref.mamba_scan_bwd_plain(*inputs, dy), repeats=3)
    case["library_ms"] = case["library_bwd_ms"] = None
    elt, cells, small = x.element_size(), b * s * d * n, 4 * (d * n + d)
    # forward: read dt, x, B, C, A, D, write y and the final state; per state
    # element and token one exp and 6 float32 operations (dt A, u B, the
    # state's fma, the output's fma)
    fwd = {"bytes": 3 * elt * b * s * d + 4 * 2 * b * s * n + small + 4 * b * d * n,
           "float32": 6 * cells, "exp": cells}
    # backward: read dt, x, dy, B, C, A, D, write d_dt, dx, dB, dC, dA, dD;
    # the function needs a_t once per state element and token and 19
    # float32 operations (the state again 4, g 3, q 2, the sums for d_dt,
    # dA, du, dB, dC 2 each)
    bwd = {"bytes": 5 * elt * b * s * d + 4 * 4 * b * s * n + 2 * small, "float32": 19 * cells, "exp": cells}
    for prefix, terms in (("", fwd), ("bwd_", bwd)):
        times = {"bytes": terms["bytes"] / HBM_BYTES_PER_S * 1e3,
                 "float32": terms["float32"] / PEAK_OPS_PER_S["float32"] * 1e3,
                 "exp": terms["exp"] / SFU_EXP_PER_S * 1e3}
        top = max(times, key=times.get)
        case[prefix + "bound_ms"] = times[top]
        case[prefix + "bound_by"] = "bytes" if top == "bytes" else "operations"
        case[prefix + "bound_terms_ms"] = times
    return case


def mamba_h0_case(ops, ref, timer, gen, *, dtype, b=8, s=1, d=8192, n=16):
    """mamba_scan from an entering state h0 (the serving path: jamba's
    decode step at S 1, its prefill at S 128) against its twin from the
    same h0: y within 1e-4 + 1e-3 |ref| in float32 and 3e-2 + 1e-2 |ref|
    in bf16, the final state within 1e-4 + 1e-3 |ref|; the times of the
    kernel and the twin (3 repeats), the kernel's device time and the
    bound: the bytes of dt, x, y, B, C and the state read and written, the
    exp and float32 operations of mamba_case's forward."""
    dt = torch.nn.functional.softplus(torch.randn((b, s, d), generator=gen, device="cuda") - 1.0).to(dtype)
    x = torch.randn((b, s, d), generator=gen, device="cuda").to(dtype)
    bm, cm = (torch.randn((b, s, n), generator=gen, device="cuda") for _ in range(2))
    a = -torch.exp(torch.randn((d, n), generator=gen, device="cuda"))
    dv = torch.randn((d,), generator=gen, device="cuda")
    h0 = torch.randn((b, d, n), generator=gen, device="cuda")
    inputs = (dt, x, bm, cm, a, dv, h0)
    with torch.no_grad():
        y, st = ops.mamba_scan(*inputs)
    want_y, want_st = ref.mamba_scan_plain(*inputs)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    shape = f"B={b} S={s} D={d} N={n} dt/x {name}, from h0"
    atol, rtol = (3e-2, 1e-2) if dtype == torch.bfloat16 else (1e-4, 1e-3)
    err = max((y.float() - want_y.float()).abs().max().item(), (st - want_st).abs().max().item())
    check(torch.allclose(y.float(), want_y.float(), atol=atol, rtol=rtol)
          and torch.allclose(st, want_st, atol=1e-4, rtol=1e-3),
          f"mamba_scan {shape}: max abs err {err} vs twin")
    case = {"shape": shape, "max_abs_err": err, "atol": atol, "rtol": rtol}
    with torch.no_grad():
        case["ms"] = timer(lambda: ops.mamba_scan(*inputs))
        case["plain_ms"] = timer(lambda: ref.mamba_scan_plain(*inputs), repeats=3)
        case["kernel_ms"] = device_ms(lambda: ops.mamba_scan(*inputs), timer.flush)
    case["fwd_resources"] = mamba_fwd_resources(dtype, n, from_h0=True)
    cells = b * s * d * n
    terms = {"bytes": (3 * x.element_size() * b * s * d + 4 * 2 * b * s * n + 4 * (d * n + d)
                       + 2 * 4 * b * d * n) / HBM_BYTES_PER_S * 1e3,
             "float32": 6 * cells / PEAK_OPS_PER_S["float32"] * 1e3, "exp": cells / SFU_EXP_PER_S * 1e3}
    top = max(terms, key=terms.get)
    case.update(bound_ms=terms[top], bound_by="bytes" if top == "bytes" else "operations", bound_terms_ms=terms,
                state_bytes_read_and_written=2 * 4 * b * d * n, library_ms=None)
    return case


def wkv6_step_case(ops, ref, timer, gen, *, dtype, b=8, h=40, k=64):
    """wkv6 at S 1 from a state s0 (rwkv6-3b's decode step) against its
    twin: out and the final state within 1e-4 + 1e-3 |ref|; the times of
    the kernel and the twin, the kernel's device time and the bound: the
    bytes of r, k, v, logw, u, out and the state read and written, 5
    float32 operations a state element."""
    shape = (b, 1, h, k)
    r, kk, v = ((0.5 * torch.randn(shape, generator=gen, device="cuda")).to(dtype) for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn(shape, generator=gen, device="cuda")), -4.0, -1e-4)
    u = 0.3 * torch.randn((h, k), generator=gen, device="cuda")
    s0 = torch.randn((b, h, k, k), generator=gen, device="cuda")
    inputs = (r, kk, v, logw, u, s0)
    with torch.no_grad():
        out, st = ops.wkv6(*inputs)
    want_out, want_st = ref.wkv6_plain(*inputs)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    err = max((out - want_out).abs().max().item(), (st - want_st).abs().max().item())
    check(torch.allclose(out, want_out, atol=1e-4, rtol=1e-3) and torch.allclose(st, want_st, atol=1e-4, rtol=1e-3),
          f"wkv6 one token {name} {shape}: max abs err {err} vs twin")
    case = {"shape": f"B={b} S=1 H={h} K={k} r/k/v {name}, from s0", "max_abs_err": err, "atol": 1e-4,
            "rtol": 1e-3}
    with torch.no_grad():
        case["ms"] = timer(lambda: ops.wkv6(*inputs))
        case["plain_ms"] = timer(lambda: ref.wkv6_plain(*inputs), repeats=3)
        case["kernel_ms"] = device_ms(lambda: ops.wkv6(*inputs), timer.flush)
    n, state_bytes = b * h * k, 4 * b * h * k * k
    case["bound_ms"], case["bound_by"] = bound(3 * r.element_size() * n + 4 * n + 4 * h * k + 4 * n + 2 * state_bytes,
                                               5 * n * k, "float32")
    case.update(state_bytes_read_and_written=2 * state_bytes, library_ms=None)
    return case


def scans_of(src: str, card: str, seed: int, scans=("wkv6", "mamba_scan")) -> int:
    """The scan kernels (and flash_decode) of the repro_torch already
    imported from ``src``: built into that tree's build/, their registers
    and spills, and the timed wkv6 and mamba_scan cases at the training
    shapes and flash_decode's at qwen3-1.7b's decode step (those named in
    ``scans``), one line each."""
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.nn.attention import ring_positions

    names = [name for scan in scans for name in ((scan,) if scan == "flash_decode" else (scan, scan + "_bwd"))]
    _build.build(names)
    print(f"scans of {src}: kernel resources {json.dumps({n: ptxas_resources(build_log(_build, n)) for n in names})}",
          flush=True)
    timer = Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if "wkv6" in scans:
        print(f"scans of {src}: wkv6 {json.dumps(wkv6_case(ops, ref, timer, gen, dtype=torch.bfloat16))} [{card}]",
              flush=True)
    if "mamba_scan" in scans:
        print(f"scans of {src}: mamba_scan {json.dumps(mamba_case(ops, ref, timer, gen, dtype=torch.bfloat16))} "
              f"[{card}]", flush=True)
    if "flash_decode" in scans:
        for q_dtype in (torch.bfloat16, torch.float32):
            case = decode_case(ops, ref, ring_positions, timer, gen, q_dtype=q_dtype)
            print(f"scans of {src}: flash_decode {json.dumps(case)} [{card}]", flush=True)
    return 0


def make_tenants(cfg, gen, n=4):
    from repro_torch.configs import PEFTConfig
    from repro_torch.core.peft import init_peft

    trees = {}
    for i in range(n):
        tree = init_peft(cfg, PEFTConfig(lora_rank=4 if i % 2 == 0 else 8), gen)
        for node in tree["attn"].values():
            node["b"].normal_(0.0, 0.02, generator=gen)  # LoRA init keeps b = 0
        trees[f"tenant{i}"] = tree
    return trees


def serve_full(api, ops, card, seed: int, arch: str = "qwen3-1.7b", cfg=None):
    """Phase 4 (and 5e, 5i for the other archs): full-width ``arch`` (or
    ``cfg``, a depth cut of it) through api.serve."""
    from repro_torch.configs import get_config
    from repro_torch.serving.batcher import ContinuousBatcher, Request

    gc.collect()  # an earlier phase's weights may sit in reference cycles
    torch.cuda.empty_cache()
    cfg = cfg or get_config(arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    t0 = time.perf_counter()
    batcher = api.serve(arch, smoke=False, cfg=cfg, adapters=make_tenants(cfg, gen),
                        batch=8, max_len=512, seed=seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    finite = []
    step = batcher.serve_step

    def checked_step(*args, **kw):
        logits, nxt, caches = step(*args, **kw)
        check(tuple(logits.shape) == (batcher.batch, cfg.vocab_size), f"logits shape {tuple(logits.shape)}")
        finite.append(torch.isfinite(logits).all())
        return logits, nxt, caches

    batcher.serve_step = checked_step
    rng = np.random.default_rng(seed)
    requests = []
    for j in range(12):
        plen = int(rng.integers(16, 129))
        requests.append(Request(prompt=rng.integers(0, cfg.vocab_size, plen).tolist(),
                                adapter=f"tenant{j % 4}", max_new_tokens=32, uid=j))
    for r in requests:
        batcher.submit(r)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = batcher.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(sorted(c.uid for c in done) == list(range(12)), "not every completion arrived")
    check(all(len(c.tokens) == 32 for c in done), "a completion is short")
    check(bool(torch.stack(finite).all().item()), "non-finite logits")
    gen_tokens = sum(len(c.tokens) for c in done)
    prompt_tokens = sum(len(r.prompt) for r in requests)
    steps = len(finite)

    # one request that entered a recycled row, served alone in a uniform batch
    j = 11
    solo = ContinuousBatcher(step, batcher.params, cfg, batcher.pool, batch=8, max_len=512,
                             cache_dtype=torch.bfloat16)
    for z in range(8):
        solo.submit(Request(prompt=requests[j].prompt, adapter=requests[j].adapter,
                            max_new_tokens=32, uid=f"{j}.{z}"))
    ref_tokens = {c.uid: c.tokens for c in solo.run()}[f"{j}.0"]
    got_tokens = next(c.tokens for c in done if c.uid == j)
    check(got_tokens == ref_tokens, f"request {j}: batched tokens {got_tokens} != per-request {ref_tokens}")

    profiled = ContinuousBatcher(step, batcher.params, cfg, batcher.pool, batch=8, max_len=512,
                                 cache_dtype=torch.bfloat16)
    breakdown = profile_steps(profiled, [
        Request(prompt=r.prompt, adapter=r.adapter, max_new_tokens=32, uid=r.uid) for r in requests[:8]
    ])
    if breakdown is not None:
        # q and v of every layer: both kernels of the redesigned segmented_lora,
        # counted over one more step.  The profiler drops a few of an 8-step
        # window's ~28 000 kernel events at random (glm4-9b: 638 of 640 calls
        # in 5 of 6 windows, 27 977 of 28 000 kernels), so the count takes
        # one-step windows, up to 5, the first whole one kept: a call that
        # skipped a kernel would repeat in every step
        keys = ("segmented_bottleneck_kernel", "segmented_stream_kernel")
        windows = []
        for _ in range(5):
            windows.append(kernel_calls(profiled, keys))
            if all(windows[-1][key] == 2 * cfg.num_layers for key in keys):
                break
        breakdown["one_step_windows_counted"] = windows
        for key in keys:
            check(windows[-1][key] == 2 * cfg.num_layers,
                  f"{key}: calls a step {[w[key] for w in windows]}, expected {2 * cfg.num_layers}; "
                  f"the windows' counts {windows}")
    return {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
        "window": cfg.sliding_window, "cache_slots": batcher.caches["k"].shape[2],
        "requests": len(done), "steps": steps, "generated_tokens": gen_tokens,
        "prompt_tokens": prompt_tokens, "setup_s": setup_s, "run_s": run_s,
        "generated_tokens_per_s": gen_tokens / run_s,
        "processed_tokens_per_s": (gen_tokens + prompt_tokens) / run_s,
        "ms_per_step": run_s / steps * 1e3, "peak_mem_gib_during_run": peak_gib,
        "batched_equals_per_request": True, "card": card,
    }, breakdown, launches


def kernel_calls(batcher, keys) -> dict:
    """Launches of the kernels named by ``keys`` (substrings) in one step of
    ``batcher``, as ``torch.profiler`` records them, beside its count of
    ``SPIN_KERNELS`` short spin kernels launched first in the window (what
    the profiler drops at a window's start falls on them) and of all the
    window's kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(SPIN_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        batcher.step()
        torch.cuda.synchronize()
    events = device_kernels(prof)
    calls = {key: sum(e.count for e in events if key in e.key) for key in (*keys, "spin_kernel")}
    calls["all_kernels"] = sum(e.count for e in events)
    return calls


def profile_steps(batcher, requests, n_steps: int = 8):
    """Where the time of a decode step goes: ``torch.profiler`` over
    ``n_steps`` steady steps of a full batch, kernel time by name beside the
    host clock (which the profiler itself slows).  Returns None when the
    profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    for r in requests:
        batcher.submit(r)
    for _ in range(2):  # warm: admission, first launches
        batcher.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            batcher.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0.0:
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [{"kernel": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
            "calls_per_step": e.count / n_steps} for e in kernels[:8]]
    named = {key: [e for e in kernels if key in e.key]
             for key in ("segmented_bottleneck_kernel", "segmented_stream_kernel", "flash_decode")}
    return {"steps": n_steps, "wall_ms_per_step_profiled": wall_ms / n_steps,
            "device_busy_ms_per_step": busy / n_steps,
            "device_idle_share_profiled": 1.0 - busy / wall_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / n_steps, "top_kernels": top,
            **{f"{key}_calls_per_step": sum(e.count for e in evs) / n_steps for key, evs in named.items()},
            **{f"{key}_ms_per_step": sum(e.self_device_time_total for e in evs) / 1e3 / n_steps
               for key, evs in named.items()}}


def recording(step, seen: list):
    """``step`` that also keeps each step's logits, on the host, in ``seen``."""

    def wrapped(*args, **kw):
        out = step(*args, **kw)
        seen.append(out[0].cpu())
        return out

    return wrapped


def card_smoke_cfg(arch: str):
    """The smoke config of ``arch`` in float32, as the comparisons of the
    card against the CPU twins run it.  The attention kernels take head
    dims that are multiples of 16, so granite-moe-3b-a800m's smoke model (4
    heads of 24 over 2 KV heads, d_model 96) runs there with 6 heads of 16
    over 2 (3 a KV head, as its full config has); the CPU tests hold the
    reference's smoke config itself."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    if arch == "granite-moe-3b-a800m":
        cfg = cfg.replace(num_heads=6, num_kv_heads=2)
    return cfg


def smoke_cuda_vs_cpu(seed: int, arch: str = "qwen3-1.7b"):
    """Phase 4b: the smoke model of ``arch``, float32, one batched run on
    the card (the kernels) and one on the CPU (the twins): the logits of
    every step agree."""
    from repro_torch import api
    from repro_torch.models.registry import init_params
    from repro_torch.serving.batcher import Request

    cfg = card_smoke_cfg(arch)
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = init_params(cfg, gen)
    trees = make_tenants(cfg, gen, n=2)
    logits = {}
    for device in ("cuda", "cpu"):
        b = api.serve(cfg=cfg, params=params, adapters=trees, batch=3, max_len=32,
                      cache_dtype="float32", device=device)
        seen = []
        b.serve_step = recording(b.serve_step, seen)
        for j, (p, t) in enumerate([([5, 7, 11], "tenant0"), ([13, 17], "tenant1"), ([19, 23, 29, 31], "tenant0")]):
            b.submit(Request(prompt=p, adapter=t, max_new_tokens=6, uid=j))
        b.run()
        logits[device] = torch.stack(seen)
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    check(err <= 1e-4, f"{arch} smoke model on the card vs the CPU twins: max abs logit err {err}")
    return {"arch": arch, "steps": int(logits["cpu"].shape[0]), "max_abs_err": err, "atol": 1e-4}


def train_batches(task, steps: int, batch: int, offset: int = 0):
    """``local_round``'s batches: (steps, batch, ...) arrays of the task."""
    per_step = [task.lm_batch(np.arange(offset + i * batch, offset + (i + 1) * batch)) for i in range(steps)]
    return {key: np.stack([b[key] for b in per_step]) for key in ("tokens", "targets", "mask")}


def profile_round(fns, params, peft, batches, rate: float, seed: int):
    """Device busy and idle share of one local step under ``torch.profiler``
    (a one-step round), beside its host clock.  None when the profiler sees
    no device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import adamw_init

    one = {key: val[:1] for key, val in batches.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fns.local_round(params, peft, adamw_init(peft), one, rate, torch.Generator().manual_seed(seed), 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0.0:
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [{"kernel": e.key[:80], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in kernels[:10]]
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy, "device_idle_share_profiled": 1.0 - busy / wall_ms,
            "kernel_launches": sum(e.count for e in kernels), "top_kernels": top}


def tree_equal(a, b) -> bool:
    from repro_torch.models.stacking import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def active_count(gates) -> int:
    """Active layers over a round's gates (one list per step, True = dropped)."""
    return sum(g.count(False) for g in gates)


def jamba_round_launches(cfg, gates) -> dict:
    """Each kernel's launches in a hybrid round, from its gates.  Per step
    and active layer: the two LoRA projections' forward (Mamba in and out,
    attention q and v); a Mamba layer's scan forward and backward (the LoRA
    on in sits before the scan) and its out dX; an attention layer's
    attention forward and backward; and the dX of in, or of q and v, in
    every active layer but the step's first, whose input comes from frozen
    weights."""
    from repro_torch.models.layers import layer_kind

    want = {"mamba_scan": 0, "mamba_scan_bwd": 0, "flash_attention": 0, "flash_attention_bwd": 0, "lora_matmul": 0}
    for step in gates:
        active = [l for l, dropped in enumerate(step) if not dropped]
        for l in active:
            later = l != active[0]
            want["lora_matmul"] += 2
            if layer_kind(cfg, l) == "mamba":
                want["mamba_scan"] += 1
                want["mamba_scan_bwd"] += 1
                want["lora_matmul"] += 1 + later
            else:
                want["flash_attention"] += 1
                want["flash_attention_bwd"] += 1
                want["lora_matmul"] += 2 * later
    return want


def check_launches(launches: dict, want: dict, what: str):
    """``launches`` equals ``want`` for the kernels it names, 0 for the rest."""
    full = {name: want.get(name, 0) for name in launches}
    check(launches == full, f"{what}: launches {launches}, expected {full}")


def train_full(ops, card, seed: int, cfg, round_launches, eval_launches, *, rate0_batch_cut: bool = True,
               after=None):
    """One client's DropPEFT local round of ``cfg`` (full width) through
    ``make_client_fns``: 4 steps at batch 16 x 512, STLD mean rate 0.5, then
    ``evaluate``, then a round at rate 0.0 for the comparison of step time
    and peak memory (with ``rate0_batch_cut``, at half the batch if batch 16
    does not fit, a cut written beside the numbers with the error that
    forced it; without, the error propagates).
    The weights are drawn and placed part by part; the peak while drawing
    is reported.  ``round_launches(gates)``, from the gates the round drew
    (one list of booleans per step, True = dropped), and
    ``eval_launches(cfg)`` give each kernel's expected launches.
    ``after(cfg, params, peft)``, when given, runs while the weights are
    held and its dict is returned under ``after``."""
    from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig
    from repro_torch.core import stld
    from repro_torch.core.peft import init_peft
    from repro_torch.data.synthetic import make_task
    from repro_torch.federated.client import make_client_fns
    from repro_torch.models.registry import init_params
    from repro_torch.models.stacking import tree_leaves
    from repro_torch.optim import adamw_init

    gc.collect()  # an earlier phase's weights may sit in reference cycles: free them before measuring memory
    torch.cuda.empty_cache()
    arch, fed, peft_cfg = cfg.name, FederatedConfig(), PEFTConfig()
    steps, batch, seq, rate = fed.local_steps, fed.batch_size, 512, 0.5
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, gen, place=True)
    draw_peak = torch.cuda.max_memory_allocated()
    peft = init_peft(cfg, peft_cfg, gen)
    task = make_task(vocab_size=cfg.vocab_size, seq_len=seq, num_examples=(steps + 1) * batch, seed=seed)
    batches = train_batches(task, steps, batch)
    fns = make_client_fns(cfg, peft_cfg, STLDConfig(), TrainConfig())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def run(r, batches=batches):
        out = fns.local_round(params, peft, adamw_init(peft), batches, r, torch.Generator().manual_seed(seed + 7), 0)
        torch.cuda.synchronize()
        return out

    run(rate, {key: val[:1] for key, val in batches.items()})  # warm: library loads, cuBLAS heuristics
    resident = torch.cuda.memory_allocated()
    gates, sample_drops = [], stld.sample_drops

    def recorded(*args, **kw):
        drops = sample_drops(*args, **kw)
        gates.append(drops.tolist())
        return drops

    stld.sample_drops = recorded
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        peft1, _, m1, imp1 = run(rate)
    finally:
        stld.sample_drops = sample_drops
    round_s = time.perf_counter() - t0
    launches = dict(ops.launch_counts)
    routes = dict(ops.lora_matmul_routes)
    peak_05 = torch.cuda.max_memory_allocated()
    metrics = {key: float(val) for key, val in m1.items()}
    check(all(np.isfinite(list(metrics.values()))), f"non-finite round metrics {metrics}")
    check(bool(torch.isfinite(imp1).all()), "non-finite importances")
    check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(peft1)), "non-finite PEFT tree")
    active = sum(g.count(False) for g in gates)
    check(len(gates) == steps and abs(metrics["active_layers"] * steps - active) < 1e-3,
          f"active layers {metrics['active_layers']} vs gates {gates}")
    check_launches(launches, round_launches(gates), f"{arch} round of gates {gates}")
    check(routes == {"fma": 0, "wmma": 0, "wgmma": launches["lora_matmul"]},
          f"{arch}: lora_matmul routes {routes}, every call expected on wgmma")

    peft2, _, m2, imp2 = run(rate)
    check(tree_equal(peft1, peft2) and torch.equal(imp1, imp2)
          and all(torch.equal(m1[key], m2[key]) for key in m1),
          "two local rounds from the same state, gates and batches differ")

    ops.reset_launch_counts()
    acc = float(fns.evaluate(params, peft1, task.tokens[-batch:], task.labels[-batch:], np.arange(task.num_classes)))
    eval_launches_seen = dict(ops.launch_counts)
    check(np.isfinite(acc) and 0.0 <= acc <= 1.0, f"accuracy {acc}")
    check_launches(eval_launches_seen, eval_launches(cfg), f"{arch} evaluate")

    gib = 2.0**30
    stats = {
        "model": cfg.name, "layers": cfg.num_layers, "batch": batch, "seq": seq, "local_steps": steps,
        "mean_rate": rate, "setup_s": setup_s, "round_s": round_s, "s_per_local_step": round_s / steps,
        "active_layers_per_step": metrics["active_layers"], "metrics": metrics, "accuracy_after_round": acc,
        "gates_rate_0.5": gates, "launches": launches, "lora_matmul_routes": routes,
        "peak_gib_drawing_weights": draw_peak / gib, "resident_gib": resident / gib,
        "peak_gib_rate_0.5": peak_05 / gib, "round_gib_above_resident_rate_0.5": (peak_05 - resident) / gib,
        "bit_identical_rounds": True, "evaluate_launches": eval_launches_seen, "card": card,
    }
    batch0, did_not_fit = batch, []
    while True:
        rate0_batches = {key: val[:, :batch0] for key, val in batches.items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            _, _, m0, _ = run(0.0, rate0_batches)
            break
        except torch.cuda.OutOfMemoryError as err:
            if not rate0_batch_cut:
                raise
            check(batch0 > 1, "rate 0.0 does not fit at batch 1")
            did_not_fit.append({"batch": batch0, "error": str(err).splitlines()[0][:200]})
        batch0 //= 2  # the cut is written beside the numbers
        gc.collect()  # after the handler, whose traceback held the failed round's tensors
        torch.cuda.empty_cache()
    round0_s = time.perf_counter() - t0
    peak_00 = torch.cuda.max_memory_allocated()
    check(float(m0["active_layers"]) == cfg.num_layers, f"rate 0.0 ran {float(m0['active_layers'])} layers")
    stats.update({"round_s_rate_0": round0_s, "s_per_local_step_rate_0": round0_s / steps, "batch_rate_0": batch0,
                  "rate_0_did_not_fit": did_not_fit or None, "peak_gib_rate_0.0": peak_00 / gib,
                  "round_gib_above_resident_rate_0.0": (peak_00 - resident) / gib})
    if after is not None:
        stats["after"] = after(cfg, params, peft)
    return stats, profile_round(fns, params, peft, batches, rate, seed), launches


def smoke_train_cuda_vs_cpu(seed: int, arch: str):
    """One local round of the smoke model of ``arch``, float32, on the card
    (the kernels) and on the CPU (the twins), from the same params, LoRA
    (``b`` off zero), batches and gates.  AdamW's first steps move an
    element by about lr * sign(g), so an element whose gradient lies within
    float error of 0 may move the other way: every element within
    2 * (sum of the step sizes) + 1e-6, and 99% within 1e-6."""
    from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig
    from repro_torch.core.peft import init_peft
    from repro_torch.data.synthetic import make_task
    from repro_torch.federated.client import make_client_fns
    from repro_torch.models.registry import init_params, place_params
    from repro_torch.models.stacking import tree_leaves, tree_map
    from repro_torch.optim import adamw_init, make_lr_schedule

    cfg, train_cfg = card_smoke_cfg(arch), TrainConfig()
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = init_params(cfg, gen)
    peft = init_peft(cfg, PEFTConfig(), gen)
    for leaf in tree_leaves(peft):
        leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
    task = make_task(vocab_size=cfg.vocab_size, seq_len=32, num_examples=8, seed=seed)
    batches = train_batches(task, 2, 4)
    out = {}
    for device in ("cuda", "cpu"):
        fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), train_cfg, device=device)
        pf = tree_map(lambda t: t.to(device), peft)
        res = fns.local_round(place_params(params, cfg, device), pf, adamw_init(pf), batches, 0.5,
                              torch.Generator().manual_seed(seed), 0)
        out[device] = [tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, part) for part in res]
    (pc, _, mc, ic), (pp, _, mp, ip) = out["cuda"], out["cpu"]
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(tree_leaves(pc), tree_leaves(pp))])
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.total_steps)
    limit = 2 * (sched(0) + sched(1)) + 1e-6
    within = float((diffs <= 1e-6).float().mean())
    check(float(diffs.max()) <= limit and within >= 0.99,
          f"smoke round on the card vs the CPU twins: PEFT max diff {float(diffs.max())}, {within} within 1e-6")
    for key in mc:
        check(torch.allclose(mc[key], mp[key], rtol=1e-5, atol=1e-6), f"smoke round metric {key}: {mc[key]} vs {mp[key]}")
    check(torch.allclose(ic, ip, rtol=1e-4, atol=1e-7), f"smoke round importances {ic} vs {ip}")
    return {"steps": 2, "peft_max_abs_diff": float(diffs.max()), "peft_share_within_1e-6": within,
            "peft_limit": limit, "metric_rtol": 1e-5, "importance_rtol": 1e-4,
            "importance_max_abs_diff": float((ic - ip).abs().max())}


def dense_round_launches(gates) -> dict:
    """A dense decoder's launches in a local round of ``gates`` (one list a
    step, True = dropped): ``training_launches`` of each step's active
    layers."""
    return training_launches([g.count(False) for g in gates])


DENSE_ARCHS = ("glm4-9b", "h2o-danube-1.8b", "yi-6b")
# glm4-9b's and yi-6b's serving runs half their depth, widths whole: their
# decode steps are bound by the host (~3 500 and ~2 700 launches, 92 and 100
# ms a step at full depth on an H100 beside a slow host), and the script has
# to stay well inside its time limit; their training runs at full depth
DENSE_SERVE_LAYERS = {"glm4-9b": 20, "yi-6b": 16}


def dense_arch_full(api, ops, card, seed: int, arch: str):
    """Phase 5e for one of the other dense decoders: serving at full width
    as phase 4, at ``DENSE_SERVE_LAYERS`` where it names the arch (and the
    smoke model on the card against the CPU twins),
    then one client's local round as phase 5, at full depth unless the
    round does not fit the card: each time it does not, three quarters of
    the layers are kept and the round is run again (the cut is returned
    beside the numbers); then the smoke round on the card against the CPU
    twins."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    serve_cfg = cfg.replace(num_layers=DENSE_SERVE_LAYERS[arch]) if arch in DENSE_SERVE_LAYERS else None
    serve_stats, breakdown, serve_launches = serve_full(api, ops, card, seed, arch, serve_cfg)
    serve_stats["depth_cut"] = None if serve_cfg is None else {"layers": serve_cfg.num_layers, "of": cfg.num_layers}
    serve_stats["decode_step_profile"] = breakdown
    serve_stats["smoke_card_vs_cpu"] = smoke_cuda_vs_cpu(seed, arch)
    layers, cuts = cfg.num_layers, []
    while True:
        try:
            train_stats, profile, train_launches = train_full(
                ops, card, seed, cfg.replace(num_layers=layers), dense_round_launches, evaluate_launches)
            break
        except torch.cuda.OutOfMemoryError as err:
            cuts.append({"layers": layers, "error": str(err).splitlines()[0][:200]})
            check(layers > 4, f"{arch}: a local round does not fit at {layers} layers")
        layers = layers * 3 // 4
        gc.collect()  # after the handler, whose traceback held the failed round's tensors
        torch.cuda.empty_cache()
    train_stats["depth_cut"] = (None if not cuts else
                                {"layers": layers, "of": cfg.num_layers, "did_not_fit": cuts})
    train_stats["local_step_profile"] = profile
    train_stats["smoke_card_vs_cpu"] = smoke_train_cuda_vs_cpu(seed, arch)
    return serve_stats, serve_launches, train_stats, train_launches


FED_ROUNDS = 3
# phase 5p's time came out of phases 5d and 5g, each run keeping its
# checks: 5d's batched runs take 2 rounds (3 before; the save after round 1,
# resumed to 2) and its sequential run, for the comparison, 1; 5g takes 2
# rounds a method (the joint bandit saved after round 1), FedHetLoRA 1 (at
# seed 0 its first round trains a device of every tier, ranks 4, 8 and 16,
# which its served checkpoint needs) and no profiled round after it (phase
# 5d profiles the sequential mode); 5g's smoke runs keep 2 rounds, as the
# second is the first whose rates the bandit picks from the kernels' rewards
FEDERATED_ROUNDS, SEQUENTIAL_ROUNDS = 2, 1
GRID_ROUNDS, HETLORA_ROUNDS, GRID_SMOKE_ROUNDS = 2, 1, 2
STARTUP_RATES = (0.2, 0.5, 0.7)  # the bandit's start-up arms (OnlineConfigurator's default)


def instrument_runner(runner, ops, clock: dict, rounds: list):
    """Record each round of ``runner``: its plan, shared layers per device,
    accuracies, active layers, gates and launches, whether the layers no
    device shared kept the previous global bit for bit, and its host
    seconds.  ``clock`` sums the host seconds of the client programs (the
    sequential mode's ``local_round`` and ``evaluate``, the batched mode's
    ``cohort_round_eval``, ``cohort_round`` and ``cohort_evaluate``) and of
    aggregation (each call ends with a device sync), and of
    ``final_accuracy``'s evaluations apart."""
    from repro_torch.core import stld
    from repro_torch.models.stacking import layer_view, tree_leaves

    engine, algo, sched = runner.ctx.engine, runner.algorithm, runner.scheduler
    phase = {"name": "final_accuracy_"}

    def timed(fn, name):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            key = phase["name"] + name
            clock[key] = clock.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    engine.local_round = timed(engine.local_round, "local_round")
    engine.evaluate = timed(engine.evaluate, "evaluate")
    engine.client = engine.client._replace(**{name: timed(getattr(engine.client, name), name)
                                              for name in ("cohort_round_eval", "cohort_round", "cohort_evaluate")})
    aggregate, report, sync_round, sample_drops = algo.aggregate, algo.report, sched._sync_round, stld.sample_drops

    def aggregate_checked(state, results):
        t0 = time.perf_counter()
        new = aggregate(state, results)
        torch.cuda.synchronize()
        clock["aggregate"] = clock.get("aggregate", 0.0) + time.perf_counter() - t0
        unshared = [l for l in range(runner.ctx.cfg.num_layers) if not results.masks[:, l].any()]
        rounds[-1]["unshared_layers"] = unshared
        rounds[-1]["unshared_kept_bit_for_bit"] = all(
            torch.equal(a, b) for l in unshared
            for a, b in zip(tree_leaves(layer_view(new.global_peft, l)), tree_leaves(layer_view(state.global_peft, l))))
        return new

    def report_recorded(state, results):
        rounds[-1].update(cohort=list(results.plan.cohort), rates=[float(r) for r in results.plan.rates],
                          shared_per_device=results.masks.sum(axis=1).tolist(), accuracies=list(results.accuracies),
                          active=[float(m["active_layers"]) for m in results.metrics])
        return report(state, results)

    def gates_recorded(*args, **kw):
        drops = sample_drops(*args, **kw)
        rounds[-1]["gates"].append(drops.tolist())
        return drops

    def round_recorded(*args, **kw):
        phase["name"] = ""
        rounds.append({"gates": []})
        ops.reset_launch_counts()
        stld.sample_drops = gates_recorded
        t0 = time.perf_counter()
        try:
            row = sync_round(*args, **kw)
        finally:
            stld.sample_drops = sample_drops
        torch.cuda.synchronize()
        rounds[-1].update(seconds=time.perf_counter() - t0, launches=dict(ops.launch_counts),
                          routes=dict(ops.lora_matmul_routes))
        ops.reset_launch_counts()  # what follows the last round is final_accuracy's
        phase["name"] = "final_accuracy_"
        return row

    algo.aggregate, algo.report, sched._sync_round = aggregate_checked, report_recorded, round_recorded


def profile_fed_round(runner):
    """Device busy and idle share of one federated round (the next round of
    ``runner``) under ``torch.profiler`` with the CUDA activity alone (the
    host's op events doubled a sequential round's wall time), beside its
    host clock.  None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.scheduler._sync_round(runner.state.round_index + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0.0:
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [{"kernel": e.key[:80], "ms": e.self_device_time_total / 1e3, "calls": e.count} for e in kernels[:10]]
    return {"round": runner.state.round_index, "wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "device_idle_share_profiled": 1.0 - busy / wall_ms,
            "kernel_launches": sum(e.count for e in kernels), "top_kernels": top}


def training_launches(runs, encoder_layers: int = 0) -> dict:
    """Each kernel's launches in training steps that run ``runs[i]``
    layers: per run layer the attention forward and backward and the q
    and v LoRA forward, and their dX in all but the step's first run layer
    (whose input needs no gradient).  An encoder-decoder's step (its
    ``encoder_layers`` > 0) also runs the encoder's attention (no backward,
    no LoRA) and in each run layer the cross-attention (its backward dQ
    alone) and its q LoRA, forward and dX (its input takes a gradient from
    the self-attention's LoRA)."""
    n, steps = sum(runs), len(runs)
    if encoder_layers:
        return {"flash_attention": steps * encoder_layers + 2 * n, "flash_attention_bwd": 2 * n,
                "lora_matmul": 6 * n - 2 * steps}
    return {"flash_attention": n, "flash_attention_bwd": n, "lora_matmul": 4 * n - 2 * steps}


def evaluate_launches(cfg) -> dict:
    """One forward's launches (``evaluate``, a cohort's fused evaluate):
    an attention and the q and v LoRA a layer; an encoder-decoder's
    encoder attention, and its decoder's cross-attention and cross q."""
    if cfg.is_encoder_decoder:
        return {"flash_attention": cfg.num_encoder_layers + 2 * cfg.num_layers, "lora_matmul": 3 * cfg.num_layers}
    return {"flash_attention": cfg.num_layers, "lora_matmul": 2 * cfg.num_layers}


def add_launches(*counts) -> dict:
    out = {}
    for c in counts:
        for name, n in c.items():
            out[name] = out.get(name, 0) + n
    return out


def cohort_step_layers(gates, devices: int, steps: int) -> list:
    """The layers each cohort step runs: a layer runs once in a step if any
    device's gate opens it.  ``gates`` are the round's draws in their order,
    device by device, step by step (True = dropped)."""
    return [sorted({l for i in range(devices) for l, dropped in enumerate(gates[i * steps + s]) if not dropped})
            for s in range(steps)]


def federated_run(api, ops, seed: int, cohort_mode: str, arch: str = "qwen3-1.7b", rounds: int = FED_ROUNDS):
    """``api.build("droppeft", arch, smoke=False)`` in ``cohort_mode`` for
    ``rounds`` rounds, instrumented, with every per-round check: finite history,
    the start-up rates, PTLS's k, unshared layers kept, launches exactly
    from the gates (sequential: a local round and an ``evaluate`` per
    member; batched: per cohort step each layer once if any gate opens it,
    the step's first run layer without dX, one fused evaluate a cohort) and
    every lora_matmul on wgmma; and ``final_accuracy``'s launches (100
    evaluations, or one ``cohort_evaluate`` per chunk of 10 devices).
    Returns (runner, stats, the history, the global LoRA, the summed
    launches)."""
    from repro_torch.models.stacking import tree_leaves

    gc.collect()  # the earlier phases' weights may sit in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # batched is what api.build runs when the caller names no mode
    runner = api.build("droppeft", arch, smoke=False, seed=seed,
                       **({} if cohort_mode == "batched" else {"cohort_mode": cohort_mode}))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(runner.cohort_mode == cohort_mode, f"cohort mode {runner.cohort_mode}, expected {cohort_mode}")
    cfg, fed, seq = runner.ctx.cfg, runner.ctx.fed_cfg, runner.ctx.task.seq_len
    layers, n, steps = cfg.num_layers, fed.devices_per_round, fed.local_steps
    resident = torch.cuda.memory_allocated()
    clock, recorded = {}, []
    instrument_runner(runner, ops, clock, recorded)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = runner.run(rounds=rounds)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    final_launches = dict(ops.launch_counts)

    hist = list(runner.state.history)
    check(len(hist) == rounds == result.rounds, f"{len(hist)} history rows")
    check(all(np.isfinite(v) for row in hist for v in row.values()), f"non-finite history {hist}")
    check(np.isfinite(result.final_accuracy), f"final accuracy {result.final_accuracy}")
    check(recorded[0]["rates"] == [STARTUP_RATES[i % 3] for i in range(n)], f"first round's rates {recorded[0]['rates']}")
    k = int(fed.ptls_share_fraction * layers)
    step_layers = []
    for j, r in enumerate(recorded):
        check(r["shared_per_device"] == [k] * n, f"shared layers per device {r['shared_per_device']}")
        check(r["unshared_kept_bit_for_bit"], f"layers {r['unshared_layers']} shared by nobody changed")
        check(len(r["gates"]) == n * steps, f"{len(r['gates'])} gate draws in a round")
        active = active_count(r["gates"])
        check(abs(sum(r["active"]) * steps - active) < 1e-3, f"active layers {r['active']} vs the gates")
        if cohort_mode == "batched":
            run = [len(ls) for ls in cohort_step_layers(r["gates"], n, steps)]
            step_layers.append(run)
            want = add_launches(training_launches(run, cfg.num_encoder_layers), evaluate_launches(cfg))
        else:
            # phase 5's counts per local round, summed over the cohort, and
            # one evaluate per member
            want = add_launches(training_launches([g.count(False) for g in r["gates"]], cfg.num_encoder_layers),
                                *[evaluate_launches(cfg)] * n)
        check_launches(r["launches"], want, f"{cohort_mode} federated round {j + 1}")
        check(r["routes"] == {"fma": 0, "wmma": 0, "wgmma": r["launches"]["lora_matmul"]}, f"routes {r['routes']}")
    evaluations = -(-fed.num_devices // n) if cohort_mode == "batched" else fed.num_devices
    check_launches(final_launches, add_launches(*[evaluate_launches(cfg)] * evaluations),
                   f"{cohort_mode} final_accuracy")
    per_round = [r["seconds"] for r in recorded]
    split = {f"{name}_s": clock[name] for name in ("local_round", "evaluate", "cohort_round_eval", "aggregate")
             if name in clock}
    split["rest_s"] = sum(per_round) - sum(split.values())
    gib = 2.0**30
    launches = {name: sum(r["launches"][name] for r in recorded) + final_launches[name] for name in final_launches}
    stats = {
        "cohort_mode": cohort_mode, "setup_s": setup_s, "run_s": run_s, "s_per_round": per_round,
        "s_per_round_mean": sum(per_round) / rounds, "split_over_rounds_s": split,
        "final_accuracy_s": sum(v for key, v in clock.items() if key.startswith("final_accuracy_")),
        "final_accuracy_calls": evaluations, "resident_gib": resident / gib, "peak_gib": peak / gib,
        "launches_per_round": [r["launches"] for r in recorded], "launches_final_accuracy": final_launches,
        "cohorts": [r["cohort"] for r in recorded], "rates": [r["rates"] for r in recorded],
        "unshared_layers": [r["unshared_layers"] for r in recorded], "history": hist,
        "final_accuracy": result.final_accuracy,
    }
    if step_layers:
        stats["layers_run_per_cohort_step"] = step_layers
    return runner, stats, hist, [t.clone() for t in tree_leaves(runner.state.global_peft)], launches


def resume_and_serve(api, seed: int, global_leaves, hist, final_accuracy):
    """Phase 5d's checkpoints: the batched run saved after round
    ``FEDERATED_ROUNDS - 1`` (``checkpoint_dir``), a fresh runner resumed
    from it (``resume=True``) and run to round ``FEDERATED_ROUNDS`` gives
    the uninterrupted run's global LoRA, history
    and final accuracy bit for bit; then ``api.serve(checkpoint_dir=...)``
    serves the global adapter and two clients' with the tokens of
    ``api.serve(adapters=...)`` given the resumed runner's own trees."""
    import shutil

    from repro_torch.models.stacking import tree_leaves
    from repro_torch.serving.batcher import Request

    ckpt_dir = ROOT / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    t0 = time.perf_counter()
    runner = api.build("droppeft", "qwen3-1.7b", smoke=False, seed=seed, checkpoint_dir=str(ckpt_dir))
    runner.run(rounds=FEDERATED_ROUNDS - 1)
    del runner
    gc.collect()
    saved = sorted(p.name for p in ckpt_dir.iterdir())
    check(saved == [f"step_{r:08d}" for r in range(1, FEDERATED_ROUNDS)], f"checkpoints {saved}")
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    runner = api.build("droppeft", "qwen3-1.7b", smoke=False, seed=seed, checkpoint_dir=str(ckpt_dir), resume=True)
    check(runner.state.round_index == FEDERATED_ROUNDS - 1, f"resumed at round {runner.state.round_index}")
    result = runner.run(rounds=FEDERATED_ROUNDS)
    resume_s = time.perf_counter() - t0
    check(all(torch.equal(a, b) for a, b in zip(global_leaves, tree_leaves(runner.state.global_peft)))
          and list(runner.state.history) == hist and result.final_accuracy == final_accuracy,
          f"the run resumed at round {FEDERATED_ROUNDS - 1} differs from the uninterrupted run")
    clients = sorted(runner.state.device_peft)[:2]
    trees = {"client_global": runner.state.global_peft,
             **{f"client{d}": runner.state.device_peft[d] for d in clients}}
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(seed + 5)
    names = list(trees)
    requests = [(rng.integers(0, 151_936, int(rng.integers(16, 65))).tolist(), names[j % 3]) for j in range(6)]
    tokens = {}
    for source in ("checkpoint", "trees"):
        kw = {"checkpoint_dir": str(ckpt_dir)} if source == "checkpoint" else {"adapters": trees}
        batcher = api.serve("qwen3-1.7b", smoke=False, batch=8, max_len=512, seed=seed, **kw)
        for j, (prompt, name) in enumerate(requests):
            batcher.submit(Request(prompt=prompt, adapter=name, max_new_tokens=16, uid=j))
        tokens[source] = {c.uid: c.tokens for c in batcher.run()}
        if source == "checkpoint":
            registered = len(batcher.pool.registry)
        del batcher
        gc.collect()
        torch.cuda.empty_cache()
    check(tokens["checkpoint"] == tokens["trees"] and len(tokens["trees"]) == 6,
          f"served from the checkpoint {tokens['checkpoint']} vs from the same trees {tokens['trees']}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"saved_rounds": FEDERATED_ROUNDS - 1, "resumed_to": FEDERATED_ROUNDS, "bit_identical": True,
            "save_run_s": save_s,
            "resume_run_s": resume_s, "adapters_in_checkpoint": registered, "served": names,
            "requests": len(requests), "tokens_equal": True}


def federated_full(api, ops, card, seed: int):
    """Phase 5d: ``api.build("droppeft", "qwen3-1.7b", smoke=False)`` on the
    card at the defaults (100 devices, 10 a round, 4 local steps of batch
    16 x 32 tokens, LoRA r 8 on q and v, 28 layers), batched (its default
    mode): ``FEDERATED_ROUNDS`` rounds, a second run from the same seed that must give the
    same bits, and one profiled round after it; then the sequential mode
    from the same seed, ``SEQUENTIAL_ROUNDS`` round(s) and a profiled
    round, for the comparison."""
    from repro_torch.models.stacking import tree_leaves

    phase_t0 = time.perf_counter()
    runner, batched, hist, global1, launches = federated_run(api, ops, seed, "batched", rounds=FEDERATED_ROUNDS)
    cfg, fed = runner.ctx.cfg, runner.ctx.fed_cfg
    seq = runner.ctx.task.seq_len
    del runner
    gc.collect()

    runner = api.build("droppeft", "qwen3-1.7b", smoke=False, seed=seed)
    result2 = runner.run(rounds=FEDERATED_ROUNDS)
    check(all(torch.equal(a, b) for a, b in zip(global1, tree_leaves(runner.state.global_peft)))
          and list(runner.state.history) == hist and result2.final_accuracy == batched["final_accuracy"],
          "two batched runs from one seed differ")
    batched["profile"] = profile_fed_round(runner)
    del runner
    gc.collect()
    batched["resume"] = resume_and_serve(api, seed, global1, hist, batched["final_accuracy"])

    runner, sequential, _, _, _ = federated_run(api, ops, seed, "sequential", rounds=SEQUENTIAL_ROUNDS)
    sequential["profile"] = profile_fed_round(runner)
    del runner
    gc.collect()
    for stats, per_step in ((batched, fed.local_steps), (sequential, fed.devices_per_round * fed.local_steps)):
        prof = stats["profile"]
        if prof:  # the profiled round's launches (with its evaluate and aggregation) per step
            stats["profiled_launches_per_step"] = prof["kernel_launches"] / per_step
    return {
        "model": cfg.name, "layers": cfg.num_layers, "devices": fed.num_devices,
        "devices_per_round": fed.devices_per_round, "local_steps": fed.local_steps, "batch": fed.batch_size,
        "seq": seq, "rounds": FEDERATED_ROUNDS, "sequential_rounds": SEQUENTIAL_ROUNDS,
        "deterministic_rounds": FEDERATED_ROUNDS, "batched": batched,
        "sequential": sequential, "phase_s": time.perf_counter() - phase_t0, "card": card,
    }, launches


def federated_smoke_cuda_vs_cpu(seed: int, arch: str):
    """Two rounds of droppeft at the smoke size of ``arch`` in float32,
    batched on the card (the kernels), sequential on the card and batched
    on the CPU (the twins), from the same base weights (drawn on the CPU),
    seed and gates: cohorts, rates and PTLS masks equal; the global LoRA
    of the card's batched run within phase 5's tree tolerance of each of
    the others, the step sizes summed over every local step of both
    rounds."""
    from repro_torch import api
    from repro_torch.configs import FederatedConfig, TrainConfig
    from repro_torch.models.registry import init_params
    from repro_torch.models.stacking import tree_leaves
    from repro_torch.optim import make_lr_schedule

    cfg, train_cfg = card_smoke_cfg(arch), TrainConfig()
    fed = FederatedConfig(num_devices=6, devices_per_round=4, local_steps=2, batch_size=8)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    runs = {}
    for device, mode in (("cuda", "batched"), ("cuda", "sequential"), ("cpu", "batched")):
        runner = api.build("droppeft", cfg=cfg, fed_cfg=fed, train_cfg=train_cfg, seed=seed, params=params,
                           device=device, cohort_mode=mode)
        plans, report = [], runner.algorithm.report

        def recorded(state, results, plans=plans, report=report):
            plans.append((results.plan.cohort, results.plan.rates, results.masks.tolist()))
            return report(state, results)

        runner.algorithm.report = recorded
        runner.run(rounds=2)
        runs[(device, mode)] = plans, [t.cpu() for t in tree_leaves(runner.state.global_peft)]
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.total_steps)
    limit = 2 * sum(sched(step) for step in range(2 * fed.devices_per_round * fed.local_steps)) + 1e-6
    plans_c, peft_c = runs[("cuda", "batched")]
    out = {"arch": arch, "rounds": 2, "cohorts_rates_masks_equal": True, "peft_limit": limit}
    for other in (("cuda", "sequential"), ("cpu", "batched")):
        plans_o, peft_o = runs[other]
        what = f"{arch}: batched on the card vs {other[1]} on the {other[0]}"
        check(plans_c == plans_o, f"{what}: cohorts, rates or masks differ: {plans_c} vs {plans_o}")
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(peft_c, peft_o)])
        within = float((diffs <= 1e-6).float().mean())
        check(float(diffs.max()) <= limit and within >= 0.99,
              f"{what}: LoRA max diff {float(diffs.max())}, {within} within 1e-6")
        out[f"vs_{other[1]}_{other[0]}"] = {"peft_max_abs_diff": float(diffs.max()), "peft_share_within_1e-6": within}
    return out


GATHER_RATE = 0.5


def gather_round_full(ops, card, seed: int):
    """Phase 5f's local round: full-width qwen3-1.7b in gather mode at rate
    0.5 (k = ``static_active_count(0.5, 28, 4)`` = 16 layers a step, their
    indices drawn each step) beside cond at the same rate, 4 steps of batch
    16 x 512: finite metrics and tree, k active layers a step, each kernel
    launched as phase 5's formula gives with a = steps x k, every
    lora_matmul on wgmma, two gather rounds from one state bit-identical;
    seconds a step and peak memory of both modes."""
    from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
    from repro_torch.core import stld
    from repro_torch.core.peft import init_peft
    from repro_torch.data.synthetic import make_task
    from repro_torch.federated.client import make_client_fns
    from repro_torch.models.registry import init_params
    from repro_torch.models.stacking import tree_leaves
    from repro_torch.optim import adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    cfg, fed, peft_cfg = get_config("qwen3-1.7b"), FederatedConfig(), PEFTConfig()
    steps, batch, seq, layers = fed.local_steps, fed.batch_size, 512, cfg.num_layers
    k = stld.static_active_count(GATHER_RATE, layers, STLDConfig().gather_bucket)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, place=True)
    peft = init_peft(cfg, peft_cfg, gen)
    task = make_task(vocab_size=cfg.vocab_size, seq_len=seq, num_examples=(steps + 1) * batch, seed=seed)
    batches = train_batches(task, steps, batch)
    fns = {mode: make_client_fns(cfg, peft_cfg, STLDConfig(mode=mode), TrainConfig()) for mode in ("gather", "cond")}

    def run(mode, b=batches):
        out = fns[mode].local_round(params, peft, adamw_init(peft), b, GATHER_RATE,
                                    torch.Generator().manual_seed(seed + 7), 0, k if mode == "gather" else None)
        torch.cuda.synchronize()
        return out

    for mode in fns:  # warm: library loads, cuBLAS heuristics
        run(mode, {key: val[:1] for key, val in batches.items()})
    indices, sample = [], stld.sample_active_indices

    def recorded(*args, **kw):
        indices.append(sample(*args, **kw).tolist())
        return torch.tensor(indices[-1])

    stats = {"model": cfg.name, "layers": layers, "batch": batch, "seq": seq, "local_steps": steps,
             "mean_rate": GATHER_RATE, "k": k, "card": card}
    outs = []
    for mode in ("gather", "cond", "gather"):
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        stld.sample_active_indices = recorded
        t0 = time.perf_counter()
        try:
            outs.append(run(mode))
        finally:
            stld.sample_active_indices = sample
        seconds = time.perf_counter() - t0
        if f"{mode}_s_per_local_step" not in stats:
            stats.update({f"{mode}_s_per_local_step": seconds / steps,
                          f"{mode}_peak_gib": torch.cuda.max_memory_allocated() / 2.0**30,
                          f"{mode}_active_layers": float(outs[-1][2]["active_layers"]),
                          f"{mode}_launches": dict(ops.launch_counts),
                          f"{mode}_routes": dict(ops.lora_matmul_routes)})
    (p1, _, m1, i1), _, (p2, _, m2, i2) = outs
    metrics = {key: float(val) for key, val in m1.items()}
    check(all(np.isfinite(list(metrics.values()))) and bool(torch.isfinite(i1).all())
          and all(bool(torch.isfinite(t).all()) for t in tree_leaves(p1)), f"non-finite gather round {metrics}")
    gates = [[l not in idx for l in range(layers)] for idx in indices[:steps]]
    check(len(indices) == 2 * steps and all(idx == sorted(set(idx)) and len(idx) == k for idx in indices),
          f"gather indices {indices}")
    check(metrics["active_layers"] == k, f"gather round ran {metrics['active_layers']} layers a step, expected {k}")
    check_launches(stats["gather_launches"], dense_round_launches(gates), f"gather round of indices {indices[:steps]}")
    check(stats["gather_routes"] == {"fma": 0, "wmma": 0, "wgmma": stats["gather_launches"]["lora_matmul"]},
          f"gather round: lora_matmul routes {stats['gather_routes']}")
    check(indices[:steps] == indices[steps:] and tree_equal(p1, p2) and torch.equal(i1, i2)
          and all(torch.equal(m1[key], m2[key]) for key in m1), "two gather rounds from one state differ")
    stats.update(indices=indices[:steps], metrics=metrics, bit_identical_rounds=True,
                 step_ratio_gather_over_cond=stats["gather_s_per_local_step"] / stats["cond_s_per_local_step"])
    del params, peft, fns, outs
    gc.collect()
    torch.cuda.empty_cache()
    return stats, stats["gather_launches"]


def run_bits(runner, result):
    """What two runs must share bit for bit."""
    from repro_torch.models.stacking import tree_leaves

    return {"history": list(runner.state.history), "events": list(runner.scheduler.event_log),
            "faults": list(runner.scheduler.fault_log), "final": result.final_accuracy,
            "peft": [t.clone() for t in tree_leaves(runner.state.global_peft)]}


def same_bits(a, b) -> bool:
    return (all(a[key] == b[key] for key in ("history", "events", "faults", "final"))
            and all(torch.equal(x, y) for x, y in zip(a["peft"], b["peft"])))


def instrument_dispatches(runner, record: dict):
    """Record each dispatch of ``runner``: its size, its devices' gather
    indices (device by device, step by step), its uplink ratios and the
    host seconds of ``compress_uplink`` (synchronized), keeping its last
    arguments for ``compress_profile``; and each round's host seconds.
    Returns the undo."""
    from repro_torch.core import stld

    engine, algo, sched = runner.ctx.engine, runner.algorithm, runner.scheduler
    run_cohort, compress, sample = engine.run_cohort, algo.compress_uplink, stld.sample_active_indices
    step = sched._deadline_round

    def dispatch(key, global_step, cohort, *args):
        record["dispatches"].append({"n": len(cohort), "indices": []})
        return run_cohort(key, global_step, cohort, *args)

    def indices(*args, **kw):
        idx = sample(*args, **kw)
        record["dispatches"][-1]["indices"].append(idx.tolist())
        return idx

    def compressed(state, results):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = compress(state, results)
        torch.cuda.synchronize()
        record["compress_s"].append(time.perf_counter() - t0)
        record["uplink_ratio"].append(None if out[1].uplink_ratio is None else out[1].uplink_ratio.tolist())
        record["last_compress_args"] = (state, results)
        return out

    def timed_round(*args, **kw):
        t0 = time.perf_counter()
        row = step(*args, **kw)
        torch.cuda.synchronize()
        record["round_s"].append(time.perf_counter() - t0)
        return row

    engine.run_cohort, algo.compress_uplink, sched._deadline_round = dispatch, compressed, timed_round
    stld.sample_active_indices = indices

    def undo():
        stld.sample_active_indices = sample

    return undo


def compress_profile(compress, state, results):
    """Device busy time and launches of one ``compress_uplink`` call under
    ``torch.profiler`` (None when the profiler sees no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        compress(state, results)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0.0:
        return None
    return {"device_busy_ms": busy, "wall_ms_profiled": wall_ms, "kernel_launches": sum(e.count for e in kernels)}


def gather_dispatch_launches(dispatches, layers: int, steps: int, evaluations: int) -> dict:
    """Each dispatch of a batched gather cohort runs, per step, each layer
    in the union of its devices' indices once, the step's first without dX,
    then one fused evaluate; ``final_accuracy`` one evaluate per chunk."""
    run = 0
    for d in dispatches:
        idx = d["indices"]
        run += sum(len({l for i in range(d["n"]) for l in idx[i * steps + s]}) for s in range(steps))
    n = len(dispatches)
    return {"flash_attention": run + (n + evaluations) * layers, "flash_attention_bwd": run,
            "lora_matmul": 4 * run - 2 * steps * n + 2 * (n + evaluations) * layers}


def straggler_full(api, ops, card, seed: int):
    """Phase 5f's federated rounds on full-width qwen3-1.7b at ``api.build``'s
    defaults in gather mode: sync for 2 rounds (its first round's median
    modelled device time sets the deadline) and ``deadline_s=inf`` against
    it, bit for bit; then the main path, 3 rounds of ``schedule="deadline"``
    with ``straggler="carry"`` and ``compression="int8+topk"`` (error
    feedback): finite rows, fewer arrivals than dispatches in some row,
    uplink ratios below 1, the first row's traffic below sync's, launches
    exactly from the gather indices, every lora_matmul on wgmma, a second
    run bit-identical, and a run saved after round 2 (jobs in flight, EF
    residuals) and resumed by a fresh runner bit-identical to it; then 3
    aggregations of ``async-buffer`` (staleness alpha 0.5)."""
    import shutil

    phase_t0 = time.perf_counter()
    base = dict(smoke=False, seed=seed, stld_mode="gather")
    out = {"card": card}

    def build_run(rounds, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        runner = api.build("droppeft", "qwen3-1.7b", **base, **kw)
        t0 = time.perf_counter()
        result = runner.run(rounds=rounds)
        torch.cuda.synchronize()
        return runner, result, time.perf_counter() - t0

    runner = api.build("droppeft", "qwen3-1.7b", **base)
    first, report = [], runner.algorithm.report

    def report_recorded(state, results):
        out_ = report(state, results)
        if not first:
            first.extend(np.asarray(results.cost.total_time_s).tolist())
        return out_

    runner.algorithm.report = report_recorded
    t0 = time.perf_counter()
    sync_bits = run_bits(runner, runner.run(rounds=2))
    out["sync_run_s"] = time.perf_counter() - t0
    del runner
    deadline = float(np.median(first))
    out["deadline_s"], out["first_sync_round_times_s"] = deadline, first
    runner, result, _ = build_run(2, schedule="deadline", deadline_s=math.inf)
    check(same_bits(run_bits(runner, result), sync_bits), "deadline_s=inf differs from sync")
    out["deadline_inf_equals_sync"] = True
    del runner

    carry = dict(schedule="deadline", deadline_s=deadline, straggler="carry", compression="int8+topk")
    gc.collect()
    torch.cuda.empty_cache()
    runner = api.build("droppeft", "qwen3-1.7b", **base, **carry)
    fed, layers = runner.ctx.fed_cfg, runner.ctx.cfg.num_layers
    record = {"dispatches": [], "compress_s": [], "uplink_ratio": [], "round_s": []}
    compress = runner.algorithm.compress_uplink
    undo = instrument_dispatches(runner, record)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        result = runner.run(rounds=FED_ROUNDS)
        torch.cuda.synchronize()
    finally:
        undo()
    run_s = time.perf_counter() - t0
    launches, routes = dict(ops.launch_counts), dict(ops.lora_matmul_routes)
    hist = list(runner.state.history)
    main_bits = run_bits(runner, result)
    check(len(hist) == FED_ROUNDS and all(np.isfinite(v) for row in hist for v in row.values()),
          f"deadline rows {hist}")
    sizes = [d["n"] for d in record["dispatches"]]
    check(any(row["arrivals"] < n for row, n in zip(hist, sizes)), f"arrivals {hist} of dispatches {sizes}")
    check(all(r is not None and max(r) < 1.0 for r in record["uplink_ratio"]), f"uplink ratios {record['uplink_ratio']}")
    check(hist[0]["traffic"] < sync_bits["history"][0]["traffic"],
          f"compressed traffic {hist[0]['traffic']} vs sync {sync_bits['history'][0]['traffic']}")
    evaluations = -(-fed.num_devices // fed.devices_per_round)
    check_launches(launches, gather_dispatch_launches(record["dispatches"], layers, fed.local_steps, evaluations),
                   "deadline-carry gather rounds")
    check(routes == {"fma": 0, "wmma": 0, "wgmma": launches["lora_matmul"]}, f"routes {routes}")
    out.update(main_path_run_s=run_s, s_per_round=record["round_s"], compress_s=record["compress_s"],
               compress_profile=compress_profile(compress, *record["last_compress_args"]),
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, history=hist, dispatch_sizes=sizes,
               uplink_ratio=[r[0] for r in record["uplink_ratio"]], rates=[r["rate"] for r in hist],
               launches=launches, in_flight_at_end=sorted(runner.scheduler.in_flight),
               fault_log=list(runner.scheduler.fault_log), sync_history=sync_bits["history"])
    del runner

    runner, result, _ = build_run(FED_ROUNDS, **carry)
    check(same_bits(run_bits(runner, result), main_bits), "two deadline-carry runs from one seed differ")
    del runner
    ckpt_dir = ROOT / "build" / "chip_smoke_checkpoints_5f"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    runner, _, _ = build_run(2, checkpoint_dir=str(ckpt_dir), **carry)
    jobs, residuals = len(runner.scheduler.in_flight), len(runner.state.ef_residual)
    check(jobs > 0 and residuals > 0, f"the save after round 2 holds {jobs} jobs in flight, {residuals} residuals")
    del runner
    runner, result, _ = build_run(FED_ROUNDS, checkpoint_dir=str(ckpt_dir), resume=True, **carry)
    check(same_bits(run_bits(runner, result), main_bits), "the deadline-carry run resumed at round 2 differs")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out.update(bit_identical_runs=True, resumed_bit_identical=True, saved_jobs_in_flight=jobs,
               saved_ef_residuals=residuals)
    del runner

    runner, result, async_s = build_run(FED_ROUNDS, schedule="async-buffer", staleness_alpha=0.5)
    ahist = list(runner.state.history)
    buffer = max(1, fed.devices_per_round // 2)
    check(len(ahist) == FED_ROUNDS and all(np.isfinite(v) for row in ahist for v in row.values())
          and all(row["arrivals"] == buffer for row in ahist), f"async-buffer rows {ahist}")
    out.update(async_history=ahist, async_run_s=async_s)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - phase_t0
    return out, launches


def schedules_smoke_cuda_vs_cpu(seed: int):
    """Three rounds of droppeft at qwen3-1.7b's smoke size in float32 under
    ``deadline`` + drop and a fault plan, ``deadline`` + carry (alpha 0.5)
    at ``int8+topk`` and the fault plan, and ``async-buffer`` (alpha 0.5),
    batched on the card and on the CPU twins from the same weights and
    seed: dispatches, history rows but the loss, event and fault logs
    equal; the loss within 1e-5; the global LoRA within phase 5's tree
    tolerance, the step sizes summed over every local step.  The deadline
    is the median modelled device time of the first sync round."""
    from repro_torch import api
    from repro_torch.configs import FederatedConfig, TrainConfig, get_config
    from repro_torch.models.registry import init_params
    from repro_torch.models.stacking import tree_leaves
    from repro_torch.optim import make_lr_schedule

    cfg, train_cfg = get_config("qwen3-1.7b", smoke=True).replace(dtype="float32"), TrainConfig()
    fed = FederatedConfig(num_devices=6, devices_per_round=4, local_steps=2, batch_size=8)
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    common = dict(cfg=cfg, fed_cfg=fed, train_cfg=train_cfg, seed=seed, params=params)
    sync = api.build("droppeft", device="cpu", **common)
    sync.run(rounds=1)
    deadline = float(np.median([t for _, _, t in sync.scheduler.event_log]))
    plan = {"seed": seed, "dropout_prob": 0.25, "bandwidth_collapse_prob": 0.25, "nan_update_prob": 0.3,
            "nan_updates": [[1, 0], [1, 1]]}
    cases = {"deadline-drop-faults": dict(schedule="deadline", deadline_s=deadline, fault_plan=plan),
             "deadline-carry-int8+topk-faults": dict(schedule="deadline", deadline_s=deadline, straggler="carry",
                                                     staleness_alpha=0.5, compression="int8+topk", fault_plan=plan),
             "async-buffer": dict(schedule="async-buffer", staleness_alpha=0.5)}
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.total_steps)
    out = {"deadline_s": deadline}
    for name, kw in cases.items():
        runs = {}
        for device in ("cuda", "cpu"):
            runner = api.build("droppeft", device=device, **common, **kw)
            cohorts, cohort_step = [], runner.algorithm.cohort_step

            def recorded(state, plan_, cohorts=cohorts, cohort_step=cohort_step):
                cohorts.append((list(plan_.cohort), [float(r) for r in plan_.rates]))
                return cohort_step(state, plan_)

            runner.algorithm.cohort_step = recorded
            runner.run(rounds=3)
            runs[device] = (cohorts, [dict(row) for row in runner.state.history], list(runner.scheduler.event_log),
                            list(runner.scheduler.fault_log), [t.cpu() for t in tree_leaves(runner.state.global_peft)],
                            runner.state.global_step)
        (cc, hc, ec, fc, pc, steps), (cp, hp, ep, fp, pp, _) = runs["cuda"], runs["cpu"]
        what = f"{name}: the card vs the CPU twins"
        check(cc == cp and ec == ep and fc == fp, f"{what}: dispatches, events or faults differ")
        check([{k: v for k, v in r.items() if k != "loss"} for r in hc] == [{k: v for k, v in r.items() if k != "loss"}
                                                                               for r in hp],
              f"{what}: history {hc} vs {hp}")
        check(np.allclose([r["loss"] for r in hc], [r["loss"] for r in hp], rtol=1e-5, atol=0), f"{what}: loss")
        limit = 2 * sum(sched(step) for step in range(steps)) + 1e-6
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(pc, pp)])
        within = float((diffs <= 1e-6).float().mean())
        check(float(diffs.max()) <= limit and within >= 0.99, f"{what}: LoRA max diff {float(diffs.max())}, {within}")
        out[name] = {"arrivals": [r["arrivals"] for r in hc], "faults": [f["reason"] for f in fc],
                     "peft_max_abs_diff": float(diffs.max()), "peft_share_within_1e-6": within, "peft_limit": limit}
    return out


TIER_RANKS = {"tx2": 4, "nx": 8, "agx": 16}  # FedHetLoRA's rank of each hardware tier
JOINT_STARTUP = [(0.2, "none"), (0.5, "int8"), (0.7, "topk")]  # the joint bandit's start-up arms


def grid_round_launches(gates, layers: int, n: int, steps: int, mode: str, kind: str) -> dict:
    """A round's launches from its gates.  LoRA: phase 5d's formulas (both
    modes).  Adapter and BitFit (batched): per cohort step each layer once
    if any gate opens it, and the attention backward in all but the step's
    first run layer, whose attention output feeds no trainable input (the
    adapter or bias sits after it); no lora_matmul; one fused evaluate."""
    if mode == "batched":
        run = sum(len(ls) for ls in cohort_step_layers(gates, n, steps))
        if kind == "lora":
            return {"flash_attention": run + layers, "flash_attention_bwd": run,
                    "lora_matmul": 4 * run - 2 * steps + 2 * layers}
        return {"flash_attention": run + layers, "flash_attention_bwd": run - steps}
    active = active_count(gates)
    return {"flash_attention": active + n * layers, "flash_attention_bwd": active,
            "lora_matmul": 4 * active - 2 * len(gates) + n * 2 * layers}


def device_busy_round(runner, round_s: float):
    """Device time of ``runner``'s next round under ``torch.profiler`` with
    the CUDA activity alone (the host's op events would take minutes over a
    sequential round's ~270 000 launches), and the idle share against
    ``round_s``, an unprofiled round's seconds, beside the one against the
    profiled round's own wall time.  None when the profiler sees no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.scheduler._sync_round(runner.state.round_index + 1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0.0:
        return None
    return {"round": runner.state.round_index, "device_busy_ms": busy, "wall_ms_profiled": wall_ms,
            "kernel_launches": sum(e.count for e in kernels), "device_idle_share": 1.0 - busy / (round_s * 1e3),
            "device_idle_share_profiled": 1.0 - busy / wall_ms}


def grid_run(api, ops, seed: int, method: str, kind: str, *, prepare=None, after_run=None, n_rounds=GRID_ROUNDS,
             profile=True, **kw):
    """One run of phase 5g: ``api.build(method, "qwen3-1.7b", smoke=False)``
    for ``n_rounds`` rounds (``prepare(runner)`` before them and ``after_run(runner)``
    after them, when given), instrumented as
    phase 5d's: finite history, launches per round from the gates
    (``grid_round_launches``), every lora_matmul on wgmma,
    ``final_accuracy``'s launches; seconds a round, peak memory, and, with
    ``profile``, the device time of one more round (``device_busy_round``:
    the idle share).
    Returns (runner, stats, the per-round records, the run's bits with the
    bandit's state, the summed launches)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    runner = api.build(method, "qwen3-1.7b", smoke=False, seed=seed, peft=kind, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cfg, fed = runner.ctx.cfg, runner.ctx.fed_cfg
    layers, n, steps, mode = cfg.num_layers, fed.devices_per_round, fed.local_steps, runner.cohort_mode
    clock, rounds = {}, []
    instrument_runner(runner, ops, clock, rounds)
    if prepare is not None:
        prepare(runner)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = runner.run(rounds=n_rounds)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    final_launches = dict(ops.launch_counts)
    bits = run_bits(runner, result)
    bits["configurator"] = json.dumps(runner.state.configurator.state_dict() if runner.state.configurator else None)
    hist = bits["history"]
    what = f"5g {method} peft={kind} {mode}"
    check(len(hist) == n_rounds and all(np.isfinite(v) for row in hist for v in row.values()),
          f"{what}: history {hist}")
    check(np.isfinite(result.final_accuracy), f"{what}: final accuracy {result.final_accuracy}")
    for j, r in enumerate(rounds):
        check(len(r["gates"]) == n * steps, f"{what}: {len(r['gates'])} gate draws in round {j + 1}")
        check_launches(r["launches"], grid_round_launches(r["gates"], layers, n, steps, mode, kind),
                       f"{what} round {j + 1}")
        check(r["routes"] == {"fma": 0, "wmma": 0, "wgmma": r["launches"]["lora_matmul"]},
              f"{what}: routes {r['routes']}")
    evaluations = fed.num_devices if mode == "sequential" else -(-fed.num_devices // n)
    lora_eval = 2 * layers if kind == "lora" else 0
    check_launches(final_launches, {"flash_attention": evaluations * layers, "lora_matmul": evaluations * lora_eval},
                   f"{what} final_accuracy")
    per_round = [r["seconds"] for r in rounds]
    stats = {"method": method, "peft": kind, "cohort_mode": mode, "setup_s": setup_s, "run_s": run_s,
             "s_per_round": per_round, "s_per_round_mean": sum(per_round) / n_rounds,
             "final_accuracy_s": run_s - sum(per_round),
             "resident_gib": resident / 2**30, "peak_gib": peak / 2**30,
             "peft_mib": sum(t.numel() * t.element_size() for t in bits["peft"]) / 2**20,
             "launches_per_round": [r["launches"] for r in rounds], "launches_final_accuracy": final_launches,
             "rates": [r["rates"] for r in rounds], "history": hist, "final_accuracy": result.final_accuracy}
    if after_run is not None:
        after_run(runner)
    stats["profile"] = prof = device_busy_round(runner, stats["s_per_round_mean"]) if profile else None
    stats["device_idle_share"] = None if prof is None else prof["device_idle_share"]
    launches = {name: sum(r["launches"][name] for r in rounds) + final_launches[name] for name in final_launches}
    return runner, stats, rounds, bits, launches


def serve_hetlora_checkpoint(api, ops, seed: int, ckpt_dir, trees: dict, layers: int, vocab: int):
    """Serving a FedHetLoRA run's checkpoint: 12 requests over tenants of
    rank 4, 8 and 16 and ``client_global`` (16) through
    ``api.serve(checkpoint_dir=...)``, whose tokens must equal serving the
    same trees; every decode step calls segmented_lora twice a layer (q
    and v, a pool of r_max 16) and flash_decode once."""
    from repro_torch.serving.batcher import Request

    rng = np.random.default_rng(seed + 7)
    names = list(trees)
    requests = [(rng.integers(0, vocab, int(rng.integers(16, 65))).tolist(), names[j % len(names)])
                for j in range(12)]
    tokens, out = {}, {}
    for source in ("checkpoint", "trees"):
        gc.collect()
        torch.cuda.empty_cache()
        kw = {"checkpoint_dir": str(ckpt_dir)} if source == "checkpoint" else {"adapters": trees}
        batcher = api.serve("qwen3-1.7b", smoke=False, batch=8, max_len=512, seed=seed, **kw)
        for j, (prompt, name) in enumerate(requests):
            batcher.submit(Request(prompt=prompt, adapter=name, max_new_tokens=16, uid=j))
        calls, serve_step = [0], batcher.serve_step

        def counted(*args, calls=calls, serve_step=serve_step, **kw_):
            calls[0] += 1
            return serve_step(*args, **kw_)

        batcher.serve_step = counted
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        tokens[source] = {c.uid: c.tokens for c in batcher.run()}
        torch.cuda.synchronize()
        check_launches(dict(ops.launch_counts), {"segmented_lora": 2 * layers * calls[0],
                                                 "flash_decode": layers * calls[0]}, f"serving from the {source}")
        ranks = {name: batcher.pool.registry.get(name)["rank"] for name in names}
        out[source] = {"steps": calls[0], "s": time.perf_counter() - t0, "launches": dict(ops.launch_counts),
                       "registered": len(batcher.pool.registry), "ranks": ranks, "r_max": batcher.pool.r_max}
        del batcher
    check(tokens["checkpoint"] == tokens["trees"] and len(tokens["trees"]) == 12,
          f"served from the hetlora checkpoint {tokens['checkpoint']} vs from the same trees {tokens['trees']}")
    check(sorted(set(out["checkpoint"]["ranks"].values())) == [4, 8, 16] and out["checkpoint"]["r_max"] == 16,
          f"tenant ranks {out['checkpoint']['ranks']}, r_max {out['checkpoint']['r_max']}")
    return {"requests": len(requests), "tenants": names, "tokens_equal": True, **out}


def merge_check(ops, runner, seed: int):
    """``merge_lora_into_base`` on a run's trained global LoRA, and on the
    same LoRA with N(0, 0.02) added to every ``b`` (``amplified``, so that
    the LoRA moves the logits well past the tolerance and a merge that
    does nothing, scales wrongly or transposes the delta cannot pass);
    full-width logits of 4 x 32 tokens.  In float32 (the base's bf16
    weights cast up, so the same weights) the merged base without LoRA
    must give the unmerged model's logits through lora_matmul within
    3e-2 + 1e-2 |ref|, and lie at most 1 % as far from them as the base
    does.  In bf16 (the card's weights) the two differ by the rounding of
    two products over 28 layers (cuBLAS's ``x @ W'`` against the fused
    kernel), which the base without LoRA already shows: the merged bf16
    logits must lie at most twice as far from the float32 unmerged ones as
    the unmerged bf16 logits do (two bf16 models, each rounded its own
    way), and, for the amplified LoRA, at most half as far from the
    unmerged bf16 logits as the base does.  Every merge changes weights; every merged
    forward launches no lora_matmul."""
    from repro_torch.core.peft import lora_scale, merge_lora_into_base
    from repro_torch.models.registry import model_apply
    from repro_torch.models.stacking import tree_map

    base, cfg, trained = runner.ctx.engine.base_params, runner.ctx.cfg, runner.state.global_peft
    scale = lora_scale(runner.ctx.peft_cfg)
    tokens = torch.from_numpy(runner.ctx.task.tokens[:4]).long().to(base["embed"].device)
    out, logits, layers = {"tokens": list(tokens.shape)}, {}, cfg.num_layers
    gen = torch.Generator(device=base["embed"].device).manual_seed(seed)

    def amplify(tree):
        if not isinstance(tree, dict):
            return tree
        return {k: v + 0.02 * torch.randn(v.shape, generator=gen, device=v.device, dtype=v.dtype) if k == "b"
                else amplify(v) for k, v in tree.items()}

    def forward(name, params, cfg_, peft=None):
        ops.reset_launch_counts()
        logits[name] = model_apply(params, cfg_, {"tokens": tokens}, peft=peft, lora_scale=scale)[0].float()
        torch.cuda.synchronize()
        want = {"flash_attention": layers, "lora_matmul": 0 if peft is None else 2 * layers}
        check_launches(dict(ops.launch_counts), want, f"the {name} forward")

    def err(a, b):
        return float((logits[a] - logits[b]).abs().max())

    loras = {"trained": trained, "amplified": amplify(trained)}
    with torch.no_grad():
        for dtype_name, params, cfg_ in (("bf16", base, cfg),
                                         ("f32", tree_map(lambda t: t.float(), base), cfg.replace(dtype="float32"))):
            forward(f"{dtype_name} base", params, cfg_)
            for lora_name, tree in loras.items():
                forward(f"{dtype_name} unmerged {lora_name}", params, cfg_, tree)
                t0 = time.perf_counter()
                merged = merge_lora_into_base(params["layers"], tree, scale)
                torch.cuda.synchronize()
                out[f"{lora_name}_{dtype_name}_merge_s"] = time.perf_counter() - t0
                changed = sum(int((merged["attn"][w]["w"] != params["layers"]["attn"][w]["w"]).sum())
                              for w in ("wq", "wv"))
                out[f"{lora_name}_{dtype_name}_weights_changed"] = changed
                check(changed > 0, f"merging the {lora_name} LoRA changed no {dtype_name} weight")
                forward(f"{dtype_name} merged {lora_name}", {**params, "layers": merged}, cfg_)
                del merged
            del params
    check(all(bool(torch.isfinite(t).all()) for t in logits.values()), "non-finite logits in the merge check")
    for lora_name in loras:
        ref = logits[f"f32 unmerged {lora_name}"]
        limit = 3e-2 + 1e-2 * ref.abs()
        e = {f"max_abs_err_{a}_vs_{b}".replace(" ", "_"): err(f"{a} {lora_name}", f"{b} {lora_name}")
             for a, b in (("f32 merged", "f32 unmerged"), ("bf16 merged", "bf16 unmerged"),
                          ("bf16 merged", "f32 unmerged"), ("bf16 unmerged", "f32 unmerged"))}
        e.update({f"max_abs_err_{d}_base_vs_{d}_unmerged": err(f"{d} base", f"{d} unmerged {lora_name}")
                  for d in ("bf16", "f32")})
        e["logit_abs_max"] = float(ref.abs().max())
        e["f32_base_off_limit"] = int(((logits["f32 base"] - ref).abs() > limit).sum())
        out[lora_name] = e
        check(bool(((logits[f"f32 merged {lora_name}"] - ref).abs() <= limit).all()),
              f"float32 merged logits off the unmerged ones by {e['max_abs_err_f32_merged_vs_f32_unmerged']} "
              f"({lora_name} LoRA)")
        check(e["max_abs_err_f32_merged_vs_f32_unmerged"] <= 1e-2 * e["max_abs_err_f32_base_vs_f32_unmerged"],
              f"float32 merged logits {e['max_abs_err_f32_merged_vs_f32_unmerged']} from the unmerged ones, over 1 % "
              f"of the base's {e['max_abs_err_f32_base_vs_f32_unmerged']} ({lora_name} LoRA)")
        check(e["max_abs_err_bf16_merged_vs_f32_unmerged"] <= 2 * e["max_abs_err_bf16_unmerged_vs_f32_unmerged"],
              f"bf16 merged logits {e['max_abs_err_bf16_merged_vs_f32_unmerged']} from float32's, over twice the "
              f"unmerged bf16 model's {e['max_abs_err_bf16_unmerged_vs_f32_unmerged']} ({lora_name} LoRA)")
    amp = out["amplified"]
    check(amp["f32_base_off_limit"] > 0,
          f"the amplified LoRA moves no float32 logit past the tolerance (base {amp['max_abs_err_f32_base_vs_f32_unmerged']})"
          ": the check could not fail")
    check(amp["max_abs_err_bf16_merged_vs_bf16_unmerged"] <= 0.5 * amp["max_abs_err_bf16_base_vs_bf16_unmerged"],
          f"bf16 merged logits {amp['max_abs_err_bf16_merged_vs_bf16_unmerged']} from the unmerged ones, over half the "
          f"base's {amp['max_abs_err_bf16_base_vs_bf16_unmerged']} (amplified LoRA)")
    return out


def method_grid_full(api, ops, card, seed: int):
    """Phase 5g: the rest of the paper's method grid on full-width
    qwen3-1.7b at ``api.build``'s defaults (100 devices, 10 a round, 4
    local steps of 16 x 32 tokens, ``GRID_ROUNDS`` rounds, then
    ``final_accuracy`` over the 100 devices): ``fedhetlora`` (sequential; device ranks by tier,
    each device's tree at its rank) checkpointed and served from its
    checkpoint over tenants of rank 4, 8 and 16; ``droppeft`` with adapter
    and with BitFit (batched, zero lora_matmul, two runs bit-identical);
    ``fedadapter`` with adapter (full depth: every layer every step);
    ``droppeft`` with ``compression="auto"`` (the joint bandit's start-up
    arms round-robin, each device's uplink ratio from its level, saved
    after round 1 and resumed bit-identical with the bandit's state); and
    ``merge_lora_into_base`` on that run's global LoRA, and amplified
    (``merge_check``)."""
    import shutil

    phase_t0 = time.perf_counter()
    out = {"card": card}
    launches = {}

    def add(counts):
        for name, v in counts.items():
            launches[name] = launches.get(name, 0) + v

    # 1. fedhetlora, checkpointed, then served from its checkpoint
    ckpt_dir = ROOT / "build" / "chip_smoke_checkpoints_5g"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tenants, kept = {}, {}

    def hetlora_checks(runner):
        """The ranks and the tenants to serve, from the state the checkpoint holds."""
        ranks, profile = runner.algorithm.device_rank, runner.ctx.device_profile
        check(ranks == [TIER_RANKS[p] for p in profile], "hetlora's device ranks do not follow the tiers")
        for dev, tree in runner.state.device_peft.items():
            got = {(t["a"].shape[-1], t["b"].shape[-2]) for t in tree["attn"].values()}
            check(got == {(ranks[dev], ranks[dev])}, f"device {dev} of rank {ranks[dev]} holds a tree of ranks {got}")
        check(runner.state.global_peft["attn"]["q"]["a"].shape[-1] == 16, "the global tree is not at rank 16")
        kept["ranks_trained"] = sorted({ranks[d] for d in runner.state.device_peft})
        kept["layers"], kept["vocab"] = runner.ctx.cfg.num_layers, runner.ctx.cfg.vocab_size
        for r in (4, 8, 16):
            dev = min((d for d in runner.state.device_peft if ranks[d] == r), default=None)
            check(dev is not None, f"no device of rank {r} trained")
            tenants[f"client{dev}"] = runner.state.device_peft[dev]
        tenants["client_global"] = runner.state.global_peft

    runner, stats, rounds, _, counts = grid_run(api, ops, seed, "fedhetlora", "lora", after_run=hetlora_checks,
                                                n_rounds=HETLORA_ROUNDS, profile=False,
                                                checkpoint_dir=str(ckpt_dir))
    add(counts)
    del runner
    gc.collect()
    stats["ranks_trained"] = kept["ranks_trained"]
    stats["serve"] = serve_hetlora_checkpoint(api, ops, seed, ckpt_dir, tenants, kept["layers"], kept["vocab"])
    add(stats["serve"]["checkpoint"]["launches"])
    del tenants
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    out["fedhetlora"] = stats

    # 2-4. adapter and BitFit: no lora_matmul; two runs from one seed give the same bits
    for name, method, kind in (("droppeft_adapter", "droppeft", "adapter"), ("droppeft_bitfit", "droppeft", "bitfit"),
                               ("fedadapter_adapter", "fedadapter", "adapter")):
        runner, stats, rounds, bits, counts = grid_run(api, ops, seed, method, kind)
        add(counts)
        check(counts["lora_matmul"] == 0, f"{name}: {counts['lora_matmul']} lora_matmul launches")
        if method == "fedadapter":
            check(all(not any(g) for r in rounds for g in r["gates"]), f"{name}: a layer was dropped")
        else:
            del runner
            gc.collect()
            again = api.build(method, "qwen3-1.7b", smoke=False, seed=seed, peft=kind)
            check(same_bits(run_bits(again, again.run(rounds=GRID_ROUNDS)), bits), f"{name}: two runs from one seed differ")
            stats["bit_identical_runs"] = True
            runner = again
        del runner
        out[name] = stats

    # 5. the joint (rate x compression level) bandit, saved after round 1 and resumed
    uplinks = []

    def record_uplinks(runner):
        compress = runner.algorithm.compress_uplink

        def compressed(state, results):
            state, results = compress(state, results)
            ratios = results.uplink_ratio  # None: every level of the round is "none"
            uplinks.append((list(results.plan.compression),
                            [1.0] * len(results.plan.cohort) if ratios is None else ratios.tolist()))
            return state, results

        runner.algorithm.compress_uplink = compressed

    runner, stats, rounds, bits, counts = grid_run(api, ops, seed, "droppeft", "lora", prepare=record_uplinks,
                                                   compression="auto")
    add(counts)
    del runner
    uplinks = uplinks[:GRID_ROUNDS]  # the profiled round's follow
    n = len(uplinks[0][0])
    first = list(zip(rounds[0]["rates"], uplinks[0][0]))
    check(first == [JOINT_STARTUP[i % 3] for i in range(n)], f"the joint bandit's first arms {first}")
    for levels, ratios in uplinks:
        check(all((r == 1.0) == (lv == "none") and r <= 1.0 for lv, r in zip(levels, ratios)),
              f"uplink ratios {ratios} for levels {levels}")
    stats["arms"] = [list(zip(r["rates"], levels)) for r, (levels, _) in zip(rounds, uplinks)]
    stats["uplink_ratios"] = [ratios for _, ratios in uplinks]
    gc.collect()
    jdir = ROOT / "build" / "chip_smoke_checkpoints_5g_joint"
    shutil.rmtree(jdir, ignore_errors=True)
    api.build("droppeft", "qwen3-1.7b", smoke=False, seed=seed, compression="auto", checkpoint_dir=str(jdir)).run(
        rounds=GRID_ROUNDS - 1)
    gc.collect()
    runner = api.build("droppeft", "qwen3-1.7b", smoke=False, seed=seed, compression="auto", checkpoint_dir=str(jdir),
                       resume=True)
    check(runner.state.round_index == GRID_ROUNDS - 1, f"the joint run resumed at round {runner.state.round_index}")
    resumed = run_bits(runner, runner.run(rounds=GRID_ROUNDS))
    check(same_bits(resumed, bits) and json.dumps(runner.state.configurator.state_dict()) == bits["configurator"],
          "the joint-bandit run resumed at round 1 differs from the uninterrupted run")
    stats["resumed_bit_identical"] = True
    stats["configurator"] = json.loads(bits["configurator"])
    shutil.rmtree(jdir, ignore_errors=True)
    out["droppeft_joint"] = stats

    # 6. merge_lora_into_base on the joint run's trained global LoRA
    out["merge"] = merge_check(ops, runner, seed)
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - phase_t0
    return out, launches


def method_grid_smoke_cuda_vs_cpu(seed: int):
    """Phase 5g at smoke size in float32, ``GRID_SMOKE_ROUNDS`` on the card and on the
    CPU twins from the same weights and seed: FedHetLoRA (sequential), the
    joint bandit, and droppeft with adapter and with BitFit on qwen3-1.7b,
    rwkv6-3b and jamba (batched): dispatches (cohorts, rates, levels),
    masks, event logs and history rows but the loss equal, the loss within
    1e-5, the global tree within phase 5's tree tolerance."""
    from repro_torch import api
    from repro_torch.configs import FederatedConfig, TrainConfig
    from repro_torch.models.registry import init_params
    from repro_torch.models.stacking import tree_leaves
    from repro_torch.optim import make_lr_schedule

    train_cfg = TrainConfig()
    fed = FederatedConfig(num_devices=6, devices_per_round=4, local_steps=2, batch_size=8)
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.total_steps)
    cases = [("qwen3-1.7b", "fedhetlora", {}), ("qwen3-1.7b", "droppeft", {"compression": "auto"})]
    cases += [(arch, "droppeft", {"peft": kind}) for arch in ("qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b")
              for kind in ("adapter", "bitfit")]
    out = {}
    for arch, method, kw in cases:
        cfg = card_smoke_cfg(arch)
        params = init_params(cfg, torch.Generator().manual_seed(seed))
        runs = {}
        for device in ("cuda", "cpu"):
            runner = api.build(method, cfg=cfg, fed_cfg=fed, train_cfg=train_cfg, seed=seed, params=params,
                               device=device, **kw)
            plans, report = [], runner.algorithm.report

            def recorded(state, results, plans=plans, report=report):
                plans.append((list(results.plan.cohort), [float(r) for r in results.plan.rates],
                              results.plan.compression, results.masks.tolist()))
                return report(state, results)

            runner.algorithm.report = recorded
            runner.run(rounds=GRID_SMOKE_ROUNDS)
            runs[device] = (plans, [dict(row) for row in runner.state.history], list(runner.scheduler.event_log),
                            [t.cpu() for t in tree_leaves(runner.state.global_peft)], runner.state.global_step)
        (pc, hc, ec, tc, steps), (pp, hp, ep, tp, _) = runs["cuda"], runs["cpu"]
        name = f"{arch} {method} {json.dumps(kw)}"
        what = f"{name}: the card vs the CPU twins"
        check(pc == pp and ec == ep, f"{what}: dispatches, masks or events differ: {pc} vs {pp}")
        check([{k: v for k, v in r.items() if k != "loss"} for r in hc] == [{k: v for k, v in r.items() if k != "loss"}
                                                                               for r in hp],
              f"{what}: history {hc} vs {hp}")
        check(np.allclose([r["loss"] for r in hc], [r["loss"] for r in hp], rtol=1e-5, atol=0), f"{what}: loss")
        limit = 2 * sum(sched(step) for step in range(steps)) + 1e-6
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(tc, tp)])
        within = float((diffs <= 1e-6).float().mean())
        check(float(diffs.max()) <= limit and within >= 0.99, f"{what}: tree max diff {float(diffs.max())}, {within}")
        out[name] = {"peft_max_abs_diff": float(diffs.max()), "peft_share_within_1e-6": within, "peft_limit": limit}
    return out


SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 128, 32  # phase 5h: batch 8, 128-token prompts, 32 new tokens
RECURRENT_ARCHS = ("rwkv6-3b", "jamba-v0.1-52b", "qwen3-1.7b")
# llama4-scout-17b-a16e on one card: 48 layers of ~4.4 GB in bf16 (~216
# GB) and a 4.1 GB embedding and head.  Serving holds 8 layers (~39 GB);
# the float32 decode check 4 (35 GB of float32 layers, 8.3 GB of head);
# training takes the deepest cut at which both rates' rounds fit at batch
# 16, from LLAMA4_TRAIN_LAYERS down: 8 layers did not fit on an 80 GB
# H100 (the float32 logits of 16 x 512 tokens over 202 048 are 6.2 GiB a
# copy), nor 7, and 6 did (68.8 GiB at rate 0.0), so the search starts
# at 7 and shows the cut above the one it takes.
LLAMA4_SERVE_LAYERS, LLAMA4_F32_LAYERS, LLAMA4_TRAIN_LAYERS = 8, 4, 7
# internvl2-76b on one card: 80 layers of ~1.7 GB in bf16 (~141 GB) and a
# 2.1 GB embedding and head each.  Serving takes the deepest cut from
# INTERNVL_SERVE_LAYERS down (by 4) that fits; the float32 decode check 4
# layers (~14 GB, and 8.4 GB of float32 embedding and head); training the
# deepest cut from INTERNVL_TRAIN_LAYERS down (by 1) whose rounds at both
# rates fit at batch 16 with its 256 patches: 9 fit, 10 did not (nor 11,
# 12), so the search starts at 10 and shows the cut above the one it takes.
INTERNVL_SERVE_LAYERS, INTERNVL_F32_LAYERS, INTERNVL_TRAIN_LAYERS = 32, 4, 10
# granite-moe-3b-a800m fits the card whole, but its decode step is bound by
# the host (~9 400 launches, 280-390 ms a step at 32 layers), so its serving
# runs half its depth to keep the script well inside its time limit; its
# training and federated runs stay uncut.
GRANITE_SERVE_LAYERS = 16
SERVING_CUTS = {
    "granite-moe-3b-a800m": f"{GRANITE_SERVE_LAYERS} of 32 layers (its host-bound decode steps, for the script's "
                            "time limit)",
    "jamba-v0.1-52b": "one period of 8 of 32 layers (52 B bf16 exceeds the card's 80 GB)",
    "llama4-scout-17b-a16e": f"{LLAMA4_SERVE_LAYERS} of 48 layers, float32 {LLAMA4_F32_LAYERS} (108 B bf16 exceeds "
                             "the card's 80 GB)",
    "internvl2-76b": f"at most {INTERNVL_SERVE_LAYERS} of 80 layers, float32 {INTERNVL_F32_LAYERS} (76 B bf16 "
                     "exceeds the card's 80 GB)",
}


def serving_cfg(arch: str, dtype: str = "bfloat16", smoke: bool = False):
    """Phase 5h's (and 5i's) full-width config of ``arch``: jamba-v0.1-52b
    cut to one period of 8 layers (7 Mamba, 1 attention), as in phase 5c,
    since its 32 layers (~104 GB in bf16) exceed the card's 80 GB, and in
    float32 at ``capacity_factor`` 8.0, as ``tests/test_decode_consistency.py``
    runs it, so that the cache-free forward drops no token that decode
    keeps; llama4-scout-17b-a16e cut to ``LLAMA4_SERVE_LAYERS`` (its 48
    layers are ~216 GB), and in float32 to ``LLAMA4_F32_LAYERS`` (8 float32
    layers, 70 GB, and the float32 head do not fit); granite-moe-3b-a800m
    cut to ``GRANITE_SERVE_LAYERS`` (for the time limit); an MoE family's
    float32 config at a capacity of every token of a group
    (``capacity_factor`` = experts), so that no token drops.  ``smoke``
    takes the smoke config instead (a rehearsal on the CPU)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=smoke).replace(dtype=dtype)
    if arch == "jamba-v0.1-52b":
        cfg = cfg.replace(num_layers=8, **({"capacity_factor": 8.0} if dtype == "float32" else {}))
    if arch == "llama4-scout-17b-a16e" and not smoke:
        cfg = cfg.replace(num_layers=LLAMA4_F32_LAYERS if dtype == "float32" else LLAMA4_SERVE_LAYERS)
    if arch == "internvl2-76b" and not smoke:
        cfg = cfg.replace(num_layers=INTERNVL_F32_LAYERS if dtype == "float32" else INTERNVL_SERVE_LAYERS)
    if arch == "granite-moe-3b-a800m" and not smoke:
        cfg = cfg.replace(num_layers=GRANITE_SERVE_LAYERS)
    if cfg.family == "moe" and dtype == "float32":
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts))
    return cfg


def step_launches(cfg) -> dict:
    """Each kernel's launches in one decode step: a WKV at S 1 per RWKV6
    layer, a scan from its state per Mamba layer, a flash_decode per
    attention layer and two per ``encdec`` layer (its ring, then every
    encoder slot); nothing else (no adapter, no backward)."""
    from repro_torch.models.layers import layer_kind

    kinds = [layer_kind(cfg, l) for l in range(cfg.num_layers)]
    return {"wkv6": kinds.count("rwkv"), "mamba_scan": kinds.count("mamba"),
            "flash_decode": kinds.count("attn") + 2 * kinds.count("encdec")}


def prefill_launches(cfg) -> dict:
    """The prefill's launches: the decode step's, with flash_attention (an
    empty ring, positions 0 .. S-1; a decoder's cross-attention over the
    encoder's frames) in place of flash_decode, and an encoder's layers'."""
    want = step_launches(cfg)
    want["flash_attention"] = want.pop("flash_decode") + cfg.num_encoder_layers
    return want


def frontend_input(cfg, batch: int, seed: int, device, dtype):
    """Stub-frontend input from ``seed``: an audio model's frames or a
    vision model's patches, (batch, frontend_seq, d_model) of 0.1 N(0, 1)
    in ``dtype`` on ``device`` (drawn on the CPU); None for a text model."""
    if cfg.frontend_key is None:
        return None
    gen = torch.Generator().manual_seed(seed)
    return (0.1 * torch.randn((batch, cfg.frontend_seq, cfg.d_model), generator=gen)).to(device=device, dtype=dtype)


def profile_decode(step, params, token, pos: int, caches, n_steps: int = 4, enc_kvs=None):
    """Device busy time, idle share and launches of ``n_steps`` decode steps
    under ``torch.profiler`` (CPU and CUDA activity), beside their host
    clock, from ``caches`` at ``pos`` (with an encoder-decoder's
    ``enc_kvs``).  None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            _, token, caches = step(params, token, pos + i, caches, enc_kvs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0.0:
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"steps": n_steps, "wall_ms_per_step_profiled": wall_ms / n_steps,
            "device_busy_ms_per_step": busy / n_steps, "device_idle_share_profiled": 1.0 - busy / wall_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / n_steps,
            "top_kernels": [{"kernel": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
                             "calls_per_step": e.count / n_steps} for e in kernels[:6]]}


def freeze_steps(tokens, eos_id: int, budgets) -> list:
    """The step after which ``generate`` with ``eos_id`` and per-row
    ``budgets`` freezes each row of a run without stops, ``tokens`` (B, T)
    on the host: the row's first ``eos_id`` at or before step budget - 1,
    else step budget - 1.  The row emits ``pad_id`` from the next step on,
    and no ``pad_id`` before."""
    out = []
    for row in range(tokens.shape[0]):
        last = min(int(budgets[row]), tokens.shape[1]) - 1
        eos = (tokens[row, : last + 1] == eos_id).nonzero()
        out.append(int(eos[0]) if len(eos) else last)
    return out


def zeroed_states(caches):
    """A copy of list-layout caches whose carried state (the KV rings, the
    RWKV6 and Mamba states) is zero and whose positions are kept."""
    return [{name: t.clone() if name == "pos" else torch.zeros_like(t) for name, t in c.items()} for c in caches]


# The depth of the float32 decode check where the model's own float32
# arithmetic does not reproduce itself at full depth.  A random 32-layer
# rwkv6-3b amplifies rounding about 1.4x a layer: two cache-free forwards
# over 16 and 24 tokens disagree on their shared positions by 1.50 of a
# largest logit of 5.6 with the kernels and by 1.58 with the twins on the
# card, against 1.5e-3 at 8 layers (NVIDIA H100 80GB HBM3, 700 W).  The full
# depth's numbers are reported beside the check.
F32_CHECK_LAYERS = {"rwkv6-3b": 8}


def decode_vs_forward(serve, cfg, params, seed: int, zero_state: bool = False):
    """Float32 decode against the cache-free forward at full width: 2 rows,
    16 prompt tokens through ``make_prefill_step``, then 8 tokens one at a
    time through ``make_serve_step``; the logits of positions 15 .. 23
    against ``model_apply``'s over all 24 tokens (an audio model's frames
    and a vision model's patches from ``seed`` with both; a patch prefix's
    logits left out).  Returns their max abs err, the max |logit| and, as
    the model's own float32 reproducibility, the max abs difference of
    ``model_apply`` over the first 16 tokens from the one over 24 on those
    positions.  ``zero_state`` zeroes the carried state between the prefill
    and the decode (the caches, or an encoder-decoder's cross K/V; the
    check must then fail)."""
    from repro_torch.launch.steps import frontend_batch, make_prefill_step, make_serve_step
    from repro_torch.models.registry import model_apply, params_device
    from repro_torch.models.transformer import init_caches

    device = params_device(params)
    toks = torch.from_numpy(serve.random_prompts(cfg, 2, 24, seed + 3)).to(device)
    frontend, p = frontend_input(cfg, 2, seed + 4, device, torch.float32), cfg.prefix_len
    with torch.no_grad():
        full = model_apply(params, cfg, frontend_batch(cfg, toks, frontend))[0][:, p:]
        prefix = model_apply(params, cfg, frontend_batch(cfg, toks[:, :16], frontend))[0][:, p:]
        caches = init_caches(cfg, 2, p + 24, dtype=torch.float32, device=device)
        last, caches, *enc_kvs = make_prefill_step(cfg)(params, frontend_batch(cfg, toks[:, :16], frontend),
                                                        caches)
        enc_kvs = enc_kvs[0] if enc_kvs else None
        if zero_state and enc_kvs is not None:
            enc_kvs = [{**kv, "k": torch.zeros_like(kv["k"]), "v": torch.zeros_like(kv["v"])} for kv in enc_kvs]
        elif zero_state:
            caches = zeroed_states(caches)
        step, got = make_serve_step(cfg), [last]
        for t in range(16, 24):
            logits, _, caches = step(params, toks[:, t:t + 1].to(torch.int32), p + t, caches, enc_kvs)
            got.append(logits)
    out = {"layers": cfg.num_layers, "max_abs_err": (torch.stack(got, dim=1) - full[:, 15:]).abs().max().item(),
           "max_abs_logit": full.abs().max().item(),
           "prefix_forward_max_abs_err": (prefix - full[:, :16]).abs().max().item()}
    return out


def serve_smoke_cuda_vs_cpu(serve, seed: int, arch: str):
    """The smoke model of ``arch`` in float32 through ``prefill_and_generate``
    on the card (the kernels) and on the CPU (the twins), from the same
    weights and prompts: the tokens equal, the logits of the prompt and of
    every decode step within 1e-4."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.registry import init_params, place_params

    cfg = card_smoke_cfg(arch)
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = init_params(cfg, gen)
    prompt = serve.random_prompts(cfg, 3, 7, seed)
    runs = {}
    for device in ("cuda", "cpu"):
        seen = []
        out = serve.prefill_and_generate(cfg, place_params(params, cfg, device), prompt, 5, device,
                                         serve_step=recording(make_serve_step(cfg), seen),
                                         frontend=frontend_input(cfg, 3, seed + 2, device, torch.float32))
        runs[device] = (out["tokens"].cpu(), torch.stack([out["last_logits"].cpu(), *seen]))
    err = (runs["cuda"][1] - runs["cpu"][1]).abs().max().item()
    check(torch.equal(runs["cuda"][0], runs["cpu"][0]), f"{arch} smoke serving: tokens differ on the card and the CPU")
    check(err <= 1e-4, f"{arch} smoke serving on the card vs the CPU twins: max abs logit err {err}")
    return {"arch": arch, "tokens_equal": True, "max_abs_err": err, "atol": 1e-4}


def free_memory(device: str):
    gc.collect()  # the earlier phases' weights may sit in reference cycles
    if device == "cuda":
        torch.cuda.empty_cache()


def recurrent_serving_full(ops, card, seed: int, arch: str, device: str = "cuda", smoke: bool = False, layers=None):
    """Phase 5h for one arch: full-width ``arch`` (``serving_cfg``) served
    through ``repro_torch.launch.serve``'s functions, random weights from
    ``seed``, batch 8, 128-token prompts, 32 new tokens, bf16: each
    kernel's launches in the prefill and in every decode step; ``generate``
    again, then a hand-rolled ``serve_step`` loop, both with the first
    run's tokens; ``eos_id`` and per-row ``max_new_tokens`` freezing the
    rows they should; prefill ms, ms a decode step, a profiled step's
    device time and idle share, peak memory; then the float32 decode
    against the cache-free forward (and the same with the carried state
    zeroed, which must fail), and the smoke model on the card against the
    CPU twins.  ``device="cpu"`` with ``smoke`` rehearses it on the CPU at
    the smoke size, every check but the card's own (launches, profile,
    peak memory, the twins) kept (``tests/test_torch_decode.py``).  An
    audio or vision model takes its frames or patches from ``seed``
    (``frontend_input``); ``layers`` cuts the bf16 model's depth."""
    from repro_torch.launch import serve
    from repro_torch.launch.steps import frontend_batch, make_prefill_step, make_serve_step
    from repro_torch.models.transformer import init_caches

    free_memory(device)
    on_card = device == "cuda"
    t_arch = time.perf_counter()
    cfg = serving_cfg(arch, smoke=smoke)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    params = serve.init_model(cfg, seed, device)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prompt = serve.random_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed)
    frontend, p = frontend_input(cfg, SERVE_BATCH, seed + 1, device, getattr(torch, cfg.dtype)), cfg.prefix_len
    step = make_serve_step(cfg)
    seen = {"prefill": None, "steps": []}

    def counted(*args, **kw):  # each decode step's launches; those before the first are the prefill's
        if seen["prefill"] is None:
            seen["prefill"] = dict(ops.launch_counts)
        ops.reset_launch_counts()
        out = step(*args, **kw)
        seen["steps"].append(dict(ops.launch_counts))
        return out

    ops.reset_launch_counts()
    first = serve.prefill_and_generate(cfg, params, prompt, SERVE_GEN, device, serve_step=counted, frontend=frontend)
    check(len(seen["steps"]) == SERVE_GEN, f"{arch}: {len(seen['steps'])} decode steps")
    if on_card:  # the CPU twins launch nothing
        check_launches(seen["prefill"], prefill_launches(cfg), f"{arch} prefill")
        for i, launches in enumerate(seen["steps"]):
            check_launches(launches, step_launches(cfg), f"{arch} decode step {i}")
    tokens = first["tokens"].cpu()
    check(tuple(tokens.shape) == (SERVE_BATCH, SERVE_GEN) and bool(torch.isfinite(first["last_logits"]).all()),
          f"{arch}: tokens {tuple(tokens.shape)}, prompt logits finite {bool(torch.isfinite(first['last_logits']).all())}")
    del first

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    timed = serve.prefill_and_generate(cfg, params, prompt, SERVE_GEN, device, serve_step=step, frontend=frontend)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    check(torch.equal(timed["tokens"].cpu(), tokens), f"{arch}: two generate runs give different tokens")
    profile = None
    if on_card:
        profile = profile_decode(step, params, timed["tokens"][:, -1:], p + SERVE_PROMPT + SERVE_GEN, timed["caches"],
                                 enc_kvs=timed["enc_kvs"])
    prefill_s, decode_s = timed["prefill_s"], timed["decode_s"]
    del timed

    caches = init_caches(cfg, SERVE_BATCH, p + SERVE_PROMPT + SERVE_GEN, dtype=torch.bfloat16, device=device)
    last, caches, *enc_kvs = make_prefill_step(cfg)(params, frontend_batch(cfg, prompt, frontend), caches)
    enc_kvs = enc_kvs[0] if enc_kvs else None
    token, manual = torch.argmax(last, dim=-1)[:, None].to(torch.int32), []
    for i in range(SERVE_GEN):
        _, token, caches = step(params, token, p + SERVE_PROMPT + i, caches, enc_kvs)
        manual.append(token[:, 0])
    check(torch.equal(torch.stack(manual, dim=1).cpu(), tokens),
          f"{arch}: generate's tokens differ from a hand-rolled serve_step loop")
    del caches, enc_kvs

    eos_id, budgets, pad_id = int(tokens[0, 12]), [SERVE_GEN, 14, 9, 17, SERVE_GEN, 11, 25, SERVE_GEN], -1
    stopped = serve.prefill_and_generate(cfg, params, prompt, SERVE_GEN, device, eos_id=eos_id, frontend=frontend,
                                         max_new_tokens=torch.tensor(budgets), pad_id=pad_id)["tokens"].cpu()
    # the freeze points from the unconditional run's tokens: each row holds
    # no pad_id up to its freeze point and only pad_id after it
    freeze = freeze_steps(tokens, eos_id, budgets)
    live = torch.arange(SERVE_GEN)[None, :] <= torch.tensor(freeze)[:, None]
    check(torch.equal(stopped == pad_id, ~live),
          f"{arch}: rows not frozen as eos_id {eos_id} and budgets {budgets} say (after steps {freeze})")
    # up to the step after the batch's first freeze every row's input is the
    # unconditional run's, so its tokens are too
    first_stop = min(freeze) + 1
    check(torch.equal(stopped[:, :first_stop], tokens[:, :first_stop]),
          f"{arch}: tokens before the first freeze (step {first_stop}) differ from the unconditional run's")
    # no row's arithmetic reads another row's values (the MoE weight gather
    # runs each chosen expert on every token of the step): every live token
    # is the unconditional run's
    live_equal = int((stopped[live] == tokens[live]).sum())
    check(live_equal == int(live.sum()), f"{arch}: {live_equal} of {int(live.sum())} live tokens as unconditional")
    del params
    free_memory(device)

    cfg32 = full_depth = serving_cfg(arch, "float32", smoke)
    if not smoke and arch in F32_CHECK_LAYERS:
        cfg32 = cfg32.replace(num_layers=F32_CHECK_LAYERS[arch])
    params32 = serve.init_model(cfg32, seed, device)
    f32 = decode_vs_forward(serve, cfg32, params32, seed)
    limit = 1e-3 * f32["max_abs_logit"]
    check(f32["max_abs_err"] <= limit, f"{arch} float32 decode vs the cache-free forward at {f32['layers']} layers: "
                                       f"{f32}, limit {limit}")
    f32["zeroed_state_max_abs_err"] = decode_vs_forward(serve, cfg32, params32, seed, zero_state=True)["max_abs_err"]
    check(f32["zeroed_state_max_abs_err"] > limit, f"{arch}: decode with the carried state zeroed passed the "
                                                   f"check ({f32}): the check cannot fail")
    f32["limit"] = limit
    del params32
    free_memory(device)
    if cfg32 is not full_depth:  # the full depth, reported only
        f32["full_depth"] = decode_vs_forward(serve, full_depth, serve.init_model(full_depth, seed, device), seed)
        free_memory(device)
    twins = serve_smoke_cuda_vs_cpu(serve, seed, arch) if on_card else None
    launches = {"prefill": seen["prefill"], "decode_step": seen["steps"][0],
                "run": {name: seen["prefill"][name] + sum(st[name] for st in seen["steps"])
                        for name in seen["prefill"]}}
    return {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "cut": SERVING_CUTS.get(arch) if not smoke else None, "frontend_seq": cfg.frontend_seq or None,
        "batch": SERVE_BATCH, "prompt_tokens": SERVE_PROMPT, "new_tokens": SERVE_GEN, "setup_s": setup_s,
        "prefill_ms": prefill_s * 1e3, "decode_ms": decode_s * 1e3, "ms_per_decode_step": decode_s / SERVE_GEN * 1e3,
        "generated_tokens_per_s": SERVE_BATCH * SERVE_GEN / decode_s, "peak_gib": peak_gib,
        "decode_step_profile": profile, "launches": launches, "generate_equals_hand_rolled_loop": True,
        "stops": {"eos_id": eos_id, "budgets": budgets, "first_freeze_step": first_stop,
                  "live_tokens_equal_unconditional": f"{live_equal}/{int(live.sum())}"},
        "decode_vs_forward_float32": f32,
        "smoke_cuda_vs_cpu": twins, "arch_s": time.perf_counter() - t_arch, "card": card,
    }, launches


MOE_ARCHS = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e")


def moe_costs(cfg, params, peft, batch: int, seq: int, flush) -> dict:
    """Device time (``torch.profiler``, kernels summed) of one MoE layer's
    forward and backward at a round's shape (batch x seq tokens, bf16; its
    input takes a gradient, as in every active layer but a step's first)
    beside that of the whole layer (attention with its q and v LoRA, then
    the MoE, the LoRA's gradients too), and the MoE's share of the layer;
    with the dispatch tensors' shape and their einsums' operations."""
    from repro_torch.configs import PEFTConfig
    from repro_torch.core.peft import lora_scale
    from repro_torch.models.layers import layer_apply
    from repro_torch.models.stacking import layer_view, tree_leaves, tree_map
    from repro_torch.nn.moe import moe_apply

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16).requires_grad_(True)
    g = torch.randn((batch, seq, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    layer = layer_view(params["layers"], 0)
    peft_l = tree_map(lambda t: t.detach().clone().requires_grad_(True), layer_view(peft, 0))
    positions = torch.arange(seq, device="cuda")
    scale = lora_scale(PEFTConfig())

    def moe_step():
        out, aux = moe_apply(layer["moe"], cfg, x)
        torch.autograd.grad([out, aux], [x], [g, torch.ones_like(aux)])

    def layer_step():
        out, aux, _ = layer_apply(layer, cfg, x, positions=positions, peft=peft_l, lora_scale=scale)
        torch.autograd.grad([out, aux], [x, *tree_leaves(peft_l)], [g, torch.ones_like(aux)])

    moe_ms, layer_ms = device_ms(moe_step, flush, repeats=3), device_ms(layer_step, flush, repeats=3)
    tokens = batch * seq
    group = min(tokens, 4096)
    cap = min(int(max(cfg.top_k, group / cfg.num_experts * cfg.capacity_factor * cfg.top_k)), group)
    return {"tokens": tokens, "dispatch_shape": [tokens // group, group, cfg.num_experts, cap],
            "dispatch_einsum_flop": 2.0 * tokens * cfg.num_experts * cap * cfg.d_model,
            "moe_fwd_bwd_device_ms": moe_ms, "layer_fwd_bwd_device_ms": layer_ms,
            "moe_share_of_layer": moe_ms / layer_ms if moe_ms and layer_ms else None}


def moe_train_full(ops, card, seed: int, arch: str, flush):
    """Phase 5i's local rounds of ``arch`` as phase 5's (``train_full``),
    with the MoE's share of a layer's device time (``moe_costs``):
    granite-moe-3b-a800m uncut (its rate-0.0 round at half the batch if
    batch 16 does not fit, the error printed); llama4-scout-17b-a16e at the
    deepest cut from ``LLAMA4_TRAIN_LAYERS`` down at which both rates'
    rounds fit at batch 16 (the cuts that did not fit printed).  Then a
    smoke round on the card against the CPU twins."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    layers, cuts = (LLAMA4_TRAIN_LAYERS if arch == "llama4-scout-17b-a16e" else cfg.num_layers), []
    while True:
        try:
            stats, profile, launches = train_full(
                ops, card, seed, cfg.replace(num_layers=layers), dense_round_launches, evaluate_launches,
                rate0_batch_cut=layers == cfg.num_layers,
                after=lambda c, p, pf: moe_costs(c, p, pf, 16, 512, flush))
            break
        except torch.cuda.OutOfMemoryError as err:
            check(layers < cfg.num_layers and layers > 1, f"{arch}: a local round does not fit at {layers} layers: "
                                                          f"{str(err).splitlines()[0][:200]}")
            cuts.append({"layers": layers, "error": str(err).splitlines()[0][:200]})
        layers -= 1
        free_memory("cuda")  # after the handler, whose traceback held the failed round's tensors
    stats["depth_cut"] = (None if layers == cfg.num_layers else
                          {"layers": layers, "of": cfg.num_layers, "did_not_fit": cuts or None})
    stats["local_step_profile"] = profile
    stats["smoke_card_vs_cpu"] = smoke_train_cuda_vs_cpu(seed, arch)
    return stats, launches


def moe_gather_round(ops, card, seed: int, einsum_stats):
    """Phase 5i's granite-moe-3b-a800m rounds again with the ``gather``
    dispatch (the same weights, batches and gates): launches as the gates
    say, two rounds bit-identical (the dispatch's backward gathers, where
    ``index_select``'s would add by atomics), the rate-0.5 loss within bf16
    tolerance (3e-2) of the einsum dispatch's; seconds a step, peak memory
    and a profiled step's idle share beside einsum's."""
    from repro_torch.configs import get_config

    free_memory("cuda")
    cfg = get_config("granite-moe-3b-a800m").replace(moe_dispatch="gather")
    stats, profile, launches = train_full(ops, card, seed, cfg, dense_round_launches, evaluate_launches)
    check(stats["gates_rate_0.5"] == einsum_stats["gates_rate_0.5"], "the gather round drew other gates")
    diff = abs(stats["metrics"]["loss"] - einsum_stats["metrics"]["loss"])
    check(diff <= 3e-2, f"gather dispatch loss {stats['metrics']['loss']} vs einsum's "
                        f"{einsum_stats['metrics']['loss']}")
    side_by_side = {key: {"gather": stats[key], "einsum": einsum_stats[key]} for key in
                    ("s_per_local_step", "s_per_local_step_rate_0", "batch_rate_0", "peak_gib_rate_0.5",
                     "peak_gib_rate_0.0")}
    idle = [p["device_idle_share_profiled"] if p else None for p in (profile, einsum_stats["local_step_profile"])]
    return {"dispatch": "gather", "loss": stats["metrics"]["loss"], "einsum_loss": einsum_stats["metrics"]["loss"],
            "loss_abs_diff": diff, "atol": 3e-2, **side_by_side,
            "device_idle_share_profiled": {"gather": idle[0], "einsum": idle[1]}, "launches": launches,
            "bit_identical_rounds": True, "card": card}, launches


def moe_serve_full(api, ops, card, seed: int, arch: str):
    """Phase 5i's multi-tenant serving of ``arch`` as phase 4's
    (``serve_full``; llama4-scout-17b-a16e at ``LLAMA4_SERVE_LAYERS``):
    every MoE call of the run takes the weight gather (a decode step's 8
    tokens), flash_decode runs once and segmented_lora twice a layer a step,
    and the smoke model on the card agrees with the CPU twins."""
    from repro_torch.models import layers as layers_mod
    from repro_torch.nn import moe

    cfg = serving_cfg(arch)
    calls = {"moe_apply": 0, "weight_gather": 0}
    moe_apply, weight_gather = layers_mod.moe_apply, moe._moe_weight_gather

    def counted(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    layers_mod.moe_apply = counted("moe_apply", moe_apply)
    moe._moe_weight_gather = counted("weight_gather", weight_gather)
    try:
        stats, breakdown, launches = serve_full(api, ops, card, seed, arch, cfg=cfg)
    finally:
        layers_mod.moe_apply, moe._moe_weight_gather = moe_apply, weight_gather
    steps, n = stats["steps"], cfg.num_layers
    check(launches["flash_decode"] == n * steps and launches["segmented_lora"] == 2 * n * steps,
          f"serving {arch}: launches {launches} over {steps} steps of {n} layers")
    check(calls["weight_gather"] == calls["moe_apply"] > 0 and calls["moe_apply"] % n == 0,
          f"serving {arch}: MoE calls {calls}, each expected to take the weight gather")
    stats.update({"cut": SERVING_CUTS.get(arch), "moe_calls": calls, "decode_step_profile": breakdown,
                  "smoke_card_vs_cpu": smoke_cuda_vs_cpu(seed, arch)})
    return stats, launches


def moe_federated_full(api, ops, card, seed: int):
    """Phase 5i's federated run: ``api.build("droppeft",
    "granite-moe-3b-a800m", smoke=False)``, batched, 2 rounds, with phase
    5d's per-round checks (``federated_run``), then a smoke-size run
    batched on the card against sequential on the card and batched on the
    CPU twins."""
    runner, stats, _, _, launches = federated_run(api, ops, seed, "batched", arch="granite-moe-3b-a800m", rounds=2)
    del runner
    free_memory("cuda")
    stats["smoke_card_vs_cpu"] = federated_smoke_cuda_vs_cpu(seed, "granite-moe-3b-a800m")
    stats["card"] = card
    return stats, launches


def moe_family_full(api, ops, card, seed: int, flush):
    """Phase 5i: the ``moe`` family on the card (the module docstring).
    Returns its stats and each path's launches."""
    t0 = time.perf_counter()
    out, runs = {}, {}
    for arch in MOE_ARCHS:
        out[f"train {arch}"], runs[f"train {arch}"] = moe_train_full(ops, card, seed, arch, flush)
        print(f"5i train {arch} {json.dumps(out[f'train {arch}'])} [{card}]", flush=True)
        if arch == "granite-moe-3b-a800m":
            out["gather"], runs["gather"] = moe_gather_round(ops, card, seed, out[f"train {arch}"])
            print(f"5i gather dispatch {json.dumps(out['gather'])} [{card}]", flush=True)
    for arch in MOE_ARCHS:
        out[f"serve {arch}"], runs[f"serve {arch}"] = moe_serve_full(api, ops, card, seed, arch)
        print(f"5i serve {arch} {json.dumps(out[f'serve {arch}'])} [{card}]", flush=True)
    for arch in MOE_ARCHS:
        out[f"generate {arch}"], served = recurrent_serving_full(ops, card, seed, arch)
        runs[f"generate {arch}"] = served["run"]
        print(f"5i prefill and generate {arch} {json.dumps(out[f'generate {arch}'])} [{card}]", flush=True)
    out["federated"], runs["federated"] = moe_federated_full(api, ops, card, seed)
    print(f"5i federated {json.dumps(out['federated'])} [{card}]", flush=True)
    for path, names in (("train", ("flash_attention", "flash_attention_bwd", "lora_matmul")),
                        ("serve", ("segmented_lora", "flash_decode")), ("generate", ("flash_attention", "flash_decode"))):
        for arch in MOE_ARCHS:
            for name in names:
                check(runs[f"{path} {arch}"][name] > 0, f"{name} never launched in phase 5i's {path} {arch}")
    for name in ("flash_attention", "flash_attention_bwd", "lora_matmul"):
        check(runs["gather"][name] > 0 and runs["federated"][name] > 0, f"{name} never launched in phase 5i")
    return out, runs, time.perf_counter() - t0


STUB_WIDTHS = {"whisper q v cross_q": (384, 384, 16 * 512), "internvl q": (8192, 8192, 16 * 768),
               "internvl v": (8192, 1024, 16 * 768)}  # (K, N, M) of phase 5j's LoRA projections


def stub_frontend_shapes(ops, ref, ring_positions, timer, seed: int, card: str) -> dict:
    """Phase 3's cases at the stub-frontend families' shapes (phase 5j),
    drawn from a generator of their own: whisper-tiny's encoder
    self-attention (batch 16, 1 500 frames, bidirectional) and its
    decoder's cross-attention (512 queries over 1 500 frames, the backward
    dQ alone), both also in float32 at batch 2; flash_decode over whisper's
    ring (batch 8, 160 slots), over its 1 500 encoder slots (every slot
    live) and at internvl2-76b's serving step (64 heads over 8, 512
    slots); lora_matmul at whisper's q, v and cross q (K = N = 384, batch
    16 x 512) and internvl's q and v (batch 16 x (256 + 512)), and
    segmented_lora at internvl's (8 rows)."""
    gen_stub = torch.Generator(device="cuda")
    gen_stub.manual_seed(seed + 8)
    bf16 = torch.bfloat16
    stub_shapes = {
        "attention_whisper_encoder": attention_case(ops, ref, timer, gen_stub, dtype=bf16, s=1500, h=6, kv=6, d=64,
                                                    causal=False),
        "attention_whisper_cross": attention_case(ops, ref, timer, gen_stub, dtype=bf16, s=512, skv=1500, h=6, kv=6,
                                                  d=64, causal=False, dq_only=True),
        "decode_whisper_self": decode_case(ops, ref, ring_positions, timer, gen_stub, q_dtype=bf16, h=6, kv=6, d=64,
                                           s=SERVE_PROMPT + SERVE_GEN),
        "decode_whisper_cross": decode_case(ops, ref, ring_positions, timer, gen_stub, q_dtype=bf16, h=6, kv=6, d=64,
                                            s=1500, all_live=True),
        "decode_internvl": decode_case(ops, ref, ring_positions, timer, gen_stub, q_dtype=bf16, h=64, kv=8),
    }
    for name in list(stub_shapes):
        print(f"{name} {json.dumps(stub_shapes[name])} [{card}]", flush=True)
    for kw in ({"s": 1500}, {"s": 512, "skv": 1500, "dq_only": True}, {"s": 100, "skv": 1500}):
        case = attention_case(ops, ref, timer, gen_stub, dtype=torch.float32, b=2, h=6, kv=6, d=64, causal=False,
                              time_it=False, **kw)
        print(f"flash_attention check {json.dumps(case)}", flush=True)
    case = decode_case(ops, ref, ring_positions, timer, gen_stub, q_dtype=torch.float32, h=6, kv=6, d=64, s=1500,
                       all_live=True)
    keys = ("shape", "max_abs_err", "atol", "rel_l2_err", "rel_l2_limit")
    print(f"flash_decode check {json.dumps({k: case[k] for k in keys})}", flush=True)
    for name, (k, n, m) in STUB_WIDTHS.items():
        stub_shapes[f"lora {name}"] = lora_case(ops, ref, timer, gen_stub, dtype=bf16, n=n, k=k, m=m)
        print(f"lora_matmul {name} {json.dumps(stub_shapes[f'lora {name}'])} [{card}]", flush=True)
        if name.startswith("internvl"):
            stub_shapes[f"segmented {name}"] = segmented_case(ops, ref, timer, gen_stub, dtype=bf16, n=n, k=k)
            print(f"segmented_lora {name} {json.dumps(stub_shapes[f'segmented {name}'])} [{card}]", flush=True)
    return stub_shapes


WHISPER, INTERNVL = "whisper-tiny", "internvl2-76b"


def bwd_kernel_split(fns, params, peft, batches, seed: int) -> dict:
    """The attention backward's kernels in one local step (a one-step round
    under ``torch.profiler``, 64 spin kernels first: a window's first
    kernels may be lost), beside the step's gates: an encoder-decoder's
    cross-attention runs the dQ kernel alone, so the dQ kernel runs twice
    and the dK/dV kernel once in every active layer."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import stld
    from repro_torch.optim import adamw_init

    gates, sample_drops = [], stld.sample_drops

    def recorded(*args, **kw):
        drops = sample_drops(*args, **kw)
        gates.append(drops.tolist())
        return drops

    one = {key: val[:1] for key, val in batches.items()}
    stld.sample_drops = recorded
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(SPIN_KERNELS):
                torch.cuda._sleep(1000)
            fns.local_round(params, peft, adamw_init(peft), one, 0.5, torch.Generator().manual_seed(seed), 0)
            torch.cuda.synchronize()
    finally:
        stld.sample_drops = sample_drops
    events = device_kernels(prof)
    calls = {key: sum(e.count for e in events if key in e.key)
             for key in ("flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel")}
    active = active_count(gates)
    check(calls == {"flash_bwd_dq_bf16_kernel": 2 * active, "flash_bwd_dkv_bf16_kernel": active},
          f"whisper's backward kernels {calls} in a step of {active} active layers: expected the cross-attention's "
          "dQ kernel alone")
    return {"active_layers": active, **calls}


def whisper_full(ops, card, seed: int):
    """Phase 5j's whisper-tiny at full width (4 + 4 layers, d 384, 6 heads of
    64, vocab 51 865, 1 500 frames): one client's local round as phase 5's
    (rates 0.5 and 0.0, batch 16 x 512, launches from the gates with the
    encoder's attention and the cross-attention's dQ-only backward, the
    backward's kernels of one step counted by the profiler) and its smoke
    round on the card against the CPU twins; prefill and generate as phase
    5h's (frames from the seed; the float32 check's mutation zeroes the
    cross K/V); ``api.serve`` raising for the ``audio`` family."""
    from repro_torch import api
    from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
    from repro_torch.federated.client import make_client_fns

    cfg = get_config(WHISPER)

    def backward_kernels(c, params, peft):  # while train_full holds the weights
        fns = make_client_fns(c, PEFTConfig(), STLDConfig(), TrainConfig())
        return bwd_kernel_split(fns, params, peft, whisper_batches(c, seed), seed)

    stats, profile, launches = train_full(
        ops, card, seed, cfg, lambda gates: training_launches([g.count(False) for g in gates], cfg.num_encoder_layers),
        evaluate_launches, after=backward_kernels)
    stats["local_step_profile"] = profile
    stats["smoke_card_vs_cpu"] = smoke_train_cuda_vs_cpu(seed, WHISPER)
    try:
        api.serve(WHISPER, smoke=False, adapters={"a": {}})
        raise AssertionError("api.serve took the audio family")
    except NotImplementedError as err:
        check("'audio'" in str(err), f"api.serve's error names no family: {err}")
    return stats, launches


def whisper_batches(cfg, seed: int):
    """One local step's batch of phase 5j's round (16 x 512 tokens)."""
    from repro_torch.data.synthetic import make_task

    task = make_task(vocab_size=cfg.vocab_size, seq_len=512, num_examples=16, seed=seed)
    return train_batches(task, 1, 16)


def internvl_train_full(ops, card, seed: int):
    """Phase 5j's internvl2-76b local rounds as phase 5's (widths whole, 256
    zero patches before the 512 tokens) at the deepest cut from
    ``INTERNVL_TRAIN_LAYERS`` down at which the rounds at both rates fit at
    batch 16 (the cuts that did not fit printed), then its smoke round on
    the card against the CPU twins."""
    from repro_torch.configs import get_config

    cfg = get_config(INTERNVL)
    layers, cuts = INTERNVL_TRAIN_LAYERS, []
    while True:
        try:
            stats, profile, launches = train_full(ops, card, seed, cfg.replace(num_layers=layers),
                                                  dense_round_launches, evaluate_launches, rate0_batch_cut=False)
            break
        except torch.cuda.OutOfMemoryError as err:
            check(layers > 1, f"{INTERNVL}: a local round does not fit at 1 layer: {str(err).splitlines()[0][:200]}")
            cuts.append({"layers": layers, "error": str(err).splitlines()[0][:200]})
        layers -= 1
        free_memory("cuda")  # after the handler, whose traceback held the failed round's tensors
    stats["depth_cut"] = {"layers": layers, "of": cfg.num_layers, "did_not_fit": cuts or None}
    stats["local_step_profile"] = profile
    stats["smoke_card_vs_cpu"] = smoke_train_cuda_vs_cpu(seed, INTERNVL)
    return stats, launches


def internvl_serve_full(api, ops, card, seed: int):
    """Phase 5j's internvl2-76b serving at the deepest cut from
    ``INTERNVL_SERVE_LAYERS`` down (by 4) that fits: through ``api.serve``
    as phase 4 (text prompts, no patches, as the reference serves it;
    flash_decode once and segmented_lora twice a layer a step) with its
    smoke model on the card against the CPU twins, then through
    ``launch.serve``'s prefill and generate as phase 5h (patches from the
    seed; the float32 check at ``INTERNVL_F32_LAYERS``)."""
    from repro_torch.configs import get_config

    layers, cuts = INTERNVL_SERVE_LAYERS, []
    while True:
        cfg = get_config(INTERNVL).replace(num_layers=layers)
        try:
            stats, breakdown, launches = serve_full(api, ops, card, seed, INTERNVL, cfg=cfg)
            generate, served = recurrent_serving_full(ops, card, seed, INTERNVL, layers=layers)
            break
        except torch.cuda.OutOfMemoryError as err:
            check(layers > 4, f"{INTERNVL}: serving does not fit at {layers} layers: {str(err).splitlines()[0][:200]}")
            cuts.append({"layers": layers, "error": str(err).splitlines()[0][:200]})
        layers -= 4
        free_memory("cuda")
    steps = stats["steps"]
    check(launches["flash_decode"] == layers * steps and launches["segmented_lora"] == 2 * layers * steps,
          f"serving {INTERNVL}: launches {launches} over {steps} steps of {layers} layers")
    stats.update({"depth_cut": {"layers": layers, "of": 80, "did_not_fit": cuts or None},
                  "decode_step_profile": breakdown, "smoke_card_vs_cpu": smoke_cuda_vs_cpu(seed, INTERNVL)})
    return stats, launches, generate, served


def stub_frontends_full(api, ops, card, seed: int):
    """Phase 5j: whisper-tiny's encoder-decoder and internvl2-76b's patch
    prefix on the card (the module docstring).  Returns its stats and each
    path's launches."""
    t0 = time.perf_counter()
    out, runs = {}, {}
    out["train whisper"], runs["train whisper"] = whisper_full(ops, card, seed)
    print(f"5j train whisper {json.dumps(out['train whisper'])} [{card}]", flush=True)
    out["generate whisper"], served = recurrent_serving_full(ops, card, seed, WHISPER)
    runs["generate whisper"] = served["run"]
    print(f"5j prefill and generate whisper {json.dumps(out['generate whisper'])} [{card}]", flush=True)
    runner, fed, _, _, runs["federated whisper"] = federated_run(api, ops, seed, "batched", arch=WHISPER, rounds=2)
    del runner
    free_memory("cuda")
    fed["smoke_card_vs_cpu"] = federated_smoke_cuda_vs_cpu(seed, WHISPER)
    out["federated whisper"] = fed
    print(f"5j federated whisper {json.dumps(fed)} [{card}]", flush=True)
    out["train internvl"], runs["train internvl"] = internvl_train_full(ops, card, seed)
    print(f"5j train internvl {json.dumps(out['train internvl'])} [{card}]", flush=True)
    out["serve internvl"], runs["serve internvl"], out["generate internvl"], served = internvl_serve_full(
        api, ops, card, seed)
    runs["generate internvl"] = served["run"]
    print(f"5j serve internvl {json.dumps(out['serve internvl'])} [{card}]", flush=True)
    print(f"5j prefill and generate internvl {json.dumps(out['generate internvl'])} [{card}]", flush=True)
    for path, names in (("train", ("flash_attention", "flash_attention_bwd", "lora_matmul")),
                        ("generate", ("flash_attention", "flash_decode"))):
        for arch in ("whisper", "internvl"):
            for name in names:
                check(runs[f"{path} {arch}"][name] > 0, f"{name} never launched in phase 5j's {path} {arch}")
    for name in ("flash_attention", "flash_attention_bwd", "lora_matmul"):
        check(runs["federated whisper"][name] > 0, f"{name} never launched in phase 5j's federated whisper")
    for name in ("segmented_lora", "flash_decode"):
        check(runs["serve internvl"][name] > 0, f"{name} never launched serving internvl in phase 5j")
    return out, runs, time.perf_counter() - t0


# ------------------------------------------------------------------ phase 5k
# the history JSON's keys in the reference's CLI (src/repro/launch/train.py:179-195)
CLI_HISTORY_KEYS = ["accuracy", "arch", "compression", "cum_time_s", "energy_j", "fault_log", "final_accuracy",
                    "method", "schedule", "traffic_mb"]
CLI_SMOKE_ARCHS = ("qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b")
# A smoke run of the CLI computes in bf16 (the smoke configs' dtype, which
# the CLI does not set), and its random models sit near chance (accuracy
# 0.22-0.38): their top logits lie close together, within the bf16
# roundings by which the card's kernels and the CPU twins differ, so some
# validation predictions take the other label.  A round's accuracy (the
# mean over the cohort of ~50 predictions a device) may move by a
# twentieth; the float32 runs of the same CLI, where the roundings are
# ~1e-7, are held to equal accuracy.
CLI_SMOKE_ACC_LIMIT = {"bfloat16": 0.05, "float32": 0.0}
# the sharded decode: qwen3-1.7b's heads over a cache of 4 096 slots, half
# a rank; (query position, window) cases: both halves live, the window past
# rank 0's half, the query in rank 0's half (rank 1's half all in its future)
SHARDED_SHAPE = {"b": 8, "h": 16, "kv": 8, "d": 128, "s": 4096}
SHARDED_CASES = ((4095, None), (4095, 1024), (1000, None))
SHARDED_RANKS = 2
SHARDED_ATOL = 3e-2  # the bf16 tolerance of tests/test_kernels.py


def cli_main(argv):
    """``repro_torch.launch.train.main(argv)`` in this process, its report
    captured: (runner, result, the report's text)."""
    import contextlib
    import io

    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runner, result = train.main(argv)
    return runner, result, buf.getvalue()


class CliTrace:
    """While active, ``repro_torch.api.build`` is wrapped: the seconds of
    the build (from the CLI's start, with ``start``), of each sync round
    (ended by a device sync), and each round's cohort and rates (the
    algorithm's ``report``).  ``params``, when given, are the base weights
    the build takes (``api.build(params=...)``) instead of drawing them on
    the run's device."""

    def __init__(self, api, params=None):
        self.api, self.build, self.params = api, api.build, params
        self.start, self.setup_s, self.round_s, self.plans = time.perf_counter(), None, [], []

    def __enter__(self):
        def traced(*args, **kw):
            runner = self.build(*args, **kw) if self.params is None else self.build(*args, params=self.params, **kw)
            cuda = runner.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize()
            self.setup_s = time.perf_counter() - self.start
            sync_round, report = runner.scheduler._sync_round, runner.algorithm.report

            def timed_round(*a, **k):
                t0 = time.perf_counter()
                row = sync_round(*a, **k)
                if cuda:
                    torch.cuda.synchronize()
                self.round_s.append(time.perf_counter() - t0)
                return row

            def recorded(state, results):
                self.plans.append({"cohort": [int(d) for d in results.plan.cohort],
                                   "rates": [float(r) for r in results.plan.rates],
                                   "masks": np.asarray(results.masks).tolist()})
                return report(state, results)

            runner.scheduler._sync_round, runner.algorithm.report = timed_round, recorded
            return runner

        self.api.build = traced
        return self

    def __exit__(self, *exc):
        self.api.build = self.build


def saved_tree(ckpt_dir: Path, cfg, step: int):
    """The global LoRA that the CLI saved under ``ckpt_dir`` (``save_pytree``
    at ``<ckpt-dir>/<cfg.name>``), loaded on the CPU with ``load_pytree``."""
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs import PEFTConfig
    from repro_torch.core.peft import init_peft

    return load_pytree(init_peft(cfg, PEFTConfig(), torch.Generator()), str(ckpt_dir / cfg.name / f"step_{step:08d}"))


def cli_history(path: Path, rounds: int) -> dict:
    """The history JSON at ``path``: the reference's keys, ``rounds`` rows,
    every number finite."""
    hist = json.loads(path.read_text())
    check(sorted(hist) == CLI_HISTORY_KEYS, f"{path.name}: keys {sorted(hist)}, the reference's {CLI_HISTORY_KEYS}")
    rows = [hist[key] for key in ("accuracy", "cum_time_s", "traffic_mb", "energy_j")]
    check(all(len(r) == rounds for r in rows), f"{path.name}: rows {[len(r) for r in rows]}, expected {rounds}")
    check(all(math.isfinite(v) for r in rows for v in r) and math.isfinite(hist["final_accuracy"]),
          f"{path.name}: a row is not finite: {hist}")
    return hist


def cli_full_width(api, ops, seed: int, work: Path):
    """Phase 5k's full-width runs of ``python -m repro_torch.launch.train
    --arch qwen3-1.7b`` at the parser's defaults (16 devices, 4 a round, 4
    local steps of batch 16, droppeft, batched): as a process of its own
    for 2 rounds with ``--state-dir``; resumed from it to 3 rounds; an
    uninterrupted 3-round run, counted by the launch counters, against the
    resumed one and against ``api.build`` with the same arguments; the
    deadline-carry-``int8+topk`` run with the shorthand fault flags against
    ``--fault-plan``.  Returns (stats, the counted run's launches)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.stacking import tree_leaves

    cfg, base = get_config("qwen3-1.7b"), ["--arch", "qwen3-1.7b", "--seed", str(seed)]
    out = {}
    # as users run it: a process of its own
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *base, "--rounds", "2", "--state-dir",
           str(work / "state"), "--ckpt-dir", str(work / "ckpt2"), "--out", str(work / "h2.json")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    out["process_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"the training CLI exited {proc.returncode}: {proc.stdout[-2000:]} {proc.stderr[-4000:]}")
    h2 = cli_history(work / "h2.json", 2)
    tree2 = saved_tree(work / "ckpt2", cfg, 2)
    check(all(torch.isfinite(t).all() for t in tree_leaves(tree2)), "the CLI's saved global LoRA is not finite")
    wall = re.search(r"wall time: ([0-9.]+)s", proc.stdout)
    out["process_wall_line_s"] = float(wall.group(1)) if wall else None
    out["process_report"] = [ln for ln in proc.stdout.splitlines() if ln.startswith(("round", "final"))]
    free_memory("cuda")

    # resumed from the process's state to 3 rounds, then an uninterrupted
    # 3-round run counted by the launch counters
    runner, result, _ = cli_main([*base, "--rounds", "3", "--resume", "--state-dir", str(work / "state"),
                                  "--ckpt-dir", str(work / "ckpt3r"), "--out", str(work / "h3r.json")])
    check(runner.state.round_index == 3 and result.rounds == 3, f"resumed to round {runner.state.round_index}")
    del runner
    free_memory("cuda")
    argv3 = [*base, "--rounds", "3", "--ckpt-dir", str(work / "ckpt3"), "--out", str(work / "h3.json")]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with CliTrace(api) as trace:
        runner, result, report = cli_main(argv3)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - trace.start
    launches, routes = dict(ops.launch_counts), dict(ops.lora_matmul_routes)
    peak = torch.cuda.max_memory_allocated() / 2.0**30
    h3, h3r = cli_history(work / "h3.json", 3), cli_history(work / "h3r.json", 3)
    tree3, tree3r = saved_tree(work / "ckpt3", cfg, 3), saved_tree(work / "ckpt3r", cfg, 3)
    check(h3r == h3 and tree_equal(tree3r, tree3), "the CLI resumed from round 2 differs from the uninterrupted run")
    check(tree_equal(tree3, cpu_tree(runner.state.global_peft)),
          "the saved global LoRA differs from the run's")
    for key in ("accuracy", "cum_time_s", "traffic_mb", "energy_j"):  # the warm-up's rates: the same first rounds
        check(h3[key][:2] == h2[key], f"the process's 2 rounds differ from the 3-round run's first two: {key}")
    for name in ("flash_attention", "flash_attention_bwd", "lora_matmul"):
        check(launches[name] > 0, f"{name} never launched in the training CLI's run: {launches}")
    check(routes == {"fma": 0, "wmma": 0, "wgmma": launches["lora_matmul"]}, f"the CLI's lora_matmul routes {routes}")
    del runner
    free_memory("cuda")
    # api.build with the same arguments launches the same kernels and gives the same run
    args = train.build_parser().parse_args(argv3)
    ops.reset_launch_counts()
    same = api.build(args.method, **train.build_kwargs(args, None))
    same_result = same.run(rounds=args.rounds)
    same_launches = dict(ops.launch_counts)
    check(same_launches == launches, f"the CLI launched {launches}, api.build with its arguments {same_launches}")
    check(json.loads(json.dumps(train.history(args, same.ctx.cfg, same, same_result))) == h3,
          "api.build with the CLI's arguments gives another history")
    del same
    free_memory("cuda")
    out.update(rounds=3, setup_s=trace.setup_s, s_per_round=trace.round_s, wall_s=wall_s, peak_gib=peak,
               launches=launches, routes=routes, resume_bit_identical=True, launches_equal_api_build=True,
               history_keys=CLI_HISTORY_KEYS, history=h3, report=[ln for ln in report.splitlines()
                                                                 if ln.startswith(("round", "final", "wall"))])

    # schedules and faults: the shorthand flags against a plan file of the same fields
    sched = ["--rounds", "2", "--schedule", "deadline", "--straggler", "carry", "--compression", "int8+topk"]
    runner, _, report = cli_main([*base, *sched, "--fault-dropout", "0.1", "--fault-nan", "0.05",
                                  "--ckpt-dir", str(work / "ckpt_flags"), "--out", str(work / "h_flags.json")])
    del runner
    free_memory("cuda")
    summary = [ln for ln in report.splitlines() if ln.startswith("faults: ")]
    check(len(summary) == 1, f"no fault summary in the CLI's report: {report[-2000:]}")
    plan = work / "plan.json"
    plan.write_text(json.dumps({"dropout_prob": 0.1, "nan_update_prob": 0.05, "seed": seed}))
    runner, _, _ = cli_main([*base, *sched, "--fault-plan", str(plan), "--ckpt-dir", str(work / "ckpt_plan"),
                             "--out", str(work / "h_plan.json")])
    del runner
    free_memory("cuda")
    flags, from_plan = cli_history(work / "h_flags.json", 2), cli_history(work / "h_plan.json", 2)
    check(from_plan == flags and tree_equal(saved_tree(work / "ckpt_plan", cfg, 2), saved_tree(work / "ckpt_flags", cfg, 2)),
          "--fault-plan with the flags' fields gives another run")
    out["faults"] = {"summary": summary[0], "fault_log": flags["fault_log"], "schedule": flags["schedule"],
                     "compression": flags["compression"], "accuracy": flags["accuracy"],
                     "plan_file_bit_identical": True}
    return out, launches


def cpu_tree(tree):
    """A tree's leaves on the CPU, in its structure."""
    from repro_torch.models.stacking import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def cli_smoke_cuda_vs_cpu(api, ops, seed: int, arch: str, work: Path, dtype: str = "bfloat16"):
    """The CLI at ``--smoke`` (the parser's defaults, 2 rounds) on the card
    against ``--device cpu``, in bf16 as users run it, or in float32 (the
    CLI's ``get_config`` patched to the float32 smoke config), both from the
    same base weights (drawn on the CPU from ``seed`` and handed to the
    build: each run otherwise draws them on its own device, and the card's
    generator is not the CPU's, while the LoRA, gates and every numpy
    stream are drawn on the host alike): cohorts,
    rates, the modelled time, traffic and energy equal; the saved LoRA
    within phase 5d's bound (every element within 2 x the summed step sizes
    + 1e-6, and in float32 99% within 1e-6); accuracy within
    ``CLI_SMOKE_ACC_LIMIT``.  Returns (stats, the card run's launches)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch import train
    from repro_torch.models.registry import init_params
    from repro_torch.models.stacking import tree_leaves
    from repro_torch.optim import make_lr_schedule

    cfg, runs = get_config(arch, smoke=True), {}
    params = init_params(cfg, torch.Generator().manual_seed(seed))
    for device in ("cuda", "cpu"):
        tag = f"{arch}-{dtype}-{device}"
        ops.reset_launch_counts()
        real_get_config = train.get_config
        if dtype == "float32":
            train.get_config = lambda arch_id, smoke=False: real_get_config(arch_id, smoke=smoke).replace(
                dtype="float32")
        try:
            with CliTrace(api, params) as trace:
                runner, _, _ = cli_main(["--arch", arch, "--smoke", "--rounds", "2", "--seed", str(seed),
                                              "--device", device, "--ckpt-dir", str(work / f"ckpt-{tag}"), "--out",
                                              str(work / f"{tag}.json")])
        finally:
            train.get_config = real_get_config
        check(runner.ctx.cfg.dtype == dtype, f"the smoke run computed in {runner.ctx.cfg.dtype}")
        fed = runner.ctx.fed_cfg
        del runner
        runs[device] = {"plans": trace.plans, "hist": cli_history(work / f"{tag}.json", 2),
                        "peft": tree_leaves(saved_tree(work / f"ckpt-{tag}", cfg, 2)), "launches": dict(ops.launch_counts),
                        "s_per_round": trace.round_s}
    card, cpu = runs["cuda"], runs["cpu"]
    what = f"{arch} smoke CLI ({dtype}) on the card vs --device cpu"
    for key in ("cohort", "rates"):
        check([p[key] for p in card["plans"]] == [p[key] for p in cpu["plans"]], f"{what}: {key} differ")
    for key in ("cum_time_s", "traffic_mb", "energy_j"):
        check(card["hist"][key] == cpu["hist"][key], f"{what}: {key} {card['hist'][key]} vs {cpu['hist'][key]}")
    train_cfg = TrainConfig(learning_rate=5e-3, total_steps=2 * fed.local_steps)  # the CLI's
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.total_steps)
    limit = 2 * sum(sched(step) for step in range(2 * fed.devices_per_round * fed.local_steps)) + 1e-6
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(card["peft"], cpu["peft"])])
    within = float((diffs <= 1e-6).float().mean())
    check(float(diffs.max()) <= limit and (dtype == "bfloat16" or within >= 0.99),
          f"{what}: LoRA max diff {float(diffs.max())} (limit {limit}), {within} within 1e-6")
    acc_err = max(abs(a - b) for a, b in zip(card["hist"]["accuracy"] + [card["hist"]["final_accuracy"]],
                                              cpu["hist"]["accuracy"] + [cpu["hist"]["final_accuracy"]]))
    check(acc_err <= CLI_SMOKE_ACC_LIMIT[dtype],
          f"{what}: accuracy differs by {acc_err} > {CLI_SMOKE_ACC_LIMIT[dtype]}")
    return {"arch": arch, "dtype": dtype, "rounds": 2, "cohorts_rates_time_traffic_energy_equal": True,
            "masks_equal": [p["masks"] for p in card["plans"]] == [p["masks"] for p in cpu["plans"]],
            "peft_max_abs_diff": float(diffs.max()), "peft_limit": limit,
            "peft_share_within_1e-6": within,
            "accuracy_max_abs_diff": acc_err, "accuracy_limit": CLI_SMOKE_ACC_LIMIT[dtype],
            "accuracy_card": card["hist"]["accuracy"], "accuracy_cpu": cpu["hist"]["accuracy"],
            "s_per_round_card": card["s_per_round"], "s_per_round_cpu": cpu["s_per_round"]}, card["launches"]


def simulator_vs_experiment(api, seed: int):
    """``FederatedSimulator`` at smoke size on the card (its device default)
    warns and gives ``api.experiment``'s result with the same arguments,
    bit for bit."""
    import warnings

    from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
    from repro_torch.federated.simulator import FederatedSimulator

    kw = dict(cfg=get_config("qwen3-1.7b", smoke=True), peft_cfg=PEFTConfig(), stld_cfg=STLDConfig(),
              fed_cfg=FederatedConfig(num_devices=6, devices_per_round=4, local_steps=2, batch_size=8),
              train_cfg=TrainConfig())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sim = FederatedSimulator(*kw.values(), strategy="droppeft", seed=seed)
    check(any(issubclass(w.category, DeprecationWarning) for w in caught), "FederatedSimulator did not warn")
    check(sim.runner.device.type == "cuda", f"FederatedSimulator ran on {sim.runner.device}")
    got = sim.run(rounds=2)
    want = api.experiment("droppeft", rounds=2, seed=seed, **kw)
    same = all(np.array_equal(getattr(got, f), getattr(want, f)) if isinstance(getattr(want, f), np.ndarray)
               else getattr(got, f) == getattr(want, f) for f in want.__dataclass_fields__)
    check(same, f"FederatedSimulator {got} vs api.experiment {want}")
    return {"rounds": 2, "bit_identical": True, "accuracy": got.accuracy.tolist(), "cohort_mode": sim.cohort_mode}


def sharded_decode_rank(rank: int, world: int, port: int, seed: int, out_path: str, repeats: int):
    """One rank of the sharded decode (``torch.multiprocessing.spawn``): a
    gloo group of ``world`` ranks on the one card, each holding its slice of
    the cache along the sequence; rank 0 saves every case's output and the
    median ms a call (CUDA events, each call after a barrier)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.serving.decode import sharded_decode_attention

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", (world,), mesh_dim_names=("data",))
        q, k, v = sharded_decode_inputs(seed)
        shard = k.shape[1] // world
        part = slice(rank * shard, (rank + 1) * shard)
        kl, vl = k[:, part].contiguous(), v[:, part].contiguous()
        kpos = torch.arange(k.shape[1], device="cuda")[part]
        results = []
        for q_position, window in SHARDED_CASES:
            fn = lambda: sharded_decode_attention(mesh, q, kl, vl, kpos, q_position, window=window)  # noqa: E731
            out = fn()
            times = []
            for _ in range(repeats):
                dist.barrier()
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            results.append({"out": out.cpu(), "ms": statistics.median(times)})
        torch.save(results, f"{out_path}.rank{rank}")
    finally:
        dist.destroy_process_group()


def sharded_decode_inputs(seed: int):
    """q (B, H, D), k and v (B, S, KV, D) in bf16 on the card, drawn on the
    CPU from ``seed`` (the same on every rank)."""
    gen = torch.Generator().manual_seed(seed)
    b, h, kv, d, s = (SHARDED_SHAPE[key] for key in ("b", "h", "kv", "d", "s"))
    return [torch.randn(shape, generator=gen).to(device="cuda", dtype=torch.bfloat16)
            for shape in ((b, h, d), (b, s, kv, d), (b, s, kv, d))]


def sharded_decode_check(ops, ref, timer, seed: int, work: Path):
    """``serving.decode.sharded_decode_attention`` over ``SHARDED_RANKS``
    gloo ranks on the one card (NCCL takes one rank a GPU), each with its
    part of a qwen3-1.7b-shaped bf16 cache, against ``ops.flash_decode``
    and its twin ``ref.decode_attention_plain`` over the whole cache: the
    relative L2 error within ``BF16_REL_L2`` and the largest within
    ``SHARDED_ATOL``, for each of ``SHARDED_CASES``; ms a call beside
    flash_decode's."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    path = str(work / "sharded")
    t0 = time.perf_counter()
    mp.spawn(sharded_decode_rank, args=(SHARDED_RANKS, port, seed, path, 20), nprocs=SHARDED_RANKS, join=True)
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(f"{path}.rank{r}") for r in range(SHARDED_RANKS)]
    q, k, v = sharded_decode_inputs(seed)
    b, s = q.shape[0], k.shape[1]
    kpos = torch.arange(s, dtype=torch.int32, device="cuda").expand(b, s).contiguous()
    cases = []
    for i, (q_position, window) in enumerate(SHARDED_CASES):
        qpos = torch.full((b,), q_position, dtype=torch.int32, device="cuda")
        got = ranks[0][i]["out"].cuda()
        check(all(torch.equal(r[i]["out"], ranks[0][i]["out"]) for r in ranks), "the ranks' merged outputs differ")
        kernel = ops.flash_decode(q, k, v, qpos, kpos, window=window)
        twin = ref.decode_attention_plain(q, k, v, qpos, kpos, window=window)
        errs = {name: {"rel_l2": rel_l2(got, want), "max_abs": (got.float() - want.float()).abs().max().item()}
                for name, want in (("flash_decode", kernel), ("twin", twin))}
        what = f"sharded decode, query at {q_position}, window {window}"
        for name, e in errs.items():
            check(e["rel_l2"] <= BF16_REL_L2 and e["max_abs"] <= SHARDED_ATOL,
                  f"{what} vs {name}: {e} over rel L2 {BF16_REL_L2} or {SHARDED_ATOL}")
        shard = s // SHARDED_RANKS
        masked = [r for r in range(SHARDED_RANKS)
                  if r * shard > q_position or (window and (r + 1) * shard - 1 <= q_position - window)]
        flash_ms = timer(lambda: ops.flash_decode(q, k, v, qpos, kpos, window=window))
        cases.append({"query_position": q_position, "window": window, "wholly_masked_ranks": masked, "errors": errs,
                      "ms": ranks[0][i]["ms"], "flash_decode_ms": flash_ms})
    check(cases[1]["wholly_masked_ranks"] == [0] and cases[2]["wholly_masked_ranks"] == [1],
          f"the masked cases mask {[c['wholly_masked_ranks'] for c in cases]}")
    return {"shape": f"B={b} H={q.shape[1]} KV={k.shape[2]} D={q.shape[2]} S={s} bfloat16, {SHARDED_RANKS} gloo "
                     f"ranks on one card, S/{SHARDED_RANKS} each", "rel_l2_limit": BF16_REL_L2, "atol": SHARDED_ATOL,
            "cases": cases, "spawn_s": spawn_s}


def cli_shapes(ops, ref, timer, seed: int, card: str) -> dict:
    """Phase 3's cases at the shapes the training CLI's defaults give its
    full-width rounds (qwen3-1.7b, a cohort of 4 devices x 16 x 32 tokens,
    batched): flash_attention over the 4 devices' rows (batch 64 x 32) and
    the grouped lora_matmul at G 4 x 512 rows, q and v; drawn from a
    generator of their own."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 9)
    shapes = {"attention": attention_case(ops, ref, timer, gen, dtype=torch.bfloat16, b=64, s=32)}
    for name, n in (("grouped q", 2048), ("grouped v", 1024)):
        shapes[name] = grouped_lora_case(ops, ref, timer, gen, dtype=torch.bfloat16, g=4, n=n)
    for name, case in shapes.items():
        print(f"train CLI shape {name} {json.dumps(case)} [{card}]", flush=True)
    return shapes


def train_cli_full(api, ops, ref, timer, card, seed: int):
    """Phase 5k: the training CLI (``launch/train.py``), ``FederatedSimulator``
    and the sharded decode on the card (the module docstring).  Returns
    (stats, the launches of each path, its seconds)."""
    import shutil

    t0 = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_cli"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out, runs = {}, {}
    out["full width"], runs["train_cli"] = cli_full_width(api, ops, seed, work)
    print(f"5k train CLI {json.dumps(out['full width'])} [{card}]", flush=True)
    for arch in CLI_SMOKE_ARCHS:
        for dtype in ("bfloat16", "float32"):
            out[f"smoke {arch} {dtype}"], launched = cli_smoke_cuda_vs_cpu(api, ops, seed, arch, work, dtype)
            if dtype == "bfloat16":  # the smoke run as users run it
                runs[f"train_cli_smoke_{arch}"] = launched
            print(f"5k train CLI smoke, card vs --device cpu: {json.dumps(out[f'smoke {arch} {dtype}'])}", flush=True)
    for arch, names in (("rwkv6-3b", ("wkv6", "wkv6_bwd")), ("jamba-v0.1-52b", ("mamba_scan", "mamba_scan_bwd"))):
        for name in names:
            check(runs[f"train_cli_smoke_{arch}"][name] > 0, f"{name} never launched in the {arch} smoke CLI run")
    out["simulator"] = simulator_vs_experiment(api, seed)
    print(f"5k FederatedSimulator vs api.experiment {json.dumps(out['simulator'])}", flush=True)
    free_memory("cuda")
    out["sharded decode"] = sharded_decode_check(ops, ref, timer, seed, work)
    print(f"5k sharded decode {json.dumps(out['sharded decode'])} [{card}]", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return out, runs, time.perf_counter() - t0


# ------------------------------------------------------------------ phase 5l
META_PEAK_TOLERANCE = 0.10  # meta's peak of a train step against the card's max_memory_allocated
META_TRAIN = {"batch": 16, "seq": 512}
META_DECODE = {"batch": 8, "slots": 512}
GUARD_POLICIES = ("sync", "deadline", "async-buffer")


def subprocess_env() -> dict:
    """The environment of the phase's subprocesses: the checkout's ``src`` on
    the path, one intra-op thread each (the dry run computes nothing)."""
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


DRYRUN_MESHES = ("16x16", "2x16x16")


def start_dryrun_sweeps(out_dir: Path) -> dict:
    """Phase 5l (a), started: ``python -m repro_torch.launch.dryrun --arch
    all --shape <shape>`` for each input shape on each mesh, one process
    each (a mesh's 40 cells in one process took 88 s on a slow host),
    writing under ``out_dir``; keyed by (mesh, shape)."""
    import shutil

    from repro_torch.configs import INPUT_SHAPES

    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}  # (mesh, shape): (process, its start on the host's clock)
    for mesh in DRYRUN_MESHES:
        for shape in INPUT_SHAPES:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all", "--shape", shape,
                   "--out-dir", str(out_dir / mesh)] + (["--multi-pod"] if mesh == "2x16x16" else [])
            procs[mesh, shape] = (subprocess.Popen(cmd, cwd=ROOT, env=subprocess_env(), stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True), time.perf_counter())
    return procs


def start_analysis() -> dict:
    """Phase 5l (d), started: ``python -m repro_torch.analysis`` (its guard on
    the card) and ``--self-test``, each a process of its own."""
    procs = {}
    for name, extra in (("analysis", []), ("self-test", ["--self-test"])):
        procs[name] = (subprocess.Popen([sys.executable, "-m", "repro_torch.analysis", *extra], cwd=ROOT,
                                        env=subprocess_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), time.perf_counter())
    return procs


def finish(procs: dict, timeout: float) -> dict:
    """(exit code, output, seconds from its start to its exit, as far as
    this wait sees it) of each started process, waited for; a process still
    running after ``timeout`` seconds of waiting is killed."""
    out = {}
    t0 = time.perf_counter()
    for name, (proc, start) in procs.items():
        try:
            text, _ = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            text += f"\n(killed after {timeout} s)"
        out[name] = (proc.returncode, text, time.perf_counter() - start)
    return out


def sweep_records(out_dir: Path, mesh: str) -> list:
    """The dry run's cell records of one mesh, each held to be ``ok`` or the
    reference's skip record for an inapplicable cell."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, shape_applicable

    recs = []
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            path = out_dir / mesh / f"{arch}__{shape}__{mesh}.json"
            check(path.exists(), f"dry run wrote no record for {arch} {shape} {mesh}")
            rec = json.loads(path.read_text())
            if shape_applicable(arch, shape):
                check(rec.get("ok") is True, f"dry run cell {arch} {shape} {mesh} failed: {rec.get('error')}")
            else:
                check(rec == {"arch": arch, "shape": shape, "mesh": mesh, "ok": False, "skipped": True,
                              "reason": "long-context decode inapplicable (DESIGN.md skip matrix)"},
                      f"dry run cell {arch} {shape} {mesh}: not the reference's skip record: {rec}")
            recs.append(rec)
    return recs


def tree_bytes(tree) -> int:
    from repro_torch.analysis.trace import tree_tensors

    return sum(t.numel() * t.element_size() for t in tree_tensors(tree))


class GateReplay:
    """Records the STLD gates ``stld.sample_drops`` draws in a card run and
    hands the same gates, in order, to the meta run."""

    def __init__(self):
        from repro_torch.core import stld

        self.stld, self.draw, self.gates = stld, stld.sample_drops, []

    def record(self):
        def recorded(*args, **kw):
            self.gates.append(self.draw(*args, **kw))
            return self.gates[-1]

        self.stld.sample_drops = recorded
        return self

    def replay(self):
        gates = iter(self.gates)
        self.stld.sample_drops = lambda *args, **kw: next(gates)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stld.sample_drops = self.draw
        return False


def meta_vs_card(ops, name: str, step, make_card_args, meta_args, meta_arg_bytes: int, *, peak: bool,
                 device: str = "cuda", fresh_args: bool = True) -> tuple:
    """One step of phase 5l (b): run ``step`` on the card (``make_card_args()``
    builds its arguments there) and on ``meta_args``; the launch counts must
    be equal, kernel for kernel, and ``meta_arg_bytes`` (the dry run's
    argument bytes at a 1 x 1 mesh) must equal the bytes of the card's
    trees; with ``peak``, the meta run's peak lies within
    ``META_PEAK_TOLERANCE`` of the card's ``max_memory_allocated`` above
    what was allocated before the arguments (not ``fresh_args``: they
    existed before, and the card's peak is not reported).  With ``device="cpu"`` (a
    rehearsal) the twins run and nothing launches: the launches and the
    peak are not compared.  Returns (stats, the card's launches)."""
    from repro_torch.analysis.trace import run_on_meta

    free_memory(device)
    on_card = device == "cuda"
    m0 = torch.cuda.memory_allocated() if on_card else 0
    replay = GateReplay().record()
    with replay:
        card_args = make_card_args()
        card_bytes = tree_bytes(card_args)
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = step(*card_args)
        if on_card:
            torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        card_peak = torch.cuda.max_memory_allocated() - m0 if on_card and fresh_args else None
        launches = {k: v for k, v in ops.launch_counts.items() if v}
        del out, card_args
        free_memory(device)
        replay.replay()
        run = run_on_meta(step, *meta_args)
    check(meta_arg_bytes == card_bytes, f"5l {name}: the dry run's argument bytes {meta_arg_bytes} at 1 x 1, the "
                                        f"card's trees {card_bytes}")
    check(not run.host_reads, f"5l {name}: host reads on meta {run.host_reads}")
    stats = {"step": name, "card_s": card_s, "meta_s": run.seconds, "launches": launches,
             "meta_launches": run.kernel_launches, "argument_bytes": meta_arg_bytes, "meta_peak_bytes": run.peak_bytes,
             "card_peak_bytes": card_peak, "meta_flops": run.flops, "meta_bytes_accessed": run.bytes_accessed}
    if on_card:
        check(launches == run.kernel_launches, f"5l {name}: launches on the card {launches}, on meta "
                                               f"{run.kernel_launches}")
    if on_card and peak:
        gap = run.peak_bytes / card_peak - 1.0
        stats["peak_gap"] = gap
        check(abs(gap) <= META_PEAK_TOLERANCE, f"5l {name}: meta peak {run.peak_bytes} B against the card's "
                                               f"{card_peak} B ({gap:+.3f})")
    return stats, launches


def meta_vs_card_steps(ops, api, seed: int, card: str = "", device: str = "cuda", smoke: bool = False) -> tuple:
    """Phase 5l (b): each step on the card and on ``meta`` (``meta_vs_card``):
    qwen3-1.7b's train step at 16 x 512 at rates 0.0 and 0.5, jamba-v0.1-52b
    cut to 8 layers (phase 5c's cut) and rwkv6-3b trained likewise, a
    qwen3-1.7b decode step over 512 slots, and one ``api.serve``
    multi-tenant step.  The meta arguments come from
    ``launch.input_specs`` at a 1 x 1 mesh (``weights_dtype="placed"``,
    the card's placement), the serve step's from its captured call.
    ``smoke`` takes the smoke configs (the CPU rehearsal).  Returns (stats
    by step, the card's launches by step)."""
    from repro_torch.analysis.trace import meta_like
    from repro_torch.configs import InputShape, PEFTConfig, TrainConfig, get_config
    from repro_torch.core.peft import init_peft
    from repro_torch.launch import input_specs as ispec
    from repro_torch.launch.dryrun import argument_bytes
    from repro_torch.launch.steps import make_serve_step, make_train_step
    from repro_torch.models.registry import init_params
    from repro_torch.models.transformer import init_caches
    from repro_torch.optim import adamw_init

    mesh = ispec.MeshShape({"data": 1, "model": 1})
    pcfg, tcfg = PEFTConfig(), TrainConfig()
    b, s = (2, 32) if smoke else (META_TRAIN["batch"], META_TRAIN["seq"])
    stats, runs = {}, {}

    def gen():
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        return g

    def train(name, cfg, rate):
        step = make_train_step(cfg, pcfg, tcfg, stld_mode="cond", mean_rate=rate)

        def card_args():
            g = gen()
            params = init_params(cfg, g, place=True)
            peft = init_peft(cfg, pcfg, g)
            tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g, device=device, dtype=torch.int32)
            return params, peft, adamw_init(peft), {"tokens": tokens}, torch.Generator().manual_seed(seed)

        args, specs = ispec.train_inputs(cfg, pcfg, InputShape(name, s, b, "train"), mesh, weights_dtype="placed")
        stats[name], runs[name] = meta_vs_card(ops, name, step, card_args, args, argument_bytes(args, specs, mesh),
                                               peak=True, device=device)

    qwen3 = get_config("qwen3-1.7b", smoke=smoke)
    for rate in (0.0, 0.5):
        train(f"train_qwen3_rate{rate}", qwen3, rate)
    jamba = get_config("jamba-v0.1-52b", smoke=smoke)
    train("train_jamba", jamba if smoke else jamba.replace(num_layers=8), 0.5)
    train("train_rwkv6", get_config("rwkv6-3b", smoke=smoke), 0.5)

    bd, slots = (2, 16) if smoke else (META_DECODE["batch"], META_DECODE["slots"])
    step = make_serve_step(qwen3)

    def decode_args():
        g = gen()
        params = init_params(qwen3, g, place=True)
        token = torch.randint(0, qwen3.vocab_size, (bd, 1), generator=g, device=device, dtype=torch.int32)
        return params, token, slots - 1, ispec.set_cache_position(init_caches(qwen3, bd, slots, device=device),
                                                                   slots - 1)

    args, specs = ispec.serve_inputs(qwen3, InputShape("decode", slots, bd, "decode"), mesh, weights_dtype="placed")
    check(args[2] == slots - 1, f"the dry run decodes at {args[2]}, the card at {slots - 1}")
    stats["decode_qwen3"], runs["decode_qwen3"] = meta_vs_card(
        ops, "decode_qwen3", step, decode_args, args, argument_bytes(args, specs, mesh), peak=False, device=device)

    # one api.serve step: its call captured on the card, then run on meta
    free_memory(device)
    g = gen()
    batcher = api.serve(cfg=qwen3, adapters=make_tenants(qwen3, g), batch=bd, max_len=slots, seed=seed,
                        device=device)
    from repro_torch.serving.batcher import Request

    batcher.submit(Request(prompt=[1, 2, 3], adapter="tenant0", max_new_tokens=4, uid=0))
    batcher.submit(Request(prompt=[4, 5], adapter="tenant1", max_new_tokens=4, uid=1))
    serve_step, captured = batcher.serve_step, {}

    def capture(*a, **kw):
        captured.update(args=a, kw=kw)
        return serve_step(*a, **kw)

    batcher.serve_step = capture
    batcher.step()  # admits both, loads their adapters
    captured_args = captured["args"] + (captured["kw"]["peft"],)
    meta_args = meta_like(captured_args)
    del batcher

    def pooled_step(params, token, pos, caches, peft):
        return serve_step(params, token, pos, caches, peft=peft)

    stats["serve_api"], runs["serve_api"] = meta_vs_card(
        ops, "serve_api", pooled_step, lambda: captured_args, meta_args, tree_bytes(meta_args), peak=False,
        device=device, fresh_args=False)
    if device == "cuda":
        seen = set().union(*(set(r) for r in runs.values()))
        check(seen == set(ops._build.KERNELS), f"5l (b) launched {sorted(seen)}, not every kernel library")
    for name, row in stats.items():
        print(f"5l meta vs card {json.dumps(row)} [{card}]", flush=True)
    return stats, runs


def dryrun_and_analysis_full(ops, api, card: str, seed: int) -> tuple:
    """Phase 5l: (a) the dry-run sweep of every arch x shape x mesh on
    ``meta``, (b) ``meta_vs_card_steps``, (c) the steady-state guard on the
    card for every schedule policy, (d) ``python -m repro_torch.analysis``
    and ``--self-test``.  (a) and (d) run as processes of their own, started
    first, and are waited for after (b) and (c).  Returns (stats, the card's
    launches of (b) by step, the phase's seconds)."""
    from repro_torch.analysis.recompile_guard import DEFAULT_BUDGETS, check_experiment_recompiles

    t0 = time.perf_counter()
    out_dir = ROOT / "build" / "dryrun_torch"
    sweeps, analysis = start_dryrun_sweeps(out_dir), start_analysis()
    stats = {}
    stats["meta_vs_card"], runs = meta_vs_card_steps(ops, api, seed, card)

    report = {}
    violations = check_experiment_recompiles(policies=GUARD_POLICIES, device="cuda", report=report)
    check(not violations, f"5l steady-state guard: {[v.render() for v in violations]}")
    for policy, row in report.items():
        check(row["budget"] == DEFAULT_BUDGETS[policy] and row["setups"] <= row["budget"], f"5l guard {policy}: {row}")
    stats["guard"] = report
    print(f"5l steady-state guard {json.dumps(report)} [{card}]", flush=True)

    done = finish({**sweeps, **analysis}, timeout=600.0)
    for name in analysis:
        rc, text, secs = done[name]
        tail = text.strip().splitlines()[-1] if text.strip() else ""
        print(f"5l python -m repro_torch.analysis {name}: exit {rc}, {secs:.1f} s: {tail} [{card}]", flush=True)
        check(rc == 0, f"5l analysis {name} exited {rc}:\n{text[-3000:]}")
        stats[name] = {"exit": rc, "s": secs, "last_line": tail}
    for mesh in DRYRUN_MESHES:
        runs_of_mesh = {shape: done[m, shape] for m, shape in sweeps if m == mesh}
        for shape, (rc, text, _) in runs_of_mesh.items():
            check(rc == 0, f"5l dry run {mesh} {shape} exited {rc}:\n{text[-3000:]}")
        recs = sweep_records(out_dir, mesh)
        for rec in recs:
            if rec["ok"]:
                print(f"5l dry run {rec['arch']} {rec['shape']} {mesh}: flops {rec['flops']:.4e} bytes "
                      f"{rec['bytes_accessed']:.4e} peak {rec['memory']['peak_bytes'] / 2**30:.2f} GiB/device "
                      f"trace {rec['trace_s']:.2f} s [{card}]", flush=True)
        stats[f"sweep {mesh}"] = {
            "cells": len(recs), "ok": sum(r["ok"] for r in recs), "skipped": sum(bool(r.get("skipped")) for r in recs),
            "s": max(secs for _, _, secs in runs_of_mesh.values()),
            "last_lines": {shape: text.strip().splitlines()[-1] for shape, (_, text, _) in runs_of_mesh.items()}}
        print(f"5l dry run {mesh} {json.dumps(stats[f'sweep {mesh}'])} [{card}]", flush=True)
    return stats, runs, time.perf_counter() - t0


# -------------------------------------------------------------------- phase 5m
REMAT_RATES = (0.0, 0.5)
REMAT_STEPS = 2
REMAT_TRAIN = {"batch": 16, "seq": 512}
# rwkv6-3b, jamba-v0.1-52b and granite-moe-3b-a800m at 4 layers, widths
# whole; jamba's 4 are layers 2-5 of its period (attention at layer 4, MoE
# at 3 and 5), which the cut config gives with its attention offset at 2
REMAT_FAMILIES = {"rwkv6-3b": {"num_layers": 4}, "jamba-v0.1-52b": {"num_layers": 4, "attn_offset": 2},
                  "granite-moe-3b-a800m": {"num_layers": 4}}
REMAT_META_LIMIT = 76 * 2**30  # internvl2-76b's depth: meta's peak of its remat step under this
EXAMPLE_SCRIPTS = ("torch_quickstart.py", "torch_federated_finetune.py", "torch_serving_decode.py",
                   "torch_bandit_configurator.py")


def remat_step_launches(cfg, gates, remat: bool) -> dict:
    """Each kernel's launches in train steps of ``gates`` (one list a step,
    True = dropped), derived from the code.  An active layer launches its
    forward kernels (an attention layer ``flash_attention`` and the q, v
    ``lora_matmul``; RWKV6 ``wkv6`` and the channel-mix up, down; Mamba
    ``mamba_scan`` and in, out), its backward kernels (attention and Mamba
    always: their LoRA sits before them; ``wkv6_bwd`` in all but the step's
    first active layer, whose WKV inputs come from frozen weights) and the
    dX of its LoRA projections whose inputs take a gradient (none of the
    first active layer's but RWKV6's down and Mamba's out, which follow the
    layer's own LoRA).  Under ``remat`` the non-reentrant checkpoint runs
    an active layer's forward again in the backward, up to its last saved
    tensor, which follows every kernel of the layer: each forward kernel
    twice.  Without ``remat`` this is phase 5's formulas
    (``training_launches``, ``jamba_round_launches``)."""
    from repro_torch.models.layers import layer_kind

    fwd = {"attn": {"flash_attention": 1, "lora_matmul": 2}, "rwkv": {"wkv6": 1, "lora_matmul": 2},
           "mamba": {"mamba_scan": 1, "lora_matmul": 2}}
    bwd_first = {"attn": {"flash_attention_bwd": 1}, "rwkv": {"lora_matmul": 1},
                 "mamba": {"mamba_scan_bwd": 1, "lora_matmul": 1}}
    bwd_later = {"attn": {"flash_attention_bwd": 1, "lora_matmul": 2}, "rwkv": {"wkv6_bwd": 1, "lora_matmul": 2},
                 "mamba": {"mamba_scan_bwd": 1, "lora_matmul": 2}}
    counts = []
    for step in gates:
        active = [l for l, dropped in enumerate(step) if not dropped]
        for j, l in enumerate(active):
            kind = layer_kind(cfg, l)
            counts += [fwd[kind], (bwd_later if j else bwd_first)[kind]] + ([fwd[kind]] if remat else [])
    return add_launches(*counts)


class RouteRecorder:
    """Records the MoE routing (``nn.moe._route``'s outputs) of each call,
    step by step, so that a ``remat`` step's recomputed routing can be held
    to its forward's bit for bit."""

    def __init__(self):
        from repro_torch.nn import moe

        self.moe, self.route, self.steps = moe, moe._route, []

    def mark(self):
        self.steps.append([])

    def __enter__(self):
        def recorded(*args, **kw):
            out = self.route(*args, **kw)
            self.steps[-1].append(tuple(t.detach().clone() for t in out))
            return out

        self.moe._route = recorded
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route
        return False


def remat_train_run(ops, cfg, params, peft, batches, rate: float, remat: bool, seed: int, routes=None) -> dict:
    """``make_train_step(cfg, ..., stld_mode="cond", mean_rate=rate,
    remat=remat)`` for a step on each batch from ``peft`` and a fresh AdamW
    state, the gates drawn from generators seeded ``seed + i``; per step its
    seconds, peak above what was allocated besides its arguments, launches
    and ``lora_matmul`` routes.  ``routes`` (a ``RouteRecorder``) marks each
    step.  Returns the last PEFT tree, every step's metrics and the gates;
    ``meta_args``: the first step's arguments on ``meta``."""
    from repro_torch.analysis.trace import meta_like
    from repro_torch.configs import PEFTConfig, TrainConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="cond", mean_rate=rate, remat=remat)
    p, opt, out = peft, adamw_init(peft), {"steps": [], "metrics": []}
    with GateReplay().record() as replay:
        for i, batch in enumerate(batches):
            args = (params, p, opt, batch, torch.Generator().manual_seed(seed + i))
            if i == 0:
                out["meta_args"] = meta_like(args)
            if routes is not None:
                routes.mark()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated() - tree_bytes(args)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            p, opt, metrics = step(*args)
            torch.cuda.synchronize()
            out["steps"].append({"s": time.perf_counter() - t0, "peak_bytes": torch.cuda.max_memory_allocated() - base,
                                 "launches": {k: v for k, v in ops.launch_counts.items() if v},
                                 "routes": dict(ops.lora_matmul_routes)})
            out["metrics"].append(metrics)
            del args
    out.update(peft=p, gates=[g.tolist() for g in replay.gates], step=step)
    return out


def check_remat_pair(cfg, runs: dict, what: str) -> dict:
    """Phase 5m's checks of a ``remat`` run against the same run without it:
    the same gates, PEFT tree and metrics bit for bit, each step's launches
    as ``remat_step_launches`` gives them (and those of phase 5's formulas
    without ``remat``), every ``lora_matmul`` on wgmma, every metric finite.
    Returns each run's launches summed over its steps."""
    plain, remat = runs[False], runs[True]
    check(plain["gates"] == remat["gates"], f"5m {what}: gates {plain['gates']} and {remat['gates']}")
    check(tree_equal(plain["peft"], remat["peft"]), f"5m {what}: the remat PEFT tree differs from the plain one")
    for a, b in zip(plain["metrics"], remat["metrics"]):
        check(all(torch.equal(a[k], b[k]) for k in a), f"5m {what}: metrics {a} and {b}")
        check(all(math.isfinite(float(v)) for v in a.values()), f"5m {what}: non-finite metrics {a}")
    active, steps = active_count(plain["gates"]), len(plain["gates"])
    if cfg.family == "hybrid":
        check(remat_step_launches(cfg, plain["gates"], False)
              == {k: v for k, v in jamba_round_launches(cfg, plain["gates"]).items() if v},
              "5m: the remat formula without remat is not phase 5c's")
    elif cfg.family == "ssm":
        check(remat_step_launches(cfg, plain["gates"], False)
              == {"wkv6": active, "wkv6_bwd": active - steps, "lora_matmul": 4 * active - steps},
              "5m: the remat formula without remat is not phase 5b's")
    else:
        check(remat_step_launches(cfg, plain["gates"], False)
              == training_launches([g.count(False) for g in plain["gates"]]), "5m: the formula is not phase 5's")
    summed = {}
    for remat_on, run in runs.items():
        for gates, st in zip(run["gates"], run["steps"]):
            check_launches(st["launches"], remat_step_launches(cfg, [gates], remat_on), f"5m {what} remat={remat_on}")
            check(st["routes"] == {"fma": 0, "wmma": 0, "wgmma": st["launches"].get("lora_matmul", 0)},
                  f"5m {what}: lora_matmul routes {st['routes']}, every call expected on wgmma")
        summed[remat_on] = add_launches(*(st["launches"] for st in run["steps"]))
    return summed


def check_recomputed_routing(routes: RouteRecorder, plain_steps: int, what: str) -> int:
    """``routes`` holds a plain run's steps, then a ``remat`` run's: each
    remat step routes every active MoE layer in its forward (as the plain
    step, bit for bit), then again in the backward's recompute, last layer
    first, bit for bit.  Returns the MoE layers checked."""
    plain, remat = routes.steps[:plain_steps], routes.steps[plain_steps:]
    checked = 0
    for a, b in zip(plain, remat):
        m = len(a)
        check(len(b) == 2 * m, f"5m {what}: {len(b)} routings in a remat step of {m} MoE layers")
        for x, y, z in zip(a, b[:m], reversed(b[m:])):
            check(all(torch.equal(s, t) and torch.equal(t, u) for s, t, u in zip(x, y, z)),
                  f"5m {what}: the recomputed MoE routing differs from the forward's")
        checked += m
    return checked


def remat_meta_run(run: dict):
    """The ``remat`` run's first step again on ``meta`` with its gates."""
    from repro_torch.analysis.trace import run_on_meta

    with GateReplay() as replay:
        replay.gates = [torch.tensor(run["gates"][0])]
        replay.replay()
        meta = run_on_meta(run["step"], *run["meta_args"])
    check(not meta.host_reads, f"5m: host reads on meta {meta.host_reads}")
    return meta


def profile_step(step, args) -> dict:
    """Device busy and idle share of one step under ``torch.profiler`` (the
    CUDA activity alone) beside its host clock."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e3
    return {"wall_ms_profiled": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None}


def remat_batches(cfg, gen, steps: int, batch: int, seq: int) -> list:
    """Phase 5m's batches: random tokens and, for a vision model, patches
    drawn from ``gen`` at the token embeddings' scale (``normal_init``'s
    0.02).  Not the zero patches of the reference's client (phase 5j):
    a zero row stays zero through every layer, and the RMSNorm backward
    of a zero row multiplies its gradient by 1 / sqrt(eps) (316), so the
    gradient grows ~300x a layer down a random internvl2-76b and
    overflows to inf at 19 layers, with or without ``remat``."""
    from repro_torch.launch.steps import frontend_batch

    out = []
    for _ in range(steps):
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen, device="cuda", dtype=torch.int32)
        patches = None
        if cfg.prefix_len:
            patches = 0.02 * torch.randn((batch, cfg.frontend_seq, cfg.d_model), generator=gen, device="cuda")
            patches = patches.to(getattr(torch, cfg.dtype))
        out.append(frontend_batch(cfg, tokens, patches))
    return out


def remat_qwen3(ops, card, seed: int) -> tuple:
    """Phase 5m's qwen3-1.7b, full width and depth: two steps at 16 x 512
    with and without ``remat`` at each rate; bit identity, launches,
    peaks (remat's below the plain run's), seconds a step, each variant's
    idle share from a profiled step, and the remat step on ``meta``
    (launches equal, peak within ``META_PEAK_TOLERANCE``)."""
    from repro_torch.configs import PEFTConfig, get_config
    from repro_torch.core.peft import init_peft
    from repro_torch.models.registry import init_params
    from repro_torch.optim import adamw_init

    free_memory("cuda")
    cfg = get_config("qwen3-1.7b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, place=True)
    peft = init_peft(cfg, PEFTConfig(), gen)
    batches = remat_batches(cfg, gen, REMAT_STEPS, REMAT_TRAIN["batch"], REMAT_TRAIN["seq"])
    stats, launches = {}, {}
    for rate in REMAT_RATES:
        runs = {remat: remat_train_run(ops, cfg, params, peft, batches, rate, remat, seed) for remat in (False, True)}
        summed = check_remat_pair(cfg, runs, f"qwen3-1.7b rate {rate}")
        peaks = {remat: max(st["peak_bytes"] for st in run["steps"]) for remat, run in runs.items()}
        check(peaks[True] < peaks[False], f"5m qwen3-1.7b rate {rate}: remat peak {peaks[True]} B, plain {peaks[False]}")
        meta = remat_meta_run(runs[True])
        card_first = runs[True]["steps"][0]
        check(meta.kernel_launches == card_first["launches"],
              f"5m qwen3-1.7b rate {rate}: launches on the card {card_first['launches']}, on meta {meta.kernel_launches}")
        gap = meta.peak_bytes / card_first["peak_bytes"] - 1.0
        check(abs(gap) <= META_PEAK_TOLERANCE, f"5m qwen3-1.7b rate {rate}: meta peak {meta.peak_bytes} B against the "
                                               f"card's {card_first['peak_bytes']} B ({gap:+.3f})")
        row = {"rate": rate, "gates": runs[True]["gates"], "meta_peak_bytes": meta.peak_bytes,
               "card_peak_bytes_first_step": card_first["peak_bytes"], "meta_peak_gap": gap}
        for remat, run in runs.items():
            name = "remat" if remat else "plain"
            args = (params, peft, adamw_init(peft), batches[0], torch.Generator().manual_seed(seed))
            row[name] = {"s_per_step": [st["s"] for st in run["steps"]], "peak_gib": peaks[remat] / 2**30,
                         "launches": summed[remat], "profile": profile_step(run["step"], args)}
            launches[f"5m_qwen3_rate{rate}_{name}"] = summed[remat]
        row["peak_saved_gib"] = (peaks[False] - peaks[True]) / 2**30
        stats[f"rate {rate}"] = row
        print(f"5m remat qwen3-1.7b {json.dumps(row)} [{card}]", flush=True)
    return stats, launches


def remat_family(ops, card, seed: int, arch: str) -> tuple:
    """Phase 5m's other families at full width, cut to 4 layers
    (``REMAT_FAMILIES``): two steps at 16 x 512 at rate 0.0 (every layer,
    so every MoE layer's routing is recomputed) with and without
    ``remat``, bit identity and launches, and each MoE layer's recomputed
    routing bit for bit."""
    from repro_torch.configs import PEFTConfig, get_config
    from repro_torch.core.peft import init_peft
    from repro_torch.models.layers import layer_kind
    from repro_torch.models.registry import init_params

    free_memory("cuda")
    cfg = get_config(arch).replace(**REMAT_FAMILIES[arch])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = init_params(cfg, gen, place=True)
    peft = init_peft(cfg, PEFTConfig(), gen)
    batches = remat_batches(cfg, gen, REMAT_STEPS, REMAT_TRAIN["batch"], REMAT_TRAIN["seq"])
    with RouteRecorder() as routes:
        runs = {remat: remat_train_run(ops, cfg, params, peft, batches, 0.0, remat, seed, routes)
                for remat in (False, True)}
    summed = check_remat_pair(cfg, runs, arch)
    moe_layers = sum(cfg.is_moe_layer(l) for l in range(cfg.num_layers))
    routed = check_recomputed_routing(routes, REMAT_STEPS, arch)
    check(routed == REMAT_STEPS * moe_layers, f"5m {arch}: {routed} MoE routings checked, {moe_layers} a step")
    stats = {"layers": cfg.num_layers, "of": get_config(arch).num_layers,
             "kinds": [layer_kind(cfg, l) + ("+moe" if cfg.is_moe_layer(l) else "") for l in range(cfg.num_layers)],
             "gates": runs[True]["gates"], "moe_routings_checked": routed,
             **{("remat" if remat else "plain"): {"launches": summed[remat],
                                                  "peak_gib": max(st["peak_bytes"] for st in run["steps"]) / 2**30}
                for remat, run in runs.items()}}
    print(f"5m remat {arch} {json.dumps(stats)} [{card}]", flush=True)
    return stats, {f"5m_{arch.split('-')[0]}_{'remat' if remat else 'plain'}": summed[remat] for remat in runs}


def internvl_meta_depth(seed: int) -> tuple:
    """The deepest cut of internvl2-76b whose ``remat`` step at rate 0.0
    (16 x (256 + 512) tokens) ``run_on_meta`` puts under
    ``REMAT_META_LIMIT``: the peak is linear in the depth, so two traces
    give the line, and the cut it gives is checked, one layer at a time, to
    fit with the next one over.  Returns (layers, the meta runs by
    depth)."""
    from repro_torch.analysis.trace import run_on_meta
    from repro_torch.configs import InputShape, PEFTConfig, TrainConfig, get_config
    from repro_torch.launch import input_specs as ispec
    from repro_torch.launch.steps import make_train_step

    full, mesh, runs = get_config(INTERNVL), ispec.MeshShape({"data": 1, "model": 1}), {}

    def peak(layers: int) -> int:
        if layers not in runs:
            cfg = full.replace(num_layers=layers)
            args, _ = ispec.train_inputs(cfg, PEFTConfig(), InputShape("remat", REMAT_TRAIN["seq"],
                                                                       REMAT_TRAIN["batch"], "train"),
                                         mesh, weights_dtype="placed")
            step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="cond", mean_rate=0.0, remat=True)
            runs[layers] = run_on_meta(step, *args[:4], torch.Generator().manual_seed(seed))
            check(not runs[layers].host_reads, f"5m internvl on meta: host reads {runs[layers].host_reads}")
        return runs[layers].peak_bytes

    lo, hi = 8, 16
    slope = (peak(hi) - peak(lo)) / (hi - lo)
    layers = min(full.num_layers, lo + int((REMAT_META_LIMIT - peak(lo)) // slope))
    while layers > 1 and peak(layers) >= REMAT_META_LIMIT:
        layers -= 1
    while layers < full.num_layers and peak(layers + 1) < REMAT_META_LIMIT:
        layers += 1
    return layers, runs


def remat_internvl(ops, card, seed: int, layers: int, meta_runs: dict) -> tuple:
    """Phase 5m's internvl2-76b: one ``remat`` step at rate 0.0 on the card
    at the depth ``internvl_meta_depth`` chose (one layer less at a time
    where the card runs out, each cut printed): the depth beyond phase 5j's
    9, launches as ``remat_step_launches`` and as on ``meta``, the card's
    peak against meta's, seconds."""
    from repro_torch.configs import PEFTConfig, get_config
    from repro_torch.core.peft import init_peft
    from repro_torch.models.registry import init_params

    full, did_not_fit = get_config(INTERNVL), []
    while True:
        free_memory("cuda")
        cfg = full.replace(num_layers=layers)
        try:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            torch.cuda.reset_peak_memory_stats()
            m0 = torch.cuda.memory_allocated()
            params = init_params(cfg, gen, place=True)
            draw_peak = torch.cuda.max_memory_allocated() - m0
            free_memory("cuda")  # the draws' cached blocks back to the card: the step's 3.9 GiB logits need room
            peft = init_peft(cfg, PEFTConfig(), gen)
            run = remat_train_run(ops, cfg, params, peft, remat_batches(cfg, gen, 1, REMAT_TRAIN["batch"],
                                                                         REMAT_TRAIN["seq"]), 0.0, True, seed)
            break
        except torch.cuda.OutOfMemoryError as err:
            did_not_fit.append({"layers": layers, "error": str(err).splitlines()[0][:200]})
        layers -= 1
        params = peft = None
        check(layers > 9, f"5m internvl2-76b: a remat step does not fit beyond phase 5j's 9 layers: {did_not_fit}")
    check(layers > 9, f"5m internvl2-76b trains under remat at {layers} layers, not beyond phase 5j's 9")
    st = run["steps"][0]
    check(all(math.isfinite(float(v)) for v in run["metrics"][0].values()), f"5m internvl: {run['metrics'][0]}")
    check_launches(st["launches"], remat_step_launches(cfg, run["gates"], True), "5m internvl2-76b remat")
    if layers not in meta_runs:
        meta_runs[layers] = remat_meta_run(run)
    meta = meta_runs[layers]
    check(meta.kernel_launches == st["launches"], f"5m internvl: launches {st['launches']}, meta {meta.kernel_launches}")
    gap = meta.peak_bytes / st["peak_bytes"] - 1.0
    check(abs(gap) <= META_PEAK_TOLERANCE, f"5m internvl: meta peak {meta.peak_bytes} B, card {st['peak_bytes']} B")
    stats = {"layers": layers, "of": full.num_layers, "phase_5j_layers": 9, "did_not_fit": did_not_fit or None,
             "s_per_step": st["s"], "card_peak_gib": st["peak_bytes"] / 2**30, "meta_peak_gib": meta.peak_bytes / 2**30,
             "meta_peak_gap": gap, "peak_gib_drawing_weights": draw_peak / 2**30,
             "meta_limit_gib": REMAT_META_LIMIT / 2**30, "launches": st["launches"],
             "metrics": {k: float(v) for k, v in run["metrics"][0].items()}}
    print(f"5m remat internvl2-76b {json.dumps(stats)} [{card}]", flush=True)
    return stats, {"5m_internvl_remat": st["launches"]}


def start_examples() -> dict:
    """The four ``examples/torch_*.py``, each a process of its own on the
    card (their default device)."""
    return {name: (subprocess.Popen([sys.executable, str(ROOT / "examples" / name)], cwd=ROOT, env=subprocess_env(),
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), time.perf_counter())
            for name in EXAMPLE_SCRIPTS}


def remat_full(ops, card, seed: int) -> tuple:
    """Phase 5m: ``remat`` through every hand-written backward at full width.
    The four examples start first, as processes; meanwhile internvl's depth
    is chosen on ``meta`` and rwkv6-3b, jamba and granite run (untimed);
    the examples are waited for before qwen3-1.7b's timed runs and
    internvl's step, which takes the card's memory.  Returns (stats, the
    card's launches by run, the phase's seconds)."""
    from torch.utils.checkpoint import checkpoint

    t0 = time.perf_counter()
    examples = start_examples()
    x = torch.ones(1, requires_grad=True)  # the first checkpoint call loads torch._dynamo (seconds): here, untimed
    checkpoint(torch.sin, x, use_reentrant=False).backward()
    stats, launches = {}, {}
    t_meta = time.perf_counter()
    layers, meta_runs = internvl_meta_depth(seed)
    stats["internvl_meta_search"] = {"layers": layers, "s": time.perf_counter() - t_meta,
                                     "peak_gib_by_layers": {n: r.peak_bytes / 2**30 for n, r in sorted(meta_runs.items())}}
    print(f"5m internvl2-76b depth on meta {json.dumps(stats['internvl_meta_search'])}", flush=True)
    for arch in REMAT_FAMILIES:
        stats[arch], runs = remat_family(ops, card, seed, arch)
        launches.update(runs)
    done = finish(examples, timeout=300.0)
    stats["examples"] = {}
    for name, (rc, text, secs) in done.items():
        lines = text.strip().splitlines()
        print(f"5m example {name}: exit {rc}, {secs:.1f} s: {lines[-1] if lines else ''} [{card}]", flush=True)
        check(rc == 0, f"5m example {name} exited {rc}:\n{text[-3000:]}")
        stats["examples"][name] = {"exit": rc, "s": secs, "last_line": lines[-1] if lines else ""}
    check("remat=True gives the same LoRA after 5 steps: True" in done["torch_quickstart.py"][1],
          "5m: the quickstart's remat steps differ from its plain steps on the card")
    stats["qwen3-1.7b"], runs = remat_qwen3(ops, card, seed)
    launches.update(runs)
    stats[INTERNVL], runs = remat_internvl(ops, card, seed, layers, meta_runs)
    launches.update(runs)
    return stats, launches, time.perf_counter() - t0


# -------------------------------------------------------------------- phase 5n
MHA_WIDTHS = {"b": 8, "h": 16, "kv": 8, "d": 128}  # qwen3-1.7b's heads at serving's batch 8
MHA_DECODE_QUERIES = 16
SERVE_WINDOW, SERVE_LAYERS = 256, 8  # the override phase 5n serves with, and its depth cut
ENCODE_BATCH, ENCODE_RATE, ENCODE_RANK = 16, 0.5, 8
# phase 5n's encoder against the twins, each output's largest error as a
# share of its largest element: bf16 as ``grads_close``'s bf16 rule; float32
# at 1e-4, the float32 kernels' sums over 24 000 rows in another order
# (a wrong mask or a dropped term moves whole percents)
ENCODE_TOLERANCE = {"bfloat16": 2e-2, "float32": 1e-4}


def plain_mha(q, k, v, q_positions, k_positions, causal: bool, window):
    """The reference's masked attention (``_mask_bias``, then ``_sdpa``) in
    float32 over absolute positions, broadcast over the rows: the plain
    version ``multi_head_attention`` is held to, whichever kernel a case
    takes.  Differentiable by autograd."""
    b, sq, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    qe = q_positions.long().expand(b, sq)[:, :, None]
    ke = k_positions.long().expand(b, skv)[:, None, :]
    ok = torch.ones((b, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (ke <= qe)
    if window is not None:
        ok = ok & (ke > qe - window)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q.float().reshape(b, sq, kv, h // kv, d), k.float()) * d**-0.5
    scores = torch.where(ok[:, None, None], scores, torch.full((), -1e30, device=q.device))
    out = torch.einsum("bgrqk,bkgd->bqgrd", torch.softmax(scores, dim=-1), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def mha_cases(gen):
    """Phase 5n's ``multi_head_attention`` cases at qwen3-1.7b's widths:
    name -> (Sq, Skv, q_positions, k_positions, causal, window, kernel,
    launches).  (d)'s rows sit at depths of their own, each row's keys past
    its depth never written (INT32_MAX)."""
    from repro_torch.nn.attention import INT32_MAX

    b, sq = MHA_WIDTHS["b"], 4
    run = lambda n, offset=0: torch.arange(n, dtype=torch.int32, device="cuda") + offset  # noqa: E731
    depth = torch.randint(64, 512 - sq, (b,), generator=gen, device="cuda", dtype=torch.int32)
    q_rows = depth[:, None] + run(sq)
    slots = run(512)[None, :].expand(b, 512)
    k_rows = torch.where(slots <= q_rows[:, -1:], slots, torch.full_like(slots, INT32_MAX)).contiguous()
    return {
        "a causal run, window 256": (512, 512, run(512), run(512), True, 256, "flash_attention", 1),
        "b bidirectional, 512 x 1500": (512, 1500, run(512), run(1500), False, None, "flash_attention", 1),
        "c 16 queries over 512 keys": (MHA_DECODE_QUERIES, 512, run(MHA_DECODE_QUERIES, 512 - MHA_DECODE_QUERIES),
                                       run(512), True, None, "flash_decode", MHA_DECODE_QUERIES),
        "d per-row positions, window 128": (sq, 512, q_rows, k_rows, True, 128, "flash_decode", sq),
    }


def mha_full(ops, timer, card: str, seed: int) -> tuple:
    """Phase 5n (a)-(d): ``multi_head_attention`` at qwen3-1.7b's widths in
    bf16 against ``plain_mha`` (3e-2 + 1e-2 |ref| and a relative L2 of
    ``BF16_REL_L2``), each case's launches exactly: one ``flash_attention``
    for (a) and (b), whose backward runs one ``flash_attention_bwd`` held
    to the plain version's autograd (``grads_close`` and the relative L2),
    one ``flash_decode`` a query column for (c) and (d), which raise for an
    input that requires a gradient.  Times beside the plain version's."""
    from repro_torch.nn.attention import multi_head_attention

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 31)
    b, h, kv, d = (MHA_WIDTHS[key] for key in ("b", "h", "kv", "d"))
    stats, launches = {}, {}
    for name, (sq, skv, qpos, kpos, causal, window, kernel, count) in mha_cases(gen).items():
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                      for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d), (b, sq, h, d)))
        pos = {"q_positions": qpos, "k_positions": kpos, "causal": causal, "window": window}
        train = kernel == "flash_attention"
        leaves = [t.clone().requires_grad_(train) for t in (q, k, v)]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with torch.set_grad_enabled(train):
            out = multi_head_attention(*leaves, **pos)
        torch.cuda.synchronize()
        fwd = {key: n for key, n in ops.launch_counts.items() if n}
        check(fwd == {kernel: count}, f"5n mha {name}: launches {fwd}, expected {{{kernel!r}: {count}}}")
        twins = [t.clone().requires_grad_(train) for t in (q, k, v)]
        want = plain_mha(*twins, qpos, kpos, causal, window)
        err, rel = (out.float() - want.float()).abs().max().item(), rel_l2(out, want)
        check(torch.allclose(out.float(), want.float(), atol=3e-2, rtol=1e-2) and rel <= BF16_REL_L2,
              f"5n mha {name}: max abs err {err}, relative L2 {rel} (limit {BF16_REL_L2})")
        case = {"shape": f"B={b} Sq={sq} Skv={skv} H={h} KV={kv} D={d} causal={causal} window={window} bf16",
                "kernel": kernel, "launches": fwd, "max_abs_err": err, "rel_l2_err": rel}
        if train:
            ops.reset_launch_counts()
            grads = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            bwd = {key: n for key, n in ops.launch_counts.items() if n}
            check(bwd == {"flash_attention_bwd": 1}, f"5n mha {name}: backward launches {bwd}")
            want_grads = torch.autograd.grad(want, twins, g)
            ok, grad_errs = grads_close(grads, want_grads, torch.bfloat16)
            rels = [rel_l2(x, y) for x, y in zip(grads, want_grads)]
            check(ok and max(rels) <= BF16_REL_L2,
                  f"5n mha {name}: dq/dk/dv max abs errs {grad_errs}, relative L2 {rels} (limit {BF16_REL_L2})")
            case.update(bwd_launches=bwd, bwd_max_abs_err=max(grad_errs), bwd_rel_l2_err=max(rels))
            launches[f"5n_mha_{name.split()[0]}"] = {**fwd, **bwd}
        else:
            try:
                multi_head_attention(q.clone().requires_grad_(True), k, v, **pos)
                raise AssertionError(f"5n mha {name}: a query that requires a gradient did not raise")
            except ValueError:
                pass
            launches[f"5n_mha_{name.split()[0]}"] = fwd
        with torch.no_grad():
            case["ms"] = timer(lambda: multi_head_attention(q, k, v, **pos), repeats=10)
            case["plain_ms"] = timer(lambda: plain_mha(q, k, v, qpos, kpos, causal, window), repeats=10)
        stats[name] = case
        print(f"5n multi_head_attention {name} {json.dumps(case)} [{card}]", flush=True)
    return stats, launches


class plain_twins:
    """Within the block, the attention and LoRA wrappers the models call
    run their plain twins, on any device: the comparison that holds a path
    to its twins on the card.  Nothing run inside counts as a launch."""

    def __init__(self, ops, ref):
        self.ops, self.swap = ops, {
            "flash_attention": lambda q, k, v, *, causal=True, window=None: ref.attention_plain(
                q, k, v, causal=causal, window=window),
            "lora_matmul": lambda x, w, a, b, *, alpha=1.0: ref.lora_matmul_plain(x, w, a, b, alpha=alpha)}

    def __enter__(self):
        self.saved = {name: getattr(self.ops, name) for name in self.swap}
        for name, fn in self.swap.items():
            setattr(self.ops, name, fn)

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.ops, name, fn)


def encode_full(ops, ref, card: str, seed: int) -> tuple:
    """Phase 5n: whisper-tiny's encoder uncut (4 layers, 16 x 1 500 frames)
    through ``encdec.encode`` with STLD gates drawn at rate 0.5 (a draw
    with a layer dropped and one kept) and a LoRA of rank 8 on q and v
    (``b`` off zero), in bf16: ``flash_attention`` launches equal the kept
    layers, as do ``flash_attention_bwd``'s, ``lora_matmul``'s follow from
    them (q and v a kept layer, and their dX in all but the first), all on
    wgmma, and a dropped layer's adapter takes an exact zero gradient.  The
    states and the LoRA's gradients are held to the same encode on the
    plain twins on the card, in bf16 and in float32 (the float32 kernels,
    the same draws), each within ``ENCODE_TOLERANCE`` of its largest
    element."""
    from repro_torch.configs import get_config
    from repro_torch.core import stld
    from repro_torch.models import encdec, stacking
    from repro_torch.models.registry import init_params
    from repro_torch.nn.linear import init_lora

    gc.collect()
    torch.cuda.empty_cache()
    layers = get_config(WHISPER).num_encoder_layers
    host = torch.Generator().manual_seed(seed + 32)
    drops = stld.sample_drops(host, torch.full((layers,), ENCODE_RATE))
    while bool(drops.all()) or not bool(drops.any()):
        drops = stld.sample_drops(host, torch.full((layers,), ENCODE_RATE))
    kept = int((~drops).sum())

    def inputs(dtype: str):
        cfg = get_config(WHISPER).replace(dtype=dtype)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 32)
        params = init_params(cfg, gen, place=True)
        width = cfg.num_heads * cfg.resolved_head_dim
        peft = {"attn": {t: init_lora(gen, cfg.d_model, width, ENCODE_RANK, lead=(layers,)) for t in ("q", "v")}}
        for node in peft["attn"].values():
            node["b"].normal_(0.0, 0.02, generator=gen)
        shape = (ENCODE_BATCH, cfg.frontend_seq, cfg.d_model)
        frames = torch.randn(shape, generator=gen, device="cuda").to(getattr(torch, dtype))
        return cfg, params, peft, frames, torch.randn(shape, generator=gen, device="cuda")

    def run(cfg, params, peft, frames, probe, twins: bool = False):
        leaves = stacking.tree_map(lambda t: t.clone().requires_grad_(True), peft)
        with plain_twins(ops, ref) if twins else contextlib.nullcontext():
            out = encdec.encode(params, cfg, frames, drops=drops, peft=leaves, lora_scale=2.0)
            grads = torch.autograd.grad(torch.sum(out.float() * probe), stacking.tree_leaves(leaves))
        torch.cuda.synchronize()
        return out, grads

    bf16 = inputs("bfloat16")
    run(*bf16)  # warm
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out, grads = run(*bf16)
    run_s = time.perf_counter() - t0
    launches = dict(ops.launch_counts)
    routes = {key: n for key, n in ops.lora_matmul_routes.items() if n}
    want_launches = {"flash_attention": kept, "flash_attention_bwd": kept, "lora_matmul": 4 * kept - 2}
    check_launches(launches, want_launches, f"5n encode with gates {drops.tolist()}")
    check(routes == {"wgmma": want_launches["lora_matmul"]}, f"5n encode: lora_matmul routes {routes}")
    check(bool(torch.isfinite(out).all()), "5n encode: non-finite states")
    for l, dropped in enumerate(drops.tolist()):
        check(all(bool(torch.any(g[l] != 0)) != dropped for g in grads),
              f"5n encode: layer {l} (dropped: {dropped}) and its adapter's gradient disagree")
    errs = {}
    for dtype in ("bfloat16", "float32"):
        args = bf16 if dtype == "bfloat16" else inputs(dtype)
        got, got_grads = (out, grads) if dtype == "bfloat16" else run(*args)
        want, want_grads = run(*args, twins=True)
        pairs = list(zip([got, *got_grads], [want, *want_grads]))
        grad_errs = [(g.float() - w.float()).abs().max().item() for g, w in pairs]
        limits = [ENCODE_TOLERANCE[dtype] * w.float().abs().max().item() for _, w in pairs]
        check(all(e <= lim for e, lim in zip(grad_errs, limits)),
              f"5n encode {dtype}: states' and LoRA gradients' max abs errs {grad_errs} against the twins, "
              f"limits {limits}")
        errs[dtype] = {"max_abs_err": grad_errs[0], "rel_l2_err": rel_l2(got, want), "grad_max_abs_errs": grad_errs[1:],
                       "limits": limits}
    stats = {"shape": f"{WHISPER} encoder, {layers} layers, B={ENCODE_BATCH} S={bf16[0].frontend_seq} "
                      f"d={bf16[0].d_model}, LoRA r={ENCODE_RANK} on q and v",
             "gates": drops.tolist(), "launches": {key: n for key, n in launches.items() if n}, "routes": routes,
             "against_twins": errs, "bf16_fwd_bwd_s": run_s}
    print(f"5n encode {json.dumps(stats)} [{card}]", flush=True)
    return stats, {"5n_encode_whisper": stats["launches"]}


def serve_overrides_full(api, ops, card: str, seed: int) -> tuple:
    """Phase 5n: ``api.serve("qwen3-1.7b", smoke=False, model_overrides=
    {"sliding_window": 256, "num_layers": 8}, stack_mode="unroll")`` (full
    width, depth cut to 8 layers) serves 8 tenants' requests whose
    positions outgrow the 256-slot ring, token for token as ``api.serve(
    cfg=<the full config>.replace(...))`` (the default ``scan``); its
    launches as phase 4's: a ``flash_decode`` a layer a step and a
    ``segmented_lora`` for q and v."""
    from repro_torch.configs import get_config
    from repro_torch.serving.batcher import Request

    gc.collect()
    torch.cuda.empty_cache()
    overrides = {"sliding_window": SERVE_WINDOW, "num_layers": SERVE_LAYERS}
    cfg = get_config("qwen3-1.7b").replace(**overrides)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 33)
    tenants = make_tenants(cfg, gen)
    rng = np.random.default_rng(seed + 33)
    requests = [(rng.integers(0, cfg.vocab_size, int(rng.integers(250, 291))).tolist(), f"tenant{j % 4}")
                for j in range(8)]
    out = {}
    for name, kw in (("overrides", {"model_overrides": overrides, "stack_mode": "unroll"}), ("cfg", {"cfg": cfg})):
        batcher = api.serve("qwen3-1.7b", smoke=False, adapters=tenants, batch=8, max_len=512, seed=seed, **kw)
        check(batcher.cfg.sliding_window == SERVE_WINDOW and batcher.caches["k"].shape[2] == SERVE_WINDOW,
              f"5n serve {name}: window {batcher.cfg.sliding_window}, ring of {batcher.caches['k'].shape[2]} slots")
        steps, step = [], batcher.serve_step

        def counted(*args, _step=step, **kwargs):
            steps.append(1)
            return _step(*args, **kwargs)

        batcher.serve_step = counted
        for uid, (prompt, adapter) in enumerate(requests):
            batcher.submit(Request(prompt=prompt, adapter=adapter, max_new_tokens=16, uid=uid))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = batcher.run()
        torch.cuda.synchronize()
        out[name] = {"tokens": {c.uid: c.tokens for c in done}, "steps": len(steps), "s": time.perf_counter() - t0,
                     "launches": dict(ops.launch_counts)}
        del batcher
    got, want = out["overrides"], out["cfg"]
    check(got["tokens"] == want["tokens"] and len(got["tokens"]) == 8, "5n serve: the overrides' tokens differ")
    n = got["steps"]
    check_launches(got["launches"], {"flash_decode": SERVE_LAYERS * n, "segmented_lora": 2 * SERVE_LAYERS * n},
                   f"5n serve in {n} steps")
    stats = {"model": cfg.name, "layers": SERVE_LAYERS, "window": SERVE_WINDOW, "steps": n,
             "longest_position": max(len(p) for p, _ in requests) + 15,
             "launches": {key: n for key, n in got["launches"].items() if n},
             "s_overrides_unroll": got["s"], "s_cfg_scan": want["s"], "ms_per_step": got["s"] / n * 1e3,
             "tokens_equal": True}
    print(f"5n serve with overrides {json.dumps(stats)} [{card}]", flush=True)
    return stats, {"5n_serve_overrides": stats["launches"]}


def list_layout_round_full(ops, card: str, seed: int) -> tuple:
    """Phase 5n: full-width qwen3-1.7b's local round (phase 5's batch 16 x
    512 and rate 0.5, 2 steps) from ``layout="list"`` trees, under
    ``unroll`` and under ``scan`` (``default_stack_mode``), gives the
    stacked round's PEFT tree, metrics and importances bit for bit, each
    with the launches the gates give."""
    from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
    from repro_torch.core import stld
    from repro_torch.core.peft import init_peft
    from repro_torch.data.synthetic import make_task
    from repro_torch.federated.client import make_client_fns
    from repro_torch.models.registry import default_stack_mode, init_params
    from repro_torch.models.stacking import in_layout
    from repro_torch.optim import adamw_init

    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, steps = get_config("qwen3-1.7b"), FederatedConfig().batch_size, 2
    task = make_task(vocab_size=cfg.vocab_size, seq_len=512, num_examples=steps * batch, seed=seed)
    batches = train_batches(task, steps, batch)
    trees = {}
    for layout in ("auto", "list"):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 34)
        trees[layout] = (init_params(cfg, gen, layout, place=True), init_peft(cfg, PEFTConfig(), gen, layout))
    check(isinstance(trees["list"][0]["layers"], list) and isinstance(trees["list"][1], list),
          "5n: layout='list' gave a stacked tree")
    runs, sample_drops = {}, stld.sample_drops
    for layout, mode in (("auto", "unroll"), ("list", "unroll"), ("list", default_stack_mode(cfg))):
        fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), TrainConfig(), stack_mode=mode)
        params, peft = trees[layout]
        gates = []

        def recorded(*args, **kw):
            drops = sample_drops(*args, **kw)
            gates.append(drops.tolist())
            return drops

        stld.sample_drops = recorded
        try:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = fns.local_round(params, peft, adamw_init(peft), batches, 0.5, torch.Generator().manual_seed(seed + 7),
                                  0)
            torch.cuda.synchronize()
        finally:
            stld.sample_drops = sample_drops
        launches = dict(ops.launch_counts)
        check_launches(launches, training_launches([g.count(False) for g in gates]), f"5n {layout} round {mode}")
        runs[layout, mode] = {"out": out, "gates": gates, "s": time.perf_counter() - t0, "launches": launches}
    want = runs["auto", "unroll"]["out"]
    for key, run in runs.items():
        got = run["out"]
        check(run["gates"] == runs["auto", "unroll"]["gates"], f"5n {key}: gates {run['gates']}")
        check(tree_equal(in_layout(got[0], "list", cfg.num_layers), in_layout(want[0], "list", cfg.num_layers)),
              f"5n {key}: the PEFT tree differs from the stacked round's")
        check(all(torch.equal(got[2][k], want[2][k]) for k in want[2]) and torch.equal(got[3], want[3]),
              f"5n {key}: metrics or importances differ from the stacked round's")
        check(all(math.isfinite(float(v)) for v in got[2].values()), f"5n {key}: non-finite metrics {got[2]}")
    stats = {"model": cfg.name, "steps": steps, "batch": f"{batch} x 512", "rate": 0.5,
             "gates": runs["auto", "unroll"]["gates"], "bit_identical": True,
             "s": {f"{layout} {mode}": run["s"] for (layout, mode), run in runs.items()},
             "metrics": {k: float(v) for k, v in want[2].items()}}
    print(f"5n list-layout local round {json.dumps(stats)} [{card}]", flush=True)
    return stats, {"5n_list_round": {k: n for k, n in runs["list", "unroll"]["launches"].items() if n}}


def public_names_full(api, ops, ref, timer, card: str, seed: int) -> tuple:
    """Phase 5n: the last of the reference's public names on the card
    (``multi_head_attention``, ``encode(drops, peft)``, ``api.serve(
    model_overrides, stack_mode)``, ``layout="list"``).  Returns (stats,
    the card's launches by run, the phase's seconds)."""
    t0 = time.perf_counter()
    stats, launches = {}, {}
    for name, (st, runs) in (("multi_head_attention", mha_full(ops, timer, card, seed)),
                             ("encode", encode_full(ops, ref, card, seed)),
                             ("serve_overrides", serve_overrides_full(api, ops, card, seed)),
                             ("list_layout_round", list_layout_round_full(ops, card, seed))):
        stats[name] = st
        launches.update(runs)
    return stats, launches, time.perf_counter() - t0


# -------------------------------------------------------------------- phase 5o
TP_ARCH = "qwen3-1.7b"
TP_TRAIN = {"batch": 16, "seq": 512, "rate": 0.5, "steps": 2}
TP_MESHES = (((1, 2), False), ((2, 2), True))  # (data, model), FSDP with regather_specs
TP_AXES = ("data", "model")
TP_LOSS_RTOL = 3e-2
# the first step's gradients, of each leaf's largest element, in float32
# (phase 5n's float32 rule): in bf16 the one-rank step's own gradients lie
# 2.2 % from its float32 step's at full depth (PERF.md §6), so the
# bf16 rule of 2 % cannot tell the sharded step's rounding from the
# one-rank step's
TP_GRAD_TOL = 1e-4
# the sharded bf16 step's first gradients may lie from the one-rank float32
# step's at most this many times the one-rank bf16 step's own distance from
# it (measured 2.2 % one rank, 2.6 % and 2.8 % sharded: PERF.md §6)
TP_BF16_GRAD_RATIO = 1.5


def tp_draws(cfg, pcfg, seed: int, device: str):
    """The base params (placed) and the PEFT tree drawn from ``seed`` on
    ``device``'s generator: the same bits in every process on one card."""
    from repro_torch.core.peft import init_peft
    from repro_torch.models.registry import init_params

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return init_params(cfg, g, place=True), init_peft(cfg, pcfg, g)


def tp_tokens(cfg, seed: int, batch: int, seq: int):
    """The global batch's tokens (B, S+1), drawn on the CPU from ``seed``."""
    return torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=torch.Generator().manual_seed(seed),
                         dtype=torch.int32)


def tp_float32(tree):
    """``tree`` with every floating leaf in float32 (the bf16 draws, exactly)."""
    from repro_torch.models.stacking import tree_map

    return tree_map(lambda t: t.float() if t.is_floating_point() else t, tree)


def tp_digest(tree) -> float:
    """A float64 sum over every leaf: the same cut of the same draws gives
    the same number."""
    from repro_torch.models.stacking import tree_leaves

    return sum(float(t.double().sum()) for t in tree_leaves(tree))


def tp_cpu(tree):
    from repro_torch.models.stacking import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def tp_two_steps(ops, step, base, peft, batch, seed: int, device: str, peak: bool = False) -> dict:
    """Two steps from one state, the gates from a generator seeded
    ``seed``: each step's metrics, seconds and PEFT and AdamW trees, the
    launches (and ``lora_matmul``'s routes), the collectives' counts and
    seconds, and with ``peak`` the card's ``max_memory_allocated`` over the
    first step."""
    from repro_torch.optim import adamw_init

    p, opt, rng = peft, adamw_init(peft), torch.Generator().manual_seed(seed)
    ops.reset_launch_counts()
    if step.comm is not None:
        step.comm.reset()
    out = {"metrics": [], "s": [], "trees": []}
    for k in range(TP_TRAIN["steps"]):
        if device == "cuda":
            torch.cuda.synchronize()
            if peak and k == 0:
                torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p, opt, m = step(base, p, opt, batch, rng)
        if device == "cuda":
            torch.cuda.synchronize()
            if peak and k == 0:
                out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["s"].append(time.perf_counter() - t0)
        out["metrics"].append({key: float(v) for key, v in m.items()})
        out["trees"].append(tp_cpu({"peft": p, "m": opt["m"], "v": opt["v"]}))
    out["launches"] = {k: v for k, v in ops.launch_counts.items() if v}
    out["routes"] = {k: v for k, v in ops.lora_matmul_routes.items() if v}
    if step.comm is not None:
        out["counts"], out["comm_s"] = dict(step.comm.counts), step.comm.seconds
    return out


def tp_rank(rank: int, world: int, port: int, shape, fsdp: bool, seed: int, out_path: str, device: str,
            smoke: bool):
    """One rank of phase 5o (``torch.multiprocessing.spawn``): a gloo group
    of ``world`` ranks on the one card (or the CPU), the mesh ``shape``
    (data, model).  The rank draws the whole trees from ``seed`` as the
    one-rank step did, cuts its part (``sharding.specs.shard_tree``: the
    base params by ``param_specs`` with ``fsdp_axes``, the PEFT tree
    whole), takes its rows of the batch, runs two steps twice from one
    state and the first step's gradients, and saves what the parent
    checks."""
    import torch.distributed as dist

    from repro_torch.configs import PEFTConfig, TrainConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.sharding import specs as S

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        cfg = get_config(TP_ARCH, smoke=smoke)
        pcfg = PEFTConfig()
        mesh = make_mesh(shape, TP_AXES, device_type=device)
        sizes, coords = dict(zip(TP_AXES, shape)), dict(zip(TP_AXES, mesh.get_coordinate()))
        S.set_mesh_axis_sizes(mesh)
        whole, peft = tp_draws(cfg, pcfg, seed, device)
        regather = S.param_specs(whole, sizes["model"]) if fsdp else None
        base = S.shard_tree(whole, S.param_specs(whole, sizes["model"], fsdp_axes=("data",) if fsdp else ()), sizes,
                            coords)
        digest = tp_digest(base)
        del whole
        free_memory(device)
        b, s = (4, 16) if smoke else (TP_TRAIN["batch"], TP_TRAIN["seq"])
        rows = b // sizes["data"]
        tokens = tp_tokens(cfg, seed, b, s)[coords["data"] * rows:(coords["data"] + 1) * rows]
        batch = {"tokens": tokens.to(device)}
        step = make_train_step(cfg, pcfg, TrainConfig(), stld_mode="cond", mean_rate=TP_TRAIN["rate"], mesh=mesh,
                               regather_specs=regather)
        runs = [tp_two_steps(ops, step, base, peft, batch, seed, device, peak=(i == 0)) for i in range(2)]
        _, grads = step.loss_and_grads(base, peft, batch, torch.Generator().manual_seed(seed))
        arg_bytes = tree_bytes((base, peft, adamw_init(peft), batch))
        grads = tp_cpu(grads)
        base = tp_float32(base)
        step32 = make_train_step(cfg.replace(dtype="float32"), pcfg, TrainConfig(), stld_mode="cond",
                                 mean_rate=TP_TRAIN["rate"], mesh=mesh, regather_specs=regather)
        _, grads32 = step32.loss_and_grads(base, peft, batch, torch.Generator().manual_seed(seed))
        grads32 = tp_cpu(grads32)
        # phase 5p: the sharded serving steps from the same draws cut by the
        # serving specs (no FSDP), everything of the train steps freed first
        del base, peft, batch, step, step32
        free_memory(device)
        whole, _ = tp_draws(cfg, pcfg, seed, device)
        serve_base = S.shard_tree(whole, S.param_specs(whole, sizes["model"]), sizes, coords)
        del whole
        free_memory(device)
        serving = TP_SERVE_SMOKE if smoke else TP_SERVE
        serve = tp_serve_rank_runs(ops, cfg, serve_base, mesh, False, seed, device, serving["batch"],
                                   serving["prompt"], serving["new"], pool=shape == (1, 2))
        torch.save({"coords": coords, "digest": digest, "runs": runs, "grads": grads, "grads32": grads32,
                    "argument_bytes": arg_bytes, "serve": serve}, f"{out_path}.rank{rank}")
    finally:
        dist.destroy_process_group()


def tp_meta(cfg, shape, fsdp: bool, gates, batch: int, seq: int) -> dict:
    """Phase 5o's cell on ``meta`` through the dry run's path
    (``launch.input_specs.rank_train_inputs``: rank 0's part at the mesh's
    axis sizes): the two steps with the card's gates, their launches and
    collective bytes summed, and the first step's peak."""
    from repro_torch.analysis.trace import run_on_meta
    from repro_torch.configs import InputShape, PEFTConfig, TrainConfig
    from repro_torch.launch import input_specs as ispec
    from repro_torch.launch.steps import make_train_step

    mesh = ispec.MeshShape(dict(zip(TP_AXES, shape)))
    pcfg = PEFTConfig()
    _, _, local, regather = ispec.rank_train_inputs(cfg, pcfg, InputShape("5o", seq, batch, "train"), mesh,
                                                    fsdp=fsdp, weights_dtype="placed")
    step = make_train_step(cfg, pcfg, TrainConfig(), stld_mode="cond", mean_rate=TP_TRAIN["rate"], mesh=mesh,
                           regather_specs=regather)
    local = list(local)
    replay = GateReplay()
    replay.gates = list(gates)
    launches, runs = {}, []
    with replay.replay():
        for _ in range(TP_TRAIN["steps"]):
            run = run_on_meta(step, *local)
            check(not run.host_reads, f"5o meta {shape}: host reads {run.host_reads}")
            runs.append(run)
            local[1], local[2] = run.out[0], run.out[1]
            for k, v in run.kernel_launches.items():
                launches[k] = launches.get(k, 0) + v
    return {"launches": launches, "counts": dict(step.comm.counts), "peak_bytes": runs[0].peak_bytes,
            "argument_bytes": runs[0].argument_bytes, "s": sum(r.seconds for r in runs)}


def tp_close_after_steps(got, want, lr_sum: float) -> float:
    """The largest difference of two PEFT trees, checked within 2·Σlr + 1e-6."""
    from repro_torch.models.stacking import tree_leaves

    worst = max((g.float() - w.float()).abs().max().item() for g, w in zip(tree_leaves(got), tree_leaves(want)))
    check(worst <= 2 * lr_sum + 1e-6, f"5o PEFT trees after {TP_TRAIN['steps']} steps differ by {worst}")
    return worst


def tp_grads_close(got, want) -> float:
    """The worst gradient error over its leaf's largest element."""
    from repro_torch.models.stacking import tree_leaves

    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        scale = w.float().abs().max().item()
        worst = max(worst, (g.float() - w.float()).abs().max().item() / max(scale, 1e-30))
    return worst


def tensor_parallel_full(ops, card: str, seed: int, device: str = "cuda", smoke: bool = False) -> tuple:
    """Phase 5o: qwen3-1.7b's train step sharded over a ``(data, model)``
    mesh of gloo ranks spawned on the one card (NCCL takes one rank a GPU):
    ``1 x 2`` (tensor parallelism over ``model``) and ``2 x 2`` (with FSDP
    and ``regather_specs``), full width and depth, LoRA r 8 on q and v,
    bf16, STLD ``cond`` at rate 0.5, a global batch of 16 x 512, against
    the one-rank step on the card from the same draws, batch and gates:
    losses within ``TP_LOSS_RTOL``, the PEFT trees after two steps within
    2·Σlr + 1e-6, the first step's gradients in float32 (the same draws cast
    up, both steps again) within ``TP_GRAD_TOL`` of each leaf's largest
    element, the bf16 gradients from the one-rank float32 step's within
    ``TP_BF16_GRAD_RATIO`` times the one-rank bf16 step's own distance from
    it; every rank's trees bit-identical after
    each step, a second run bit-identical to the first; launches
    ``flash_attention`` a, its backward a and ``lora_matmul`` 4a − 2s, all
    on ``wgmma``; the dry run's path on ``meta`` (``tp_meta``) gives each
    rank's launches and collective bytes exactly and its peak within
    ``META_PEAK_TOLERANCE``.  With ``device="cpu", smoke=True`` it
    rehearses on the CPU (the twins; launches and peaks not compared).
    Its ranks and the one-rank step's draws also run phase 5p's qwen3-1.7b
    serving (``tp_serve_rank_runs``, ``tp_serve_one_rank``), checked by
    ``tensor_parallel_serve_full``.  Returns (stats, launches by path, the
    seconds less 5p's part, 5p's part: the ranks' and the one-rank serving
    records and their seconds)."""
    import socket

    import torch.multiprocessing as mp

    from repro_torch.configs import PEFTConfig, TrainConfig, get_config
    from repro_torch.launch import input_specs as ispec
    from repro_torch.launch.steps import make_train_step
    from repro_torch.sharding import specs as S

    t_phase = time.perf_counter()
    cfg, pcfg, tcfg = get_config(TP_ARCH, smoke=smoke), PEFTConfig(), TrainConfig()
    on_card = device == "cuda"
    b, s = (4, 16) if smoke else (TP_TRAIN["batch"], TP_TRAIN["seq"])
    stats, launches = {}, {}

    # the one-rank step on the card: the reference of every mesh
    free_memory(device)
    base, peft = tp_draws(cfg, pcfg, seed, device)
    batch = {"tokens": tp_tokens(cfg, seed, b, s).to(device)}
    step = make_train_step(cfg, pcfg, tcfg, stld_mode="cond", mean_rate=TP_TRAIN["rate"])
    replay = GateReplay().record()
    with replay:
        one = tp_two_steps(ops, step, base, peft, batch, seed, device, peak=True)
    _, one_grads = step.loss_and_grads(base, peft, batch, torch.Generator().manual_seed(seed))
    one_grads = tp_cpu(one_grads)
    step32 = make_train_step(cfg.replace(dtype="float32"), pcfg, tcfg, stld_mode="cond", mean_rate=TP_TRAIN["rate"])
    _, one_grads32 = step32.loss_and_grads(tp_float32(base), peft, batch, torch.Generator().manual_seed(seed))
    one_grads32 = tp_cpu(one_grads32)
    del step32
    free_memory(device)
    # phase 5p's one-rank serving runs from the same draws, with and without the pool
    t_serve = time.perf_counter()
    serving = TP_SERVE_SMOKE if smoke else TP_SERVE
    serve_one = tp_serve_one_rank(ops, cfg, base, seed, device, serving["batch"], serving["prompt"], serving["new"],
                                  pools=(False, True))
    serve_s = time.perf_counter() - t_serve
    free_memory(device)
    gates = list(replay.gates)
    active = sum(int((~g.bool()).sum()) for g in gates)
    whole_digest = {}
    for shape, fsdp in TP_MESHES:  # each rank's cut, to hold the ranks' own draws against
        sizes = dict(zip(TP_AXES, shape))
        S.set_mesh_axis_sizes(ispec.MeshShape(sizes))
        cut = S.param_specs(base, shape[1], fsdp_axes=("data",) if fsdp else ())
        whole_digest[shape] = {coords: tp_digest(S.shard_tree(base, cut, sizes, dict(zip(TP_AXES, coords))))
                               for coords in np.ndindex(*shape)}
    del base, peft, step
    free_memory(device)
    stats["one_rank"] = {"s_per_step": one["s"], "losses": [m["loss"] for m in one["metrics"]],
                         "peak_gib": one.get("peak_bytes", 0) / 2**30, "launches": one["launches"],
                         "active_layers": active, "bf16_grad_err_vs_float32": tp_grads_close(one_grads, one_grads32)}
    launches["5o_one_rank"] = one["launches"]
    print(f"5o one rank {json.dumps(stats['one_rank'])} [{card}]", flush=True)

    work = ROOT / "build" / "tp"
    work.mkdir(parents=True, exist_ok=True)
    lr_sum = TP_TRAIN["steps"] * tcfg.learning_rate
    serve_ranks = {}
    for shape, fsdp in TP_MESHES:
        world = shape[0] * shape[1]
        name = f"{shape[0]}x{shape[1]}" + (" fsdp" if fsdp else "")
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        path = str(work / name.replace(" ", "_"))
        t0 = time.perf_counter()
        mp.spawn(tp_rank, args=(world, port, shape, fsdp, seed, path, device, smoke), nprocs=world, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(f"{path}.rank{r}") for r in range(world)]
        serve_ranks[name] = [rank.pop("serve") for rank in ranks]
        serve_s += max(r["s"] for r in serve_ranks[name])
        first = ranks[0]
        for r, rank in enumerate(ranks):
            coords = tuple(rank["coords"][a] for a in TP_AXES)
            check(rank["digest"] == whole_digest[shape][coords],
                  f"5o {name} rank {r}: its cut of the draws differs from the one-rank step's")
            for k in range(TP_TRAIN["steps"]):
                check(tree_equal(rank["runs"][0]["trees"][k], first["runs"][0]["trees"][k]),
                      f"5o {name}: rank {r}'s PEFT tree or AdamW state after step {k + 1} differs from rank 0's")
            check(tree_equal(rank["runs"][1]["trees"][-1], rank["runs"][0]["trees"][-1])
                  and rank["runs"][1]["metrics"] == rank["runs"][0]["metrics"],
                  f"5o {name} rank {r}: a second run differs from the first")
            check(rank["runs"][0]["metrics"] == first["runs"][0]["metrics"], f"5o {name}: rank {r}'s metrics differ")
        run = first["runs"][0]
        rel = [abs(m["loss"] - o["loss"]) / abs(o["loss"]) for m, o in zip(run["metrics"], one["metrics"])]
        check(max(rel) <= TP_LOSS_RTOL, f"5o {name}: losses {run['metrics']} against one rank's {one['metrics']}")
        grad_err = tp_grads_close(first["grads32"], one_grads32)
        check(grad_err <= TP_GRAD_TOL, f"5o {name}: float32 first-step gradients off by {grad_err} of a leaf's "
                                       "largest")
        bf16_err = tp_grads_close(first["grads"], one_grads32)
        check(bf16_err <= TP_BF16_GRAD_RATIO * stats["one_rank"]["bf16_grad_err_vs_float32"],
              f"5o {name}: bf16 first-step gradients {bf16_err} of a leaf's largest from the one-rank float32 "
              f"step's, above {TP_BF16_GRAD_RATIO} x the one-rank bf16 step's "
              f"{stats['one_rank']['bf16_grad_err_vs_float32']}")
        peft_err = tp_close_after_steps(run["trees"][-1]["peft"], one["trees"][-1]["peft"], lr_sum)
        row = {"mesh": name, "spawn_s": spawn_s, "s_per_step": [r["runs"][0]["s"] for r in ranks],
               "comm_s": [r["runs"][0]["comm_s"] for r in ranks], "counts": run["counts"],
               "losses": [m["loss"] for m in run["metrics"]], "loss_rel_err": rel, "grad_err_float32": grad_err,
               "bf16_grad_err": tp_grads_close(first["grads"], one_grads),
               "bf16_grad_err_vs_float32": bf16_err,
               "peft_max_abs_diff": peft_err, "launches": run["launches"], "routes": run["routes"]}
        meta = tp_meta(cfg, shape, fsdp, gates, b, s)
        row.update(meta_launches=meta["launches"], meta_counts=meta["counts"], meta_peak_gib=meta["peak_bytes"] / 2**30,
                   meta_s=meta["s"])
        for r, rank in enumerate(ranks):
            check(rank["runs"][0]["counts"] == meta["counts"],
                  f"5o {name} rank {r}: collectives {rank['runs'][0]['counts']}, on meta {meta['counts']}")
            check(rank["argument_bytes"] == meta["argument_bytes"],
                  f"5o {name} rank {r}: argument bytes {rank['argument_bytes']}, on meta {meta['argument_bytes']}")
        if on_card:
            want = {"flash_attention": active, "flash_attention_bwd": active,
                    "lora_matmul": 4 * active - 2 * TP_TRAIN["steps"]}
            row["peak_gib"] = [r["runs"][0]["peak_bytes"] / 2**30 for r in ranks]
            for r, rank in enumerate(ranks):
                got = rank["runs"][0]
                check(got["launches"] == want, f"5o {name} rank {r}: launches {got['launches']}, want {want}")
                check(got["routes"] == {"wgmma": want["lora_matmul"]}, f"5o {name} rank {r}: routes {got['routes']}")
                check(got["launches"] == meta["launches"], f"5o {name} rank {r}: launches {got['launches']} on the "
                                                           f"card, {meta['launches']} on meta")
                gap = meta["peak_bytes"] / got["peak_bytes"] - 1.0
                check(abs(gap) <= META_PEAK_TOLERANCE, f"5o {name} rank {r}: meta peak {meta['peak_bytes']} B "
                                                       f"against the card's {got['peak_bytes']} B ({gap:+.3f})")
            row["meta_peak_gap"] = [meta["peak_bytes"] / r["runs"][0]["peak_bytes"] - 1.0 for r in ranks]
        stats[name] = row
        launches[f"5o_{name.replace(' ', '_')}"] = run["launches"]
        print(f"5o {name} {json.dumps(row)} [{card}]", flush=True)
    # phase 5p's part (the one-rank serving runs, the ranks' serving runs) is counted as 5p's
    return stats, launches, time.perf_counter() - t_phase - serve_s, {"ranks": serve_ranks, "one": serve_one,
                                                                        "s": serve_s}


# -------------------------------------------------------------------- phase 5p
# the sharded serving steps: qwen3-1.7b's inside phase 5o's ranks (1 x 2 with
# a pool of tenants, 2 x 2 with rows over data), and two spawns of their own
TP_SERVE = {"batch": 8, "prompt": 512, "new": 16}
TP_SERVE_SMOKE = {"batch": 2, "prompt": 16, "new": 4}
TP_SERVE_POOL_RANKS = (4, 8, 4, 8)  # the 1 x 2 decode's tenants on q and v, r_max 8
# (arch, (data, model), layers, batch, prompt, sequence over data): glm4-9b's
# caches cut on the head dim (KV 2 under model 4: 32 dims a rank); danube's
# 4 096-slot window ring cut over data at batch 1 (2 048 slots a rank), its
# prompt past the window and its decode crossing from data rank 0's slots
# to rank 1's (6 140 % 4 096 = 2 044)
TP_SERVE_SPAWNS = (("glm4-9b", (1, 4), 8, 8, 512, False), ("h2o-danube-1.8b", (2, 2), 8, 1, 6140, True))
TP_SERVE_SPAWN_NEW = 8  # the spawns' new tokens: danube's decode crosses to data rank 1's slots at the fifth
TP_SERVE_SPAWNS_SMOKE = (("glm4-9b", (1, 4), 2, 2, 16, False), ("h2o-danube-1.8b", (2, 2), 2, 1, 94, True))
TP_SERVE_SHORT = {"glm4-9b": "glm4", "h2o-danube-1.8b": "danube"}  # the runs' names in launches_by_path
TP_SERVE_F32_TOL = 1e-4  # float32 logits, of the largest |logit|: sums over ranks in another order


def tp_serve_pool(cfg, seed: int, batch: int, device: str):
    """Stacked tenant pools on ``q`` and ``v`` (``TP_SERVE_POOL_RANKS``,
    each rank's tail zero, the scale folded into b), drawn on the CPU from
    ``seed``; row i at tenant i % 4."""
    from repro_torch.nn.linear import AdapterPool

    g = torch.Generator().manual_seed(seed + 11)
    hd, layers, n, r_max = cfg.resolved_head_dim, cfg.num_layers, len(TP_SERVE_POOL_RANKS), max(TP_SERVE_POOL_RANKS)
    pools = {}
    for name, width in (("q", cfg.num_heads * hd), ("v", cfg.num_kv_heads * hd)):
        a = torch.randn((layers, n, cfg.d_model, r_max), generator=g) * cfg.d_model**-0.5
        b = torch.randn((layers, n, r_max, width), generator=g) * 0.05
        for t, r in enumerate(TP_SERVE_POOL_RANKS):
            a[:, t, :, r:] = 0
            b[:, t, r:] = 0
        idx = (torch.arange(batch, dtype=torch.int32) % n).expand(layers, batch).contiguous()
        ranks = torch.tensor(TP_SERVE_POOL_RANKS, dtype=torch.int32).expand(layers, n).contiguous()
        pools[name] = AdapterPool(a.to(device), b.to(device), idx.to(device), ranks.to(device))
    return {"attn": pools}


def tp_serve_prompt(cfg, seed: int, batch: int, prompt: int):
    return torch.randint(0, cfg.vocab_size, (batch, prompt), generator=torch.Generator().manual_seed(seed + 12),
                         dtype=torch.int32)


def tp_serve_run(ops, cfg, params, prompt, new: int, device: str, *, mesh=None, seq: bool = False, peft=None,
                 feed=None, measure: bool = False) -> dict:
    """The prefill of ``prompt`` (this rank's rows) into fresh caches
    (``init_caches`` in ``cfg.dtype``, cut by ``cache_specs`` for a mesh),
    then ``new`` decode steps at the scalar position: greedy, or fed the
    tokens ``feed`` (new, B) (the float32 run's, so that bf16 logits are
    compared on one token stream).  Returns each step's last logits
    (float32, on the CPU), the next tokens, and with ``measure`` the
    seconds, collective seconds and counts (the prefill's, each decode
    step's), launches and peaks of the prefill and of the decode steps."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.losses import vocab_parallel_argmax
    from repro_torch.models.transformer import init_caches
    from repro_torch.sharding import specs as S

    b_rows, p_len = prompt.shape
    batch = b_rows if mesh is None or seq else b_rows * dict(zip(TP_AXES, mesh.mesh.shape))["data"]
    caches = init_caches(cfg, batch, p_len + new, dtype=getattr(torch, cfg.dtype), device=device)
    prefill = make_prefill_step(cfg, mesh=mesh, shard_seq=seq)
    serve = make_serve_step(cfg, mesh=mesh, shard_seq=seq)
    comm = prefill.comm
    if mesh is not None:
        sizes = dict(zip(TP_AXES, mesh.mesh.shape))
        coords = dict(zip(TP_AXES, mesh.get_coordinate()))
        caches = S.shard_tree(caches, S.cache_specs(caches, ("data",), sizes["model"], shard_seq_on_data=seq),
                              sizes, coords)
        serve.comm.reset()
    on_card = device == "cuda"
    out = {"logits": [], "tokens": [], "counts": [], "comm_s": 0.0}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    free_memory(device)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, caches = prefill(params, {"tokens": prompt.to(device)}, caches)
    sync()
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_launches"] = {k: v for k, v in ops.launch_counts.items() if v}
    if on_card:
        out["prefill_peak_bytes"] = torch.cuda.max_memory_allocated()
    if comm is not None:
        out["counts"].append(dict(comm.counts))
        out["comm_s"] += comm.seconds
    token = (torch.argmax(logits, -1) if comm is None else vocab_parallel_argmax(logits, comm))[:, None].to(torch.int32)
    out["logits"].append(logits.float().cpu())
    out["first_token"] = token[:, 0].cpu()
    if feed is not None:
        token = feed[0][:, None].to(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for k in range(new):
        if comm is not None:
            serve.comm.reset()
        logits, nxt, caches = serve(params, token, p_len + k, caches, peft=peft)
        if comm is not None:
            out["counts"].append(dict(serve.comm.counts))
            out["comm_s"] += serve.comm.seconds
        out["logits"].append(logits.float().cpu())
        out["tokens"].append(nxt[:, 0].cpu())
        token = nxt if feed is None or k + 1 >= new else feed[k + 1][:, None].to(device)
    sync()
    out["decode_s"] = time.perf_counter() - t0
    out["s_per_token"] = out["decode_s"] / new
    out["decode_launches"] = {k: v for k, v in ops.launch_counts.items() if v}
    if on_card:
        out["decode_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["tokens"] = torch.stack(out["tokens"])
    out["fed"] = torch.cat([out["first_token"][None], out["tokens"][:-1]]) if feed is None else feed
    if not measure:
        for key in ("prefill_launches", "decode_launches", "counts"):
            out.pop(key)
    return out


def tp_serve_dtypes(ops, cfg, params, prompt, new: int, device: str, **kw) -> dict:
    """``tp_serve_run`` in float32 (the same draws cast up, the pool's
    float32 as drawn; greedy), then in ``cfg.dtype`` fed the float32 run's
    tokens and measured."""
    f32 = tp_serve_run(ops, cfg.replace(dtype="float32"), tp_float32(params), prompt, new, device, **kw)
    free_memory(device)
    return {"float32": f32, "bf16": tp_serve_run(ops, cfg, params, prompt, new, device, feed=f32["fed"],
                                                 measure=True, **kw)}


def tp_serve_rank_runs(ops, cfg, base, mesh, seq: bool, seed: int, device: str, batch: int, prompt_len: int,
                       new: int, pool: bool) -> dict:
    """A rank's sharded serving runs (``tp_serve_dtypes``) from its part of
    the weights ``base``: its rows of the prompt (all of them with ``seq``)
    and, with ``pool``, the tenant pools, their slot maps cut to its rows."""
    from repro_torch.nn.linear import AdapterPool

    sizes, coords = dict(zip(TP_AXES, mesh.mesh.shape)), dict(zip(TP_AXES, mesh.get_coordinate()))
    rows = batch if seq else batch // sizes["data"]
    lo = 0 if seq else coords["data"] * rows
    prompt = tp_serve_prompt(cfg, seed, batch, prompt_len)[lo:lo + rows]
    peft = None
    if pool:
        whole = tp_serve_pool(cfg, seed, batch, device)
        peft = {"attn": {k: AdapterPool(v.a, v.b, v.idx[..., lo:lo + rows].contiguous(), v.ranks)
                         for k, v in whole["attn"].items()}}
    t0 = time.perf_counter()
    runs = tp_serve_dtypes(ops, cfg, base, prompt, new, device, mesh=mesh, seq=seq, peft=peft)
    return {"coords": coords, "rows": (lo, lo + rows), "runs": runs, "s": time.perf_counter() - t0,
            "argument_bytes": tree_bytes(base)}


def tp_serve_one_rank(ops, cfg, base, seed: int, device: str, batch: int, prompt_len: int, new: int,
                      pools=(False,)) -> dict:
    """The one-rank serving steps on the card from the whole draws: the
    reference of every mesh, in float32 and bf16, with and without the
    tenant pool."""
    prompt = tp_serve_prompt(cfg, seed, batch, prompt_len)
    out = {}
    for pool in pools:
        peft = tp_serve_pool(cfg, seed, batch, device) if pool else None
        out[pool] = tp_serve_dtypes(ops, cfg, base, prompt, new, device, peft=peft)
    return out


def tp_serve_rank(rank: int, world: int, port: int, arch: str, shape, layers: int, batch: int, prompt_len: int,
                  seq: bool, seed: int, out_path: str, device: str, smoke: bool):
    """One rank of phase 5p's own spawns (``TP_SERVE_SPAWNS``): the whole
    draws of ``arch`` cut to ``layers`` (as the one-rank steps drew them),
    its part cut by ``param_specs``, the sharded serving runs; saves them."""
    import torch.distributed as dist

    from repro_torch.configs import PEFTConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import specs as S

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    try:
        cfg = get_config(arch, smoke=smoke).replace(num_layers=layers)
        mesh = make_mesh(shape, TP_AXES, device_type=device)
        sizes, coords = dict(zip(TP_AXES, shape)), dict(zip(TP_AXES, mesh.get_coordinate()))
        S.set_mesh_axis_sizes(mesh)
        whole, _ = tp_draws(cfg, PEFTConfig(), seed, device)
        base = S.shard_tree(whole, S.param_specs(whole, sizes["model"]), sizes, coords)
        digest = tp_digest(base)
        del whole
        free_memory(device)
        new = TP_SERVE_SMOKE["new"] if smoke else TP_SERVE_SPAWN_NEW
        serve = tp_serve_rank_runs(ops, cfg, base, mesh, seq, seed, device, batch, prompt_len, new, False)
        torch.save({"coords": coords, "digest": digest, "serve": serve}, f"{out_path}.rank{rank}")
    finally:
        dist.destroy_process_group()


def tp_serve_meta(cfg, shape, batch: int, prompt_len: int, new: int, seq: bool, pool) -> dict:
    """Phase 5p's run on ``meta`` through the dry run's path
    (``launch.input_specs.rank_serve_inputs``: rank 0's part at the mesh's
    axis sizes, the weights as placed, caches of prompt + new slots): the
    prefill (from position 0), then one decode step; each one's launches,
    collective bytes and peak."""
    from repro_torch.analysis.trace import meta_like, run_on_meta
    from repro_torch.configs import InputShape
    from repro_torch.launch import input_specs as ispec
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    mesh = ispec.MeshShape(dict(zip(TP_AXES, shape)))
    _, _, (params, token, pos, caches) = ispec.rank_serve_inputs(
        cfg, InputShape("5p", prompt_len + new, batch, "decode"), mesh, weights_dtype="placed")
    rows = batch if seq else batch // shape[0]
    prefill = make_prefill_step(cfg, mesh=mesh, shard_seq=seq)
    run = run_on_meta(prefill, params, {"tokens": torch.empty((rows, prompt_len), dtype=torch.int32, device="meta")},
                      ispec.set_cache_position(caches, 0))
    check(not run.host_reads, f"5p meta prefill {cfg.name} {shape}: host reads {run.host_reads}")
    out = {"prefill": {"launches": run.kernel_launches, "counts": dict(prefill.comm.counts),
                       "peak_bytes": run.peak_bytes, "argument_bytes": run.argument_bytes}}
    serve = make_serve_step(cfg, mesh=mesh, shard_seq=seq)
    caches = ispec.set_cache_position(caches, pos)
    if pool is not None:  # rank 0's rows of the slot maps
        from repro_torch.nn.linear import AdapterPool

        pool = {"attn": {k: AdapterPool(v.a, v.b, v.idx[..., :rows].contiguous(), v.ranks)
                         for k, v in pool["attn"].items()}}
        run = run_on_meta(serve, params, token, pos, caches, None, meta_like(pool))
    else:
        run = run_on_meta(serve, params, token, pos, caches)
    check(not run.host_reads, f"5p meta decode {cfg.name} {shape}: host reads {run.host_reads}")
    out["decode"] = {"launches": run.kernel_launches, "counts": dict(serve.comm.counts), "peak_bytes": run.peak_bytes,
                     "argument_bytes": run.argument_bytes}
    return out


def tp_logit_err(got, want) -> float:
    """The largest |difference| over the largest |logit| of ``want``."""
    return (got.float() - want.float()).abs().max().item() / want.float().abs().max().item()


def tp_serve_check(name: str, cfg, ranks: list, one: dict, meta, shape, seq: bool, new: int, on_card: bool,
                   pool: bool) -> dict:
    """Phase 5p's checks of one mesh's ranks (their ``serve`` records)
    against the one-rank runs ``one`` (``tp_serve_dtypes``' pair) and the
    meta runs: float32 tokens equal and logits within
    ``TP_SERVE_F32_TOL``; bf16 first decode step within
    ``TP_BF16_GRAD_RATIO`` times the one-rank bf16 step's distance from
    its float32 step; every model rank's tokens bit-identical; on the card
    launches, collective bytes and peaks against meta's."""
    sizes = dict(zip(TP_AXES, shape))
    vocab = cfg.vocab_size

    def gathered(dtype: str, k: int, key="logits"):
        """Step k's logits (or tokens), put together from the ranks' rows
        and vocabulary slices."""
        if key == "tokens":
            out = torch.empty_like(one[dtype]["tokens"])
            for r in ranks:
                lo, hi = r["rows"]
                out[:, lo:hi] = r["runs"][dtype]["tokens"]
            return out
        out = torch.empty((one[dtype]["logits"][k].shape[0], vocab))
        for r in ranks:
            lo, hi = r["rows"]
            part = r["runs"][dtype]["logits"][k]
            m = r["coords"]["model"]
            out[lo:hi, m * part.shape[1]:(m + 1) * part.shape[1]] = part
        return out

    row = {"mesh": name}
    # float32: the tokens, the prefill's argmax included, and every step's logits
    f32_one = one["float32"]
    f32_tokens = gathered("float32", 0, "tokens")
    check(torch.equal(f32_tokens, f32_one["tokens"]), f"5p {name}: float32 tokens {f32_tokens.tolist()}, one rank "
                                                      f"{f32_one['tokens'].tolist()}")
    errs = [tp_logit_err(gathered("float32", k), f32_one["logits"][k]) for k in range(new + 1)]
    check(max(errs) <= TP_SERVE_F32_TOL, f"5p {name}: float32 logits off by {max(errs)} of the largest |logit|")
    row["float32_logit_err"] = max(errs)
    # bf16, fed the float32 tokens: the first decode step against the one-rank float32 step
    one_bf16 = tp_logit_err(one["bf16"]["logits"][1], f32_one["logits"][1])
    got_bf16 = tp_logit_err(gathered("bf16", 1), f32_one["logits"][1])
    check(got_bf16 <= TP_BF16_GRAD_RATIO * one_bf16, f"5p {name}: bf16 first decode logits {got_bf16} of the largest "
                                                     f"|logit| from float32's, above {TP_BF16_GRAD_RATIO} x the "
                                                     f"one-rank bf16 step's {one_bf16}")
    bf16_tokens = gathered("bf16", 0, "tokens")
    row.update(bf16_first_decode_err=got_bf16, one_rank_bf16_first_decode_err=one_bf16,
               bf16_token_agreement=float((bf16_tokens == one["bf16"]["tokens"]).float().mean()),
               bf16_prefill_err=tp_logit_err(gathered("bf16", 0), one["bf16"]["logits"][0]))
    for dtype in ("float32", "bf16"):  # every model rank's next tokens and logits' rows alike
        for r in ranks:
            twin = next(o for o in ranks if o["rows"] == r["rows"])
            check(torch.equal(r["runs"][dtype]["tokens"], twin["runs"][dtype]["tokens"]),
                  f"5p {name} {dtype}: model ranks' tokens differ")
    bf = [r["runs"]["bf16"] for r in ranks]
    row.update(s_per_token=[b["s_per_token"] for b in bf], prefill_s=[b["prefill_s"] for b in bf],
               comm_s=[b["comm_s"] for b in bf], one_rank_s_per_token=one["bf16"]["s_per_token"],
               one_rank_prefill_s=one["bf16"]["prefill_s"], counts_prefill=bf[0]["counts"][0],
               counts_decode_step=bf[0]["counts"][1], launches_prefill=bf[0]["prefill_launches"],
               launches_decode=bf[0]["decode_launches"], rank_s=[r["s"] for r in ranks],
               meta_launches=meta["prefill"]["launches"] | {f"decode_{k}": v for k, v in
                                                            meta["decode"]["launches"].items()})
    for b in bf:
        check(b["counts"][0] == meta["prefill"]["counts"], f"5p {name}: prefill collectives {b['counts'][0]}, on "
                                                           f"meta {meta['prefill']['counts']}")
        for c in b["counts"][1:]:
            check(c == meta["decode"]["counts"], f"5p {name}: decode collectives {c}, on meta "
                                                 f"{meta['decode']['counts']}")
    if on_card:
        layers = cfg.num_layers
        dim_cut = cfg.num_kv_heads % sizes["model"] != 0
        want_decode = ({"flash_decode_scores": layers * new, "flash_decode_combine": layers * new} if dim_cut
                       else {"flash_decode": layers * new})
        if pool:
            want_decode["segmented_lora"] = 2 * layers * new
        for b in bf:
            check(b["prefill_launches"] == {"flash_attention": layers} == meta["prefill"]["launches"],
                  f"5p {name}: prefill launches {b['prefill_launches']}, meta {meta['prefill']['launches']}")
            per_step = {k: v * new for k, v in meta["decode"]["launches"].items()}
            check(b["decode_launches"] == want_decode == per_step,
                  f"5p {name}: decode launches {b['decode_launches']}, want {want_decode}, meta x {new} {per_step}")
        row["peak_gib"] = {"prefill": [b["prefill_peak_bytes"] / 2**30 for b in bf],
                           "decode": [b["decode_peak_bytes"] / 2**30 for b in bf]}
        row["one_rank_peak_gib"] = {"prefill": one["bf16"]["prefill_peak_bytes"] / 2**30,
                                    "decode": one["bf16"]["decode_peak_bytes"] / 2**30}
        row["meta_peak_gib"] = {"prefill": meta["prefill"]["peak_bytes"] / 2**30,
                                "decode": meta["decode"]["peak_bytes"] / 2**30}
        for phase in ("prefill", "decode"):
            for b in bf:
                gap = meta[phase]["peak_bytes"] / b[f"{phase}_peak_bytes"] - 1.0
                check(abs(gap) <= META_PEAK_TOLERANCE, f"5p {name} {phase}: meta peak {meta[phase]['peak_bytes']} B "
                                                       f"against the card's {b[f'{phase}_peak_bytes']} B ({gap:+.3f})")
    return row


def split_pair_case(ops, ref, ring_positions, timer, gen, *, b: int, h: int, kv: int, dr: int, hd: int, s: int,
                    window=None) -> dict:
    """The head-dim split's two kernels at a rank's shape of phase 5p's
    decode (every query head, ``dr`` of each KV head's ``hd`` dims, bf16,
    every row at the ring's last slot), each against its twin: the scores
    within 1e-4 + 1e-4 |ref| (float32 sums of Dr bf16 products in another
    order), the output within bf16's 3e-2 + 1e-2 |ref|, the log-sum-exp
    within 1e-4; again on the same draws cast up to float32, the scores
    within 1e-5 + 1e-5 |ref| and the output within 2e-5 + 1e-5 |ref|, a
    bound that a wrong P V cannot meet; timed in bf16 beside the twins,
    the bounds and, for the scores, one ``torch.einsum`` of the same
    products (the combine has no single library call)."""
    q = torch.randn((b, h, dr), generator=gen, device="cuda").to(torch.bfloat16)
    kc = torch.randn((b, s, kv, dr), generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn((b, s, kv, dr), generator=gen, device="cuda").to(torch.bfloat16)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device="cuda")
    kpos = ring_positions(pos, s)
    scale = hd**-0.5
    scores_fn = lambda: ops.flash_decode_scores(q, kc, scale=scale)  # noqa: E731
    scores = scores_fn()
    want = ref.decode_scores_plain(q, kc, scale=scale)
    combine_fn = lambda: ops.flash_decode_combine(scores, vc, pos, kpos, window=window, dtype=q.dtype)  # noqa: E731
    out, lse = combine_fn()
    want_out, want_lse = ref.decode_combine_plain(scores, vc, pos, kpos, window=window, dtype=q.dtype)
    torch.cuda.synchronize()
    what = f"B={b} H={h} KV={kv} Dr={dr} S={s}"
    check(torch.allclose(scores, want, atol=1e-4, rtol=1e-4), f"flash_decode_scores {what}: off its twin by "
                                                              f"{(scores - want).abs().max().item()}")
    check(torch.allclose(out.float(), want_out.float(), atol=3e-2, rtol=1e-2),
          f"flash_decode_combine {what}: off its twin by {(out.float() - want_out.float()).abs().max().item()}")
    check(torch.allclose(lse, want_lse, atol=1e-4, rtol=1e-5), f"flash_decode_combine {what}: log-sum-exp off by "
                                                              f"{(lse - want_lse).abs().max().item()}")
    q32, kc32, vc32 = q.float(), kc.float(), vc.float()
    scores32 = ops.flash_decode_scores(q32, kc32, scale=scale)
    want32 = ref.decode_scores_plain(q32, kc32, scale=scale)
    out32, lse32 = ops.flash_decode_combine(scores32, vc32, pos, kpos, window=window, dtype=torch.float32)
    want_out32, want_lse32 = ref.decode_combine_plain(scores32, vc32, pos, kpos, window=window, dtype=torch.float32)
    torch.cuda.synchronize()
    errs32 = {"scores": (scores32 - want32).abs().max().item(), "out": (out32 - want_out32).abs().max().item(),
              "lse": (lse32 - want_lse32).abs().max().item()}
    check(torch.allclose(scores32, want32, atol=1e-5, rtol=1e-5) and
          torch.allclose(out32, want_out32, atol=2e-5, rtol=1e-5) and
          torch.allclose(lse32, want_lse32, atol=1e-4, rtol=1e-5),
          f"the split pair {what} in float32: off its twins by {errs32}")
    live = ((kpos <= pos[:, None]) & ((kpos > pos[:, None] - window) if window else True)).sum(-1)
    live_total = int(live.sum().item())  # live slots summed over the rows
    qg = q.view(b, kv, h // kv, dr)
    scores_bytes = q.numel() * 2 + kc.numel() * 2 + b * h * s * 4
    combine_bytes = h * live_total * 4 + live_total * kv * dr * 2 + 4 * (b + b * s) + b * h * dr * 2 + b * h * 4
    sb, sby = bound(scores_bytes, 2 * b * h * s * dr, "float32")
    cb, cby = bound(combine_bytes, 2 * h * dr * live_total + 4 * h * live_total, "float32")
    shape = f"{what} hd={hd} window={window} bf16 q and cache, float32 scores, {live_total} live slots over {b} rows"
    return {
        "scores": {"shape": shape, "max_abs_err": (scores - want).abs().max().item(), "ms": timer(scores_fn),
                   "plain_ms": timer(lambda: ref.decode_scores_plain(q, kc, scale=scale)), "bound_ms": sb,
                   "bound_by": sby,
                   "library_ms": timer(lambda: torch.einsum("bgrd,bsgd->bgrs", qg, kc)),
                   "kernel_ms": device_ms(scores_fn, timer.flush)},
        "combine": {"shape": shape, "max_abs_err": (out.float() - want_out.float()).abs().max().item(),
                    "lse_max_abs_err": (lse - want_lse).abs().max().item(), "float32_max_abs_err": errs32,
                    "ms": timer(combine_fn),
                    "plain_ms": timer(lambda: ref.decode_combine_plain(scores, vc, pos, kpos, window=window,
                                                                       dtype=q.dtype)),
                    "bound_ms": cb, "bound_by": cby, "library_ms": None,
                    "kernel_ms": device_ms(combine_fn, timer.flush)},
    }


def decode_lse_case(ops, ref, ring_positions, timer, gen, *, h: int, kv: int, d: int, slots: int, ring: int, pos: int,
                    window) -> dict:
    """``flash_decode`` with its log-sum-exp at a data rank's slice of a
    sequence-sharded ring (batch 1: rank 0's ``slots`` of ``ring``, the
    query at ``pos``), bf16, against its twin (the output as
    ``decode_case``'s rule, the log-sum-exp within 1e-4), timed with and
    without the log-sum-exp, beside the twin and the bound."""
    q = torch.randn((1, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    kc = torch.randn((1, slots, kv, d), generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn((1, slots, kv, d), generator=gen, device="cuda").to(torch.bfloat16)
    qpos = torch.tensor([pos], dtype=torch.int32, device="cuda")
    kpos = ring_positions(qpos, ring, 0, slots)
    fn = lambda: ops.flash_decode(q, kc, vc, qpos, kpos, window=window, return_lse=True)  # noqa: E731
    out, lse = fn()
    want, want_lse = ref.decode_attention_plain(q, kc, vc, qpos, kpos, window=window, return_lse=True)
    torch.cuda.synchronize()
    check(torch.allclose(out.float(), want.float(), atol=3e-2, rtol=1e-2) and
          torch.allclose(lse, want_lse, atol=1e-4, rtol=1e-5),
          f"flash_decode with its log-sum-exp: off its twin by {(out.float() - want.float()).abs().max().item()}, "
          f"{(lse - want_lse).abs().max().item()}")
    live = int(((kpos <= qpos[:, None]) & (kpos > qpos[:, None] - window)).sum().item())
    nbytes = q.numel() * 2 * 2 + live * kv * d * 2 * 2 + 4 * (1 + slots) + h * 4
    b_ms, b_by = bound(nbytes, 4 * live * h * d, "bfloat16")
    return {"shape": f"B=1 H={h} KV={kv} D={d} S={slots} of a ring of {ring}, query at {pos}, window={window}, bf16, "
                     f"{live} live slots",
            "max_abs_err": (out.float() - want.float()).abs().max().item(),
            "lse_max_abs_err": (lse - want_lse).abs().max().item(), "ms": timer(fn),
            "ms_without_lse": timer(lambda: ops.flash_decode(q, kc, vc, qpos, kpos, window=window)),
            "kernel_ms": device_ms(fn, timer.flush),
            "kernel_ms_without_lse": device_ms(lambda: ops.flash_decode(q, kc, vc, qpos, kpos, window=window),
                                                    timer.flush),
            "plain_ms": timer(lambda: ref.decode_attention_plain(q, kc, vc, qpos, kpos, window=window,
                                                                 return_lse=True)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def tensor_parallel_serve_full(ops, ref, timer, card: str, seed: int, qwen3: dict, device: str = "cuda",
                               smoke: bool = False) -> tuple:
    """Phase 5p: the dense family's sharded prefill and decode steps
    (``make_prefill_step``/``make_serve_step`` with ``mesh=...``) on gloo
    ranks on the one card, full width, bf16: qwen3-1.7b inside phase 5o's
    ranks (``qwen3``: ``tensor_parallel_full``'s serving records and
    one-rank runs; 1 x 2 with a pool of tenants through
    ``segmented_lora``, 2 x 2 with rows over ``data``; the KV heads over
    ``model``), then ``TP_SERVE_SPAWNS`` (glm4-9b on 1 x 4, its caches cut
    on the head dim: the split pair; h2o-danube-1.8b on 2 x 2 at batch 1,
    its window ring cut over ``data``: ``flash_decode``'s log-sum-exp and
    the combine), each depth-cut (printed), against the one-rank steps on
    the card from the same draws and prompts (``tp_serve_check``) and the
    dry run's path on meta (``tp_serve_meta``); then the split pair and the
    log-sum-exp at the runs' shapes against their twins, timed.  With
    ``device="cpu", smoke=True`` it rehearses on the CPU (the twins;
    launches, peaks and timings not compared).  Returns (stats, launches by
    path, the kernel cases, seconds)."""
    import socket

    import torch.multiprocessing as mp

    from repro_torch.configs import PEFTConfig, get_config
    from repro_torch.launch import input_specs as ispec
    from repro_torch.nn.attention import ring_positions
    from repro_torch.sharding import specs as S

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    shapes = TP_SERVE_SMOKE if smoke else TP_SERVE
    new = shapes["new"]
    stats, launches = {}, {}

    def record(key, ranks):
        bf = ranks[0]["runs"]["bf16"]
        launches[key] = {k: bf["prefill_launches"].get(k, 0) + bf["decode_launches"].get(k, 0)
                         for k in set(bf["prefill_launches"]) | set(bf["decode_launches"])}

    cfg = get_config(TP_ARCH, smoke=smoke)
    for (shape, _), name in zip(TP_MESHES, qwen3["ranks"]):  # 5o's names; the serving cut takes no FSDP
        pool, label = shape == (1, 2), name.split()[0]
        meta = tp_serve_meta(cfg, shape, shapes["batch"], shapes["prompt"], new, False,
                             tp_serve_pool(cfg, seed, shapes["batch"], "cpu") if pool else None)
        row = tp_serve_check(f"qwen3 {label}", cfg, qwen3["ranks"][name], qwen3["one"][pool], meta, shape, False,
                             new, on_card, pool)
        stats[f"qwen3 {label}"] = row
        record(f"5p_qwen3_{label}", qwen3["ranks"][name])
        print(f"5p qwen3 {label} {json.dumps(row)} [{card}]", flush=True)

    work = ROOT / "build" / "tp_serve"
    work.mkdir(parents=True, exist_ok=True)
    new = TP_SERVE_SMOKE["new"] if smoke else TP_SERVE_SPAWN_NEW
    for arch, shape, layers, batch, prompt_len, seq in (TP_SERVE_SPAWNS_SMOKE if smoke else TP_SERVE_SPAWNS):
        full = get_config(arch, smoke=smoke)
        c = full.replace(num_layers=layers)
        name = f"{arch} {shape[0]}x{shape[1]}" + (" seq" if seq else "")
        print(f"5p {name}: depth cut to {layers} of {full.num_layers} layers, widths whole, batch {batch}, "
              f"prompt {prompt_len}, {new} new tokens [{card}]", flush=True)
        free_memory(device)
        t0 = time.perf_counter()
        whole, _ = tp_draws(c, PEFTConfig(), seed, device)
        sizes = dict(zip(TP_AXES, shape))
        S.set_mesh_axis_sizes(ispec.MeshShape(sizes))
        spec = S.param_specs(whole, sizes["model"])
        digest = {coords: tp_digest(S.shard_tree(whole, spec, sizes, dict(zip(TP_AXES, coords))))
                  for coords in np.ndindex(*shape)}
        one = tp_serve_one_rank(ops, c, whole, seed, device, batch, prompt_len, new)[False]
        one_s = time.perf_counter() - t0
        del whole
        free_memory(device)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        path = str(work / name.replace(" ", "_"))
        t0 = time.perf_counter()
        mp.spawn(tp_serve_rank, args=(shape[0] * shape[1], port, arch, shape, layers, batch, prompt_len, seq, seed,
                                      path, device, smoke), nprocs=shape[0] * shape[1], join=True)
        spawn_s = time.perf_counter() - t0
        saved = [torch.load(f"{path}.rank{r}") for r in range(shape[0] * shape[1])]
        for r, rank in enumerate(saved):
            coords = tuple(rank["coords"][a] for a in TP_AXES)
            check(rank["digest"] == digest[coords], f"5p {name} rank {r}: its cut of the draws differs from the "
                                                    "one-rank steps'")
        ranks = [rank["serve"] for rank in saved]
        meta = tp_serve_meta(c, shape, batch, prompt_len, new, seq, None)
        row = tp_serve_check(name, c, ranks, one, meta, shape, seq, new, on_card, False)
        row.update(layers=layers, full_layers=full.num_layers, one_rank_s=one_s, spawn_s=spawn_s)
        stats[name] = row
        record(f"5p_{TP_SERVE_SHORT[arch]}_{shape[0]}x{shape[1]}" + ("_seq" if seq else ""), ranks)
        print(f"5p {name} {json.dumps(row)} [{card}]", flush=True)

    cases = {}
    if on_card:  # the new kernel work at the runs' shapes: glm4-9b's rank of 1 x 4, danube's data rank 0
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 13)
        glm4 = get_config("glm4-9b")
        cases["split"] = split_pair_case(ops, ref, ring_positions, timer, gen, b=TP_SERVE_SPAWNS[0][3],
                                         h=glm4.num_heads, kv=glm4.num_kv_heads, dr=glm4.resolved_head_dim // 4,
                                         hd=glm4.resolved_head_dim, s=TP_SERVE_SPAWNS[0][4] + TP_SERVE_SPAWN_NEW)
        danube = get_config("h2o-danube-1.8b")
        prompt_len = TP_SERVE_SPAWNS[1][4]
        cases["lse"] = decode_lse_case(ops, ref, ring_positions, timer, gen, h=danube.num_heads // 2,
                                       kv=danube.num_kv_heads // 2, d=danube.resolved_head_dim,
                                       slots=danube.sliding_window // 2, ring=danube.sliding_window,
                                       pos=prompt_len + TP_SERVE_SPAWN_NEW - 1, window=danube.sliding_window)
        for key, case in (("flash_decode_scores", cases["split"]["scores"]),
                          ("flash_decode_combine", cases["split"]["combine"]), ("flash_decode lse", cases["lse"])):
            print(f"5p {key} {json.dumps(case)} [{card}]", flush=True)
    return stats, launches, cases, time.perf_counter() - t_phase


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--scans-of", metavar="SRC",
                        help="run only the scan kernels' timed cases (phase 3's wkv6 and mamba_scan, bf16) with the "
                             "repro_torch under SRC, another tree's src directory, and print no result; run once "
                             "for each tree, in turns, to compare two trees on one card")
    parser.add_argument("--scans", default="wkv6,mamba_scan",
                        help="with --scans-of, the kernels to time, a comma-separated subset of "
                             "wkv6,mamba_scan,flash_decode")
    args = parser.parse_args()
    t_script = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.scans_of:
        sys.path.insert(0, str(Path(args.scans_of).resolve()))
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models.layers import layer_kind
    from repro_torch.nn.attention import ring_positions

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    print(card, flush=True)
    if args.scans_of:
        scans = tuple(args.scans.split(","))
        check(set(scans) <= {"wkv6", "mamba_scan", "flash_decode"},
              f"--scans takes wkv6, mamba_scan and flash_decode, got {args.scans}")
        return scans_of(args.scans_of, card, args.seed, scans)

    # 2. build
    t0 = time.perf_counter()
    build_s = _build.build()
    for name in _build.KERNELS:
        log = _build.library_path(name).with_name(_build.library_path(name).name + ".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {name}: {build_s[name]:.1f} s; ptxas: {' | '.join(usage)}", flush=True)
    print(f"build: {len(_build.KERNELS)} kernels in {time.perf_counter() - t0:.1f} s wall", flush=True)
    print(f"kernel resources: {json.dumps(kernel_resources(_build))}", flush=True)

    # 3. kernels against their twins, timed
    t_phase = time.perf_counter()
    timer = Timer()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    seg = {}
    for dtype in (torch.bfloat16, torch.float32):
        for n in (2048, 1024):
            seg[(dtype, n)] = segmented_case(ops, ref, timer, gen, dtype=dtype, n=n)
            print(f"segmented_lora {json.dumps(seg[(dtype, n)])} [{card}]", flush=True)
    dec = {}
    for q_dtype in (torch.bfloat16, torch.float32):
        dec[q_dtype] = decode_case(ops, ref, ring_positions, timer, gen, q_dtype=q_dtype)
        print(f"flash_decode {json.dumps(dec[q_dtype])} [{card}]", flush=True)
    attn = attention_case(ops, ref, timer, gen, dtype=torch.bfloat16)
    print(f"flash_attention {json.dumps(attn)} [{card}]", flush=True)
    # jamba-v0.1-52b's heads, drawn from a generator of their own so that
    # every later case sees the inputs it saw before this case was added
    gen_jamba = torch.Generator(device="cuda")
    gen_jamba.manual_seed(args.seed + 1)
    attn_jamba = attention_case(ops, ref, timer, gen_jamba, dtype=torch.bfloat16, h=32)
    print(f"flash_attention jamba {json.dumps(attn_jamba)} [{card}]", flush=True)
    for kw in ({"dtype": torch.float32, "b": 2}, {"dtype": torch.bfloat16, "s": 100, "window": 48},
               {"dtype": torch.float32, "s": 100, "b": 4}):
        print(f"flash_attention check {json.dumps(attention_case(ops, ref, timer, gen, time_it=False, **kw))}",
              flush=True)
    lora = {}
    for dtype, m in ((torch.bfloat16, 8192), (torch.float32, 1024)):
        for n in (2048, 1024):
            lora[(dtype, n)] = lora_case(ops, ref, timer, gen, dtype=dtype, n=n, m=m)
            print(f"lora_matmul {json.dumps(lora[(dtype, n)])} [{card}]", flush=True)
    for name, k, n in (("up", 2560, 8960), ("down", 8960, 2560)):  # rwkv6-3b channel-mix
        lora[name] = lora_case(ops, ref, timer, gen, dtype=torch.bfloat16, n=n, k=k)
        print(f"lora_matmul rwkv cm {name} {json.dumps(lora[name])} [{card}]", flush=True)
    print(f"lora_matmul fixed failing draw {json.dumps(lora_fault_case(ops, ref))}", flush=True)
    # the federated rounds' shapes (phase 5d: batch 16 x 32 tokens), drawn
    # from a generator of their own, as jamba's heads above
    gen_fed = torch.Generator(device="cuda")
    gen_fed.manual_seed(args.seed + 2)
    attn_fed = attention_case(ops, ref, timer, gen_fed, dtype=torch.bfloat16, s=32)
    print(f"flash_attention federated {json.dumps(attn_fed)} [{card}]", flush=True)
    lora_fed = {n: lora_case(ops, ref, timer, gen_fed, dtype=torch.bfloat16, n=n, m=16 * 32) for n in (2048, 1024)}
    print(f"lora_matmul federated {json.dumps(lora_fed)} [{card}]", flush=True)
    # the batched cohort's grouped launch at phase 5d's shape (10 devices x
    # 16 x 32 tokens, q and v), then the other routes' checks: groups off
    # the 128-row tile (the wgmma route stages 3 groups' B a tile), K off 8
    # and 3 groups of rank 64 (the WMMA route), float32; drawn from a
    # generator of their own
    gen_grouped = torch.Generator(device="cuda")
    gen_grouped.manual_seed(args.seed + 3)
    grouped = {n: grouped_lora_case(ops, ref, timer, gen_grouped, dtype=torch.bfloat16, n=n) for n in (2048, 1024)}
    print(f"lora_matmul grouped {json.dumps(grouped)} [{card}]", flush=True)
    for kw in ({"dtype": torch.bfloat16, "g": 4, "rows": 100, "k": 136, "n": 520},
               {"dtype": torch.bfloat16, "g": 4, "rows": 100, "k": 1004, "n": 512},
               {"dtype": torch.bfloat16, "g": 3, "rows": 100, "k": 256, "n": 264, "r": 64},
               {"dtype": torch.float32, "g": 10, "rows": 64, "k": 256, "n": 264}):
        case = grouped_lora_case(ops, ref, timer, gen_grouped, time_it=False, **kw)
        print(f"lora_matmul grouped check {json.dumps(case)}", flush=True)
    wkv = wkv6_case(ops, ref, timer, gen, dtype=torch.bfloat16)
    print(f"wkv6 {json.dumps(wkv)} [{card}]", flush=True)
    for kw in ({"dtype": torch.float32, "b": 2, "s": 100}, {"dtype": torch.float32, "b": 2, "s": 100, "k": 32, "h": 4},
               {"dtype": torch.float32, "b": 2, "s": 40, "state": True}, {"dtype": torch.bfloat16, "b": 1, "s": 33,
                                                                           "h": 3, "k": 16, "state": True}):
        print(f"wkv6 check {json.dumps(wkv6_case(ops, ref, timer, gen, time_it=False, **kw))}", flush=True)
    for name, k, n in (("in", 4096, 16384), ("out", 8192, 4096)):  # jamba's Mamba projections
        lora[name] = lora_case(ops, ref, timer, gen, dtype=torch.bfloat16, n=n, k=k)
        print(f"lora_matmul jamba mamba {name} {json.dumps(lora[name])} [{card}]", flush=True)
    msc = mamba_case(ops, ref, timer, gen, dtype=torch.bfloat16)
    print(f"mamba_scan {json.dumps(msc)} [{card}]", flush=True)
    for kw in ({"dtype": torch.float32, "b": 2, "s": 70, "d": 512}, {"dtype": torch.float32, "b": 2, "s": 70, "d": 256,
                                                                     "n": 8}, {"dtype": torch.bfloat16, "b": 1, "s": 33,
                                                                               "d": 200, "n": 8}):
        print(f"mamba_scan check {json.dumps(mamba_case(ops, ref, timer, gen, time_it=False, **kw))}", flush=True)
    # serving's scans from a state (phase 5h), drawn from a generator of
    # their own: mamba_scan from h0 at jamba's decode step (B 8, S 1) and
    # prefill (S 128), wkv6 at S 1 from s0 (rwkv6-3b's 40 heads of 64)
    gen_serve = torch.Generator(device="cuda")
    gen_serve.manual_seed(args.seed + 6)
    scans_h0 = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for s_len in (1, SERVE_PROMPT):
            scans_h0[f"mamba_scan S{s_len} {name}"] = mamba_h0_case(ops, ref, timer, gen_serve, dtype=dtype, s=s_len)
        scans_h0[f"wkv6 S1 {name}"] = wkv6_step_case(ops, ref, timer, gen_serve, dtype=dtype)
    for name, case in scans_h0.items():
        print(f"{name} from a state {json.dumps(case)} [{card}]", flush=True)
    # and its attention shapes: flash_decode over phase 5h's ring of 160
    # slots, flash_attention over its 128-token prompts at batch 8, at
    # qwen3-1.7b's heads and jamba-v0.1-52b's
    ring = SERVE_PROMPT + SERVE_GEN
    serve_attn = {
        "decode_qwen3": decode_case(ops, ref, ring_positions, timer, gen_serve, q_dtype=torch.bfloat16, s=ring),
        "decode_jamba": decode_case(ops, ref, ring_positions, timer, gen_serve, q_dtype=torch.bfloat16, h=32,
                                    s=ring),
        "prefill_qwen3": attention_case(ops, ref, timer, gen_serve, dtype=torch.bfloat16, b=SERVE_BATCH,
                                        s=SERVE_PROMPT),
        "prefill_jamba": attention_case(ops, ref, timer, gen_serve, dtype=torch.bfloat16, b=SERVE_BATCH,
                                        s=SERVE_PROMPT, h=32),
    }
    for name, case in serve_attn.items():
        print(f"serving {name} {json.dumps(case)} [{card}]", flush=True)

    # FedHetLoRA's lowest and highest device ranks at the federated rounds'
    # shape (16 x 32 tokens, q and v; scales alpha / r = 4 and 1) on the
    # wgmma route, and a served pool of its tenants (ranks 4, 8, 16, 16 at
    # r_max 16); drawn from a generator of their own
    gen_het = torch.Generator(device="cuda")
    gen_het.manual_seed(args.seed + 5)
    hetlora = {}
    for r, alpha in ((4, 4.0), (16, 1.0)):
        for n in (2048, 1024):
            case = lora_case(ops, ref, timer, gen_het, dtype=torch.bfloat16, n=n, m=16 * 32, r=r, alpha=alpha)
            check(case["route"] == "wgmma" and case["dx_route"] == "wgmma", f"lora_matmul r={r}: {case['route']}")
            hetlora[f"lora r{r} n{n}"] = case
    for n in (2048, 1024):
        hetlora[f"segmented n{n}"] = segmented_case(ops, ref, timer, gen_het, dtype=torch.bfloat16, n=n,
                                                    ranks=(4, 8, 16, 16), r_max=16)
    for name, case in hetlora.items():
        print(f"hetlora {name} {json.dumps(case)} [{card}]", flush=True)

    # the other dense decoders' shapes, drawn from a generator of their own:
    # glm4-9b (32 heads over 2 KV heads, 16 a KV head), h2o-danube-1.8b
    # (head dim 80, its window of 4096 and one over a wrapped ring), yi-6b;
    # flash_decode at their serving step (batch 8, 512 slots),
    # flash_attention at their training shape (batch 16 x 512), and the q
    # and v projections' lora_matmul (batch 16 x 512) and segmented_lora
    # (the serving step's 8 rows)
    gen_dense = torch.Generator(device="cuda")
    gen_dense.manual_seed(args.seed + 4)
    dense = {
        "decode_glm4": decode_case(ops, ref, ring_positions, timer, gen_dense, q_dtype=torch.bfloat16, h=32, kv=2),
        "decode_danube": decode_case(ops, ref, ring_positions, timer, gen_dense, q_dtype=torch.bfloat16, h=32, kv=8,
                                     d=80, window=4096),
        "attention_glm4": attention_case(ops, ref, timer, gen_dense, dtype=torch.bfloat16, h=32, kv=2),
        "attention_danube": attention_case(ops, ref, timer, gen_dense, dtype=torch.bfloat16, h=32, kv=8, d=80,
                                           window=4096),
    }
    for name in dense:
        print(f"{name} {json.dumps(dense[name])} [{card}]", flush=True)
    for kw in ({"q_dtype": torch.bfloat16, "h": 32, "kv": 8, "d": 80, "window": 100},
               {"q_dtype": torch.float32, "h": 32, "kv": 2}, {"q_dtype": torch.float32, "h": 32, "kv": 8, "d": 80}):
        case = decode_case(ops, ref, ring_positions, timer, gen_dense, **kw)
        print(f"flash_decode check {json.dumps({k: case[k] for k in ('shape', 'max_abs_err', 'atol')})}", flush=True)
    for kw in ({"dtype": torch.bfloat16, "h": 32, "kv": 8, "d": 80, "window": 100},
               {"dtype": torch.float32, "b": 2, "h": 32, "kv": 8, "d": 80},
               {"dtype": torch.float32, "b": 2, "h": 32, "kv": 8, "d": 80, "window": 100},
               {"dtype": torch.float32, "b": 2, "h": 32, "kv": 2}):
        print(f"flash_attention check {json.dumps(attention_case(ops, ref, timer, gen_dense, time_it=False, **kw))}",
              flush=True)
    dense_widths = {"glm4 q": (4096, 4096), "glm4 v": (4096, 256), "danube q": (2560, 2560),
                    "danube v": (2560, 640), "yi v": (4096, 512)}  # (K, N); yi's q is glm4's
    for name, (k, n) in dense_widths.items():
        dense[f"lora {name}"] = lora_case(ops, ref, timer, gen_dense, dtype=torch.bfloat16, n=n, k=k)
        dense[f"segmented {name}"] = segmented_case(ops, ref, timer, gen_dense, dtype=torch.bfloat16, n=n, k=k)
        print(f"lora_matmul {name} {json.dumps(dense[f'lora {name}'])} [{card}]", flush=True)
        print(f"segmented_lora {name} {json.dumps(dense[f'segmented {name}'])} [{card}]", flush=True)

    # the moe family's shapes (phase 5i), drawn from a generator of their
    # own: granite-moe-3b-a800m (24 heads of 64 over 8 KV heads, d 1 536)
    # and llama4-scout-17b-a16e (40 heads of 128 over 8, d 5 120);
    # flash_attention at the training shape (batch 16 x 512), flash_decode
    # at the serving step (batch 8, 512 slots), and the q and v projections'
    # lora_matmul (batch 16 x 512) and segmented_lora (8 rows)
    gen_moe = torch.Generator(device="cuda")
    gen_moe.manual_seed(args.seed + 7)
    moe_shapes = {
        "attention_granite": attention_case(ops, ref, timer, gen_moe, dtype=torch.bfloat16, h=24, kv=8, d=64),
        "attention_llama4": attention_case(ops, ref, timer, gen_moe, dtype=torch.bfloat16, h=40, kv=8),
        "decode_granite": decode_case(ops, ref, ring_positions, timer, gen_moe, q_dtype=torch.bfloat16, h=24, kv=8,
                                      d=64),
        "decode_llama4": decode_case(ops, ref, ring_positions, timer, gen_moe, q_dtype=torch.bfloat16, h=40, kv=8),
    }
    for name in list(moe_shapes):
        print(f"{name} {json.dumps(moe_shapes[name])} [{card}]", flush=True)
    for kw in ({"dtype": torch.float32, "b": 2, "h": 24, "kv": 8, "d": 64},
               {"dtype": torch.float32, "b": 2, "h": 40, "kv": 8}):
        print(f"flash_attention check {json.dumps(attention_case(ops, ref, timer, gen_moe, time_it=False, **kw))}",
              flush=True)
    for kw in ({"q_dtype": torch.float32, "h": 24, "kv": 8, "d": 64}, {"q_dtype": torch.float32, "h": 40, "kv": 8}):
        case = decode_case(ops, ref, ring_positions, timer, gen_moe, **kw)
        print(f"flash_decode check {json.dumps({k: case[k] for k in ('shape', 'max_abs_err', 'atol')})}", flush=True)
    moe_widths = {"granite q": (1536, 1536), "granite v": (1536, 512), "llama4 q": (5120, 5120),
                  "llama4 v": (5120, 1024)}  # (K, N)
    for name, (k, n) in moe_widths.items():
        moe_shapes[f"lora {name}"] = lora_case(ops, ref, timer, gen_moe, dtype=torch.bfloat16, n=n, k=k)
        moe_shapes[f"segmented {name}"] = segmented_case(ops, ref, timer, gen_moe, dtype=torch.bfloat16, n=n, k=k)
        print(f"lora_matmul {name} {json.dumps(moe_shapes[f'lora {name}'])} [{card}]", flush=True)
        print(f"segmented_lora {name} {json.dumps(moe_shapes[f'segmented {name}'])} [{card}]", flush=True)

    # the stub-frontend families' shapes (phase 5j)
    stub_shapes = stub_frontend_shapes(ops, ref, ring_positions, timer, args.seed, card)
    # the training CLI's full-width shapes (phase 5k)
    cli_shape = cli_shapes(ops, ref, timer, args.seed, card)

    print(f"phase 3: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)

    # 4. serve full-width qwen3-1.7b
    t_phase = time.perf_counter()
    serve_stats, breakdown, launches = serve_full(api, ops, card, args.seed)
    print(f"serve {json.dumps(serve_stats)}", flush=True)
    print(f"decode step profile: {json.dumps(breakdown) if breakdown else 'not measured'} [{card}]", flush=True)
    print(f"smoke model, card vs CPU twins: {json.dumps(smoke_cuda_vs_cpu(args.seed))}", flush=True)

    print(f"phase 4: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    t_phase = time.perf_counter()

    # 5. one client's local round of full-width qwen3-1.7b: per step, the q
    #    and v forward of every active layer and their dX in all but the
    #    step's first active layer (whose input needs no gradient)
    train_stats, train_profile, train_launches = train_full(
        ops, card, args.seed, get_config("qwen3-1.7b"),
        lambda gates: {"flash_attention": active_count(gates), "flash_attention_bwd": active_count(gates),
                       "lora_matmul": 4 * active_count(gates) - 2 * len(gates)},
        lambda cfg: {"flash_attention": cfg.num_layers, "lora_matmul": 2 * cfg.num_layers})
    print(f"train {json.dumps(train_stats)}", flush=True)
    print(f"local step profile: {json.dumps(train_profile) if train_profile else 'not measured'} [{card}]",
          flush=True)
    print(f"smoke round, card vs CPU twins: {json.dumps(smoke_train_cuda_vs_cpu(args.seed, 'qwen3-1.7b'))}",
          flush=True)

    # 5b. one client's local round of full-width rwkv6-3b: per step, the WKV
    #     forward of every active layer and its backward in all but the
    #     step's first active layer (the embedding and the time-mix are
    #     frozen, and the layer's LoRA sits after its WKV); the channel-mix
    #     up and down forward and down's dX in every active layer, up's dX in
    #     all but the first
    rwkv_stats, rwkv_profile, rwkv_launches = train_full(
        ops, card, args.seed, get_config("rwkv6-3b"),
        lambda gates: {"wkv6": active_count(gates), "wkv6_bwd": active_count(gates) - len(gates),
                       "lora_matmul": 4 * active_count(gates) - len(gates)},
        lambda cfg: {"wkv6": cfg.num_layers, "lora_matmul": 2 * cfg.num_layers})
    print(f"train rwkv {json.dumps(rwkv_stats)}", flush=True)
    print(f"rwkv local step profile: {json.dumps(rwkv_profile) if rwkv_profile else 'not measured'} [{card}]",
          flush=True)
    print(f"rwkv smoke round, card vs CPU twins: {json.dumps(smoke_train_cuda_vs_cpu(args.seed, 'rwkv6-3b'))}",
          flush=True)

    # 5c. one client's local round of full-width jamba-v0.1-52b cut to one
    #     period of 8 layers (7 Mamba, attention at layer 4; MoE at the odd
    #     layers): 26.6 GB in bf16, where the 32 layers (~104 GB) exceed the
    #     card's 80 GB
    jamba_cfg = get_config("jamba-v0.1-52b").replace(num_layers=8)
    jamba_stats, jamba_profile, jamba_launches = train_full(
        ops, card, args.seed, jamba_cfg, lambda gates: jamba_round_launches(jamba_cfg, gates),
        lambda cfg: {"mamba_scan": sum(layer_kind(cfg, l) == "mamba" for l in range(cfg.num_layers)),
                     "flash_attention": sum(layer_kind(cfg, l) == "attn" for l in range(cfg.num_layers)),
                     "lora_matmul": 2 * cfg.num_layers})
    print(f"train jamba {json.dumps(jamba_stats)}", flush=True)
    print(f"jamba local step profile: {json.dumps(jamba_profile) if jamba_profile else 'not measured'} [{card}]",
          flush=True)
    print(f"jamba smoke round, card vs CPU twins: "
          f"{json.dumps(smoke_train_cuda_vs_cpu(args.seed, 'jamba-v0.1-52b'))}", flush=True)

    print(f"phases 5-5c: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)

    # 5d. two federated rounds of droppeft on full-width qwen3-1.7b through
    #     api.build: 100 devices, 10 a round, batch 16 x 32 tokens; batched
    #     (the default), then sequential for the comparison
    t_phase = time.perf_counter()
    fed_stats, fed_launches = federated_full(api, ops, card, args.seed)
    print(f"federated {json.dumps(fed_stats)}", flush=True)
    for arch in ("qwen3-1.7b", "rwkv6-3b", "jamba-v0.1-52b"):
        print(f"federated smoke run, batched on the card vs sequential and the CPU twins: "
              f"{json.dumps(federated_smoke_cuda_vs_cpu(args.seed, arch))}", flush=True)

    print(f"phase 5d: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)

    # 5e. the other dense decoders at full width: serving as phase 4, a local
    #     round as phase 5 (at full depth where it fits the card)
    t_phase = time.perf_counter()
    dense_runs = {}
    for arch in DENSE_ARCHS:
        serve_a, serve_launches_a, train_a, train_launches_a = dense_arch_full(api, ops, card, args.seed, arch)
        dense_runs[arch] = {"serve_launches": serve_launches_a, "train_launches": train_launches_a}
        print(f"serve {arch} {json.dumps(serve_a)}", flush=True)
        print(f"train {arch} {json.dumps(train_a)}", flush=True)
        for name in ("segmented_lora", "flash_decode"):
            check(serve_launches_a[name] > 0, f"{name} never launched while serving {arch}: {serve_launches_a}")
        for name in ("flash_attention", "flash_attention_bwd", "lora_matmul"):
            check(train_launches_a[name] > 0, f"{name} never launched in the {arch} local round: {train_launches_a}")

    print(f"phase 5e: {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)

    # 5f. the straggler-tolerant federation on full-width qwen3-1.7b: a
    #     gather local round beside cond, then gather-mode federated rounds
    #     under the deadline (carry, int8+topk) and async-buffer schedules
    t5f = time.perf_counter()
    gather_stats, gather_launches = gather_round_full(ops, card, args.seed)
    print(f"gather round {json.dumps(gather_stats)} [{card}]", flush=True)
    strag_stats, strag_launches = straggler_full(api, ops, card, args.seed)
    print(f"straggler federation {json.dumps(strag_stats)} [{card}]", flush=True)
    print(f"schedules smoke runs, card vs CPU twins: {json.dumps(schedules_smoke_cuda_vs_cpu(args.seed))}", flush=True)
    print(f"phase 5f: {time.perf_counter() - t5f:.1f} s [{card}]", flush=True)

    # 5g. the rest of the method grid on full-width qwen3-1.7b: FedHetLoRA
    #     (served from its checkpoint), adapter and BitFit PEFT, the joint
    #     rate x compression bandit and LoRA merging; then smoke-size runs
    #     on the card against the CPU twins
    t5g = time.perf_counter()
    grid_stats, grid_launches = method_grid_full(api, ops, card, args.seed)
    print(f"method grid {json.dumps(grid_stats)} [{card}]", flush=True)
    print(f"method grid smoke runs, card vs CPU twins: {json.dumps(method_grid_smoke_cuda_vs_cpu(args.seed))}",
          flush=True)
    print(f"phase 5g: {time.perf_counter() - t5g:.1f} s [{card}]", flush=True)

    # 5h. recurrent-state serving: full-width rwkv6-3b, jamba-v0.1-52b cut
    #     to 8 layers and qwen3-1.7b through launch.serve's prefill and
    #     generate (batch 8, 128-token prompts, 32 new tokens)
    t5h = time.perf_counter()
    recurrent = {}
    for arch in RECURRENT_ARCHS:
        stats, recurrent[arch] = recurrent_serving_full(ops, card, args.seed, arch)
        print(f"serve from a state {arch} {json.dumps(stats)} [{card}]", flush=True)
    print(f"phase 5h: {time.perf_counter() - t5h:.1f} s [{card}]", flush=True)
    served = {arch: recurrent[arch]["run"] for arch in RECURRENT_ARCHS}
    for arch, name in (("rwkv6-3b", "wkv6"), ("jamba-v0.1-52b", "mamba_scan"), ("jamba-v0.1-52b", "flash_decode"),
                       ("jamba-v0.1-52b", "flash_attention"), ("qwen3-1.7b", "flash_decode"),
                       ("qwen3-1.7b", "flash_attention")):
        check(served[arch][name] > 0, f"{name} never launched serving {arch} in phase 5h: {served[arch]}")

    # 5i. the moe family: granite-moe-3b-a800m (uncut but for serving) and
    #     llama4-scout-17b-a16e depth-cut, local rounds (granite's again with the gather
    #     dispatch), multi-tenant serving, prefill and generate, and
    #     granite's federated rounds
    moe_stats, moe_runs, moe_s = moe_family_full(api, ops, card, args.seed, timer.flush)
    print(f"phase 5i: {moe_s:.1f} s [{card}]", flush=True)
    moe_paths = {"granite": "granite-moe-3b-a800m", "llama4": "llama4-scout-17b-a16e"}

    def moe_launches(name, paths):
        return {f"5i_{path}_{short}": moe_runs[f"{path} {arch}"][name] for path in paths
                for short, arch in moe_paths.items()}

    # 5j. the stub-frontend families: whisper-tiny uncut (a local round,
    #     prefill and generate, 2 federated rounds) and internvl2-76b
    #     depth-cut (local rounds, api.serve, prefill and generate)
    stub_stats, stub_runs, stub_s = stub_frontends_full(api, ops, card, args.seed)
    print(f"phase 5j: {stub_s:.1f} s [{card}]", flush=True)

    def stub_launches(name, paths):
        return {f"5j_{path.replace(' ', '_')}": stub_runs[path][name] for path in paths}

    # 5k. the training CLI (launch/train.py) as users run it, FederatedSimulator
    #     and the sharded decode over 2 gloo ranks
    cli_stats, cli_runs, cli_s = train_cli_full(api, ops, ref, timer, card, args.seed)
    print(f"phase 5k: {cli_s:.1f} s [{card}]", flush=True)

    def cli_launches(name):
        return {f"5k_{path}": counts[name] for path, counts in cli_runs.items() if counts.get(name)}

    # 5l. the dry run of every arch x shape x mesh on meta, each meta step
    #     against the same step on the card, the steady-state guard and the
    #     analysis passes
    meta_stats, meta_runs, meta_s = dryrun_and_analysis_full(ops, api, card, args.seed)
    print(f"phase 5l: {meta_s:.1f} s [{card}]", flush=True)

    def meta_launches(name):
        return {f"5l_{step}": counts[name] for step, counts in meta_runs.items() if counts.get(name)}

    # 5m. remat: per-layer recomputation through every hand-written backward
    #     (qwen3-1.7b at full depth, rwkv6-3b, jamba and granite at 4
    #     layers, internvl2-76b at the depth meta chooses), and the examples
    remat_stats, remat_runs, remat_s = remat_full(ops, card, args.seed)
    print(f"phase 5m: {remat_s:.1f} s [{card}]", flush=True)
    for path, names in (("5m_qwen3_rate0.5_remat", ("flash_attention", "flash_attention_bwd", "lora_matmul")),
                        ("5m_rwkv6_remat", ("wkv6", "wkv6_bwd")), ("5m_jamba_remat", ("mamba_scan", "mamba_scan_bwd"))):
        for name in names:
            check(remat_runs[path].get(name, 0) > 0, f"{name} never launched in phase 5m's {path}: {remat_runs[path]}")

    def remat_launches(name):
        return {path: counts[name] for path, counts in remat_runs.items() if counts.get(name)}

    # 5n. the last of the reference's public names: multi_head_attention on
    #     both attention kernels, encode with gates and LoRA, api.serve with
    #     model_overrides and stack_mode, and a round from layout="list" trees
    names_stats, names_runs, names_s = public_names_full(api, ops, ref, timer, card, args.seed)
    print(f"phase 5n: {names_s:.1f} s [{card}]", flush=True)
    for path, names in (("5n_mha_a", ("flash_attention", "flash_attention_bwd")), ("5n_mha_c", ("flash_decode",)),
                        ("5n_encode_whisper", ("flash_attention", "flash_attention_bwd", "lora_matmul")),
                        ("5n_serve_overrides", ("flash_decode", "segmented_lora")),
                        ("5n_list_round", ("flash_attention", "flash_attention_bwd", "lora_matmul"))):
        for name in names:
            check(names_runs[path].get(name, 0) > 0, f"{name} never launched in phase 5n's {path}: {names_runs[path]}")

    def names_launches(name):
        return {path: counts[name] for path, counts in names_runs.items() if counts.get(name)}

    # 5o. qwen3-1.7b's train step sharded over (data, model) meshes of gloo
    #     ranks on the one card, against the one-rank step and the dry run
    tp_stats, tp_runs, tp_s, tp_serving = tensor_parallel_full(ops, card, args.seed)
    print(f"phase 5o: {tp_s:.1f} s [{card}]", flush=True)
    for path, counts in tp_runs.items():
        for name in ("flash_attention", "flash_attention_bwd", "lora_matmul"):
            check(counts.get(name, 0) > 0, f"{name} never launched in phase 5o's {path}: {counts}")

    # 5p. the dense family's sharded prefill and decode steps: qwen3-1.7b in
    #     5o's ranks, glm4-9b's head-dim cut and h2o-danube-1.8b's sequence
    #     over data, against the one-rank steps and the dry run
    serve_tp_stats, serve_tp_runs, serve_tp_cases, serve_tp_s = tensor_parallel_serve_full(
        ops, ref, timer, card, args.seed, tp_serving)
    print(f"phase 5p: {serve_tp_s + tp_serving['s']:.1f} s ({tp_serving['s']:.1f} of it in 5o's ranks) [{card}]",
          flush=True)
    tp_runs.update(serve_tp_runs)
    for path, names in (("5p_qwen3_1x2", ("flash_attention", "flash_decode", "segmented_lora")),
                        ("5p_glm4_1x4", ("flash_attention", "flash_decode_scores", "flash_decode_combine")),
                        ("5p_danube_2x2_seq", ("flash_attention", "flash_decode"))):
        for name in names:
            check(serve_tp_runs[path].get(name, 0) > 0, f"{name} never launched in phase 5p's {path}: "
                                                        f"{serve_tp_runs[path]}")

    def tp_launches(name):
        return {path: counts[name] for path, counts in tp_runs.items() if counts.get(name)}

    stub_shape_keys = {"flash_attention": ("attention_whisper_encoder", "attention_whisper_cross"),
                       "flash_decode": ("decode_whisper_self", "decode_whisper_cross", "decode_internvl")}

    # 6. kernels line: each path's shapes (bf16) and launches; q and v
    #    projections summed for segmented_lora and lora_matmul (forward)
    for name in ("segmented_lora", "flash_decode"):
        check(launches[name] > 0, f"{name} never launched while serving: {launches}")
    for name in ("flash_attention", "flash_attention_bwd", "lora_matmul"):
        check(train_launches[name] > 0, f"{name} never launched in the local round: {train_launches}")
        check(fed_launches[name] > 0, f"{name} never launched in the federated rounds: {fed_launches}")
        check(strag_launches[name] > 0, f"{name} never launched in phase 5f's deadline rounds: {strag_launches}")
        check(gather_launches[name] > 0, f"{name} never launched in the gather local round: {gather_launches}")
        check(grid_launches[name] > 0, f"{name} never launched in phase 5g's runs: {grid_launches}")
    for name in ("segmented_lora", "flash_decode"):
        check(grid_launches[name] > 0, f"{name} never launched serving phase 5g's checkpoint: {grid_launches}")
    for name in ("wkv6", "wkv6_bwd"):
        check(rwkv_launches[name] > 0, f"{name} never launched in the rwkv6-3b local round: {rwkv_launches}")
    for name in ("mamba_scan", "mamba_scan_bwd"):
        check(jamba_launches[name] > 0, f"{name} never launched in the jamba local round: {jamba_launches}")
    def pick(case, keys, **renamed):
        return {**{key: case.get(key) for key in keys}, **{new: case.get(old) for new, old in renamed.items()}}

    fwd_keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_ms",
                "library_kernel_ms")
    bwd_renamed = {"max_abs_err": "bwd_max_abs_err", "ms": "bwd_ms", "plain_ms": "plain_bwd_ms",
                   "bound_ms": "bwd_bound_ms", "bound_by": "bwd_bound_by", "library_ms": "library_bwd_ms",
                   "dq_kernel_ms": "bwd_dq_ms", "dkv_kernel_ms": "bwd_dkv_ms",
                   "library_kernel_ms": "library_bwd_kernel_ms"}
    proj_keys = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "kernel_ms", "cublas_x_at_w_ms",
                 "cublas_x_at_w_kernel_ms")
    dense_shapes = {kind: {name: pick(dense[f"{kind} {name}"], proj_keys) for name in dense_widths}
                    for kind in ("lora", "segmented")}
    dense_launches = {role: {arch: dense_runs[arch][role] for arch in DENSE_ARCHS}
                      for role in ("serve_launches", "train_launches")}
    q_case, v_case = seg[(torch.bfloat16, 2048)], seg[(torch.bfloat16, 1024)]
    d_case = dec[torch.bfloat16]
    lq, lv = lora[(torch.bfloat16, 2048)], lora[(torch.bfloat16, 1024)]
    kernels = [
        {
            "name": "segmented_lora", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segmented_lora.cu",
            "replaces": "src/repro/kernels/segmented_lora.py:55",
            "launches": launches["segmented_lora"],
            "max_abs_err": max(q_case["max_abs_err"], v_case["max_abs_err"]),
            **{key: q_case[key] + v_case[key] for key in ("ms", "plain_ms", "bound_ms")},
            "bound_by": q_case["bound_by"], "library_ms": None,
            **{key: None if q_case[key] is None or v_case[key] is None else q_case[key] + v_case[key]
               for key in ("kernel_ms", "bottleneck_kernel_ms", "stream_kernel_ms", "cublas_x_at_w_ms",
                           "cublas_x_at_w_kernel_ms")},
            "device_only_ms_q_v": [q_case["kernel_ms"], v_case["kernel_ms"]],
            "splits_q_v": [q_case["splits"], v_case["splits"]],
            "shape": "q then v projection of one layer: " + q_case["shape"] + " + " + v_case["shape"],
            "dense_arch_shapes": dense_shapes["segmented"],
            "launches_by_path": {"serve_qwen3": launches["segmented_lora"],
                                 **{f"serve_{a}": dense_launches["serve_launches"][a]["segmented_lora"]
                                    for a in DENSE_ARCHS},
                                 "5g_serve_hetlora_checkpoint": grid_launches["segmented_lora"],
                                 **moe_launches("segmented_lora", ("serve",)),
                                 **stub_launches("segmented_lora", ("serve internvl",)),
                                 **meta_launches("segmented_lora"), **names_launches("segmented_lora"),
                                 **tp_launches("segmented_lora")},
            "internvl_shapes": {name: pick(stub_shapes[f"segmented {name}"], proj_keys)
                                for name in ("internvl q", "internvl v")},
            "hetlora_shapes": {name: pick(hetlora[f"segmented n{n}"], proj_keys) for name, n in (("q", 2048),
                                                                                               ("v", 1024))},
            "moe_arch_shapes": {name: pick(moe_shapes[f"segmented {name}"], proj_keys) for name in moe_widths},
        },
        {
            "name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:78",
            "launches": launches["flash_decode"],
            **{key: d_case[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "device_only_ms": d_case["kernel_ms"],
            "split_kernel_ms": d_case["split_kernel_ms"], "combine_kernel_ms": d_case["combine_kernel_ms"],
            "library_device_only_ms": d_case["library_kernel_ms"], "splits": d_case["splits"],
            "shape": d_case["shape"],
            "glm4_shape": pick(dense["decode_glm4"], fwd_keys),
            "danube_shape": pick(dense["decode_danube"], fwd_keys),
            "generate_shapes": {arch: pick(serve_attn[f"decode_{arch}"], fwd_keys) for arch in ("qwen3", "jamba")},
            "launches_by_path": {"serve_qwen3": launches["flash_decode"],
                                 **{f"serve_{a}": dense_launches["serve_launches"][a]["flash_decode"]
                                    for a in DENSE_ARCHS},
                                 "5g_serve_hetlora_checkpoint": grid_launches["flash_decode"],
                                 "5h_generate_qwen3": served["qwen3-1.7b"]["flash_decode"],
                                 "5h_generate_jamba": served["jamba-v0.1-52b"]["flash_decode"],
                                 **moe_launches("flash_decode", ("serve", "generate")),
                                 **stub_launches("flash_decode", ("generate whisper", "serve internvl",
                                                                  "generate internvl")),
                                 **meta_launches("flash_decode"), **names_launches("flash_decode"),
                                 **tp_launches("flash_decode")},
            "lse_shape": serve_tp_cases["lse"],
            "moe_shapes": {short: pick(moe_shapes[f"decode_{short}"], fwd_keys) for short in moe_paths},
            "stub_frontend_shapes": {key: pick(stub_shapes[key], fwd_keys) for key in stub_shape_keys["flash_decode"]},
            "sharded_decode_yardstick": {  # phase 5k: the whole cache beside its 2-rank sequence-sharded decode
                "shape": cli_stats["sharded decode"]["shape"],
                "cases": [{key: c[key] for key in ("query_position", "window", "ms", "flash_decode_ms")}
                          | {"flash_decode_max_abs_err": c["errors"]["flash_decode"]["max_abs"]}
                          for c in cli_stats["sharded decode"]["cases"]]},
        },
        {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:101",
            "launches": train_launches["flash_attention"],
            "launches_by_path": {"local_round": train_launches["flash_attention"],
                                 "federated_rounds": fed_launches["flash_attention"],
                                 "5f": strag_launches["flash_attention"], "5f_gather_local_round": gather_launches["flash_attention"],
                                 "5g": grid_launches["flash_attention"],
                                 **{f"local_round_{a}": dense_launches["train_launches"][a]["flash_attention"]
                                    for a in DENSE_ARCHS},
                                 "5h_prefill_qwen3": served["qwen3-1.7b"]["flash_attention"],
                                 "5h_prefill_jamba": served["jamba-v0.1-52b"]["flash_attention"],
                                 **moe_launches("flash_attention", ("train", "generate")),
                                 "5i_gather_round_granite": moe_runs["gather"]["flash_attention"],
                                 "5i_federated_granite": moe_runs["federated"]["flash_attention"],
                                 **stub_launches("flash_attention", ("train whisper", "generate whisper",
                                                                     "federated whisper", "train internvl",
                                                                     "generate internvl")),
                                 **cli_launches("flash_attention"), **meta_launches("flash_attention"),
                                 **remat_launches("flash_attention"), **names_launches("flash_attention"),
                                 **tp_launches("flash_attention")},
            "train_cli_shape": pick(cli_shape["attention"], fwd_keys),
            "moe_shapes": {short: pick(moe_shapes[f"attention_{short}"], fwd_keys) for short in moe_paths},
            "whisper_shapes": {key: pick(stub_shapes[key], fwd_keys) for key in stub_shape_keys["flash_attention"]},
            "glm4_shape": pick(dense["attention_glm4"], fwd_keys),
            "danube_shape": pick(dense["attention_danube"], fwd_keys),
            "prefill_shapes": {arch: pick(serve_attn[f"prefill_{arch}"], fwd_keys) for arch in ("qwen3", "jamba")},
            **{key: attn[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "jamba_ms": attn_jamba["ms"], "jamba_library_ms": attn_jamba["library_ms"],
            "device_only_ms": attn["kernel_ms"], "library_device_only_ms": attn["library_kernel_ms"],
            "federated_shape": {key: attn_fed[key] for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                               "library_ms", "kernel_ms", "library_kernel_ms")},
            "shape": "forward, " + attn["shape"] + "; jamba: " + attn_jamba["shape"],
        },
        {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:101",
            "launches": train_launches["flash_attention_bwd"],
            "launches_by_path": {"local_round": train_launches["flash_attention_bwd"],
                                 "federated_rounds": fed_launches["flash_attention_bwd"],
                                 "5f": strag_launches["flash_attention_bwd"], "5f_gather_local_round": gather_launches["flash_attention_bwd"],
                                 "5g": grid_launches["flash_attention_bwd"],
                                 **{f"local_round_{a}": dense_launches["train_launches"][a]["flash_attention_bwd"]
                                    for a in DENSE_ARCHS},
                                 **moe_launches("flash_attention_bwd", ("train",)),
                                 "5i_gather_round_granite": moe_runs["gather"]["flash_attention_bwd"],
                                 "5i_federated_granite": moe_runs["federated"]["flash_attention_bwd"],
                                 **stub_launches("flash_attention_bwd", ("train whisper", "federated whisper",
                                                                         "train internvl")),
                                 **cli_launches("flash_attention_bwd"), **meta_launches("flash_attention_bwd"),
                                 **remat_launches("flash_attention_bwd"), **names_launches("flash_attention_bwd"),
                                 **tp_launches("flash_attention_bwd")},
            "train_cli_shape": pick(cli_shape["attention"], ("shape",), **bwd_renamed),
            "whisper_shapes": {key: pick(stub_shapes[key], ("shape",), **bwd_renamed)
                               for key in stub_shape_keys["flash_attention"]},
            "moe_shapes": {short: pick(moe_shapes[f"attention_{short}"], ("shape",), **bwd_renamed)
                           for short in moe_paths},
            "glm4_shape": pick(dense["attention_glm4"], ("shape",), **bwd_renamed),
            "danube_shape": pick(dense["attention_danube"], ("shape",), **bwd_renamed),
            "max_abs_err": attn["bwd_max_abs_err"], "ms": attn["bwd_ms"], "plain_ms": attn["plain_bwd_ms"],
            "bound_ms": attn["bwd_bound_ms"], "bound_by": attn["bwd_bound_by"], "library_ms": attn["library_bwd_ms"],
            "dq_kernel_ms": attn["bwd_dq_ms"], "dkv_kernel_ms": attn["bwd_dkv_ms"],
            "library_device_only_ms": attn["library_bwd_kernel_ms"],
            "jamba_ms": attn_jamba["bwd_ms"], "jamba_library_ms": attn_jamba["library_bwd_ms"],
            "federated_shape": {"shape": attn_fed["shape"], "max_abs_err": attn_fed["bwd_max_abs_err"],
                                "ms": attn_fed["bwd_ms"], "plain_ms": attn_fed["plain_bwd_ms"],
                                "bound_ms": attn_fed["bwd_bound_ms"], "library_ms": attn_fed["library_bwd_ms"],
                                "dq_kernel_ms": attn_fed["bwd_dq_ms"], "dkv_kernel_ms": attn_fed["bwd_dkv_ms"],
                                "library_kernel_ms": attn_fed["library_bwd_kernel_ms"]},
            "shape": "backward (dQ, dK, dV), " + attn["shape"] + "; jamba: " + attn_jamba["shape"],
        },
        {
            "name": "lora_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lora_matmul.cu",
            "replaces": "src/repro/kernels/lora_matmul.py:31",
            "launches": train_launches["lora_matmul"],
            "launches_by_path": {"local_round": train_launches["lora_matmul"],
                                 "federated_rounds": fed_launches["lora_matmul"],
                                 "5f": strag_launches["lora_matmul"], "5f_gather_local_round": gather_launches["lora_matmul"],
                                 "5g": grid_launches["lora_matmul"],
                                 **{f"local_round_{a}": dense_launches["train_launches"][a]["lora_matmul"]
                                    for a in DENSE_ARCHS},
                                 **moe_launches("lora_matmul", ("train",)),
                                 "5i_gather_round_granite": moe_runs["gather"]["lora_matmul"],
                                 "5i_federated_granite": moe_runs["federated"]["lora_matmul"],
                                 **stub_launches("lora_matmul", ("train whisper", "federated whisper",
                                                                 "train internvl")),
                                 **cli_launches("lora_matmul"), **meta_launches("lora_matmul"),
                                 **remat_launches("lora_matmul"), **names_launches("lora_matmul"),
                                 **tp_launches("lora_matmul")},
            "train_cli_grouped_shapes": {name: pick(cli_shape[name], proj_keys + ("route", "ungrouped_launches_ms"))
                                         for name in ("grouped q", "grouped v")},
            "stub_frontend_shapes": {name: pick(stub_shapes[f"lora {name}"],
                                                proj_keys + ("dx_ms", "dx_bound_ms", "route"))
                                     for name in STUB_WIDTHS},
            "dense_arch_shapes": dense_shapes["lora"],
            "moe_arch_shapes": {name: pick(moe_shapes[f"lora {name}"], proj_keys + ("dx_ms", "dx_bound_ms", "route"))
                                for name in moe_widths},
            "hetlora_shapes": {name: pick(case, proj_keys + ("bwd_max_abs_err", "dx_ms", "dx_bound_ms", "route"))
                               for name, case in hetlora.items() if name.startswith("lora")},
            "max_abs_err": max(lq["max_abs_err"], lv["max_abs_err"]),
            **{key: lq[key] + lv[key] for key in ("ms", "plain_ms", "bound_ms")},
            "bound_by": lq["bound_by"], "library_ms": None,
            "cublas_x_at_w_ms": lq["cublas_x_at_w_ms"] + lv["cublas_x_at_w_ms"],
            **{key: None if lq[key] is None or lv[key] is None else lq[key] + lv[key]
               for key in ("kernel_ms", "bottleneck_kernel_ms", "main_kernel_ms", "cublas_x_at_w_kernel_ms")},
            "routes_in_round": train_stats["lora_matmul_routes"],
            "grouped": {  # phase 5d's cohort launch: 10 devices' q, then v
                "shape": "q then v, forward: " + grouped[2048]["shape"] + " + " + grouped[1024]["shape"],
                "route": grouped[2048]["route"], "launches_in_batched_rounds": fed_launches["lora_matmul"],
                "max_abs_err": max(c["max_abs_err"] for c in grouped.values()),
                **{key: grouped[2048][key] + grouped[1024][key]
                   for key in ("ms", "plain_ms", "bound_ms", "ungrouped_launches_ms", "cublas_x_at_w_ms")},
                **{key: None if grouped[2048][key] is None or grouped[1024][key] is None
                   else grouped[2048][key] + grouped[1024][key]
                   for key in ("kernel_ms", "kernels_device_ms", "ungrouped_launches_device_ms",
                               "one_adapter_kernel_ms", "cublas_x_at_w_kernel_ms")},
                "bound_by": grouped[2048]["bound_by"], "library_ms": None},
            "federated_shape": {
                "shape": "q then v, forward: " + lora_fed[2048]["shape"] + " + " + lora_fed[1024]["shape"],
                "max_abs_err": max(c["max_abs_err"] for c in lora_fed.values()),
                **{key: lora_fed[2048][key] + lora_fed[1024][key]
                   for key in ("ms", "plain_ms", "bound_ms", "cublas_x_at_w_ms", "kernel_ms")}},
            "shape": "q then v projection of one layer, forward: " + lq["shape"] + " + " + lv["shape"],
        },
        *({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:78",
            "launches": serve_tp_runs["5p_glm4_1x4"][name],
            **{key: serve_tp_cases["split"][half][key]
               for key in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "device_only_ms": serve_tp_cases["split"][half]["kernel_ms"],
            "launches_by_path": tp_launches(name),
        } for name, half in (("flash_decode_scores", "scores"), ("flash_decode_combine", "combine"))),
        {
            "name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/rwkv6_scan.py:63",
            "launches": rwkv_launches["wkv6"],
            **{key: wkv[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "device_only_ms": wkv["kernel_ms"], "shape": "forward, " + wkv["shape"],
            "launches_by_path": {"local_round_rwkv6": rwkv_launches["wkv6"], "5h_serve_rwkv6": served["rwkv6-3b"]["wkv6"],
                                 **cli_launches("wkv6"), **meta_launches("wkv6"), **remat_launches("wkv6")},
            "decode_step_shape": {name.split()[-1]: pick(case, fwd_keys) for name, case in scans_h0.items()
                                  if name.startswith("wkv6")},
        },
        {
            "name": "wkv6_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6_bwd.cu",
            "replaces": "src/repro/kernels/rwkv6_scan.py:63",
            "launches": rwkv_launches["wkv6_bwd"],
            "max_abs_err": wkv["bwd_max_abs_err"], "ms": wkv["bwd_ms"], "plain_ms": wkv["plain_bwd_ms"],
            "bound_ms": wkv["bwd_bound_ms"], "bound_by": wkv["bwd_bound_by"], "library_ms": wkv["library_bwd_ms"],
            "device_only_ms": wkv["bwd_kernel_ms"], "kernels_ms": wkv["bwd_kernels_ms"],
            "launches_by_path": {"local_round_rwkv6": rwkv_launches["wkv6_bwd"], **cli_launches("wkv6_bwd"),
                                 **meta_launches("wkv6_bwd"), **remat_launches("wkv6_bwd")},
            "shape": "backward (dr, dk, dv, dlogw, du), " + wkv["shape"],
        },
        {
            "name": "mamba_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:54",
            "launches": jamba_launches["mamba_scan"],
            **{key: msc[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "device_only_ms": msc["kernel_ms"], "kernels_ms": {"forward": msc["kernel_ms"]},
            "bound_terms_ms": msc["bound_terms_ms"], "shape": "forward, " + msc["shape"],
            "launches_by_path": {"local_round_jamba": jamba_launches["mamba_scan"],
                                 "5h_serve_jamba": served["jamba-v0.1-52b"]["mamba_scan"],
                                 **cli_launches("mamba_scan"), **meta_launches("mamba_scan"),
                                 **remat_launches("mamba_scan")},
            "h0_shapes": {name.replace("mamba_scan ", ""): pick(case, fwd_keys) for name, case in scans_h0.items()
                          if name.startswith("mamba_scan")},
        },
        {
            "name": "mamba_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mamba_scan_bwd.cu",
            "replaces": "src/repro/kernels/mamba_scan.py:54",
            "launches": jamba_launches["mamba_scan_bwd"],
            "max_abs_err": msc["bwd_max_abs_err"], "ms": msc["bwd_ms"], "plain_ms": msc["plain_bwd_ms"],
            "bound_ms": msc["bwd_bound_ms"], "bound_by": msc["bwd_bound_by"], "library_ms": msc["library_bwd_ms"],
            "device_only_ms": msc["bwd_kernel_ms"], "kernels_ms": msc["bwd_kernels_ms"],
            "scratch_bytes": msc["bwd_scratch_bytes"], "bound_terms_ms": msc["bwd_bound_terms_ms"],
            "launches_by_path": {"local_round_jamba": jamba_launches["mamba_scan_bwd"],
                                 **cli_launches("mamba_scan_bwd"), **meta_launches("mamba_scan_bwd"),
                                 **remat_launches("mamba_scan_bwd")},
            "shape": "backward (d_dt, dx, dB, dC, dA, dD), " + msc["shape"],
        },
    ]
    print(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s, the build included [{card}]", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
