#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of the checkout, on a machine with a CUDA card and the
CUDA toolkit::

    python3 chip_smoke.py [--seed 0]

Phases, one line each before the last:

1. the card's name and power limit (``nvidia-smi``);
2. build of both CUDA kernels from the sources in the checkout;
3. each kernel held against its plain PyTorch twin on the card at the
   serving shapes of qwen3-1.7b, with its time (CUDA events, L2 flushed,
   median of repeats) beside the twin's, the library call's and the bound;
4. full-width qwen3-1.7b (28 layers, random weights from ``--seed``)
   served through ``repro_torch.api.serve``: 12 requests over 4 LoRA
   tenants of rank 4/8 at batch 8, rows recycling mid-run; every completion
   arrives, every logit is finite, one request's batched tokens equal its
   tokens served in a uniform batch, and the smoke-size model on the card
   agrees with the same model on the CPU twins;
5. the ``kernels`` JSON line: launches of each kernel in phase 4's run.

The last line is ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero before it; without a CUDA card, or outside the checkout, the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
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
    ms = timer(lambda: ops.segmented_lora(x, w, a, b, idx, rk))
    plain_ms = timer(lambda: ref.segmented_lora_plain(x, w, a, b, idx, rk))
    elt = x.element_size()
    distinct = len(set(idx.tolist()))
    nbytes = elt * (m * k + k * n + distinct * (k * r_max + r_max * n) + m * n) + 4 * (m + na)
    ops_count = 2 * m * k * n + 2 * m * k * r_max + 2 * m * r_max * n
    bound_ms, bound_by = bound(nbytes, ops_count, str(dtype).split(".")[-1])
    return {
        "shape": f"M={m} K={k} N={n} r_max={r_max} {str(dtype).split('.')[-1]}",
        "max_abs_err": err, "atol": atol, "rtol": rtol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def decode_case(ops, ref, ring_positions, timer, gen, *, q_dtype, b=8, h=16, kv=8, d=128, s=512):
    """One flash_decode shape: kernel vs twin, with times, bound and SDPA."""
    import torch.nn.functional as F

    q = torch.randn((b, h, d), generator=gen, device="cuda").to(q_dtype)
    kc = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(torch.bfloat16)
    vc = torch.randn((b, s, kv, d), generator=gen, device="cuda").to(torch.bfloat16)
    # per-row depths: a fresh row, mid-ring rows, a full ring, two wrapped
    # rings, and a recycled row (small position over a ring full of stale
    # K/V from the previous tenant)
    pos = torch.tensor([0, 17, 130, s - 1, s + 100, 3 * s + 7, 5, 300], dtype=torch.int32, device="cuda")[:b]
    kpos = ring_positions(pos, s)
    got = ops.flash_decode(q, kc, vc, pos, kpos)
    want = ref.decode_attention_plain(q, kc, vc, pos, kpos)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    atol, rtol = (3e-2, 1e-2) if q_dtype == torch.bfloat16 else (2e-5, 1e-5)
    check(torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol),
          f"flash_decode q {q_dtype}: max abs err {err} vs twin")
    ms = timer(lambda: ops.flash_decode(q, kc, vc, pos, kpos))
    plain_ms = timer(lambda: ref.decode_attention_plain(q, kc, vc, pos, kpos))
    library_ms = None
    if q_dtype == kc.dtype:
        # the yardstick: one SDPA call on the same inputs (never used by the port)
        mask = (kpos <= pos[:, None])[:, None, None, :]
        q4, k4, v4 = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
        library_ms = timer(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, enable_gqa=True))
    live = int((kpos <= pos[:, None]).sum().item())
    nbytes = (q.numel() * 2 * q.element_size() + live * kv * d * 2 * kc.element_size()
              + 4 * (b + b * s))
    ops_count = 4 * live * h * d
    bound_ms, bound_by = bound(nbytes, ops_count, str(q_dtype).split(".")[-1])
    return {
        "shape": f"B={b} H={h} KV={kv} D={d} S={s} q {str(q_dtype).split('.')[-1]} cache bfloat16, {live} live slots",
        "max_abs_err": err, "atol": atol, "rtol": rtol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
    }


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


def serve_full(api, ops, card, seed: int):
    """Phase 4: full-width qwen3-1.7b through api.serve."""
    from repro_torch.configs import get_config
    from repro_torch.serving.batcher import ContinuousBatcher, Request

    cfg = get_config("qwen3-1.7b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    t0 = time.perf_counter()
    batcher = api.serve("qwen3-1.7b", smoke=False, adapters=make_tenants(cfg, gen),
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
    return {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
        "requests": len(done), "steps": steps, "generated_tokens": gen_tokens,
        "prompt_tokens": prompt_tokens, "setup_s": setup_s, "run_s": run_s,
        "generated_tokens_per_s": gen_tokens / run_s,
        "processed_tokens_per_s": (gen_tokens + prompt_tokens) / run_s,
        "ms_per_step": run_s / steps * 1e3, "peak_mem_gib_during_run": peak_gib,
        "batched_equals_per_request": True, "card": card,
    }, breakdown, launches


def profile_steps(batcher, requests, n_steps: int = 8):
    """Where the time of a decode step goes: ``torch.profiler`` over
    ``n_steps`` steady steps of a full batch, kernel time by name beside the
    host clock (which the profiler itself slows).  Returns None when the
    profiler sees no device time."""
    from torch.autograd import DeviceType
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
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0.0:
        return None
    kernels.sort(key=lambda e: -e.self_device_time_total)
    top = [{"kernel": e.key[:80], "ms_per_step": e.self_device_time_total / 1e3 / n_steps,
            "calls_per_step": e.count / n_steps} for e in kernels[:8]]
    return {"steps": n_steps, "wall_ms_per_step_profiled": wall_ms / n_steps,
            "device_busy_ms_per_step": busy / n_steps,
            "device_idle_share_profiled": 1.0 - busy / wall_ms,
            "kernel_launches_per_step": sum(e.count for e in kernels) / n_steps, "top_kernels": top}


def recording(step, seen: list):
    """``step`` that also keeps each step's logits, on the host, in ``seen``."""

    def wrapped(*args, **kw):
        out = step(*args, **kw)
        seen.append(out[0].cpu())
        return out

    return wrapped


def smoke_cuda_vs_cpu(seed: int):
    """Phase 4b: the smoke model, float32, one batched run on the card (the
    kernels) and one on the CPU (the twins): the logits of every step agree."""
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.models.registry import init_params
    from repro_torch.serving.batcher import Request

    cfg = get_config("qwen3-1.7b", smoke=True).replace(dtype="float32")
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
    check(err <= 1e-4, f"smoke model on the card vs the CPU twins: max abs logit err {err}")
    return {"steps": int(logits["cpu"].shape[0]), "max_abs_err": err, "atol": 1e-4}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import api
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.nn.attention import ring_positions

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    card = card_line()
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    build_s = _build.build()
    for name in _build.KERNELS:
        log = _build.library_path(name).with_name(_build.library_path(name).name + ".log")
        usage = [ln.strip() for ln in log.read_text().splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {name}: {build_s[name]:.1f} s; ptxas: {' | '.join(usage)}", flush=True)
    print(f"build: both kernels in {time.perf_counter() - t0:.1f} s wall", flush=True)

    # 3. kernels against their twins, timed
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

    # 4. serve full-width qwen3-1.7b
    serve_stats, breakdown, launches = serve_full(api, ops, card, args.seed)
    print(f"serve {json.dumps(serve_stats)}", flush=True)
    print(f"decode step profile: {json.dumps(breakdown) if breakdown else 'not measured'} [{card}]", flush=True)
    print(f"smoke model, card vs CPU twins: {json.dumps(smoke_cuda_vs_cpu(args.seed))}", flush=True)

    # 5. kernels line: the main path's shapes (bf16; q and v projections
    #    summed for segmented_lora, one launch each per layer and step)
    check(all(launches[name] > 0 for name in _build.KERNELS), f"a kernel never launched: {launches}")
    q_case, v_case = seg[(torch.bfloat16, 2048)], seg[(torch.bfloat16, 1024)]
    d_case = dec[torch.bfloat16]
    kernels = [
        {
            "name": "segmented_lora", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segmented_lora.cu",
            "replaces": "src/repro/kernels/segmented_lora.py:55",
            "launches": launches["segmented_lora"],
            "max_abs_err": max(q_case["max_abs_err"], v_case["max_abs_err"]),
            **{key: q_case[key] + v_case[key] for key in ("ms", "plain_ms", "bound_ms")},
            "bound_by": q_case["bound_by"], "library_ms": None,
            "shape": "q then v projection of one layer: " + q_case["shape"] + " + " + v_case["shape"],
        },
        {
            "name": "flash_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:78",
            "launches": launches["flash_decode"],
            **{key: d_case[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "shape": d_case["shape"],
        },
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
