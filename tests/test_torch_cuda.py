"""The port's CUDA kernels against their plain twins, on a CUDA card.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the JAX package, so that it runs on a machine that
has only the port's dependencies; ``tests/conftest.py`` imports JAX, hence
``--noconftest``::

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 outputs within 1e-4 (segmented_lora, lora_matmul, wkv6,
mamba_scan: K- or N-long float32 sums in another order) or 2e-5
(flash_decode, flash_attention); bfloat16 outputs within 3e-2 + 1e-2 |ref|,
about two bf16 roundings of an O(1) value.  Gradients: float32 within 1e-4 + 1e-4 |ref|;
bfloat16 within 2% of the largest element of the gradient, since the
kernels round P and dS (or the rank bottleneck) to bf16 for the tensor
cores where the twin's autograd keeps float32.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.nn.attention import INT32_MAX, ring_positions


def _pool(rng, *, m, k, n, ranks, stale):
    """Mixed-rank pool; rows cycle through the slots.  With ``stale`` the
    tails beyond each rank hold garbage, as a recycled slot may."""
    r_max = 8
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) * k**-0.5
    a = rng.standard_normal((len(ranks), k, r_max), dtype=np.float32) * k**-0.5
    b = rng.standard_normal((len(ranks), r_max, n), dtype=np.float32) * 0.1
    if not stale:
        for s, r in enumerate(ranks):
            a[s, :, r:] = 0.0
            b[s, r:, :] = 0.0
    idx = (np.arange(m) % len(ranks)).astype(np.int32)
    return x, w, a, b, idx, np.asarray(ranks, np.int32)


def _to_torch(arrays, dtype, device):
    out = []
    for arr in arrays:
        t = torch.from_numpy(arr)
        out.append((t.to(getattr(torch, dtype)) if t.is_floating_point() else t).to(device))
    return out


def _decode_inputs(rng, b, h, kv, d, s):
    return tuple(rng.standard_normal(shape, dtype=np.float32) for shape in ((b, h, d), (b, s, kv, d), (b, s, kv, d)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "m,k,n,stale", [(6, 200, 192, True), (10, 256, 2048, True), (8, 2048, 1024, False), (3, 96, 33, True)]
)
def test_cuda_segmented_lora_matches_twin(cuda, dtype, m, k, n, stale):
    """N off the 16-column tile and off the 8-column vector (N=33), K off
    the 128 slices, more rows than one pass (M=10), stale rank tails."""
    arrays = _pool(np.random.default_rng(8), m=m, k=k, n=n, ranks=(4, 8, 2), stale=stale)
    args = _to_torch(arrays, dtype, cuda)
    ops.reset_launch_counts()
    got = ops.segmented_lora(*args)
    assert ops.launch_counts["segmented_lora"] == 1
    want = ref.segmented_lora_plain(*args)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_segmented_lora_batch_invariant(cuda):
    """A mixed-adapter batch gives bitwise the rows of uniform batches."""
    x, w, a, b, idx, ranks = _to_torch(
        _pool(np.random.default_rng(9), m=8, k=512, n=320, ranks=(2, 4, 8), stale=True), "bfloat16", cuda
    )
    mixed = ops.segmented_lora(x, w, a, b, idx, ranks)
    for s in range(3):
        uniform = ops.segmented_lora(x, w, a, b, torch.full_like(idx, s), ranks)
        rows = idx == s
        assert torch.equal(mixed[rows], uniform[rows])


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache_dtype", [("bfloat16", "bfloat16"), ("float32", "bfloat16"), ("float32", "float32")])
@pytest.mark.parametrize("window", [None, 40])
def test_cuda_flash_decode_matches_twin(cuda, q_dtype, cache_dtype, window):
    """S=100 (off the 32- and 16-slot steps), rep=4, per-row depths incl. a wrapped
    ring and a recycled row, with and without a window."""
    b, h, kv, d, s = 6, 8, 2, 128, 100
    q, k, v = _decode_inputs(np.random.default_rng(10), b, h, kv, d, s)
    q = torch.from_numpy(q).to(cuda, getattr(torch, q_dtype))
    kc, vc = (torch.from_numpy(t).to(cuda, getattr(torch, cache_dtype)) for t in (k, v))
    pos = torch.tensor([0, 7, 99, 150, 333, 3], dtype=torch.int32, device=cuda)
    kpos = ring_positions(pos, s)
    got = ops.flash_decode(q, kc, vc, pos, kpos, window=window)
    want = ref.decode_attention_plain(q, kc, vc, pos, kpos, window=window)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if q_dtype == "bfloat16" else (2e-5, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_flash_decode_all_masked_row_is_guarded(cuda):
    """A row whose slots are all dead (INT32_MAX) stays finite: the TPU
    kernel's finite -1e30 mask gives the mean of V, as the twin does."""
    q, k, v = (torch.from_numpy(t).to(cuda) for t in _decode_inputs(np.random.default_rng(11), 1, 2, 1, 32, 70))
    pos = torch.tensor([5], dtype=torch.int32, device=cuda)
    kpos = torch.full((1, 70), INT32_MAX, dtype=torch.int32, device=cuda)
    got = ops.flash_decode(q, k, v, pos, kpos)
    want = ref.decode_attention_plain(q, k, v, pos, kpos)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def _attn(rng, b, s, h, kv, d, dtype, device):
    shapes = ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d))
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(device, getattr(torch, dtype)) for sh in shapes]


def _grad_close(got, want, dtype):
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2 * scale, rtol=0)


ATTN_CASES = [  # (B, S, H, KV, D, causal, window)
    (2, 100, 4, 2, 64, True, None),  # ragged S, GQA
    (1, 512, 16, 8, 128, True, None),  # the training shape's heads, batch 1
    (2, 128, 2, 2, 32, True, 48),  # window
    (1, 96, 4, 1, 64, False, None),  # bidirectional, one kv head
    (1, 17, 1, 1, 128, True, None),  # one partial tile
    (2, 100, 4, 2, 128, True, 40),  # ragged S with a window
    (1, 512, 32, 8, 128, True, None),  # jamba-v0.1-52b's attention heads
    (2, 300, 8, 2, 128, True, 200),  # ragged causal window at the training head dim
    (1, 1024, 4, 1, 128, True, None),  # a longer causal sequence: the kv ring turns several times
    (2, 300, 4, 2, 32, True, None),  # ragged S at a head dim under one 64-column box
    (1, 17, 2, 1, 64, False, None),  # one partial tile, bidirectional, D 64
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kv,d,causal,window", ATTN_CASES)
def test_cuda_flash_attention_matches_twin(cuda, dtype, b, s, h, kv, d, causal, window):
    """Forward against the twin; dQ, dK, dV against autograd through it."""
    q, k, v, g = _attn(np.random.default_rng(12), b, s, h, kv, d, dtype, cuda)
    qk = [t.clone().requires_grad_(True) for t in (q, k, v)]
    qt = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ops.reset_launch_counts()
    got = ops.flash_attention(*qk, causal=causal, window=window)
    got_grads = torch.autograd.grad(got, qk, g)
    assert ops.launch_counts["flash_attention"] == 1 and ops.launch_counts["flash_attention_bwd"] == 1
    want = ref.attention_plain(*qt, causal=causal, window=window)
    want_grads = torch.autograd.grad(want, qt, g)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (2e-5, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    for gg, wg in zip(got_grads, want_grads):
        assert gg.dtype == wg.dtype and gg.shape == wg.shape
        _grad_close(gg, wg, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kv,window", [(2, 200, 8, 2, 64), (2, 512, 16, 8, None)])
def test_cuda_flash_attention_backward_is_deterministic(cuda, b, s, h, kv, window):
    """No float atomics: two backward passes give the same bits, with a
    window and at the training shape's heads without one."""
    q, k, v, g = _attn(np.random.default_rng(13), b, s, h, kv, 128, "bfloat16", cuda)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        grads.append(torch.autograd.grad(ops.flash_attention(*leaves, window=window), leaves, g))
    for first, second in zip(*grads):
        assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("rs", [False, True], ids=["ss", "rs"])
@pytest.mark.parametrize("b_mn", [False, True], ids=["b_kmajor", "b_mnmajor"])
@pytest.mark.parametrize("n,k", [(64, 64), (64, 128), (128, 64), (128, 128)])
def test_cuda_wgmma_forms_match_matmul(cuda, rs, b_mn, n, k):
    """Each wgmma form of the bf16 attention kernels (csrc/hopper.cuh), one
    warpgroup's (64 x k) @ (k x n) through the flash_attention library's
    probe entry point, against torch.matmul in float32: A from shared
    memory (SS) or registers (RS), B K-major (given transposed) or MN-major,
    both loaded by TMA into 128-byte-swizzled tiles.  Exact bf16 products
    summed in float32 in another order: within 1e-3 + 1e-4 |ref|."""
    import ctypes

    from repro_torch.kernels import _build

    rng = np.random.default_rng(24)
    a = torch.from_numpy(rng.standard_normal((64, k), dtype=np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)).to(cuda, torch.bfloat16)
    b_arg = b.contiguous() if b_mn else b.t().contiguous()
    c = torch.empty((64, n), dtype=torch.float32, device=cuda)
    fn = _build.load("flash_attention").hopper_wgmma_probe
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    err = fn(int(rs), int(b_mn), n, k, a.data_ptr(), b_arg.data_ptr(), c.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    torch.testing.assert_close(c, a.float() @ b.float(), atol=1e-3, rtol=1e-4)


def _lora(rng, m, k, n, r, dtype, device):
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) * k**-0.5
    a = rng.standard_normal((k, r), dtype=np.float32) * k**-0.5
    b = rng.standard_normal((r, n), dtype=np.float32) * r**-0.5
    g = rng.standard_normal((m, n), dtype=np.float32)
    return [torch.from_numpy(t).to(device, getattr(torch, dtype)) for t in (x, w, a, b, g)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", [(100, 64, 72, 8), (300, 2048, 1024, 8), (64, 96, 40, 16), (7, 33, 5, 4), (130, 256, 2048, 64)])
def test_cuda_lora_matmul_matches_twin(cuda, dtype, m, k, n, r):
    """Forward against the twin; dX (the kernel on transposed views), dA
    and dB against autograd through it.  K, N and M off the tiles."""
    x, w, a, b, g = _lora(np.random.default_rng(14), m, k, n, r, dtype, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, b)]
    twins = [t.clone().requires_grad_(True) for t in (x, a, b)]
    ops.reset_launch_counts()
    got = ops.lora_matmul(leaves[0], w, leaves[1], leaves[2], alpha=2.0)
    got_grads = torch.autograd.grad(got, leaves, g)
    assert ops.launch_counts["lora_matmul"] == 2  # forward and dX
    want = ref.lora_matmul_plain(twins[0], w, twins[1], twins[2], alpha=2.0)
    want_grads = torch.autograd.grad(want, twins, g)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    for gg, wg in zip(got_grads, want_grads):
        assert gg.dtype == wg.dtype and gg.shape == wg.shape
        _grad_close(gg, wg, dtype)


@pytest.mark.cuda
def test_cuda_lora_matmul_takes_no_gradient_for_w(cuda):
    x, w, a, b, _ = _lora(np.random.default_rng(15), 8, 32, 16, 4, "float32", cuda)
    with pytest.raises(ValueError, match="frozen"):
        ops.lora_matmul(x, w.requires_grad_(True), a, b)


def _wkv(rng, b, s, h, k, dtype, device, state):
    r, kk, v = (0.5 * rng.standard_normal((b, s, h, k), dtype=np.float32) for _ in range(3))
    logw = np.clip(-np.exp(rng.standard_normal((b, s, h, k), dtype=np.float32)), -4.0, -1e-4)
    u = 0.3 * rng.standard_normal((h, k), dtype=np.float32)
    dout = rng.standard_normal((b, s, h, k), dtype=np.float32)
    s0, dstate = (rng.standard_normal((b, h, k, k), dtype=np.float32) if state else None for _ in range(2))
    to = lambda a, dt=torch.float32: None if a is None else torch.from_numpy(a).to(device, dt)  # noqa: E731
    return ([to(a, getattr(torch, dtype)) for a in (r, kk, v)] + [to(logw), to(u), to(s0)], to(dout), to(dstate))


WKV_CASES = [  # (B, S, H, K, state)
    (2, 100, 3, 64, False),  # S off the 16-token chunk
    (1, 16, 2, 32, True),  # one chunk, a state in and out
    (2, 33, 4, 16, True),
    (1, 1, 1, 64, False),  # one token
    (2, 512, 40, 64, False),  # the training shape's heads
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,k,state", WKV_CASES)
def test_cuda_wkv6_matches_twins(cuda, dtype, b, s, h, k, state):
    """Forward (out, final state) against ``wkv6_plain``; dr, dk, dv,
    dlogw, du (and ds0, with a cotangent on the final state) against
    ``wkv6_bwd_plain``.  Float32 outputs within 1e-4 + 1e-3 |ref|; bf16
    dr, dk, dv within 3e-2 + 1e-2 |ref| (one bf16 rounding)."""
    inputs, dout, dstate = _wkv(np.random.default_rng(16), b, s, h, k, dtype, cuda, state)
    leaves = [t.clone().requires_grad_(True) for t in inputs if t is not None]
    ops.reset_launch_counts()
    out, st = ops.wkv6(*leaves, *([] if state else [None]))
    loss = (out * dout).sum() + ((st * dstate).sum() if state else 0.0)
    grads = torch.autograd.grad(loss, leaves)
    assert ops.launch_counts["wkv6"] == 1 and ops.launch_counts["wkv6_bwd"] == 1
    want_out, want_st = ref.wkv6_plain(*inputs)
    want = [g for g in ref.wkv6_bwd_plain(*inputs, dout, dstate) if g is not None]
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-3)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        atol, rtol = (3e-2, 1e-2) if g.dtype == torch.bfloat16 else (1e-4, 1e-3)
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_cuda_wkv6_backward_is_deterministic(cuda):
    """No atomics: two backward passes give the same bits (du sums over
    the batch in a second pass, in order)."""
    inputs, dout, _ = _wkv(np.random.default_rng(17), 4, 70, 3, 64, "bfloat16", cuda, False)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in inputs[:5]]
        out, _ = ops.wkv6(*leaves)
        grads.append(torch.autograd.grad(out, leaves, dout))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wkv6_rejects_what_the_kernel_does_not_take(cuda):
    inputs, _, _ = _wkv(np.random.default_rng(18), 1, 8, 2, 48, "float32", cuda, False)
    with pytest.raises(ValueError, match="head dim"):
        ops.wkv6(*inputs[:5])
    inputs, _, _ = _wkv(np.random.default_rng(18), 1, 8, 2, 32, "float32", cuda, False)
    with pytest.raises(ValueError, match="float32"):
        ops.wkv6(*inputs[:3], inputs[3].to(torch.bfloat16), inputs[4])


@pytest.mark.cuda
def test_cuda_rwkv_smoke_round_matches_the_cpu(cuda):
    """One local round of the rwkv6-3b smoke model in float32 on the card
    (the kernels) and on the CPU (the twins), from the same params, LoRA,
    batches and gates.  AdamW's first steps move an element by about
    lr * sign(g): every PEFT element within 2 * (sum of the step sizes) +
    1e-6, 99% within 1e-6; metrics within 1e-5 rel, importances 1e-4 rel."""
    from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
    from repro_torch.core.peft import init_peft
    from repro_torch.data.synthetic import make_task
    from repro_torch.federated.client import make_client_fns
    from repro_torch.models.registry import init_params, place_params
    from repro_torch.models.stacking import tree_leaves, tree_map
    from repro_torch.optim import adamw_init, make_lr_schedule

    cfg, train_cfg = get_config("rwkv6-3b", smoke=True).replace(dtype="float32"), TrainConfig()
    gen = torch.Generator().manual_seed(19)
    params, peft = init_params(cfg, gen), init_peft(cfg, PEFTConfig(), gen)
    for leaf in tree_leaves(peft):
        leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
    task = make_task(vocab_size=cfg.vocab_size, seq_len=40, num_examples=8, seed=19)
    per_step = [task.lm_batch(np.arange(4 * i, 4 * i + 4)) for i in range(2)]
    batches = {key: np.stack([b[key] for b in per_step]) for key in ("tokens", "targets", "mask")}
    out = {}
    for device in ("cuda", "cpu"):
        fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), train_cfg, device=device)
        pf = tree_map(lambda t: t.to(device), peft)
        ops.reset_launch_counts()
        res = fns.local_round(place_params(params, cfg, device), pf, adamw_init(pf), batches, 0.5,
                              torch.Generator().manual_seed(19), 0)
        if device == "cuda":
            assert ops.launch_counts["wkv6"] > 0
        out[device] = [tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, part) for part in res]
    (pc, _, mc, ic), (pp, _, mp, ip) = out["cuda"], out["cpu"]
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(tree_leaves(pc), tree_leaves(pp))])
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.total_steps)
    assert float(diffs.max()) <= 2 * (sched(0) + sched(1)) + 1e-6
    assert float((diffs <= 1e-6).float().mean()) >= 0.99
    for key in mc:
        torch.testing.assert_close(mc[key], mp[key], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ic, ip, rtol=1e-4, atol=1e-7)


def _mamba(rng, b, s, d, n, dtype, device):
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d), dtype=np.float32) - 1.0))  # softplus, as the model's dt
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    bm, cm = (rng.standard_normal((b, s, n), dtype=np.float32) for _ in range(2))
    a = -np.exp(rng.standard_normal((d, n), dtype=np.float32))
    dv = rng.standard_normal((d,), dtype=np.float32)
    dy = rng.standard_normal((b, s, d), dtype=np.float32)
    to = lambda v, t=torch.float32: torch.from_numpy(v).to(device, t)  # noqa: E731
    io = getattr(torch, dtype)
    return [to(dt, io), to(x, io), to(bm), to(cm), to(a), to(dv)], to(dy, io)


MAMBA_CASES = [  # (B, S, D, N)
    (2, 70, 256, 8),  # S off the chunk
    (1, 33, 200, 16),  # D off the 128-channel block
    (2, 1, 128, 16),  # one token
    (3, 16, 384, 8),  # whole chunks
    (2, 512, 8192, 16),  # the training shape's channels and length
]


def _sum_close(got, want):
    """A float32 sum over rows, time or channels, in another order: within
    1e-3 |ref| + 1e-5 of the largest element."""
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()) + 1e-6, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,n", MAMBA_CASES)
def test_cuda_mamba_scan_matches_twins(cuda, dtype, b, s, d, n):
    """Forward (y, final state) against ``mamba_scan_plain``; d_dt, dx,
    dB, dC, dA, dD against ``mamba_scan_bwd_plain``.  y, d_dt, dx within
    1e-4 + 1e-3 |ref| in float32 and 3e-2 + 1e-2 |ref| in bf16 (one bf16
    rounding); the final state within 1e-4 + 1e-3 |ref|; dB, dC, dA, dD
    (float32 sums over channels, rows and time) by ``_sum_close``."""
    inputs, dy = _mamba(np.random.default_rng(20), b, s, d, n, dtype, cuda)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    ops.reset_launch_counts()
    y, st = ops.mamba_scan(*leaves)
    grads = torch.autograd.grad(y, leaves, dy)
    assert ops.launch_counts["mamba_scan"] == 1 and ops.launch_counts["mamba_scan_bwd"] == 1
    assert not st.requires_grad
    want_y, want_st = ref.mamba_scan_plain(*inputs)
    want = ref.mamba_scan_bwd_plain(*inputs, dy)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-3)
    assert y.dtype == want_y.dtype and st.dtype == torch.float32
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-3)
    for name, g, w in zip(("d_dt", "dx", "dB", "dC", "dA", "dD"), grads, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in ("d_dt", "dx"):
            torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=name)
        else:
            _sum_close(g, w)


@pytest.mark.cuda
def test_cuda_mamba_scan_backward_is_deterministic(cuda):
    """No atomics: two backward passes give the same bits (dB, dC sum over
    channel blocks, dA, dD over rows, each in a second pass, in order)."""
    inputs, dy = _mamba(np.random.default_rng(21), 4, 70, 640, 16, "bfloat16", cuda)
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        y, _ = ops.mamba_scan(*leaves)
        grads.append(torch.autograd.grad(y, leaves, dy))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_mamba_scan_rejects_what_the_kernel_does_not_take(cuda):
    inputs, _ = _mamba(np.random.default_rng(22), 1, 8, 64, 4, "float32", cuda)
    with pytest.raises(ValueError, match="state dim"):
        ops.mamba_scan(*inputs)
    inputs, _ = _mamba(np.random.default_rng(22), 2, 8, 64, 8, "bfloat16", cuda)
    with pytest.raises(ValueError, match="float32"):
        ops.mamba_scan(*inputs[:2], inputs[2].to(torch.bfloat16), *inputs[3:])
    with pytest.raises(ValueError, match="one dtype"):
        ops.mamba_scan(inputs[0].float(), *inputs[1:])
    with pytest.raises(ValueError, match="shapes"):
        ops.mamba_scan(*inputs[:2], inputs[2][:, :4].contiguous(), *inputs[3:])
    with pytest.raises(ValueError, match="contiguous"):
        ops.mamba_scan(inputs[0].transpose(0, 1).contiguous().transpose(0, 1), *inputs[1:])


@pytest.mark.cuda
def test_cuda_jamba_smoke_round_matches_the_cpu(cuda):
    """One local round of the jamba smoke model (Mamba + MLP, attention +
    MoE) in float32 on the card (the kernels) and on the CPU (the twins),
    from the same params, LoRA, batches and gates; the limits of
    ``test_cuda_rwkv_smoke_round_matches_the_cpu``."""
    from repro_torch.configs import PEFTConfig, STLDConfig, TrainConfig, get_config
    from repro_torch.core.peft import init_peft
    from repro_torch.data.synthetic import make_task
    from repro_torch.federated.client import make_client_fns
    from repro_torch.models.registry import init_params, place_params
    from repro_torch.models.stacking import tree_leaves, tree_map
    from repro_torch.optim import adamw_init, make_lr_schedule

    cfg, train_cfg = get_config("jamba-v0.1-52b", smoke=True).replace(dtype="float32"), TrainConfig()
    gen = torch.Generator().manual_seed(23)
    params, peft = init_params(cfg, gen), init_peft(cfg, PEFTConfig(), gen)
    for leaf in tree_leaves(peft):
        leaf.add_(0.02 * torch.randn(leaf.shape, generator=gen))
    task = make_task(vocab_size=cfg.vocab_size, seq_len=40, num_examples=8, seed=23)
    per_step = [task.lm_batch(np.arange(4 * i, 4 * i + 4)) for i in range(2)]
    batches = {key: np.stack([b[key] for b in per_step]) for key in ("tokens", "targets", "mask")}
    out = {}
    for device in ("cuda", "cpu"):
        fns = make_client_fns(cfg, PEFTConfig(), STLDConfig(), train_cfg, device=device)
        pf = tree_map(lambda t: t.to(device), peft)
        ops.reset_launch_counts()
        res = fns.local_round(place_params(params, cfg, device), pf, adamw_init(pf), batches, 0.5,
                              torch.Generator().manual_seed(23), 0)
        if device == "cuda":
            assert ops.launch_counts["mamba_scan"] > 0 and ops.launch_counts["mamba_scan_bwd"] > 0
        out[device] = [tree_map(lambda t: t.cpu() if isinstance(t, torch.Tensor) else t, part) for part in res]
    (pc, _, mc, ic), (pp, _, mp, ip) = out["cuda"], out["cpu"]
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(tree_leaves(pc), tree_leaves(pp))])
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.total_steps)
    assert float(diffs.max()) <= 2 * (sched(0) + sched(1)) + 1e-6
    assert float((diffs <= 1e-6).float().mean()) >= 0.99
    for key in mc:
        torch.testing.assert_close(mc[key], mp[key], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ic, ip, rtol=1e-4, atol=1e-7)
