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
cores where the twin's autograd keeps float32.  Bidirectional bf16
attention over keys of their own length, and flash_decode over every slot,
are also held to the output's own scale: ||got - want|| / ||want|| within
6e-3 (``_rel_l2_close``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.nn.attention import INT32_MAX, ring_positions


def _pool(rng, *, m, k, n, ranks, stale, r_max=8):
    """Mixed-rank pool; rows cycle through the slots.  With ``stale`` the
    tails beyond each rank hold garbage, as a recycled slot may."""
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 1024)])
@pytest.mark.parametrize("m", [8, 12])
def test_cuda_segmented_lora_hetlora_ranks_match_twin(cuda, dtype, m, k, n):
    """A FedHetLoRA checkpoint's tenants: ranks 4, 8, 16 and 16 in a pool of
    r_max 16 over stale tails, at qwen3-1.7b's q and v projections."""
    arrays = _pool(np.random.default_rng(60 + m), m=m, k=k, n=n, ranks=(4, 8, 16, 16), stale=True, r_max=16)
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


SEGMENTED_SHAPES = [  # (K, N): the decode step's v; K off the 128-row slab steps, N off the 64- and 32-column tiles
    (2048, 1024), (1000, 1000), (2100, 333),
    # the q and v projections of glm4-9b, h2o-danube-1.8b and yi-6b
    (4096, 4096), (4096, 256), (2560, 2560), (2560, 640), (4096, 512),
    (2048, 2048),  # qwen3-1.7b's q
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", SEGMENTED_SHAPES)
@pytest.mark.parametrize("m", [1, 3, 8, 13, 64])
def test_cuda_segmented_lora_shapes_match_twin(cuda, dtype, m, k, n):
    """M of one row to several passes of 8, K and N off the slabs, splits
    and tiles (N = 333 off the 16-byte vector too), a pooled rank of 64
    with slots of rank 64, 8, 33 and 1 over stale tails."""
    arrays = _pool(np.random.default_rng(40 + m), m=m, k=k, n=n, ranks=(64, 8, 33, 1), stale=True, r_max=64)
    args = _to_torch(arrays, dtype, cuda)
    ops.reset_launch_counts()
    got = ops.segmented_lora(*args)
    assert ops.launch_counts["segmented_lora"] == 1
    want = ref.segmented_lora_plain(*args)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(2048, 2048), (2100, 333)])
def test_cuda_segmented_lora_row_is_batch_invariant(cuda, dtype, k, n):
    """A row gives the same bits alone, in a batch of 8 and in a batch of 13
    with other tenants: the slabs and splits come from K, N and the card,
    never from M or the slots."""
    x, w, a, b, idx, ranks = _to_torch(
        _pool(np.random.default_rng(41), m=13, k=k, n=n, ranks=(8, 4, 2, 8), stale=True), dtype, cuda
    )
    idx = torch.tensor([0, 1, 2, 3, 1, 0, 2, 3, 3, 1, 0, 2, 1], dtype=torch.int32, device=cuda)
    all13 = ops.segmented_lora(x, w, a, b, idx, ranks)
    first8 = ops.segmented_lora(x[:8].contiguous(), w, a, b, idx[:8].contiguous(), ranks)
    assert torch.equal(first8, all13[:8])
    for i in (0, 5, 7):
        alone = ops.segmented_lora(x[i:i + 1].contiguous(), w, a, b, idx[i:i + 1].contiguous(), ranks)
        assert torch.equal(alone[0], all13[i]), i


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
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", [1500, 77])
def test_cuda_flash_decode_every_slot_live_matches_twin(cuda, q_dtype, s):
    """One query over S slots all live (slot j at position j, the query at
    S - 1), as whisper-tiny's cross-attention decodes over its 1 500
    encoder frames; S off the 64-slot chunk."""
    q, k, v = _decode_inputs(np.random.default_rng(17), 8, 6, 6, 64, s)
    q = torch.from_numpy(q).to(cuda, getattr(torch, q_dtype))
    kc, vc = (torch.from_numpy(t).to(cuda, torch.bfloat16) for t in (k, v))
    pos = torch.full((8,), s - 1, dtype=torch.int32, device=cuda)
    kpos = torch.arange(s, dtype=torch.int32, device=cuda).expand(8, s).contiguous()
    got = ops.flash_decode(q, kc, vc, pos, kpos)
    want = ref.decode_attention_plain(q, kc, vc, pos, kpos)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if q_dtype == "bfloat16" else (2e-5, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    _rel_l2_close(got, want)


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


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache_dtype", [("bfloat16", "bfloat16"), ("float32", "bfloat16"), ("float32", "float32")])
@pytest.mark.parametrize("window", [None, 40])
def test_cuda_flash_decode_lse_matches_twin(cuda, q_dtype, cache_dtype, window):
    """The log-sum-exp output (the merge's m + log l) against the twin's,
    within 1e-4 (float32 sums in another order); -1e30 for a row with no
    live slot; the output bit for bit the call's without it."""
    b, h, kv, d, s = 6, 8, 2, 128, 100
    q, k, v = _decode_inputs(np.random.default_rng(12), b, h, kv, d, s)
    q = torch.from_numpy(q).to(cuda, getattr(torch, q_dtype))
    kc, vc = (torch.from_numpy(t).to(cuda, getattr(torch, cache_dtype)) for t in (k, v))
    pos = torch.tensor([0, 7, 99, 150, 333, 3], dtype=torch.int32, device=cuda)
    kpos = ring_positions(pos, s)
    kpos[5] = INT32_MAX
    ops.reset_launch_counts()
    got, lse = ops.flash_decode(q, kc, vc, pos, kpos, window=window, return_lse=True)
    assert ops.launch_counts["flash_decode"] == 1
    _, want = ref.decode_attention_plain(q, kc, vc, pos, kpos, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and (lse[5] == -1e30).all()
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    assert torch.equal(got, ops.flash_decode(q, kc, vc, pos, kpos, window=window))


SPLIT_CASES = [  # (B, H, KV, Dr, S): the head-dim slices of the dense archs' caches
    (8, 16, 8, 8, 512),  # qwen3-1.7b at model 16: hd 128 / 16
    (8, 32, 8, 5, 300),  # h2o-danube-1.8b at model 16: hd 80 / 16
    (4, 32, 2, 32, 512),  # glm4-9b at model 4: rep 16
    (2, 4, 2, 8, 77),  # the smoke configs, S off the 128-slot block
    (2, 8, 1, 160, 130),  # Dr past 128 threads: two dims a thread
]


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache_dtype", [("bfloat16", "bfloat16"), ("float32", "bfloat16"), ("float32", "float32")])
@pytest.mark.parametrize("b,h,kv,dr,s", SPLIT_CASES)
def test_cuda_flash_decode_split_pair_matches_twins(cuda, q_dtype, cache_dtype, b, h, kv, dr, s):
    """``flash_decode_scores`` and ``flash_decode_combine`` against their
    twins, with and without a window, a wrapped ring and a row with no
    live slot: the scores within 1e-5 + 1e-5 |ref| (float32 sums of Dr
    products in another order), the output as ``flash_decode``'s rule, the
    log-sum-exp within 1e-4."""
    rng = np.random.default_rng(40 + dr)
    q, k, v = _decode_inputs(rng, b, h, kv, dr, s)
    q = torch.from_numpy(q).to(cuda, getattr(torch, q_dtype))
    kc, vc = (torch.from_numpy(t).to(cuda, getattr(torch, cache_dtype)) for t in (k, v))
    pos = torch.tensor([0, 3, s - 1, 2 * s + 17, s // 2, 5, 40, 9][:b], dtype=torch.int32, device=cuda)
    kpos = ring_positions(pos, s)
    kpos[b - 1] = INT32_MAX
    scale = (dr * 16) ** -0.5
    ops.reset_launch_counts()
    scores = ops.flash_decode_scores(q, kc, scale=scale)
    torch.testing.assert_close(scores, ref.decode_scores_plain(q, kc, scale=scale), atol=1e-5, rtol=1e-5)
    atol, rtol = (3e-2, 1e-2) if q_dtype == "bfloat16" else (2e-5, 1e-5)
    for window in (None, 40):
        got, lse = ops.flash_decode_combine(scores, vc, pos, kpos, window=window, dtype=q.dtype)
        want, want_lse = ref.decode_combine_plain(scores, vc, pos, kpos, window=window, dtype=q.dtype)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype and torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    assert ops.launch_counts["flash_decode_scores"] == 1 and ops.launch_counts["flash_decode_combine"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dr", [5, 8, 32])
def test_cuda_flash_decode_split_pair_sums_to_flash_decode(cuda, dr):
    """Over the head dim's slices (hd 160): the scores summed, each
    slice's combine, concatenated, give ``flash_decode``'s output on the
    whole head within 2e-5 in float32, and each slice's log-sum-exp its."""
    b, h, kv, hd, s = 4, 16, 8, 160, 300
    q, k, v = (torch.from_numpy(t).to(cuda) for t in _decode_inputs(np.random.default_rng(50), b, h, kv, hd, s))
    pos = torch.tensor([0, 3, 299, 617], dtype=torch.int32, device=cuda)
    kpos = ring_positions(pos, s)
    want, want_lse = ops.flash_decode(q, k, v, pos, kpos, window=100, return_lse=True)
    cuts = [(lo, lo + dr) for lo in range(0, hd, dr)]
    scores = sum(ops.flash_decode_scores(q[..., lo:hi].contiguous(), k[..., lo:hi].contiguous(), scale=hd**-0.5)
                 for lo, hi in cuts)
    parts = [ops.flash_decode_combine(scores, v[..., lo:hi].contiguous(), pos, kpos, window=100) for lo, hi in cuts]
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([o for o, _ in parts], -1), want, atol=2e-5, rtol=1e-5)
    for _, lse in parts:
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)


DECODE_CASES = [  # (B, H, KV, D, S, window)
    (3, 8, 8, 64, 1000, None),  # rep 1, D 64, S off the split (16 splits of 62-63 slots)
    (4, 16, 8, 128, 512, None),  # rep 2, the decode step's heads
    (2, 8, 1, 256, 70, 33),  # rep 8, D 256, a window
    (2, 16, 2, 128, 300, 100),  # rep 8, a window over a wrapped ring
    (4, 32, 2, 128, 512, None),  # rep 16: glm4-9b's heads, one block a KV head
    (4, 32, 8, 80, 300, 100),  # D 80: h2o-danube-1.8b's heads, a window over a wrapped ring
    (2, 32, 2, 256, 130, None),  # rep 16 at D 256: two blocks of 8 queries a KV head
    (2, 6, 2, 48, 70, 20),  # rep 3 at D 48: a lane's dims masked past D
    (4, 24, 8, 64, 512, None),  # rep 3 at D 64: granite-moe-3b-a800m's serving step
    (4, 40, 8, 128, 512, None),  # rep 5 at D 128: llama4-scout-17b-a16e's serving step
]
DECODE_DTYPES = [("bfloat16", "bfloat16"), ("float32", "bfloat16"), ("float32", "float32")]


def _decode_case(rng, b, h, kv, d, s, q_dtype, cache_dtype, device):
    q, k, v = _decode_inputs(rng, b, h, kv, d, s)
    q = torch.from_numpy(q).to(device, getattr(torch, q_dtype))
    kc, vc = (torch.from_numpy(t).to(device, getattr(torch, cache_dtype)) for t in (k, v))
    # a fresh row, a shallow row (its later slabs dead), a full ring, a wrapped ring
    pos = torch.tensor([0, 3, s - 1, 2 * s + 17, s // 2, 5][:b], dtype=torch.int32, device=device)
    return q, kc, vc, pos, ring_positions(pos, s)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache_dtype", DECODE_DTYPES)
@pytest.mark.parametrize("b,h,kv,d,s,window", DECODE_CASES)
def test_cuda_flash_decode_shapes_match_twin(cuda, q_dtype, cache_dtype, b, h, kv, d, s, window):
    """rep 1, 2, 3, 5, 8 and 16; D 48, 64, 80, 128 and 256; S off the
    split; windows; rows whose later slabs are dead."""
    q, kc, vc, pos, kpos = _decode_case(np.random.default_rng(30), b, h, kv, d, s, q_dtype, cache_dtype, cuda)
    ops.reset_launch_counts()
    got = ops.flash_decode(q, kc, vc, pos, kpos, window=window)
    assert ops.launch_counts["flash_decode"] == 1
    want = ref.decode_attention_plain(q, kc, vc, pos, kpos, window=window)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if q_dtype == "bfloat16" else (2e-5, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 20])
def test_cuda_flash_decode_dead_slabs_add_nothing(cuda, window):
    """In a row with a live slot, the dead slots (never written, or outside
    the window) add exactly 0: other K/V in them leave every bit of the
    output as it was."""
    b, h, kv, d, s = 3, 16, 8, 128, 512
    q, kc, vc, pos, kpos = _decode_case(np.random.default_rng(31), b, h, kv, d, s, "bfloat16", "bfloat16", cuda)
    pos = torch.tensor([3, 700, 260], dtype=torch.int32, device=cuda)
    kpos = ring_positions(pos, s)
    got = ops.flash_decode(q, kc, vc, pos, kpos, window=window)
    live = (kpos <= pos[:, None]) & ((kpos > pos[:, None] - window) if window else True)
    kc2, vc2 = kc.clone(), vc.clone()
    kc2[~live] = 7.0
    vc2[~live] = -3.0
    torch.testing.assert_close(got.float(), ref.decode_attention_plain(q, kc, vc, pos, kpos, window=window).float(),
                               atol=3e-2, rtol=1e-2)
    assert torch.equal(got, ops.flash_decode(q, kc2, vc2, pos, kpos, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache_dtype", DECODE_DTYPES)
def test_cuda_flash_decode_all_masked_row_in_a_batch(cuda, q_dtype, cache_dtype):
    """A row whose 512 slots are all dead, between live rows: finite, the
    mean of V as the twin gives it; its neighbours unchanged."""
    q, kc, vc, pos, kpos = _decode_case(np.random.default_rng(32), 3, 16, 8, 128, 512, q_dtype, cache_dtype, cuda)
    kpos[1] = INT32_MAX
    got = ops.flash_decode(q, kc, vc, pos, kpos)
    want = ref.decode_attention_plain(q, kc, vc, pos, kpos)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    atol, rtol = (3e-2, 1e-2) if q_dtype == "bfloat16" else (2e-5, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,cache_dtype", DECODE_DTYPES)
def test_cuda_flash_decode_row_is_batch_invariant(cuda, q_dtype, cache_dtype):
    """A row alone and the same row inside a batch of 8 other rows give the
    same bits: the splits come from S and the card, never from B."""
    b, h, kv, d, s = 9, 16, 8, 128, 512
    q, kc, vc, _, _ = _decode_case(np.random.default_rng(33), b, h, kv, d, s, q_dtype, cache_dtype, cuda)
    pos = torch.tensor([0, 3, 17, 130, 511, 611, 1543, 5, 300], dtype=torch.int32, device=cuda)
    kpos = ring_positions(pos, s)
    batched = ops.flash_decode(q, kc, vc, pos, kpos)
    for i in range(b):
        alone = ops.flash_decode(q[i:i + 1].contiguous(), kc[i:i + 1].contiguous(), vc[i:i + 1].contiguous(),
                                 pos[i:i + 1].contiguous(), kpos[i:i + 1].contiguous())
        assert torch.equal(alone[0], batched[i]), i


def _attn(rng, b, s, h, kv, d, dtype, device):
    shapes = ((b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d))
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(device, getattr(torch, dtype)) for sh in shapes]


def _grad_close(got, want, dtype):
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2 * scale, rtol=0)


# Over 1 500 keys a typical |out| is ~0.04, so the 3e-2 limits above pass
# a key past S_kv left visible (~1.4e-2 of every output and gradient); the
# sound kernels measured 2.3e-3 - 2.8e-3 on N(0, 1) inputs at these shapes
# (``tests/cuda_tail_mask_check.py``, which also shows that fault failing here).
BF16_REL_L2 = 6e-3


def _rel_l2_close(got, want):
    rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    assert rel <= BF16_REL_L2, f"relative L2 error {rel} over {BF16_REL_L2}"


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
    (16, 32, 16, 8, 128, True, None),  # the federated runner's shape: batch 16 x 32 tokens, one partial tile
    (2, 300, 32, 8, 80, True, None),  # h2o-danube-1.8b's heads: D 80, 16 live columns of the second 64-column box
    (2, 300, 32, 8, 80, True, 100),  # D 80 with a window
    (1, 256, 32, 2, 128, True, None),  # glm4-9b's heads: 16 query heads a KV head
    (2, 300, 24, 8, 64, True, None),  # granite-moe-3b-a800m's heads: 3 a KV head at D 64
    (1, 256, 40, 8, 128, True, None),  # llama4-scout-17b-a16e's heads: 5 a KV head
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


CROSS_CASES = [  # (B, S_q, S_kv, H, KV, D): keys of a length of their own, bidirectional
    (2, 64, 1500, 6, 6, 64),  # whisper-tiny's cross-attention: 1 500 encoder frames, D 64
    (1, 130, 200, 4, 2, 128),  # S_kv off the 64- and 128-key tiles, S_q off the 128-query tile, GQA
    (2, 300, 77, 4, 4, 32),  # fewer keys than queries, both ragged
    (2, 1500, 1500, 6, 6, 64),  # whisper-tiny's encoder self-attention: S 1 500 on both sides
]


def _cross(rng, b, sq, skv, h, kv, d, dtype, device):
    shapes = ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d), (b, sq, h, d))
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32)).to(device, getattr(torch, dtype)) for sh in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,h,kv,d", CROSS_CASES)
def test_cuda_flash_attention_key_length_of_its_own_matches_twin(cuda, dtype, b, sq, skv, h, kv, d):
    """Bidirectional attention over K/V of S_kv rows: the forward against
    the twin; dQ, dK, dV against autograd through it."""
    q, k, v, g = _cross(np.random.default_rng(14), b, sq, skv, h, kv, d, dtype, cuda)
    qk = [t.clone().requires_grad_(True) for t in (q, k, v)]
    qt = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = ops.flash_attention(*qk, causal=False)
    got_grads = torch.autograd.grad(got, qk, g)
    want = ref.attention_plain(*qt, causal=False)
    want_grads = torch.autograd.grad(want, qt, g)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (2e-5, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    for gg, wg in zip(got_grads, want_grads):
        assert gg.shape == wg.shape
        _grad_close(gg, wg, dtype)
    if dtype == "bfloat16":
        for gg, wg in zip((got, *got_grads), (want, *want_grads)):
            _rel_l2_close(gg, wg)


def _bwd_kernel_calls(fn) -> dict:
    """The attention backward's kernels that ``fn`` launches, by name
    (``flash_bwd_dq_bf16_kernel``, ...), from ``torch.profiler``'s device
    events.  64 spin kernels go first: the profiler has been seen to lose
    a window's first kernels."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    calls = {}
    for e in prof.profiler.kineto_results.events():
        found = re.search(r"flash_bwd_(dq|dkv)_(bf16|f32)_kernel", e.name())
        if e.device_type() == DeviceType.CUDA and found:
            calls[found.group(0)] = calls.get(found.group(0), 0) + 1
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_dq_only_backward(cuda, dtype):
    """K and V that take no gradient (a frozen encoder's cross K/V): the
    backward launches the dQ kernel alone, no dK/dV kernel, and its dQ is
    the full backward's, bit for bit."""
    q, k, v, g = _cross(np.random.default_rng(15), 2, 64, 1500, 6, 6, 64, dtype, cuda)
    full = [t.clone().requires_grad_(True) for t in (q, k, v)]
    dq_full = torch.autograd.grad(ops.flash_attention(*full, causal=False), full, g)[0]
    q_only = q.clone().requires_grad_(True)
    out = ops.flash_attention(q_only, k, v, causal=False)
    ops.reset_launch_counts()
    calls = _bwd_kernel_calls(lambda: torch.autograd.grad(out, [q_only], g, retain_graph=True))
    assert ops.launch_counts["flash_attention_bwd"] == 1
    tag = "f32" if dtype == "float32" else "bf16"
    assert calls == {f"flash_bwd_dq_{tag}_kernel": 1}, calls
    dq = torch.autograd.grad(out, [q_only], g)[0]
    assert torch.equal(dq, dq_full)
    both = _bwd_kernel_calls(lambda: torch.autograd.grad(ops.flash_attention(*full, causal=False), full, g))
    assert both == {f"flash_bwd_dq_{tag}_kernel": 1, f"flash_bwd_dkv_{tag}_kernel": 1}, both


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"causal": True}, {"causal": False, "window": 64}])
def test_cuda_flash_attention_key_length_of_its_own_raises_unless_bidirectional(cuda, kw):
    q, k, v, _ = _cross(np.random.default_rng(16), 1, 64, 100, 2, 2, 64, "bfloat16", cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="bidirectional only"):
        ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts["flash_attention"] == 0


WGMMA_FORMS = [  # (rs, b_mn, n, k): the attention kernels' forms, then lora_matmul's m64n256k16
    (rs, b_mn, n, k) for rs in (False, True) for b_mn in (False, True)
    for n, k in ((64, 64), (64, 128), (128, 64), (128, 128))
] + [(False, False, 256, 64), (False, True, 256, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "rs,b_mn,n,k", WGMMA_FORMS,
    ids=[f"{'rs' if f[0] else 'ss'}-{'b_mnmajor' if f[1] else 'b_kmajor'}-n{f[2]}-k{f[3]}" for f in WGMMA_FORMS],
)
def test_cuda_wgmma_forms_match_matmul(cuda, rs, b_mn, n, k):
    """Each wgmma form of the bf16 attention kernels and of lora_matmul
    (csrc/hopper.cuh), one warpgroup's (64 x k) @ (k x n) through the
    flash_attention library's probe entry point, against torch.matmul in
    float32: A from shared memory (SS) or registers (RS), B K-major (given
    transposed) or MN-major, both loaded by TMA into 128-byte-swizzled
    tiles.  Exact bf16 products summed in float32 in another order: within
    1e-3 + 1e-4 |ref|."""
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


LORA_CASES = [  # (M, K, N, r)
    (100, 64, 72, 8), (300, 2048, 1024, 8), (64, 96, 40, 16), (7, 33, 5, 4), (130, 256, 2048, 64),
    (257, 520, 264, 1), (129, 136, 520, 33), (1, 8, 8, 5),  # ragged M, K and N off the tiles, multiples of 8
    (50, 44, 24, 8), (33, 64, 100, 2),  # K or N not a multiple of 8: the WMMA route
    # the q and v projections of glm4-9b (K 4096, N 4096 and 256), h2o-danube-1.8b (K 2560, N 2560 and 640)
    # and yi-6b (K 4096, N 512)
    (300, 4096, 4096, 8), (300, 4096, 256, 8), (300, 2560, 2560, 8), (300, 2560, 640, 8), (300, 4096, 512, 8),
    # FedHetLoRA's lowest and highest ranks at the federated rounds' shape (16 x 32 tokens, qwen3-1.7b's q and v):
    # below 8 the bottleneck is staged through the RT path, above 8 the epilogue sums each group of 8 ranks in turn
    (512, 2048, 2048, 4), (512, 2048, 1024, 4), (512, 2048, 2048, 16), (512, 2048, 1024, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", LORA_CASES)
def test_cuda_lora_matmul_matches_twin(cuda, dtype, m, k, n, r):
    """Forward against the twin; dX (the kernel on transposed views), dA
    and dB against autograd through it.  K, N and M off the tiles; bf16
    takes the wgmma route when K and N are multiples of 8, else WMMA."""
    x, w, a, b, g = _lora(np.random.default_rng(14), m, k, n, r, dtype, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, b)]
    twins = [t.clone().requires_grad_(True) for t in (x, a, b)]
    ops.reset_launch_counts()
    got = ops.lora_matmul(leaves[0], w, leaves[1], leaves[2], alpha=2.0)
    got_grads = torch.autograd.grad(got, leaves, g)
    assert ops.launch_counts["lora_matmul"] == 2  # forward and dX
    route = "fma" if dtype == "float32" else ("wgmma" if k % 8 == 0 and n % 8 == 0 else "wmma")
    assert ops.lora_matmul_routes[route] == 2
    want = ref.lora_matmul_plain(twins[0], w, twins[1], twins[2], alpha=2.0)
    want_grads = torch.autograd.grad(want, twins, g)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    for gg, wg in zip(got_grads, want_grads):
        assert gg.dtype == wg.dtype and gg.shape == wg.shape
        _grad_close(gg, wg, dtype)


@pytest.mark.cuda
def test_cuda_tma_kernels_launch_from_a_thread_without_a_context(cuda):
    """A thread that has made no CUDA runtime call holds no current context
    (as PyTorch's autograd thread before its first one), and the wgmma
    lora_matmul and the bf16 attention encode their TMA maps through
    libcuda: launched there, they bind the card's context and give the
    main thread's bits."""
    import ctypes
    import threading

    x, w, a, b, _ = _lora(np.random.default_rng(20), 256, 512, 264, 8, "bfloat16", cuda)
    q, k, v = (torch.randn(shape, device=cuda).to(torch.bfloat16) for shape in ((2, 128, 4, 64), (2, 128, 2, 64),
                                                                                (2, 128, 2, 64)))
    run = lambda: (ops.lora_matmul(x, w, a, b, alpha=2.0), ops.flash_attention(q, k, v, causal=True))  # noqa: E731
    want = run()
    got, errors, context = [], [], ctypes.c_void_p(1)

    def worker():
        try:
            ctypes.CDLL("libcuda.so.1").cuCtxGetCurrent(ctypes.byref(context))
            got.extend(run())
            torch.cuda.synchronize()
        except Exception as err:  # raised in the thread, reported by the test
            errors.append(err)

    thread = threading.Thread(target=worker)
    thread.start()
    thread.join(timeout=120)
    assert not thread.is_alive()
    assert context.value is None  # the thread started without a current context
    assert not errors, errors
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


@pytest.mark.cuda
def test_cuda_lora_matmul_takes_no_gradient_for_w(cuda):
    x, w, a, b, _ = _lora(np.random.default_rng(15), 8, 32, 16, 4, "float32", cuda)
    with pytest.raises(ValueError, match="frozen"):
        ops.lora_matmul(x, w.requires_grad_(True), a, b)


LORA_FAULT_OFFSET = 1100  # Philox offset of the card's generator seeded 0 at the failing draw (chip_smoke.py)


def _lora_fixed_draw(device, m=8192, k=2560, n=8960, r=8):
    """The draw on which the first bf16 design failed its check, at the
    rwkv6-3b channel-mix ``up`` shape: the card's generator seeded 0 at
    Philox offset 1100, drawn as ``chip_smoke.lora_case`` draws."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    gen.set_offset(LORA_FAULT_OFFSET)
    rn = lambda shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    x = rn((m, k)).to(torch.bfloat16)
    w = (rn((k, n)) * k**-0.5).to(torch.bfloat16)
    a = (rn((k, r)) * k**-0.5).to(torch.bfloat16)
    b = (rn((r, n)) * r**-0.5).to(torch.bfloat16)
    return x, w, a, b, rn((m, n)).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("draw", ["fixed", 1, 2, 3, 4, 5])
def test_cuda_lora_matmul_rwkv_up_shape(cuda, draw):
    """The rwkv6-3b channel-mix ``up`` shape (M 8192, K 2560, N 8960, r 8,
    alpha 2): the fixed draw that failed the first design, and 5 numpy
    draws; forward within 3e-2 + 1e-2 |ref|, dX, dA, dB within 2% of the
    largest element, both products on the wgmma route."""
    m, k, n, r = 8192, 2560, 8960, 8
    if draw == "fixed":
        x, w, a, b, g = _lora_fixed_draw(cuda)
    else:
        x, w, a, b, g = _lora(np.random.default_rng(100 + draw), m, k, n, r, "bfloat16", cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, b)]
    twins = [t.clone().requires_grad_(True) for t in (x, a, b)]
    ops.reset_launch_counts()
    got = ops.lora_matmul(leaves[0], w, leaves[1], leaves[2], alpha=2.0)
    got_grads = torch.autograd.grad(got, leaves, g)
    assert ops.lora_matmul_routes["wgmma"] == 2
    want = ref.lora_matmul_plain(twins[0], w, twins[1], twins[2], alpha=2.0)
    want_grads = torch.autograd.grad(want, twins, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1e-2)
    for gg, wg in zip(got_grads, want_grads):
        _grad_close(gg, wg, "bfloat16")


def _bottleneck(x, a):
    """The kernel's rounded t = T(x @ A), read through the public call: with
    W = 0, B the identity and alpha 2, y = T(2 t) = 2 t exactly."""
    k, r = a.shape
    n = -(-r // 8) * 8
    eye = torch.zeros((r, n), dtype=x.dtype, device=x.device)
    eye[:, :r] = torch.eye(r, dtype=x.dtype, device=x.device)
    y = ops.lora_matmul(x, torch.zeros((k, n), dtype=x.dtype, device=x.device), a, eye, alpha=2.0)
    return y[:, :r].float() / 2


def _bf16_ulp(v):
    """The spacing of bf16 values at |v|, floored at 2^-19 (|v| below
    2^-12): there two float32 sums of ~2 000 products in other orders
    already differ by more than a bf16 ulp."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0**-12))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,r,draw", [(8192, 2560, 8, "fixed"), (8192, 2560, 8, 1), (300, 2048, 1, 2),
                                        (300, 2048, 16, 3), (257, 520, 64, 4)])
def test_cuda_lora_bottleneck_within_one_ulp(cuda, m, k, r, draw):
    """The wgmma route's bottleneck t (float32 FMAs, one rounding to bf16)
    lies within one bf16 ulp of the twin's T(x.float() @ a.float())
    everywhere; the tensor cores' truncated sums did not."""
    if draw == "fixed":
        x, _, a, _, _ = _lora_fixed_draw(cuda)
    else:
        x, _, a, _, _ = _lora(np.random.default_rng(200 + draw), m, k, 8, r, "bfloat16", cuda)
    ops.reset_launch_counts()
    got = _bottleneck(x, a)
    assert ops.lora_matmul_routes["wgmma"] == 1
    want = (x.float() @ a.float()).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= _bf16_ulp(want)).all())


@pytest.mark.cuda
def test_cuda_lora_matmul_wmma_route_bottleneck_at_large_k(cuda):
    """K off 8 takes the WMMA route; at K 8 190 its bottleneck t (from the
    float32-FMA kernel, one rounding to bf16) lies within one bf16 ulp of
    the twin's everywhere, and y within 3e-2 + 1e-2 |ref|."""
    x, w, a, b, _ = _lora(np.random.default_rng(300), 512, 8190, 1000, 8, "bfloat16", cuda)
    ops.reset_launch_counts()
    got = ops.lora_matmul(x, w, a, b, alpha=2.0)
    t = _bottleneck(x, a)
    assert ops.lora_matmul_routes["wmma"] == 2
    want = ref.lora_matmul_plain(x, w, a, b, alpha=2.0)
    t_ref = (x.float() @ a.float()).to(torch.bfloat16).float()
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=1e-2)
    assert bool(((t - t_ref).abs() <= _bf16_ulp(t_ref)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,r", [(1000, 2560, 1024, 8), (50, 44, 24, 8)])
def test_cuda_lora_matmul_is_deterministic(cuda, m, k, n, r):
    """No split-K and no atomics: two forward passes and two dX passes give
    the same bits, on the wgmma and the WMMA route."""
    x, w, a, b, g = _lora(np.random.default_rng(16), m, k, n, r, "bfloat16", cuda)
    outs = []
    for _ in range(2):
        xl = x.clone().requires_grad_(True)
        y = ops.lora_matmul(xl, w, a, b, alpha=2.0)
        outs.append((y, torch.autograd.grad(y, xl, g)[0]))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def _grouped_lora(rng, g, rows, k, n, r, dtype, device):
    x, w, _, _, dy = _lora(rng, g * rows, k, n, r, dtype, device)
    a = rng.standard_normal((g, k, r), dtype=np.float32) * k**-0.5
    b = rng.standard_normal((g, r, n), dtype=np.float32) * r**-0.5
    return x, w, *(torch.from_numpy(t).to(device, getattr(torch, dtype)) for t in (a, b)), dy


GROUPED_CASES = [  # (G, rows a group, K, N, r, the bf16 route)
    (3, 256, 256, 264, 8, "wgmma"),  # rows on the 128-row tile
    (4, 100, 136, 520, 8, "wgmma"),  # off it: a tile stages the B_g of up to 3 groups
    (5, 33, 64, 72, 8, "wgmma"),  # 5 groups a tile
    (3, 100, 64, 40, 64, "wmma"),  # 3 groups of rank 64 would not fit: the wgmma route refuses
    (2, 50, 44, 24, 8, "wmma"),  # K off 8
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,rows,k,n,r,route", GROUPED_CASES)
def test_cuda_grouped_lora_matmul_matches_twin(cuda, dtype, g, rows, k, n, r, route):
    """A (G, K, r) and B (G, r, N): one launch forward and one for dX, on
    the route ``lora_matmul_route`` names, against the grouped twin; dA
    and dB against autograd through it.  dA and dB are batched products
    over the groups, whose float32 sums run in another order than the
    twin's per-group products: in float32 they are held within 1e-5 of the
    gradient's largest element."""
    x, w, a, b, dy = _grouped_lora(np.random.default_rng(17), g, rows, k, n, r, dtype, cuda)
    leaves = [t.clone().requires_grad_(True) for t in (x, a, b)]
    twins = [t.clone().requires_grad_(True) for t in (x, a, b)]
    ops.reset_launch_counts()
    got = ops.lora_matmul(leaves[0], w, leaves[1], leaves[2], alpha=2.0)
    got_grads = torch.autograd.grad(got, leaves, dy)
    assert ops.launch_counts["lora_matmul"] == 2
    assert ops.lora_matmul_routes["fma" if dtype == "float32" else route] == 2
    want = ref.lora_matmul_plain(twins[0], w, twins[1], twins[2], alpha=2.0)
    want_grads = torch.autograd.grad(want, twins, dy)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    for i, (gg, wg) in enumerate(zip(got_grads, want_grads)):
        assert gg.dtype == wg.dtype and gg.shape == wg.shape
        if i == 0 or dtype == "bfloat16":
            _grad_close(gg, wg, dtype)
        else:
            torch.testing.assert_close(gg, wg, atol=1e-5 * wg.abs().max().item(), rtol=0)


def _forward_and_dx(x, w, a, b, dy):
    xl = x.clone().requires_grad_(True)
    y = ops.lora_matmul(xl, w, a, b, alpha=2.0)
    return y, torch.autograd.grad(y, xl, dy)[0]


def _launches(x, w, a, b, dy, route, dx_route):
    """Forward and dX as two launches on the routes given."""
    return (ops._lora_matmul_launch(x, w, a, b, 2.0, route),
            ops._lora_matmul_launch(dy, w.t(), b.transpose(-1, -2), a.transpose(-1, -2), 2.0, dx_route))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k,n", [("float32", 64, 72), ("bfloat16", 256, 264), ("bfloat16", 44, 24)])
def test_cuda_grouped_lora_matmul_of_one_group_is_the_ungrouped_kernel(cuda, dtype, k, n):
    """G = 1 gives the ungrouped call's bits, forward and dX, on each route."""
    x, w, a, b, dy = _grouped_lora(np.random.default_rng(18), 1, 300, k, n, 8, dtype, cuda)
    grouped = _forward_and_dx(x, w, a, b, dy)
    plain = _forward_and_dx(x, w, a[0], b[0], dy)
    assert all(torch.equal(p, q) for p, q in zip(grouped, plain))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g,rows,k,n,r,route", GROUPED_CASES)
def test_cuda_grouped_lora_matmul_rows_equal_ungrouped_launches(cuda, dtype, g, rows, k, n, r, route):
    """Every sum keeps its order whatever M and G: the rows of group g,
    forward and dX, equal bit for bit the ungrouped launch on those rows
    with A_g and B_g on the same route (on the wgmma route also where a
    tile spans groups)."""
    x, w, a, b, dy = _grouped_lora(np.random.default_rng(19), g, rows, k, n, r, dtype, cuda)
    y, dx = _forward_and_dx(x, w, a, b, dy)
    routes = ops.lora_matmul_route(x, w, a), ops.lora_matmul_route(dy, w.t(), b.transpose(-1, -2))
    assert routes[0] == ("fma" if dtype == "float32" else route)
    for i in range(g):
        part = slice(i * rows, (i + 1) * rows)
        y_i, dx_i = _launches(x[part], w, a[i], b[i], dy[part], *routes)
        assert torch.equal(y[part], y_i) and torch.equal(dx[part], dx_i), i


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
    (2, 65, 3, 64, False),  # S off the chunk by one token
    (2, 65, 3, 64, True),
    (1, 200, 2, 32, False),  # S off the chunk and off a 64-token spacing
    (1, 200, 2, 64, True),
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
@pytest.mark.parametrize("state", [False, True])
def test_cuda_wkv6_backward_bits_repeat_off_the_chunk(cuda, state):
    """Two backward passes at S 200 (off the chunk), with and without a
    state in and a cotangent on the final state, give the same bits."""
    inputs, dout, dstate = _wkv(np.random.default_rng(25), 2, 200, 3, 64, "bfloat16", cuda, state)
    r, kk, v, logw, u, s0 = inputs
    first = ops._wkv6_bwd(r, kk, v, logw, u, s0, dout, dstate)
    second = ops._wkv6_bwd(r, kk, v, logw, u, s0, dout, dstate)
    for a, b in zip(first, second):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wkv6_bwd_scratch_is_one_state_per_chunk(cuda):
    """The backward asks for no more memory than its outputs, one float32
    state per 16-token chunk of every (batch, head) and the per-block du
    partials (each allocation rounded up to 512 bytes)."""
    b, s, h, k = 2, 200, 4, 64
    inputs, dout, dstate = _wkv(np.random.default_rng(26), b, s, h, k, "bfloat16", cuda, True)
    r, kk, v, logw, u, s0 = inputs
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = ops._wkv6_bwd(r, kk, v, logw, u, s0, dout, dstate)
    torch.cuda.synchronize()
    asked = torch.cuda.max_memory_allocated() - before
    outputs = sum(g.numel() * g.element_size() for g in grads)
    scratch = b * h * -(-s // 16) * k * k * 4 + b * h * k * 4
    assert asked <= outputs + scratch + 512 * 10


@pytest.mark.cuda
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("k", [16, 32, 64])
def test_cuda_wkv6_forward_bits_repeat_off_the_chunk(cuda, k, state):
    """The forward's register tiles at each head dim, S off the 16-token
    chunk: out and the final state match ``wkv6_plain`` (1e-4 + 1e-3 |ref|)
    and two runs give the same bits (the row groups' shares of out are
    summed in one order)."""
    inputs, _, _ = _wkv(np.random.default_rng(29), 2, 37, 3, k, "bfloat16", cuda, state)
    with torch.no_grad():
        first = ops.wkv6(*inputs)
        second = ops.wkv6(*inputs)
    want = ref.wkv6_plain(*inputs)
    for got, again, w in zip(first, second, want):
        assert torch.equal(got, again)
        torch.testing.assert_close(got, w, atol=1e-4, rtol=1e-3)


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
    (2, 45, 129, 16),  # odd D: no pair of channels at the row's end, rows staged element by element
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("d", [129, 200, 8192])
@pytest.mark.parametrize("s", [1, 7, 33, 70, 512])
def test_cuda_mamba_scan_fwd_matches_twin(cuda, s, d, n, dtype):
    """The forward alone (``ops._mamba_fwd``) against ``mamba_scan_plain``
    at S within one 8-token chunk, off it and whole, D odd (129: the last
    thread holds one live channel, and no row is a whole 16-byte copy),
    off the block of 256 channels (200) and at jamba's 8 192, N 8 and 16:
    y within 1e-4 + 1e-3 |ref| in float32 and 3e-2 + 1e-2 |ref| in bf16
    (one bf16 rounding), the final state within 1e-4 + 1e-3 |ref|."""
    b = 1 if d == 8192 else 2
    inputs, _ = _mamba(np.random.default_rng(29), b, s, d, n, dtype, cuda)
    y, st = ops._mamba_fwd(*inputs)
    want_y, want_st = ref.mamba_scan_plain(*inputs)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-3)
    assert y.dtype == want_y.dtype and y.shape == want_y.shape
    assert st.dtype == torch.float32 and st.shape == (b, d, n)
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b3_row", [0, 2])
@pytest.mark.parametrize("s,d,n,dtype", [(70, 200, 8, "bfloat16"), (33, 129, 16, "float32"),
                                         (70, 8192, 16, "bfloat16")])
def test_cuda_mamba_scan_fwd_row_is_batch_invariant(cuda, s, d, n, dtype, b3_row):
    """A row's y and final state are the same bits alone (B 1) as in a
    batch of 3 (at row 0 and at row 2), and two forwards of the same inputs
    give the same bits: the forward splits channels, never rows or time,
    and sums y over n in one order."""
    inputs, _ = _mamba(np.random.default_rng(30), 3, s, d, n, dtype, cuda)
    y, st = ops._mamba_fwd(*inputs)
    y2, st2 = ops._mamba_fwd(*inputs)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    pick = lambda t: t[b3_row:b3_row + 1].contiguous()  # noqa: E731
    y1, st1 = ops._mamba_fwd(*(pick(t) for t in inputs[:4]), *inputs[4:])
    assert torch.equal(y1, y[b3_row:b3_row + 1]) and torch.equal(st1, st[b3_row:b3_row + 1])


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("d", [100, 200, 8192])
@pytest.mark.parametrize("s", [1, 33, 70, 512])
def test_cuda_mamba_scan_bwd_splits_match_twin(cuda, s, d, n, dtype):
    """The backward alone (``ops._mamba_bwd``) against
    ``mamba_scan_bwd_plain`` at S off the 8-token chunk and whole, D off
    the block of 256 * 8 / N channels (100, 200; 100 bf16 channels are no
    whole 16-byte row, so they stage element by element) and at jamba's
    8 192, N 8 (two lanes a channel) and 16 (four): d_dt, dx within
    1e-4 + 1e-3 |ref| in float32 and 3e-2 + 1e-2 |ref| in bf16, dB, dC, dA,
    dD by ``_sum_close``.  The backward asks for no more bytes than its
    outputs, one float32 state per 8-token chunk of every channel, the
    per-block dB, dC partials and the per-row dA, dD partials (the
    allocator's requested bytes, before it rounds them up)."""
    b = 1 if d == 8192 else 2
    inputs, dy = _mamba(np.random.default_rng(27), b, s, d, n, dtype, cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    got = ops._mamba_bwd(*inputs, dy)
    torch.cuda.synchronize()
    asked = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before
    outputs = sum(g.numel() * g.element_size() for g in got)
    scratch = 4 * (b * -(-s // 8) * d * n + b * -(-d // (2048 // n)) * s * 2 * n + b * d * n + b * d)
    assert asked <= outputs + scratch
    want = ref.mamba_scan_bwd_plain(*inputs, dy)
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-3)
    for name, g, w in zip(("d_dt", "dx", "dB", "dC", "dA", "dD"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in ("d_dt", "dx"):
            torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol, msg=name)
        else:
            _sum_close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b3_row", [0, 2])
@pytest.mark.parametrize("s,d,n", [(70, 200, 8), (70, 200, 16), (33, 8192, 16)])
def test_cuda_mamba_scan_bwd_row_is_batch_invariant(cuda, s, d, n, b3_row):
    """A row's d_dt, dx, dB, dC are the same bits alone (B 1) as in a batch
    of 3 (at row 0 and at row 2): the backward splits channels and time,
    never rows."""
    inputs, dy = _mamba(np.random.default_rng(28), 3, s, d, n, "bfloat16", cuda)
    batched = ops._mamba_bwd(*inputs, dy)
    pick = lambda t: t[b3_row:b3_row + 1].contiguous()  # noqa: E731
    alone = ops._mamba_bwd(*(pick(t) for t in inputs[:4]), *inputs[4:], pick(dy))
    for name, g, w in zip(("d_dt", "dx", "dB", "dC"), alone, batched):
        assert torch.equal(g, w[b3_row:b3_row + 1]), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,d,n", [(8, 1, 8192, 16), (2, 9, 200, 16), (3, 9, 129, 8), (2, 70, 256, 8)])
def test_cuda_mamba_scan_from_h0_matches_twin(cuda, dtype, b, s, d, n):
    """The forward from an entering state h0 (the serving path: one token,
    S 9 across the 8-token chunk's edge, D odd and off the block) against
    ``mamba_scan_plain`` from the same h0, the limits of
    ``test_cuda_mamba_scan_fwd_matches_twin``; one launch, and with h0
    zero the bits of the forward from no state.  A backward raises."""
    inputs, _ = _mamba(np.random.default_rng(31), b, s, d, n, dtype, cuda)
    h0 = torch.from_numpy(np.random.default_rng(32).standard_normal((b, d, n), dtype=np.float32)).to(cuda)
    ops.reset_launch_counts()
    with torch.no_grad():
        y, st = ops.mamba_scan(*inputs, h0)
    assert ops.launch_counts["mamba_scan"] == 1
    want_y, want_st = ref.mamba_scan_plain(*inputs, h0)
    torch.cuda.synchronize()
    atol, rtol = (3e-2, 1e-2) if dtype == "bfloat16" else (1e-4, 1e-3)
    torch.testing.assert_close(y.float(), want_y.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-3)
    y0, st0 = ops._mamba_fwd(*inputs, torch.zeros_like(h0))
    y1, st1 = ops._mamba_fwd(*inputs)
    assert torch.equal(y0, y1) and torch.equal(st0, st1)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    y2, _ = ops.mamba_scan(*leaves, h0)
    with pytest.raises(NotImplementedError):
        y2.float().sum().backward()
    with pytest.raises(ValueError, match="h0"):
        ops.mamba_scan(*inputs, h0[:, :, :4].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,k", [(8, 40, 64), (3, 4, 32)])
def test_cuda_wkv6_one_token_from_s0_matches_twin(cuda, dtype, b, h, k):
    """The decode step's WKV: S = 1 from a state s0 (rwkv6-3b's 40 heads of
    64 at batch 8), out and the final state against ``wkv6_plain``
    within 1e-4 + 1e-3 |ref|, one launch and no backward kernel."""
    inputs, _, _ = _wkv(np.random.default_rng(18), b, 1, h, k, dtype, cuda, True)
    ops.reset_launch_counts()
    with torch.no_grad():
        out, st = ops.wkv6(*inputs)
    assert ops.launch_counts["wkv6"] == 1 and ops.launch_counts["wkv6_bwd"] == 0
    want_out, want_st = ref.wkv6_plain(*inputs)
    torch.cuda.synchronize()
    assert out.dtype == st.dtype == torch.float32 and out.shape == (b, 1, h, k)
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(st, want_st, atol=1e-4, rtol=1e-3)


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


@pytest.mark.cuda
def test_cuda_federated_smoke_run_matches_the_cpu(cuda):
    """Two rounds of ``api.experiment``'s droppeft at the qwen3-1.7b smoke
    size in float32, on the card (the kernels) and on the CPU (the twins),
    from the same base weights (drawn on the CPU), seed and gates: cohorts,
    rates and PTLS masks equal; the global LoRA within the limits of
    ``test_cuda_rwkv_smoke_round_matches_the_cpu``, the step sizes summed
    over every local step of both rounds."""
    from repro_torch import api
    from repro_torch.configs import FederatedConfig, TrainConfig, get_config
    from repro_torch.models.registry import init_params
    from repro_torch.models.stacking import tree_leaves
    from repro_torch.optim import make_lr_schedule

    cfg, train_cfg = get_config("qwen3-1.7b", smoke=True).replace(dtype="float32"), TrainConfig()
    fed = FederatedConfig(num_devices=6, devices_per_round=4, local_steps=2, batch_size=8)
    params = init_params(cfg, torch.Generator().manual_seed(29))
    runs = {}
    for device in ("cuda", "cpu"):
        runner = api.build("droppeft", cfg=cfg, fed_cfg=fed, train_cfg=train_cfg, seed=29, params=params,
                           device=device)
        plans, report = [], runner.algorithm.report

        def recorded(state, results, plans=plans, report=report):
            plans.append((results.plan.cohort, results.plan.rates, results.masks.tolist()))
            return report(state, results)

        runner.algorithm.report = recorded
        ops.reset_launch_counts()
        result = runner.run(rounds=2)
        if device == "cuda":
            for name in ("flash_attention", "flash_attention_bwd", "lora_matmul"):
                assert ops.launch_counts[name] > 0, name
        runs[device] = plans, [t.cpu() for t in tree_leaves(runner.state.global_peft)], result
    (plans_c, peft_c, res_c), (plans_p, peft_p, res_p) = runs["cuda"], runs["cpu"]
    assert plans_c == plans_p and len(plans_c) == 2
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(peft_c, peft_p)])
    sched = make_lr_schedule(train_cfg.schedule, train_cfg.learning_rate, train_cfg.warmup_steps, train_cfg.total_steps)
    lr_sum = sum(sched(step) for step in range(2 * fed.devices_per_round * fed.local_steps))
    assert float(diffs.max()) <= 2 * lr_sum + 1e-6
    assert float((diffs <= 1e-6).float().mean()) >= 0.99
    np.testing.assert_array_equal(res_c.rates, res_p.rates)
    np.testing.assert_array_equal(res_c.active_fraction, res_p.active_fraction)
