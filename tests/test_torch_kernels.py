"""The plain twins of the port's kernels against the JAX package's Pallas
kernels, on the CPU (Pallas in interpret mode), and the twins' autograd
gradients against ``jax.grad`` of the JAX oracles.  The CUDA kernels are held
against the twins on the card by ``tests/test_torch_cuda.py``.

Inputs come from ``np.random.default_rng`` and go to both frameworks as the
same numbers.  Tolerances are those of ``tests/test_kernels.py``: 2e-5 in
float32 and 3e-2 in bfloat16 (one bf16 rounding of an O(1) output).
Gradients (float32) within 1e-4 abs + 1e-4 rel: sums of S or K float32
products taken in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.flash_decode import flash_decode_pallas
from repro.kernels.lora_matmul import lora_matmul_pallas
from repro.kernels.ops import flash_attention as jax_flash_attention
from repro.kernels.ops import segmented_lora as jax_segmented_lora
from repro.kernels.ref import segmented_lora_ref
from repro.nn.attention import multi_head_attention as jax_multi_head_attention
from repro_torch.kernels import ops, ref
from repro_torch.nn.attention import INT32_MAX, ring_positions

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _pool(rng, *, m=6, k=32, n=192, ranks=(2, 4, 8), stale=False):
    """Mixed-rank pool (numpy float32); rows cycle through the slots.  With
    ``stale`` the tails beyond each rank hold garbage, as a recycled slot
    may; otherwise they are zero, as the pool cache writes them."""
    r_max = 8
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) * 0.1
    a = rng.standard_normal((len(ranks), k, r_max), dtype=np.float32) * 0.1
    b = rng.standard_normal((len(ranks), r_max, n), dtype=np.float32) * 0.1
    if not stale:
        for s, r in enumerate(ranks):
            a[s, :, r:] = 0.0
            b[s, r:, :] = 0.0
    idx = (np.arange(m) % len(ranks)).astype(np.int32)
    return x, w, a, b, idx, np.asarray(ranks, np.int32)


def _to_torch(arrays, dtype):
    out = []
    for arr in arrays:
        t = torch.from_numpy(arr)
        out.append(t.to(getattr(torch, dtype)) if t.is_floating_point() else t)
    return out


def _to_jax(arrays, dtype):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "n,ranks,stale",
    [
        (192, (2, 4, 8), False),  # N not a multiple of the TPU block: the padding case
        (128, (2, 4, 8), False),
        (192, (4, 8, 8), True),  # slot 0 serves rank 4 over a stale rank-8 tail
    ],
)
def test_segmented_plain_matches_pallas(dtype, n, ranks, stale):
    arrays = _pool(np.random.default_rng(0), n=n, ranks=ranks, stale=stale)
    got = ref.segmented_lora_plain(*_to_torch(arrays, dtype)).float().numpy()
    jx = _to_jax(arrays, dtype)
    pallas = np.asarray(jax_segmented_lora(*jx, block_n=64), np.float32)
    oracle = np.asarray(segmented_lora_ref(*jx), np.float32)
    np.testing.assert_allclose(got, pallas, atol=ATOL[dtype], rtol=0)
    np.testing.assert_allclose(got, oracle, atol=ATOL[dtype], rtol=0)


def test_segmented_plain_stale_tail_inert():
    x, w, a, b, idx, ranks = _pool(np.random.default_rng(1), ranks=(4, 8, 8), stale=True)
    dirty = ref.segmented_lora_plain(*_to_torch((x, w, a, b, idx, ranks), "float32"))
    a[0, :, 4:] = 0.0
    b[0, 4:, :] = 0.0
    clean = ref.segmented_lora_plain(*_to_torch((x, w, a, b, idx, ranks), "float32"))
    assert torch.equal(dirty, clean)


def _decode_inputs(rng, b, h, kv, d, s):
    q = rng.standard_normal((b, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "b,h,kv,d,s,qpos,window,bk,kpos",
    [
        (2, 4, 2, 32, 100, 80, None, 32, None),
        (1, 8, 8, 64, 64, 63, None, 64, None),
        (1, 4, 4, 32, 96, 90, 24, 32, None),  # sliding window
        (1, 2, 2, 16, 32, 71, None, 16, "ring"),  # wrapped ring: positions 40..71
    ],
)
def test_decode_plain_matches_flash_decode_pallas(b, h, kv, d, s, qpos, window, bk, kpos):
    q, k, v = _decode_inputs(np.random.default_rng(2), b, h, kv, d, s)
    kpos = 40 + np.mod(np.arange(s) - 40, s) if kpos == "ring" else np.arange(s)
    kpos = kpos.astype(np.int32)
    want = flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kpos), qpos, window=window, block_k=bk
    )
    got = ref.decode_attention_plain(
        *_to_torch((q, k, v), "float32"),
        torch.full((b,), qpos, dtype=torch.int32),
        torch.from_numpy(np.broadcast_to(kpos, (b, s)).copy()),
        window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL["float32"], rtol=0)


def test_decode_plain_bf16_cache_matches_flash_decode_pallas():
    b, h, kv, d, s, qpos = 2, 4, 2, 32, 100, 80
    q, k, v = _decode_inputs(np.random.default_rng(3), b, h, kv, d, s)
    kpos = np.arange(s, dtype=np.int32)
    want = flash_decode_pallas(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), jnp.asarray(kpos), qpos, block_k=32
    )
    got = ref.decode_attention_plain(
        *_to_torch((q, k, v), "bfloat16"),
        torch.full((b,), qpos, dtype=torch.int32),
        torch.from_numpy(np.broadcast_to(kpos, (b, s)).copy()),
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=ATOL["bfloat16"], rtol=0
    )


def _jax_ring_positions(pos, cache_len):
    """``attention_apply``'s slot positions (``repro/nn/attention.py:176-186``)."""
    last = jnp.asarray(pos)[:, None]
    kp = last - jnp.mod(last - jnp.arange(cache_len)[None, :], cache_len)
    return jnp.where(kp < 0, jnp.iinfo(jnp.int32).max, kp)


def test_ring_positions_match_attention_apply():
    pos = np.asarray([0, 3, 15, 16, 37, 100], np.int32)
    got = ring_positions(torch.from_numpy(pos), 16)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(_jax_ring_positions(pos, 16)))
    assert int(got[0, 1]) == INT32_MAX  # never written by the row's request


@pytest.mark.parametrize("window", [None, 6])
def test_decode_plain_per_row_positions_match_batched_attention(window):
    """Every row at its own depth: a fresh row, a mid-ring row, a full ring,
    a wrapped ring and a recycled row over stale K/V, against the batched
    branch of JAX ``attention_apply`` (``multi_head_attention`` with
    (B, 1) query and (B, S) slot positions)."""
    b, h, kv, d, s = 5, 4, 2, 32, 16
    q, k, v = _decode_inputs(np.random.default_rng(4), b, h, kv, d, s)
    pos = np.asarray([0, 5, 15, 37, 2], np.int32)
    kpos = _jax_ring_positions(pos, s)
    want = jax_multi_head_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos)[:, None], k_positions=kpos, causal=True, window=window,
    )[:, 0]
    got = ref.decode_attention_plain(
        *_to_torch((q, k, v), "float32"), torch.from_numpy(pos),
        torch.from_numpy(np.array(kpos, np.int32)), window=window,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL["float32"], rtol=0)


def test_cpu_tensors_run_the_twins_and_launch_nothing():
    x, w, a, b, idx, ranks = _to_torch(_pool(np.random.default_rng(5)), "float32")
    ops.reset_launch_counts()
    y = ops.segmented_lora(x, w, a, b, idx, ranks)
    assert torch.equal(y, ref.segmented_lora_plain(x, w, a, b, idx, ranks))
    q, kc, vc = _to_torch(_decode_inputs(np.random.default_rng(6), 2, 4, 2, 32, 8), "float32")
    pos = torch.tensor([3, 9], dtype=torch.int32)
    out = ops.flash_decode(q, kc, vc, pos, ring_positions(pos, 8))
    assert torch.equal(out, ref.decode_attention_plain(q, kc, vc, pos, ring_positions(pos, 8)))
    assert set(ops.launch_counts) >= {"segmented_lora", "flash_decode"}
    assert not any(ops.launch_counts.values())


def test_mixed_devices_raise():
    x, w, a, b, idx, ranks = _to_torch(_pool(np.random.default_rng(7)), "float32")
    with pytest.raises(ValueError, match="one device"):
        ops.segmented_lora(x, w, a, b, idx, ranks.to("meta"))


# ------------------------------------------------------------- training kernels
ATTN_SWEEP = [  # tests/test_kernels.py:19-28
    (2, 4, 4, 64, 32, True, None, 32, 32),
    (1, 4, 2, 100, 64, True, None, 32, 32),  # GQA + padding
    (2, 2, 2, 128, 32, True, 48, 32, 32),  # sliding window
    (1, 2, 2, 96, 64, False, None, 64, 32),  # bidirectional
    (1, 1, 1, 17, 128, True, None, 128, 128),  # single block, pad
]


def _attn_inputs(rng, b, h, kv, s, d):
    """q (B, S, H, D), k and v (B, S, KV, D): the model's layout."""
    return tuple(rng.standard_normal(shape, dtype=np.float32) for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))


def _heads_first(arr, dtype):
    return jnp.asarray(np.swapaxes(arr, 1, 2), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window,bq,bk", ATTN_SWEEP)
def test_attention_plain_matches_flash_attention_pallas(dtype, b, h, kv, s, d, causal, window, bq, bk):
    q, k, v = _attn_inputs(np.random.default_rng(20), b, h, kv, s, d)
    want = jax_flash_attention(
        *(_heads_first(t, dtype) for t in (q, k, v)), causal=causal, window=window, block_q=bq, block_k=bk
    )
    got = ops.flash_attention(*_to_torch((q, k, v), dtype), causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(
        got.float().numpy(), np.swapaxes(np.asarray(want, np.float32), 1, 2), atol=ATOL[dtype], rtol=0
    )


@pytest.mark.parametrize("b,h,kv,s,d,causal,window,bq,bk", ATTN_SWEEP[1:4])
def test_attention_plain_grads_match_jax_grad(b, h, kv, s, d, causal, window, bq, bk):
    rng = np.random.default_rng(21)
    q, k, v = _attn_inputs(rng, b, h, kv, s, d)
    g = rng.standard_normal((b, s, h, d), dtype=np.float32)

    def jax_loss(q, k, v):
        rep = h // kv
        out = jax_ref.attention_ref(
            q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1), causal=causal, window=window
        )
        return jnp.sum(out * jnp.swapaxes(jnp.asarray(g), 1, 2))

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(*(_heads_first(t, "float32") for t in (q, k, v)))
    tq, tk, tv = (t.requires_grad_(True) for t in _to_torch((q, k, v), "float32"))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(g)), (tq, tk, tv))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.swapaxes(np.asarray(wt), 1, 2), atol=1e-4, rtol=1e-4)


def _lora_inputs(rng, m, k, n, r):
    """Scaled so that every output is O(1), like a projection's."""
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32) * k**-0.5
    a = rng.standard_normal((k, r), dtype=np.float32) * k**-0.5
    b = rng.standard_normal((r, n), dtype=np.float32) * r**-0.5
    return x, w, a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,r", [(100, 64, 72, 8), (32, 128, 128, 4), (128, 32, 40, 16)])  # tests/test_kernels.py:107
def test_lora_matmul_plain_matches_pallas(dtype, m, k, n, r):
    arrays = _lora_inputs(np.random.default_rng(22), m, k, n, r)
    want = lora_matmul_pallas(*_to_jax(arrays, dtype), alpha=0.5, block_m=32, block_n=32, interpret=True)
    got = ops.lora_matmul(*_to_torch(arrays, dtype), alpha=0.5)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=ATOL[dtype], rtol=0)


def test_lora_matmul_plain_rounds_the_bottleneck_like_pallas():
    """In bf16 the rank-r bottleneck is rounded before its second dot, as
    in the TPU kernel (``ref.lora_matmul_ref`` does not round it)."""
    x, w, a, b = _lora_inputs(np.random.default_rng(23), 16, 64, 32, 8)
    tx, tw, ta, tb = _to_torch((x, w, a, b), "bfloat16")
    t = (tx.float() @ ta.float()).to(torch.bfloat16).float()
    want = (tx.float() @ tw.float() + 2.0 * (t @ tb.float())).to(torch.bfloat16)
    assert torch.equal(ops.lora_matmul(tx, tw, ta, tb, alpha=2.0), want)


def test_lora_matmul_plain_grads_match_jax_grad():
    rng = np.random.default_rng(24)
    x, w, a, b = _lora_inputs(rng, 48, 64, 40, 8)
    g = rng.standard_normal((48, 40), dtype=np.float32)
    want = jax.grad(
        lambda x, a, b: jnp.sum(jax_ref.lora_matmul_ref(x, jnp.asarray(w), a, b, alpha=2.0) * g), argnums=(0, 1, 2)
    )(jnp.asarray(x), jnp.asarray(a), jnp.asarray(b))
    tx, tw, ta, tb = _to_torch((x, w, a, b), "float32")
    for t in (tx, ta, tb):
        t.requires_grad_(True)
    got = torch.autograd.grad(torch.sum(ops.lora_matmul(tx, tw, ta, tb, alpha=2.0) * torch.from_numpy(g)), (tx, ta, tb))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype,k,n,view,route", [
    ("float32", 64, 72, "rows", "fma"),
    ("bfloat16", 2048, 1024, "rows", "wgmma"),  # a forward of the training path
    ("bfloat16", 2048, 1024, "transposed", "wgmma"),  # its dX: W^T as a view
    ("bfloat16", 33, 40, "rows", "wmma"),  # K off TMA's 16-byte rows
    ("bfloat16", 40, 5, "transposed", "wmma"),  # N off them
    ("bfloat16", 64, 64, "strided", "wmma"),  # neither stride 1
])
def test_lora_matmul_route_follows_dtype_and_shape(dtype, k, n, view, route):
    """``lora_matmul_route`` picks the route by dtype and shape alone: the
    Hopper route for bf16 with K and N multiples of 8 and W row-major or a
    transposed view, the WMMA route for the other bf16 shapes."""
    dt = getattr(torch, dtype)
    x = torch.zeros((16, k), dtype=dt)
    if view == "rows":
        w = torch.zeros((k, n), dtype=dt)
    elif view == "transposed":
        w = torch.zeros((n, k), dtype=dt).t()
    else:
        w = torch.zeros((k, 2 * n), dtype=dt)[:, ::2]
    assert tuple(w.shape) == (k, n)
    assert ops.lora_matmul_route(x, w) == route
