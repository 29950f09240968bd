"""The plain twins of the port's kernels against the JAX package's Pallas
kernels, on the CPU (Pallas in interpret mode).  The CUDA kernels are held
against the twins on the card by ``tests/test_torch_cuda.py``.

Inputs come from ``np.random.default_rng`` and go to both frameworks as the
same numbers.  Tolerances are those of ``tests/test_kernels.py``: 2e-5 in
float32 and 3e-2 in bfloat16 (one bf16 rounding of an O(1) output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode import flash_decode_pallas
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
    assert ops.launch_counts == {"segmented_lora": 0, "flash_decode": 0}


def test_mixed_devices_raise():
    x, w, a, b, idx, ranks = _to_torch(_pool(np.random.default_rng(7)), "float32")
    with pytest.raises(ValueError, match="one device"):
        ops.segmented_lora(x, w, a, b, idx, ranks.to("meta"))
