"""Dispatch to the port's CUDA kernels, or to their plain twins on the CPU.

Each wrapper chooses by the device of the tensors it is given (``_on_cpu``):
a CPU tensor runs the plain twin in ``ref``; a CUDA tensor launches the
hand-written kernel, or raises; a ``meta`` tensor (the dry run,
``repro_torch.launch.dryrun``) runs the CUDA path's argument checks and
allocations (outputs and scratch, shapes and dtypes only) and counts the
launch without one; any other device raises ``no kernel for device``.  A
kernel that fails to build or launch is an error, never a silent fall back
to the twin.  ``wkv6`` and ``mamba_scan`` run their CPU path inside their
``autograd.Function``: forward ``wkv6_plain`` and ``mamba_scan_plain``,
backward ``wkv6_bwd_plain`` and ``mamba_scan_bwd_plain``, so the CPU tests
hold the backward twins too.

``launch_counts`` counts the kernel launches of each wrapper on the card
(``ENTRIES``: one a kernel library, and one each for the head-dim split's
two entries of ``csrc/flash_decode.cu``) and nothing else (neither the CPU
twin nor a ``meta`` call), so a run can show that its main path went
through the kernels: ``reset_launch_counts()`` before it, read the counts
after.  ``lora_matmul_routes`` counts
``lora_matmul``'s launches on the card by route; a grouped ``lora_matmul``
(one adapter per group of rows) is one launch.  ``meta_calls`` counts the
``meta`` calls that stand for a launch, and ``kernel_work`` sums, per
kernel, their FLOPs and bytes: each call's products in full (masked
products included, as XLA's ``cost_analysis`` counts the reference's
attention) and its inputs read once and outputs written once; each
launcher's docstring says what its count includes.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # csrc/common.cuh DTypeCode
MAX_LORA_RANK = 64  # csrc/segmented_lora.cu and csrc/lora_matmul.cu MAX_R
LORA_TILE_ROWS = 128  # csrc/lora_matmul.cu GM: the rows of a wgmma-route tile
MAX_GQA_REP = 16  # csrc/flash_decode.cu MAX_REP
MAX_HEAD_DIM = 256  # csrc/flash_decode.cu MAX_D
MAX_ATTN_HEAD_DIM = 128  # csrc/tiles.cuh MAX_D, flash_attention forward and backward
WKV_HEAD_DIMS = (16, 32, 64)  # csrc/wkv6_common.cuh wkv_supported_head_dim
WKV_CHUNK = 16  # csrc/wkv6_common.cuh WKV_CHUNK: the backward saves one state per chunk
MAMBA_STATE_DIMS = (8, 16)  # csrc/mamba_common.cuh mamba_supported_state_dim
# csrc/mamba_common.cuh, the backward: threads a block, tokens a chunk, and
# the states of how many channels a thread holds in its walk
MAMBA_BWD_THREADS = 256
MAMBA_BWD_CHUNK = 8
MAMBA_LANE_STATES = 4
MAMBA_LANE_CHANNELS = 2

# csrc/segmented_lora.cu make_plan: threads a block, 16-byte units of a
# block's slice of a row of W, cp.async stages, the largest K-slab, blocks
# an SM; csrc/flash_decode.cu SLAB: the cache slots a block aims for.  The
# launch plans below are made from these on every device; each kernel
# recomputes its plan and refuses a launch whose splits differ.
SEGMENTED_THREADS, SEGMENTED_UNITS, SEGMENTED_STAGES, SEGMENTED_MAX_SLAB, SEGMENTED_BLOCKS_PER_SM = 256, 8, 4, 512, 2
DECODE_SLAB = 64
META_SM_COUNT = 132  # an H100 SXM's SMs: the launch plans of a meta call

# the wrappers' names: a kernel library's, and the head-dim split's two
# entries, which live in the flash_decode library (``_LIBRARY``)
_LIBRARY = {"flash_decode_scores": "flash_decode", "flash_decode_combine": "flash_decode"}
ENTRIES = _build.KERNELS + tuple(_LIBRARY)
launch_counts: Dict[str, int] = {name: 0 for name in ENTRIES}
LORA_ROUTES = ("fma", "wmma", "wgmma")  # csrc/lora_matmul.cu LoraRoute
lora_matmul_routes: Dict[str, int] = {route: 0 for route in LORA_ROUTES}
meta_calls: Dict[str, int] = {name: 0 for name in ENTRIES}
kernel_work: Dict[str, Dict[str, float]] = {name: {"flops": 0.0, "bytes": 0.0} for name in ENTRIES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "segmented_lora": (
        "segmented_lora_launch",
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "flash_decode": (
        "flash_decode_launch",
        [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "flash_decode_scores": ("flash_decode_scores_launch", [_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "flash_decode_combine": (
        "flash_decode_combine_launch",
        [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "flash_attention": (
        "flash_attention_fwd_launch",
        [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    ),
    "flash_attention_bwd": (
        "flash_attention_bwd_launch",
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    ),
    "lora_matmul": (
        "lora_matmul_launch",
        [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _F, _P],
    ),
    "wkv6": ("wkv6_fwd_launch", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "wkv6_bwd": (
        "wkv6_bwd_launch",
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "mamba_scan": ("mamba_scan_fwd_launch", [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "mamba_scan_bwd": (
        "mamba_scan_bwd_launch",
        [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
}
_entry_points: Dict[str, ctypes._CFuncPtr] = {}


def reset_launch_counts():
    """Zero ``launch_counts``, ``lora_matmul_routes``, ``meta_calls`` and
    ``kernel_work``."""
    for counts in (launch_counts, lora_matmul_routes, meta_calls):
        for name in counts:
            counts[name] = 0
    for work in kernel_work.values():
        work["flops"] = work["bytes"] = 0.0


def _entry(name: str):
    fn = _entry_points.get(name)
    if fn is None:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(_build.load(_LIBRARY.get(name, name)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entry_points[name] = fn
        _build.fire_setup("entry", name)
    return fn


def _plan(cache: dict, key, make, what: str):
    """``cache[key]``, made by ``make()`` on a miss, which is reported to
    the set-up listeners as a ``"plan"`` (``_build.fire_setup``)."""
    if key not in cache:
        cache[key] = make()
        _build.fire_setup("plan", f"{what} {key}")
    return cache[key]


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors (the plain twin), False for CUDA or ``meta``
    tensors (the kernel's path); raises for tensors on several devices or
    on any other device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all tensors must lie on one device, got {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"no kernel for device {device}")
    return False


_libcuda = None  # opened at the first launch
_thread = threading.local()


def _bind_context(device):
    """Make the card's primary context current on the calling thread when
    none is.  The launchers encode their TMA maps through libcuda, which
    needs a current context; PyTorch's autograd thread sets its
    device without binding one until its first runtime call, so a backward
    whose first work is one of these kernels would find none."""
    if getattr(_thread, "bound", False):
        return
    global _libcuda
    if _libcuda is None:
        _libcuda = ctypes.CDLL("libcuda.so.1")
        for name, argtypes in (("cuCtxGetCurrent", [ctypes.POINTER(_P)]), ("cuDeviceGet", [ctypes.POINTER(_I), _I]),
                               ("cuDevicePrimaryCtxRetain", [ctypes.POINTER(_P), _I]), ("cuCtxSetCurrent", [_P])):
            fn = getattr(_libcuda, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    ctx = ctypes.c_void_p()
    err = _libcuda.cuCtxGetCurrent(ctypes.byref(ctx))
    if err == 0 and not ctx.value:
        dev = ctypes.c_int()
        err = _libcuda.cuDeviceGet(ctypes.byref(dev), device.index if device.index is not None
                                   else torch.cuda.current_device())
        err = err or _libcuda.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev)
        err = err or _libcuda.cuCtxSetCurrent(ctx)
    if err != 0:
        raise RuntimeError(f"no CUDA context for {device} on this thread (libcuda error {err})")
    _thread.bound = True


def _launch(name: str, device, launch, flops: float, *tensors):
    """Launch kernel ``name``: ``launch()`` calls its entry point and returns
    the error code, on a thread whose context ``_bind_context`` made
    current.  On the ``meta`` device nothing is called: the call is
    counted in ``meta_calls``, with ``flops`` and the bytes of ``tensors``
    (its inputs and outputs; None skipped) added to ``kernel_work``."""
    if device.type == "meta":
        work = kernel_work[name]
        work["flops"] += flops
        work["bytes"] += sum(t.numel() * t.element_size() for t in tensors if t is not None)
        meta_calls[name] += 1
        return
    _bind_context(device)
    _check_launch(name, launch())


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_launch(name: str, err: int):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (code {err})")
    launch_counts[name] += 1


def segmented_lora(x, w, a, b, idx, ranks):
    """Multi-tenant LoRA matmul: row i uses adapter ``idx[i]`` of the pool.

    x: (M, K); w: (K, N); a: (NA, K, r_max); b: (NA, r_max, N) with the
    alpha/rank scale folded in; idx: (M,) int32 slots in ``[0, NA)`` (the
    adapter pool hands out only such slots); ranks: (NA,) int32.
    Returns (M, N) in ``x.dtype``.  Work: 2·M·(K·N + K·r_max + r_max·N)
    FLOPs (every row at the pool's rank).
    """
    if _on_cpu(x, w, a, b, idx, ranks):
        return ref.segmented_lora_plain(x, w, a, b, idx, ranks)
    m, k = x.shape
    n = w.shape[1]
    na, _, r = a.shape
    _require(x.dtype in _DTYPE_CODE, f"segmented_lora takes float32 or bfloat16, got {x.dtype}")
    _require(
        w.dtype == a.dtype == b.dtype == x.dtype,
        f"x, w, a, b must share one dtype, got {x.dtype}, {w.dtype}, {a.dtype}, {b.dtype}",
    )
    _require(
        tuple(w.shape) == (k, n) and tuple(a.shape) == (na, k, r) and tuple(b.shape) == (na, r, n),
        f"shapes do not agree: x {tuple(x.shape)}, w {tuple(w.shape)}, "
        f"a {tuple(a.shape)}, b {tuple(b.shape)}",
    )
    _require(
        tuple(idx.shape) == (m,) and tuple(ranks.shape) == (na,),
        f"idx must be ({m},) and ranks ({na},), got {tuple(idx.shape)}, {tuple(ranks.shape)}",
    )
    _require(idx.dtype == ranks.dtype == torch.int32, "idx and ranks must be int32")
    _require(0 < r <= MAX_LORA_RANK, f"pooled rank {r} outside 1..{MAX_LORA_RANK}")
    for t in (x, w, a, b, idx, ranks):
        _require(t.is_contiguous(), "segmented_lora takes contiguous tensors")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    code = _DTYPE_CODE[x.dtype]
    splits, tiles = _segmented_plan(code, k, n, x.device)
    # scratch, freed on return: the K-slabs' partial sums (splits, M, N), then
    # the rounded bottleneck t (M, r), float32
    scratch = torch.empty(splits * m * n + m * r, dtype=torch.float32, device=x.device)

    def launch():
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return _entry("segmented_lora")(
            code, x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), idx.data_ptr(), ranks.data_ptr(),
            scratch.data_ptr() + 4 * splits * m * n, scratch.data_ptr(), _tickets(x.device, stream, tiles).data_ptr(),
            y.data_ptr(), m, k, n, r, splits, stream,
        )

    _launch("segmented_lora", x.device, launch, 2 * m * (k * n + k * r + r * n), x, w, a, b, idx, ranks, y)
    return y


_segmented_plans: Dict[tuple, tuple] = {}
_segmented_tickets: Dict[tuple, torch.Tensor] = {}


def segmented_lora_plan(elt: int, k: int, n: int, sms: int) -> tuple:
    """(K-splits, column tiles) of a ``segmented_lora`` call at element size
    ``elt``, K, N on a card of ``sms`` SMs: ``csrc/segmented_lora.cu``'s
    ``make_plan``."""
    tn = SEGMENTED_UNITS * 16 // elt
    tiles = -(-n // tn)
    want = max(1, -(-SEGMENTED_BLOCKS_PER_SM * sms // tiles))
    step = SEGMENTED_THREADS // SEGMENTED_UNITS * SEGMENTED_STAGES
    slab = min(SEGMENTED_MAX_SLAB, -(-(-(-k // want)) // step) * step)
    return -(-k // slab), tiles


def _sm_count(device) -> int:
    """The SMs of ``device``'s card; ``META_SM_COUNT`` on the ``meta`` device."""
    return META_SM_COUNT if device.type == "meta" else torch.cuda.get_device_properties(device).multi_processor_count


def _segmented_plan(code: int, k: int, n: int, device):
    """(K-splits, column tiles) of a ``segmented_lora`` call on ``device``:
    ``segmented_lora_plan`` from the dtype, K, N and the card's SM count."""
    _require(k > 0 and n > 0, f"segmented_lora takes no K={k}, N={n}")
    elt = 4 if code == _DTYPE_CODE[torch.float32] else 2
    return _plan(_segmented_plans, (str(device), code, k, n),
                 lambda: segmented_lora_plan(elt, k, n, _sm_count(device)), "segmented_lora")


def _tickets(device, stream: int, tiles: int) -> torch.Tensor:
    """The column tiles' tickets of ``segmented_lora`` calls on one stream:
    zero between calls (each call's merging blocks reset theirs)."""
    key = (device.index, stream)
    t = _segmented_tickets.get(key)
    if t is None or t.numel() < tiles:
        t = _segmented_tickets[key] = torch.zeros(max(tiles, 256), dtype=torch.int32, device=device)
        _build.fire_setup("plan", f"segmented_lora tickets {key}")
    return t


_splits: Dict[tuple, int] = {}


def flash_decode_splits_for(s: int, sms: int) -> int:
    """How many blocks share a row's cache of ``s`` slots on a card of
    ``sms`` SMs: ``csrc/flash_decode.cu``'s ``splits_for``."""
    return max(1, min(-(-s // DECODE_SLAB), sms))


def _decode_splits(s: int, device) -> int:
    """How many blocks share a row's cache of ``s`` slots on ``device``:
    ``flash_decode_splits_for`` from ``s`` and the card's SM count."""
    _require(s > 0, f"flash_decode takes no cache of {s} slots")
    return _plan(_splits, (str(device), s), lambda: flash_decode_splits_for(s, _sm_count(device)), "flash_decode")


def flash_decode(q, k_cache, v_cache, q_positions, k_positions, *, window: Optional[int] = None,
                 return_lse: bool = False):
    """Single-query GQA attention over a batched ring cache.

    q: (B, H, D); k_cache, v_cache: (B, S, KV, D); q_positions: (B,) int32;
    k_positions: (B, S) int32 absolute slot positions (INT32_MAX = never
    written).  Slot j of row b is live iff ``kpos <= qpos`` (and
    ``kpos > qpos - window``).  Returns (B, H, D) in ``q.dtype``, and with
    ``return_lse`` also each query's log-sum-exp of its scaled scores over
    the live slots, (B, H) float32 (-1e30 where none is live): the weight
    of the output against a decode over other slots of the sequence.
    Work: 4·B·H·S·D FLOPs (every slot, dead ones included).
    """
    if _on_cpu(q, k_cache, v_cache, q_positions, k_positions):
        return ref.decode_attention_plain(q, k_cache, v_cache, q_positions, k_positions, window=window,
                                          return_lse=return_lse)
    bsz, h, d = q.shape
    _, s, kv, _ = k_cache.shape
    _require(
        (q.dtype, k_cache.dtype)
        in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16), (torch.float32, torch.float32)),
        f"flash_decode takes (q, cache) dtypes bf16/bf16, f32/bf16 or f32/f32, got {q.dtype}/{k_cache.dtype}",
    )
    _require(v_cache.dtype == k_cache.dtype, "k_cache and v_cache must share one dtype")
    _require(
        tuple(k_cache.shape) == (bsz, s, kv, d) and tuple(v_cache.shape) == (bsz, s, kv, d),
        f"caches must be ({bsz}, S, KV, {d}), got {tuple(k_cache.shape)}, {tuple(v_cache.shape)}",
    )
    _require(h % kv == 0 and h // kv <= MAX_GQA_REP, f"{h} heads over {kv} kv heads not supported")
    _require(d % 16 == 0 and 0 < d <= MAX_HEAD_DIM, f"head dim {d} must be a multiple of 16, <= {MAX_HEAD_DIM}")
    _require(
        tuple(q_positions.shape) == (bsz,) and tuple(k_positions.shape) == (bsz, s),
        f"positions must be ({bsz},) and ({bsz}, {s}), got "
        f"{tuple(q_positions.shape)}, {tuple(k_positions.shape)}",
    )
    _require(q_positions.dtype == k_positions.dtype == torch.int32, "positions must be int32")
    _require(window is None or window > 0, f"window must be None or positive, got {window}")
    for t in (q, k_cache, v_cache, q_positions, k_positions):
        _require(t.is_contiguous(), "flash_decode takes contiguous tensors")
    out = torch.empty_like(q)
    splits = _decode_splits(s, q.device)
    # scratch, freed on return: each split's (m, l, acc[D]) per query
    part = torch.empty((bsz, h, splits, d + 2), dtype=torch.float32, device=q.device)
    lse = torch.empty((bsz, h), dtype=torch.float32, device=q.device) if return_lse else None
    _launch("flash_decode", q.device, lambda: _entry("flash_decode")(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype], q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), q_positions.data_ptr(), k_positions.data_ptr(), out.data_ptr(), part.data_ptr(),
        _ptr(lse), bsz, h, kv, d, s, window or 0, d**-0.5, splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    ), 4 * bsz * h * s * d, q, k_cache, v_cache, q_positions, k_positions, out, lse)
    return (out, lse) if return_lse else out


def _check_split(q_or_scores, cache, name: str, out_dtype):
    """The dtype pair and contiguity rules of the head-dim split's two
    kernels (``flash_decode``'s pairs)."""
    _require((out_dtype, cache.dtype)
             in ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16), (torch.float32, torch.float32)),
             f"{name} takes (q, cache) dtypes bf16/bf16, f32/bf16 or f32/f32, got {out_dtype}/{cache.dtype}")
    for t in (q_or_scores, cache):
        _require(t.is_contiguous(), f"{name} takes contiguous tensors")


def flash_decode_scores(q, k_cache, *, scale: float):
    """The head-dim split's first half: each query's partial scores over
    this rank's slice of the head dim, ``scale · q · k`` in float32.

    q: (B, H, Dr); k_cache: (B, S, KV, Dr), any Dr > 0 (the rank's dims of
    every KV head: a cache cut over ``model`` on its head dim); ``scale``
    the whole head's ``hd ** -0.5``; the KV head of query head h is ``h //
    (H // KV)``.  Returns (B, H, S) float32, which summed over the ranks
    gives the scores.  Work: 2·B·H·S·Dr FLOPs."""
    if _on_cpu(q, k_cache):
        return ref.decode_scores_plain(q, k_cache, scale=scale)
    bsz, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    _check_split(q, k_cache, "flash_decode_scores", q.dtype)
    _require(tuple(k_cache.shape) == (bsz, s, kv, d), f"k_cache must be ({bsz}, S, KV, {d}), got "
                                                      f"{tuple(k_cache.shape)}")
    _require(s > 0 and h % kv == 0 and h // kv <= MAX_GQA_REP, f"{h} heads over {kv} kv heads not supported")
    _require(0 < d <= MAX_HEAD_DIM and h * d * 4 <= 48 * 1024, f"head-dim slice {d} at {h} heads not supported")
    scores = torch.empty((bsz, h, s), dtype=torch.float32, device=q.device)
    _launch("flash_decode_scores", q.device, lambda: _entry("flash_decode_scores")(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype], q.data_ptr(), k_cache.data_ptr(), scores.data_ptr(),
        bsz, h, kv, d, s, scale, _stream(q),
    ), 2 * bsz * h * s * d, q, k_cache, scores)
    return scores


def flash_decode_combine(scores, v_cache, q_positions, k_positions, *, window: Optional[int] = None,
                         dtype=None):
    """The head-dim split's second half: from the scores summed over the
    ranks, the masked softmax of ``flash_decode`` and P V over this rank's
    slice of the head dim.

    scores: (B, H, S) float32 (``flash_decode_scores``' summed); v_cache:
    (B, S, KV, Dr); positions and ``window`` as ``flash_decode``'s; a row
    with no live slot weighs every slot alike, as there.  Returns (out (B,
    H, Dr) in ``dtype``, default ``v_cache``'s; lse (B, H) float32, as
    ``flash_decode``'s ``return_lse``).  Work: 2·B·H·S·Dr + 4·B·H·S FLOPs
    (P V; the max, the exponentials and the sum)."""
    dtype = v_cache.dtype if dtype is None else dtype
    if _on_cpu(scores, v_cache, q_positions, k_positions):
        return ref.decode_combine_plain(scores, v_cache, q_positions, k_positions, window=window, dtype=dtype)
    bsz, h, s = scores.shape
    kv, d = v_cache.shape[2], v_cache.shape[3]
    _check_split(scores, v_cache, "flash_decode_combine", dtype)
    _require(scores.dtype == torch.float32, f"flash_decode_combine takes float32 scores, got {scores.dtype}")
    _require(tuple(v_cache.shape) == (bsz, s, kv, d), f"v_cache must be ({bsz}, {s}, KV, Dr), got "
                                                      f"{tuple(v_cache.shape)}")
    _require(h % kv == 0 and 0 < d <= MAX_HEAD_DIM, f"{h} heads over {kv} kv heads at Dr {d} not supported")
    _require(tuple(q_positions.shape) == (bsz,) and tuple(k_positions.shape) == (bsz, s)
             and q_positions.dtype == k_positions.dtype == torch.int32,
             f"positions must be ({bsz},) and ({bsz}, {s}) int32")
    _require(window is None or window > 0, f"window must be None or positive, got {window}")
    for t in (q_positions, k_positions):
        _require(t.is_contiguous(), "flash_decode_combine takes contiguous tensors")
    out = torch.empty((bsz, h, d), dtype=dtype, device=scores.device)
    lse = torch.empty((bsz, h), dtype=torch.float32, device=scores.device)
    _launch("flash_decode_combine", scores.device, lambda: _entry("flash_decode_combine")(
        _DTYPE_CODE[dtype], _DTYPE_CODE[v_cache.dtype], scores.data_ptr(), v_cache.data_ptr(),
        q_positions.data_ptr(), k_positions.data_ptr(), out.data_ptr(), lse.data_ptr(), bsz, h, kv, d, s,
        window or 0, _stream(scores),
    ), 2 * bsz * h * s * d + 4 * bsz * h * s, scores, v_cache, q_positions, k_positions, out, lse)
    return out, lse


# ------------------------------------------------------------- training path
def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_key_length(q, k, causal: bool, window: Optional[int]):
    """K/V of a length of their own only without the causal mask and the
    window (cross-attention); raises ``ValueError`` otherwise."""
    _require(k.ndim == 4 and q.ndim == 4, f"q, k must be 4-d, got {tuple(q.shape)}, {tuple(k.shape)}")
    _require(k.shape[1] == q.shape[1] or not (causal or window),
             f"keys of length {k.shape[1]} for {q.shape[1]} queries: a key length of its own is bidirectional only "
             f"(causal={causal}, window={window})")


def _check_attention(q, k, v, window):
    bsz, s, h, d = q.shape
    skv, kv = k.shape[1], k.shape[2]
    _require(q.dtype in _DTYPE_CODE, f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    _require(k.dtype == v.dtype == q.dtype, f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    _require(
        k.ndim == 4 and skv > 0 and tuple(k.shape) == (bsz, skv, kv, d) and tuple(v.shape) == (bsz, skv, kv, d),
        f"k, v must be ({bsz}, S_kv, KV, {d}), got {tuple(k.shape)}, {tuple(v.shape)}",
    )
    _require(h % kv == 0, f"{h} heads over {kv} kv heads")
    _require(d % 16 == 0 and d <= MAX_ATTN_HEAD_DIM, f"head dim {d} must be a multiple of 16, <= {MAX_ATTN_HEAD_DIM}")
    _require(window is None or window > 0, f"window must be None or positive, got {window}")
    for t in (q, k, v):
        _require(t.is_contiguous(), "flash_attention takes contiguous (B, S, heads, D) tensors")


def _flash_attention_fwd(q, k, v, causal: bool, window: Optional[int]):
    """Work: 4·B·H·S·S_kv·D FLOPs (QKᵀ and PV in full, the masked products
    included)."""
    bsz, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bsz, h, s), dtype=torch.float32, device=q.device)
    _launch("flash_attention", q.device, lambda: _entry("flash_attention")(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        bsz, s, k.shape[1], h, k.shape[2], d, int(causal), window or 0, d**-0.5, _stream(q),
    ), 4 * bsz * h * s * k.shape[1] * d, q, k, v, out, lse)
    return out, lse


def _flash_attention_bwd(q, k, v, out, lse, dout, causal: bool, window: Optional[int], dkv: bool = True):
    """dQ, and with ``dkv`` dK and dV (else None, None: the dK/dV kernel is
    not launched).  Work: the gradient's products in full, dP = dO Vᵀ and
    dQ = dS K, with ``dkv`` also dV = Pᵀ dO and dK = dSᵀ Q: 4 or 8
    ·B·H·S·S_kv·D FLOPs (the kernel's recompute of QKᵀ not counted)."""
    bsz, s, h, d = q.shape
    dq = torch.empty_like(q)
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if dkv else (None, None)
    delta = torch.empty((bsz, h, s), dtype=torch.float32, device=q.device)  # rowsum(dO * O)
    _launch("flash_attention_bwd", q.device, lambda: _entry("flash_attention_bwd")(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(dk), _ptr(dv),
        bsz, s, k.shape[1], h, k.shape[2], d, int(causal), window or 0, d**-0.5, int(dkv), _stream(q),
    ), (8 if dkv else 4) * bsz * h * s * k.shape[1] * d, q, k, v, out, lse, dout, dq, dk, dv)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel saves the row log-sum-exp; the backward kernel
    recomputes the probabilities tile by tile from it.  Where K and V take
    no gradient (a frozen encoder's cross-attention K/V), the backward runs
    the dQ kernel alone."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dkv = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dq, dk, dv = _flash_attention_bwd(q, k, v, out, lse, dout.contiguous(), ctx.causal, ctx.window, dkv)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """Causal (or bidirectional), optionally windowed GQA attention over the
    positions ``0 .. S-1`` of each sequence, differentiable.

    q: (B, S, H, D); k, v: (B, S_kv, KV, D), the model's own layout; the KV
    head of query head h is ``h // (H // KV)``.  S_kv may differ from S
    (cross-attention: queries 0 .. S-1 over keys 0 .. S_kv-1) only with
    ``causal=False`` and no window, else ``ValueError``.  Returns (B, S, H,
    D) in ``q.dtype``.  On the card: the ``flash_attention`` kernel forward
    and the ``flash_attention_bwd`` kernel backward (its dQ kernel alone
    where K and V take no gradient).
    """
    _check_key_length(q, k, causal, window)
    if _on_cpu(q, k, v):
        return ref.attention_plain(q, k, v, causal=causal, window=window)
    _check_attention(q, k, v, window)
    return _FlashAttention.apply(q, k, v, causal, window)


def lora_group_span(groups: int, rows: int) -> int:
    """The most groups of ``rows`` rows that one 128-row tile of the wgmma
    route can touch: 1 when ``rows`` is a multiple of the tile
    (``csrc/lora_matmul.cu`` group_span)."""
    if rows % LORA_TILE_ROWS == 0:
        return 1
    return min(groups, (LORA_TILE_ROWS - 1 + rows - 1) // rows + 1)


def lora_matmul_route(x, w, a=None) -> str:
    """The ``lora_matmul`` route for these operands, by dtype and shape:
    ``fma`` for float32; for bf16 ``wgmma`` (TMA and the tensor cores) when
    K and N are multiples of 8 and W is row-major or a transposed view of a
    row-major matrix, 16-byte aligned (TMA's rule), and, for a grouped ``a``
    (G, K, r), the B_g of every group that a 128-row tile touches fit its
    staging (``lora_group_span`` times r rounded up to 8 at most
    ``MAX_LORA_RANK``), else ``wmma``.  Both bf16 routes take the
    bottleneck from one float32-FMA kernel."""
    if x.dtype == torch.float32:
        return "fma"
    k, n = w.shape
    if w.stride(1) == 1:
        ld = w.stride(0)
    elif w.stride(0) == 1:
        ld = w.stride(1)
    else:
        return "wmma"
    if a is not None and a.ndim == 3:
        groups, r = a.shape[0], a.shape[-1]
        if lora_group_span(groups, x.shape[0] // groups) * (-(-r // 8) * 8) > MAX_LORA_RANK:
            return "wmma"
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "wgmma" if k % 8 == 0 and n % 8 == 0 and ld % 8 == 0 and aligned else "wmma"


def _lora_matmul_launch(x, w, a, b, alpha: float, route: Optional[str] = None):
    """One ``lora_matmul`` launch.  x: (M, K) contiguous; w (K, N), a (K, r)
    or grouped (G, K, r), b (r, N) or (G, r, N) may be strided views (the
    backward passes transposes).  ``route`` None takes
    ``lora_matmul_route``'s; a route given by name (for measurements)
    raises if it cannot take the operands.  Returns (M, N) in ``x.dtype``.
    Work: 2·M·(K·N + K·r + r·N) FLOPs, grouped or not."""
    m, k = x.shape
    n, r = w.shape[1], a.shape[-1]
    groups, sag, sbg = (a.shape[0], a.stride(0), b.stride(0)) if a.ndim == 3 else (1, 0, 0)
    route = lora_matmul_route(x, w, a) if route is None else route
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    # the bf16 routes' scratch, freed on return: t = T(x @ A_g), (M, r rounded up to 8)
    t = torch.empty((m, -(-r // 8) * 8) if route != "fma" else (0,), dtype=x.dtype, device=x.device)
    _launch("lora_matmul", x.device, lambda: _entry("lora_matmul")(
        _DTYPE_CODE[x.dtype], LORA_ROUTES.index(route), x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
        y.data_ptr(), t.data_ptr(), m, k, n, r, groups, w.stride(0), w.stride(1), a.stride(-2), a.stride(-1), sag,
        b.stride(-2), b.stride(-1), sbg, alpha, _stream(x),
    ), 2 * m * (k * n + k * r + r * n), x, w, a, b, y)
    if x.device.type != "meta":
        lora_matmul_routes[route] += 1
    return y


def _by_group(t, a):
    """``t`` (M, ·) as (G, M / G, ·) views for a grouped ``a`` (G, K, r)."""
    return t if a.ndim == 2 else t.view(a.shape[0], -1, t.shape[-1])


class _LoraMatmul(torch.autograd.Function):
    """Forward and dX through the ``lora_matmul`` kernel; W is frozen.

    dX = dY @ W^T + alpha * (dY @ B_g^T) @ A_g^T is the forward kernel on
    transposed views (no copy of W; grouped, one launch for every group).
    dA = alpha * x^T (dY B^T) and dB = alpha * t^T dY are rank-r products,
    left to ``torch.matmul`` (batched over the groups) as the JAX package
    leaves them to XLA.
    """

    @staticmethod
    def forward(ctx, x, w, a, b, alpha):
        ctx.save_for_backward(x, w, a, b)
        ctx.alpha = alpha
        return _lora_matmul_launch(x, w, a, b, alpha)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        dy = dy.contiguous()
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            dx = _lora_matmul_launch(dy, w.t(), b.transpose(-1, -2), a.transpose(-1, -2), ctx.alpha)
        xg, dyg = _by_group(x, a), _by_group(dy, a)
        if ctx.needs_input_grad[2]:
            da = ctx.alpha * (xg.transpose(-1, -2) @ (dyg @ b.transpose(-1, -2)))
        if ctx.needs_input_grad[3]:
            db = ctx.alpha * ((xg @ a).transpose(-1, -2) @ dyg)
        return dx, None, da, db, None


def lora_matmul(x, w, a, b, *, alpha: float = 1.0):
    """``x @ W + alpha * (x @ A) @ B`` with a frozen W, differentiable in
    x, A and B.  x: (M, K); w: (K, N); a: (K, r); b: (r, N), all of one
    dtype.  Grouped: a (G, K, r) and b (G, r, N), and row i of group
    ``i // (M / G)`` takes A_g and B_g (G divides M), in one launch.
    Returns (M, N) in ``x.dtype``."""
    if _on_cpu(x, w, a, b):
        return ref.lora_matmul_plain(x, w, a, b, alpha=alpha)
    m, k = x.shape
    n, r = w.shape[1], a.shape[-1]
    lead = tuple(a.shape[:-2])
    _require(x.dtype in _DTYPE_CODE, f"lora_matmul takes float32 or bfloat16, got {x.dtype}")
    _require(w.dtype == a.dtype == b.dtype == x.dtype,
             f"x, w, a, b must share one dtype, got {x.dtype}, {w.dtype}, {a.dtype}, {b.dtype}")
    _require(a.ndim in (2, 3) and tuple(w.shape) == (k, n) and tuple(a.shape) == (*lead, k, r)
             and tuple(b.shape) == (*lead, r, n) and (not lead or (lead[0] > 0 and m % lead[0] == 0)),
             f"shapes do not agree: x {tuple(x.shape)}, w {tuple(w.shape)}, a {tuple(a.shape)}, b {tuple(b.shape)}")
    _require(0 < r <= MAX_LORA_RANK, f"rank {r} outside 1..{MAX_LORA_RANK}")
    for t in (x, w, a, b):
        _require(t.is_contiguous(), "lora_matmul takes contiguous tensors")
    _require(not w.requires_grad, "lora_matmul keeps W frozen: W must not require a gradient")
    return _LoraMatmul.apply(x, w, a, b, alpha)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _wkv6_fwd(r, k, v, logw, u, s0):
    """Work: 6·B·S·H·K² FLOPs, a token and head's rank-1 update k vᵀ, decay
    w ⊙ S and sum (3·K²) and readout rᵀ(S + u ⊙ k vᵀ) (3·K²)."""
    r, k, v, logw = (_aligned16(t) for t in (r, k, v, logw))
    s0 = None if s0 is None else _aligned16(s0)
    bsz, s, h, kd = r.shape
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    state = torch.empty((bsz, h, kd, kd), dtype=torch.float32, device=r.device)
    _launch("wkv6", r.device, lambda: _entry("wkv6")(
        _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), _ptr(s0),
        out.data_ptr(), state.data_ptr(), bsz, s, h, kd, _stream(r),
    ), 6 * bsz * s * h * kd * kd, r, k, v, logw, u, s0, out, state)
    return out, state


def _aligned16(t):
    """``t``, or a copy of it where its data is not 16-byte aligned (the WKV
    kernels stage their chunks by 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _wkv6_bwd(r, k, v, logw, u, s0, dout, dstate):
    """Work: 12·B·S·H·K² FLOPs, twice the forward's (each product's
    gradient is two products of its size; the states' recompute not
    counted)."""
    r, k, v, logw, dout = (_aligned16(t) for t in (r, k, v, logw, dout))
    bsz, s, h, kd = r.shape
    dr, dk, dv = (torch.empty_like(t) for t in (r, k, v))
    dlogw = torch.empty_like(logw)
    du = torch.empty_like(u)
    ds0 = None if s0 is None else torch.empty_like(s0)
    n_chunks = -(-s // WKV_CHUNK)
    # scratch, freed on return: the caching allocator hands it out again only
    # to work queued after these kernels on this stream
    states = torch.empty((bsz * h, n_chunks, kd, kd), dtype=torch.float32, device=r.device)
    du_part = torch.empty((bsz, h, kd), dtype=torch.float32, device=r.device)
    _launch("wkv6_bwd", r.device, lambda: _entry("wkv6_bwd")(
        _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), _ptr(s0),
        dout.data_ptr(), _ptr(dstate), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlogw.data_ptr(),
        du.data_ptr(), _ptr(ds0), states.data_ptr(), du_part.data_ptr(), bsz, s, h, kd, _stream(r),
    ), 12 * bsz * s * h * kd * kd, r, k, v, logw, u, s0, dout, dstate, dr, dk, dv, dlogw, du, ds0)
    return dr, dk, dv, dlogw, du, ds0


class _WKV6(torch.autograd.Function):
    """The forward saves its inputs only; the backward recomputes the
    states (the ``wkv6_bwd`` kernel on the card, ``ref.wkv6_bwd_plain`` on
    the CPU).  Gradients flow from both outputs, out and the final state."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        if _on_cpu(r, k, v, logw, u):
            return ref.wkv6_plain(r, k, v, logw, u, s0)
        return _wkv6_fwd(r, k, v, logw, u, s0)

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        dout = dout.float().contiguous()
        dstate = None if dstate is None else dstate.float().contiguous()
        if _on_cpu(r, k, v, logw, u, dout):
            grads = ref.wkv6_bwd_plain(r, k, v, logw, u, s0, dout, dstate)
        else:
            grads = _wkv6_bwd(r, k, v, logw, u, s0, dout, dstate)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def wkv6(r, k, v, logw, u, s0=None):
    """The RWKV6 WKV recurrence (``ref.wkv6_plain``), differentiable in
    every input.  r, k, v: (B, S, H, K) of one dtype (float32 or bfloat16);
    logw: (B, S, H, K) float32, the log decay (< 0); u: (H, K) float32;
    s0: (B, H, K, K) float32 or None (a zero state).  Returns (out
    (B, S, H, K) float32, final state (B, H, K, K) float32).  On the card:
    the ``wkv6`` kernel forward and the ``wkv6_bwd`` kernel backward; on
    the CPU: the plain twins, forward and backward.
    """
    tensors = (r, k, v, logw, u) + (() if s0 is None else (s0,))
    if not _on_cpu(*tensors):
        bsz, s, h, kd = r.shape
        _require(r.dtype in _DTYPE_CODE, f"wkv6 takes float32 or bfloat16 r, k, v, got {r.dtype}")
        _require(k.dtype == v.dtype == r.dtype, f"r, k, v must share one dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
        _require(logw.dtype == u.dtype == torch.float32, f"logw and u must be float32, got {logw.dtype}, {u.dtype}")
        _require(tuple(k.shape) == tuple(v.shape) == tuple(logw.shape) == (bsz, s, h, kd) and tuple(u.shape) == (h, kd),
                 f"shapes do not agree: r {tuple(r.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                 f"logw {tuple(logw.shape)}, u {tuple(u.shape)}")
        _require(kd in WKV_HEAD_DIMS, f"wkv6 head dim {kd} not in {WKV_HEAD_DIMS}")
        _require(s > 0, "wkv6 needs at least one token")
        if s0 is not None:
            _require(s0.dtype == torch.float32 and tuple(s0.shape) == (bsz, h, kd, kd),
                     f"s0 must be ({bsz}, {h}, {kd}, {kd}) float32, got {tuple(s0.shape)} {s0.dtype}")
        for t in tensors:
            _require(t.is_contiguous(), "wkv6 takes contiguous tensors")
    return _WKV6.apply(r, k, v, logw, u, s0)


def _mamba_fwd(dt, x, bmat, cmat, a, dvec, h0=None):
    """Work: 7·B·S·D·N + 3·B·S·D FLOPs: a state's decay exp(dt·A) (2),
    update a·h + (dt·x)·B (3) and readout C·h (2), a channel's dt·x and
    D·x skip (3)."""
    bsz, s, d = x.shape
    n = a.shape[1]
    y = torch.empty_like(x)
    state = torch.empty((bsz, d, n), dtype=torch.float32, device=x.device)
    _launch("mamba_scan", x.device, lambda: _entry("mamba_scan")(
        _DTYPE_CODE[x.dtype], dt.data_ptr(), x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
        dvec.data_ptr(), _ptr(h0), y.data_ptr(), state.data_ptr(), bsz, s, d, n, _stream(x),
    ), 7 * bsz * s * d * n + 3 * bsz * s * d, dt, x, bmat, cmat, a, dvec, h0, y, state)
    return y, state


def mamba_bwd_scratch_shapes(bsz, s, d, n):
    """The float32 scratch of the ``mamba_scan_bwd`` kernel at dt, x of
    shape (bsz, s, d) and state dim n, as csrc/mamba_scan_bwd.cu lays it
    out: the state entering each chunk of ``MAMBA_BWD_CHUNK`` tokens,
    per-block partial sums of dB and dC over a block's channels, per-row
    partial sums of dA and dD."""
    channels = MAMBA_BWD_THREADS * MAMBA_LANE_STATES * MAMBA_LANE_CHANNELS // n  # a block's, in the walk
    return {
        "states": (bsz, -(-s // MAMBA_BWD_CHUNK), d, n),
        "bc_part": (bsz, -(-d // channels), s, 2 * n),
        "da_part": (bsz, d, n),
        "dd_part": (bsz, d),
    }


def _mamba_bwd(dt, x, bmat, cmat, a, dvec, dy):
    """Work: twice the forward's FLOPs (the states' recompute not
    counted)."""
    bsz, s, d = x.shape
    n = a.shape[1]
    d_dt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(bmat), torch.empty_like(cmat)
    da, dd = torch.empty_like(a), torch.empty_like(dvec)
    # scratch, freed on return: the caching allocator hands it out again
    # only to work queued after these kernels on this stream
    scratch = {name: torch.empty(shape, dtype=torch.float32, device=x.device)
               for name, shape in mamba_bwd_scratch_shapes(bsz, s, d, n).items()}
    _launch("mamba_scan_bwd", x.device, lambda: _entry("mamba_scan_bwd")(
        _DTYPE_CODE[x.dtype], dt.data_ptr(), x.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(),
        dvec.data_ptr(), dy.data_ptr(), d_dt.data_ptr(), dx.data_ptr(), db.data_ptr(), dc.data_ptr(), da.data_ptr(),
        dd.data_ptr(), *(scratch[name].data_ptr() for name in ("states", "bc_part", "da_part", "dd_part")),
        bsz, s, d, n, _stream(x),
    ), 14 * bsz * s * d * n + 6 * bsz * s * d, dt, x, bmat, cmat, a, dvec, dy, d_dt, dx, db, dc, da, dd)
    return d_dt, dx, db, dc, da, dd


class _MambaScan(torch.autograd.Function):
    """The forward saves its inputs only; the backward recomputes the
    states (the ``mamba_scan_bwd`` kernel on the card,
    ``ref.mamba_scan_bwd_plain`` on the CPU).  The final state is returned
    but takes no gradient.  The backward runs from a zero state only: with
    an entering state ``h0`` (the serving path, which takes no gradient) it
    raises ``NotImplementedError``."""

    @staticmethod
    def forward(ctx, dt, x, bmat, cmat, a, dvec, h0):
        ctx.save_for_backward(dt, x, bmat, cmat, a, dvec)
        ctx.has_h0 = h0 is not None
        if _on_cpu(dt, x, bmat, cmat, a, dvec):
            y, state = ref.mamba_scan_plain(dt, x, bmat, cmat, a, dvec, h0)
        else:
            y, state = _mamba_fwd(dt, x, bmat, cmat, a, dvec, h0)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, dy, _dstate):
        if ctx.has_h0:
            raise NotImplementedError("mamba_scan takes no gradient through an entering state h0")
        dt, x, bmat, cmat, a, dvec = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        if _on_cpu(dt, x, bmat, cmat, a, dvec, dy):
            grads = ref.mamba_scan_bwd_plain(dt, x, bmat, cmat, a, dvec, dy)
        else:
            grads = _mamba_bwd(dt, x, bmat, cmat, a, dvec, dy)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad)) + (None,)


def mamba_scan(dt, x, bmat, cmat, a, dvec, h0=None):
    """The Mamba selective scan (``ref.mamba_scan_plain``) from the entering
    state ``h0`` (B, D, N) float32, or from zero when it is None.  dt, x:
    (B, S, D) of one dtype (float32 or bfloat16); bmat, cmat: (B, S, N)
    float32; a: (D, N) float32 (negative); dvec: (D,) float32; N in
    ``MAMBA_STATE_DIMS``.  Returns (y (B, S, D) in ``x.dtype``, final state
    (B, D, N) float32, which takes no gradient).  On the card: the
    ``mamba_scan`` kernel forward and the ``mamba_scan_bwd`` kernel
    backward; on the CPU: the plain twins, forward and backward.  From a
    zero state it is differentiable in every input; with an ``h0`` (the
    serving path) it takes no gradient, and a backward raises
    ``NotImplementedError``.
    """
    tensors = (dt, x, bmat, cmat, a, dvec) + (() if h0 is None else (h0,))
    if not _on_cpu(*tensors):
        bsz, s, d = x.shape
        _require(x.dtype in _DTYPE_CODE, f"mamba_scan takes float32 or bfloat16 dt and x, got {x.dtype}")
        _require(dt.dtype == x.dtype, f"dt and x must share one dtype, got {dt.dtype}, {x.dtype}")
        _require(bmat.dtype == cmat.dtype == a.dtype == dvec.dtype == torch.float32,
                 f"B, C, A and D must be float32, got {bmat.dtype}, {cmat.dtype}, {a.dtype}, {dvec.dtype}")
        _require(a.ndim == 2 and a.shape[0] == d, f"A must be ({d}, N), got {tuple(a.shape)}")
        n = a.shape[1]
        _require(tuple(dt.shape) == (bsz, s, d) and tuple(bmat.shape) == tuple(cmat.shape) == (bsz, s, n)
                 and tuple(dvec.shape) == (d,),
                 f"shapes do not agree: dt {tuple(dt.shape)}, x {tuple(x.shape)}, B {tuple(bmat.shape)}, "
                 f"C {tuple(cmat.shape)}, A {tuple(a.shape)}, D {tuple(dvec.shape)}")
        _require(n in MAMBA_STATE_DIMS, f"mamba_scan state dim {n} not in {MAMBA_STATE_DIMS}")
        _require(s > 0 and d > 0, "mamba_scan needs at least one token and one channel")
        if h0 is not None:
            _require(h0.dtype == torch.float32 and tuple(h0.shape) == (bsz, d, n),
                     f"h0 must be ({bsz}, {d}, {n}) float32, got {tuple(h0.shape)} {h0.dtype}")
            _require(h0.data_ptr() % 16 == 0, "h0 must start on a 16-byte boundary (the kernel reads float4s)")
        for t in tensors:
            _require(t.is_contiguous(), "mamba_scan takes contiguous tensors")
    return _MambaScan.apply(dt, x, bmat, cmat, a, dvec, h0)
