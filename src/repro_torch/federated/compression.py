"""Compression of the device→server uplink, as
``repro.federated.compression``: int8 quantization, top-k sparsification
and error feedback, with the reference's wire-format byte accounting.

The algorithm's ``compress_uplink`` hook compresses each device's PEFT
*delta*; :class:`ErrorFeedback` residuals ride
:class:`~repro_torch.federated.state.RoundState`; ``SystemModel`` bills the
compressed wire sizes.  Every function runs on the tree's device, in
float32, and gives the reference's bits:

* ``quantize_int8`` / ``dequantize_int8`` — per-leaf symmetric int8:
  ``scale = max(max|x|, 1e-12) / 127``, then ``round(x / scale)`` (half
  to even) clipped to ±127, in that order.
* ``topk_sparsify`` — exactly ``topk_k(n, fraction)`` entries a leaf, by
  magnitude; equal magnitudes keep the lowest flat index, as
  ``jax.lax.top_k`` does.  The selection is a stable sort of ``-|x|``
  (``torch.topk`` promises no order among ties on CUDA).
* ``ef_step`` — one error-feedback round: compress ``update + decay ·
  residual`` and carry the compression error.

A "leaf" is a leaf of the reference's layout: in the stacked layout one
``(L, ...)`` tensor per kind, so k and the byte count are per stacked leaf.
Wire format, per leaf of n entries (k kept; indices int32, scales fp32)::

    none       4n
    int8       n + 4
    topk       8k            (4k indices + 4k fp32 values)
    int8+topk  5k + 4        (4k indices + k int8 values + 1 scale)

``serialize_compressed`` builds those buffers on the host (numpy) in the
reference's leaf order (dict keys sorted), so that a test can hold the
accounting to real serialized sizes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace as dc_replace
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.models.stacking import tree_map

# Compression levels, in increasing-aggressiveness order (the joint
# bandit's arm axis in the reference).
LEVELS = ("none", "int8", "topk", "int8+topk")


@dataclass(frozen=True)
class CompressionConfig:
    """How a client compresses its PEFT delta on the uplink.

    ``kind`` is one of :data:`LEVELS`; ``tune=True`` hands the level to the
    joint (dropout rate × compression level) bandit.  ``ef_decay`` scales
    the carried residual each round (1.0 = classic EF-SGD)."""

    kind: str = "int8+topk"
    topk_fraction: float = 0.1
    error_feedback: bool = True
    ef_decay: float = 1.0
    tune: bool = False

    def __post_init__(self):
        if self.kind not in LEVELS:
            raise ValueError(f"unknown compression kind {self.kind!r}; one of {LEVELS}")
        if not 0.0 < self.topk_fraction <= 1.0:
            raise ValueError(f"topk_fraction must be in (0, 1], got {self.topk_fraction}")
        if not 0.0 <= self.ef_decay <= 1.0:
            raise ValueError(f"ef_decay must be in [0, 1], got {self.ef_decay}")


def resolve_compression(spec, **overrides) -> Optional[CompressionConfig]:
    """Normalize a level name / ``"auto"`` / dict / config / None, applying
    any non-None keyword overrides.  ``None`` means no compression at all
    (the bit-exact uncompressed path); overrides without a spec raise.
    ``"auto"`` asks for the joint bandit (``tune=True``)."""
    kw = {k: v for k, v in overrides.items() if v is not None}
    if spec is None:
        if kw:
            raise ValueError(f"compression options {sorted(kw)} have no effect without compression=; pass a level "
                             "name, 'auto', or a CompressionConfig")
        return None
    if isinstance(spec, CompressionConfig):
        cfg = spec
    elif isinstance(spec, str):
        cfg = CompressionConfig(tune=True) if spec == "auto" else CompressionConfig(kind=spec)
    elif isinstance(spec, dict):
        cfg = CompressionConfig(**spec)
    else:
        raise TypeError(f"compression must be a level name, 'auto', a dict, or a CompressionConfig, got {spec!r}")
    return dc_replace(cfg, **kw) if kw else cfg


def sorted_leaves(tree) -> list:
    """The leaves in the reference's flatten order: dict keys sorted,
    lists in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in sorted_leaves(t)]
    return [tree]


# ------------------------------------------------------------------ kernels
def topk_k(n: int, fraction: float) -> int:
    """Entries kept per leaf of ``n``: round half-up, floor at 1."""
    return max(1, int(math.floor(fraction * n + 0.5)))


def _quantize_leaf(x):
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def quantize_int8(tree) -> Tuple[object, object]:
    """tree -> (int8 tree, float32 scale tree): symmetric, per leaf."""
    return _split_pairs(tree_map(_quantize_leaf, tree))


def _split_pairs(pairs):
    """Two trees out of a tree whose leaves are (values, scale) tuples."""
    if isinstance(pairs, dict):
        parts = {k: _split_pairs(v) for k, v in pairs.items()}
        return {k: p[0] for k, p in parts.items()}, {k: p[1] for k, p in parts.items()}
    if isinstance(pairs, list):
        parts = [_split_pairs(v) for v in pairs]
        return [p[0] for p in parts], [p[1] for p in parts]
    return pairs


def dequantize_int8(vals, scales, dtype=torch.float32):
    return tree_map(lambda v, s: (v.float() * s).to(dtype), vals, scales)


def _topk_leaf(x, fraction: float):
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    k = topk_k(n, fraction)
    if k >= n:
        return x
    order = torch.argsort(-torch.abs(flat), stable=True)[:k]
    mask = torch.zeros((n,), dtype=torch.bool, device=flat.device)
    mask[order] = True
    return torch.where(mask, flat, torch.zeros_like(flat)).reshape(x.shape).to(x.dtype)


def topk_sparsify(tree, fraction: float):
    """Keep exactly ``topk_k(n, fraction)`` entries by magnitude per leaf
    (ties: the lowest flat index first)."""
    return tree_map(lambda x: _topk_leaf(x, fraction), tree)


def compress_decompress(tree, *, kind: str, fraction: float = 0.1):
    """The lossy uplink round trip as the server reconstructs it: top-k,
    then int8 quantize-dequantize; ``kind="none"`` is the identity."""
    if "topk" in kind:
        tree = topk_sparsify(tree, fraction)
    if "int8" in kind:
        vals, scales = quantize_int8(tree)
        tree = dequantize_int8(vals, scales)
    return tree


def ef_step(update, residual, *, kind: str, fraction: float = 0.1, decay: float = 1.0):
    """One error-feedback round: compress ``update + decay · residual``,
    carry the compression error.  Returns ``(sent, new_residual)``, ``sent``
    the dense server-side reconstruction."""
    corrected = tree_map(lambda x, r: x.float() + decay * r, update, residual)
    sent = compress_decompress(corrected, kind=kind, fraction=fraction)
    return sent, tree_map(lambda c, s: c - s.float(), corrected, sent)


# ------------------------------------------------------------- wire format
def _numel(x) -> int:
    shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
    return int(np.prod(shape)) if shape else 1


def compressed_bytes(tree, config="int8+topk") -> int:
    """Uplink bytes after compression, per the wire format above."""
    cfg = resolve_compression(config) or CompressionConfig(kind="none")
    total = 0
    for x in sorted_leaves(tree):
        n = _numel(x)
        if cfg.kind == "none":
            total += 4 * n
        elif cfg.kind == "int8":
            total += n + 4
        else:
            k = min(topk_k(n, cfg.topk_fraction), n)
            total += 8 * k if cfg.kind == "topk" else 5 * k + 4
    return total


def serialize_compressed(tree, config="int8+topk") -> list:
    """Host-side wire buffers (numpy) for every leaf, in the format
    :func:`compressed_bytes` accounts for: ``sum(b.nbytes)`` equals it."""
    cfg = resolve_compression(config) or CompressionConfig(kind="none")
    buffers = []
    for x in sorted_leaves(tree):
        # repro-lint: disable=TXH002 — the host's wire buffers are what this builds: one read a leaf
        arr = x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        flat = np.asarray(arr, dtype=np.float32).reshape(-1)
        n = flat.size
        if cfg.kind == "none":
            buffers.append(flat)
            continue
        if "topk" in cfg.kind:
            k = min(topk_k(n, cfg.topk_fraction), n)
            order = np.lexsort((np.arange(n), -np.abs(flat)))[:k]  # ties: lowest index first
            idx = np.sort(order).astype(np.int32)
            vals = flat[idx]
            buffers.append(idx)
        else:
            vals = flat
        if "int8" in cfg.kind:
            scale = max(float(np.max(np.abs(vals))) if vals.size else 0.0, 1e-12) / 127.0
            buffers.append(np.clip(np.round(vals / scale), -127, 127).astype(np.int8))
            buffers.append(np.float32(scale).reshape(1))
        else:
            buffers.append(vals.astype(np.float32))
    return buffers


def uplink_ratio(tree, config) -> float:
    """Compressed / fp32 uplink size of ``tree``: the per-device factor the
    ``SystemModel`` multiplies into its uplink traffic (1.0 uncompressed)."""
    n = sum(_numel(x) for x in sorted_leaves(tree))
    if n == 0:
        return 1.0
    return compressed_bytes(tree, config) / (4.0 * n)


# ---------------------------------------------------------- error feedback
class ErrorFeedback:
    """EF residual state: ``compress(update + residual)``, carry the error."""

    @staticmethod
    def init(tree):
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), tree)

    @staticmethod
    def compress(tree, residual, compressor) -> Tuple[object, object]:
        """(compressed-then-decompressed update, new residual)."""
        corrected = tree_map(lambda x, r: x.float() + r, tree, residual)
        sent = compressor(corrected)
        return sent, tree_map(lambda c, s: c - s.float(), corrected, sent)


def int8_roundtrip(tree):
    """Compressor for :class:`ErrorFeedback`: int8 quantize-dequantize."""
    vals, scales = quantize_int8(tree)
    return dequantize_int8(vals, scales)
