"""Continuous-batching request scheduler for multi-tenant LoRA decode.

Orca-style token-level scheduling over ONE fixed-shape ``(batch, 1)``
decode step: every step each live row consumes one token (prompt tokens
stream through the same step as generated ones), and finished rows are
recycled for queued requests between steps.  Admission, stop handling and
slot recycling are host-side bookkeeping.

Each row serves its own tenant: the row's adapter is resolved through
:class:`~repro_torch.serving.adapters.AdapterPoolCache` and applied by the
segmented kernel via per-row slot indices.  Per-row KV state lives in a
batched cache (``pos`` is ``(L, B)``): recycling a row resets its position
to zero, and the slot positions of ``attention_apply`` keep the previous
tenant's stale K/V inert without a cache clear.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.transformer import init_caches
from repro_torch.serving.adapters import AdapterPoolCache


@dataclass
class Request:
    """One generation request bound to a named adapter."""

    prompt: Sequence[int]
    adapter: str
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    uid: Any = None


@dataclass
class Completion:
    """Finished request: the tokens generated after the prompt."""

    uid: Any
    adapter: str
    tokens: List[int] = field(default_factory=list)
    finish_reason: str = "length"  # "length" | "eos"


@dataclass
class _Row:
    req: Request
    remaining_prompt: List[int]
    generated: List[int] = field(default_factory=list)
    slot: int = 0


def _reset_rows(caches, pos_mask):
    """Zero the cache positions of recycled rows (pos_mask: (B,) bool), in
    place.  Only positions reset; the stale K/V stays in the ring, masked."""
    caches["pos"].masked_fill_(pos_mask[None, :], 0)
    return caches


def batched_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """Stacked caches with per-row positions: ``pos`` is ``(L, B)``."""
    caches = init_caches(cfg, batch, max_len, dtype, device, layout="stacked")
    caches["pos"] = torch.zeros((cfg.num_layers, batch), dtype=torch.int32, device=device)
    return caches


class ContinuousBatcher:
    """Admit, step, and drain multi-tenant generation requests.

    ``serve_step`` is the callable from ``make_serve_step``; it runs on the
    device of ``params``.
    """

    def __init__(self, serve_step, params, cfg, pool: AdapterPoolCache, *, batch: int,
                 max_len: int, cache_dtype=torch.bfloat16, pad_id: int = 0):
        self.serve_step = serve_step
        self.params = params
        self.cfg = cfg
        self.pool = pool
        self.batch = int(batch)
        self.max_len = int(max_len)
        self.pad_id = int(pad_id)
        self.device = params["embed"].device
        self.queue: List[Request] = []
        self.done: List[Completion] = []
        self.rows: List[Optional[_Row]] = [None] * self.batch
        self.caches = batched_caches(cfg, self.batch, self.max_len, cache_dtype, self.device)
        self._tokens = np.full((self.batch,), pad_id, np.int32)
        self._pos = np.zeros((self.batch,), np.int32)

    # -------------------------------------------------------------- admit
    def submit(self, req: Request):
        if not req.prompt:
            raise ValueError("empty prompt")
        if len(req.prompt) + 1 > self.max_len:
            # prompt prefill + at least one generated token must fit in the
            # KV ring, else teacher-forced prefill silently wraps it
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens needs {len(req.prompt) + 1} "
                f"cache positions but max_len is {self.max_len}"
            )
        self.queue.append(req)

    def _admit(self):
        """Fill free rows from the queue; reset recycled rows' positions.

        Each admitted row ``acquire``s its adapter, holding the pool slot
        until the row completes.  A request whose adapter cannot be loaded
        yet (every slot pinned by live rows) stays queued; later queued
        requests whose adapters are already resident may admit ahead of it.
        """
        freed = np.zeros((self.batch,), bool)
        for i in range(self.batch):
            if self.rows[i] is not None or not self.queue:
                continue
            admitted = None
            for qi, req in enumerate(self.queue):
                try:
                    slot = self.pool.acquire(req.adapter)
                except RuntimeError:
                    continue  # all slots held by live rows; leave queued
                admitted = _Row(req=req, remaining_prompt=list(req.prompt), slot=slot)
                self.queue.pop(qi)
                break
            if admitted is None:
                break  # nothing admissible until a live row releases a pin
            self.rows[i] = admitted
            self._tokens[i] = admitted.remaining_prompt.pop(0)
            self._pos[i] = 0
            freed[i] = True
        if freed.any():
            self.caches = _reset_rows(self.caches, torch.from_numpy(freed).to(self.device))

    # --------------------------------------------------------------- step
    def step(self):
        """One decode step over all live rows."""
        self._admit()
        live = [i for i in range(self.batch) if self.rows[i] is not None]
        if not live:
            return False
        slots = [self.rows[i].slot if self.rows[i] else 0 for i in range(self.batch)]
        peft = self.pool.pooled_peft(torch.tensor(slots, dtype=torch.int32).to(self.device))
        _, nxt, self.caches = self.serve_step(
            self.params,
            torch.from_numpy(self._tokens[:, None]).to(self.device),
            torch.from_numpy(self._pos).to(self.device),
            self.caches,
            peft=peft,
        )
        nxt = nxt[:, 0].tolist()  # one transfer for the batch
        self._pos += 1
        for i in live:
            row = self.rows[i]
            if row.remaining_prompt:
                # prompt still streaming: the prediction is ignored and the
                # next prompt token is forced (teacher-forced prefill
                # through the decode step)
                self._tokens[i] = row.remaining_prompt.pop(0)
                continue
            tok = nxt[i]
            row.generated.append(tok)
            hit_eos = row.req.eos_id is not None and tok == row.req.eos_id
            out_of_budget = len(row.generated) >= row.req.max_new_tokens
            out_of_cache = bool(self._pos[i] >= self.max_len)
            if hit_eos or out_of_budget or out_of_cache:
                self.done.append(
                    Completion(
                        uid=row.req.uid,
                        adapter=row.req.adapter,
                        tokens=list(row.generated),
                        finish_reason="eos" if hit_eos else "length",
                    )
                )
                self.pool.release(row.req.adapter)
                self.rows[i] = None  # row recycles next _admit()
                self._tokens[i] = self.pad_id
                self._pos[i] = 0
            else:
                self._tokens[i] = tok
        return True

    # ---------------------------------------------------------------- run
    def run(self, max_steps: int = 100_000) -> List[Completion]:
        """Step until queue and rows drain; returns completions in finish
        order.  Raises rather than silently dropping work: if ``max_steps``
        is exhausted with requests in flight, or the queue cannot make
        progress (every pool slot pinned outside the batcher)."""
        steps = 0
        while (self.queue or any(r is not None for r in self.rows)) and steps < max_steps:
            if not self.step() and self.queue:
                raise RuntimeError(
                    f"{len(self.queue)} queued request(s) cannot be admitted: all "
                    f"{self.pool.n_slots} pool slots are pinned outside the batcher"
                )
            steps += 1
        live = sum(r is not None for r in self.rows)
        if self.queue or live:
            raise RuntimeError(
                f"run() exhausted max_steps={max_steps} with {live} live row(s) and "
                f"{len(self.queue)} queued request(s) — their completions were never emitted"
            )
        out, self.done = self.done, []
        return out
