"""Adapter registry + pooled LRU cache for multi-tenant LoRA serving.

:class:`AdapterRegistry` is the host-side catalogue of named LoRA trees
(stacked layout), each with its true rank and alpha, registered in-process
or loaded from a checkpoint of either package (``load_checkpoint``: a
federated runner's ``save_state`` or a ``save_pytree`` of one adapter).

:class:`AdapterPoolCache` owns the device pools the segmented kernel reads:
for every LoRA projection a stacked ``(L, n_slots, ...)`` pool, zero-padded
to the pool-wide ``r_max``, with the per-adapter ``alpha / rank`` scale
folded into ``b`` at slot-write time.  The pools are kept in the serving
compute dtype: rounding once at the slot write gives the values the JAX
package gets by casting its float32 pools at every step.  A slot write
copies into the pool in place.  Eviction is LRU over unpinned slots; pins
are refcounted so every live request holds its adapter's slot
(``acquire``/``release``) and eviction never rewrites a slot that a
mid-generation row still reads.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint import ckpt as ckpt_lib
from repro_torch.nn.linear import AdapterPool

DEFAULT_LORA_ALPHA = 16.0  # PEFTConfig default


def _is_lora_node(node) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"a", "b"}


def _walk(node, fn, path=()):
    """Apply ``fn`` to every LoRA ``{"a","b"}`` node; rebuild around it."""
    if _is_lora_node(node):
        return fn(node, path)
    if isinstance(node, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in node.items()}
    raise ValueError(
        f"pooled serving supports pure-LoRA stacked peft trees; found a non-LoRA node "
        f"at {'/'.join(path) or '<root>'}: {type(node).__name__}"
    )


def infer_rank(peft_tree) -> int:
    """True rank of a LoRA tree = trailing dim of any ``a`` leaf."""
    ranks = set()
    _walk(peft_tree, lambda n, p: ranks.add(int(n["a"].shape[-1])) or n)
    if len(ranks) != 1:
        raise ValueError(f"mixed ranks within one adapter tree: {sorted(ranks)}")
    return ranks.pop()


class AdapterRegistry:
    """Named catalogue of per-tenant LoRA trees (stacked layout)."""

    def __init__(self):
        self._entries: Dict[str, dict] = {}

    def register(self, name: str, peft_tree, *, alpha: float = DEFAULT_LORA_ALPHA):
        """Register a stacked LoRA tree under ``name``."""
        rank = infer_rank(peft_tree)
        self._entries[name] = {"peft": peft_tree, "rank": rank, "alpha": float(alpha)}
        return self

    def load_checkpoint(self, checkpoint_dir: str, *, prefix: str = "client", alpha: float = DEFAULT_LORA_ALPHA):
        """Register every client adapter of a federated ``save_state``
        checkpoint (the reference's or the port's).  ``checkpoint_dir`` may
        be a ``step_*`` dir, a run dir whose latest step is used, or a root
        holding one run dir.  Clients land as ``f"{prefix}{device_id}"``;
        the server-side global adapter as ``f"{prefix}_global"``."""
        arrays = self._load_arrays(self._resolve_state_dir(checkpoint_dir))
        for dev, tree in arrays.get("device_peft", {}).items():
            self.register(f"{prefix}{dev}", tree, alpha=alpha)
        if arrays.get("global_peft") is not None:
            self.register(f"{prefix}_global", arrays["global_peft"], alpha=alpha)
        return self

    @staticmethod
    def _resolve_state_dir(checkpoint_dir: str) -> str:
        latest = ckpt_lib.latest_state_dir(checkpoint_dir)
        if latest is not None:
            return latest
        if os.path.isfile(os.path.join(checkpoint_dir, "manifest.json")):
            return checkpoint_dir  # already a step_* dir
        runs = []
        if os.path.isdir(checkpoint_dir):
            for name in sorted(os.listdir(checkpoint_dir)):
                sub = ckpt_lib.latest_state_dir(os.path.join(checkpoint_dir, name))
                if sub is not None:
                    runs.append(sub)
        if len(runs) == 1:
            return runs[0]
        found = f"; {len(runs)} run dirs found — pass one of them" if runs else ""
        raise FileNotFoundError(f"no checkpoint under {checkpoint_dir!r}{found}")

    @staticmethod
    def _load_arrays(state_dir: str) -> dict:
        """Either checkpoint schema as a ``{"global_peft", "device_peft"}``
        dict of CPU tensors: a runner's ``save_state`` (JSON skeleton)
        directly, or a ``save_pytree`` manifest (one global adapter) by
        rebuilding the nested dict from the leaf paths."""
        with open(os.path.join(state_dir, "manifest.json")) as f:
            manifest = json.load(f)
        if "skeleton" in manifest:
            return ckpt_lib.load_state(state_dir)[0]
        tree: dict = {}
        with np.load(os.path.join(state_dir, "arrays.npz")) as data:
            for entry in manifest["leaves"]:
                *parents, leaf = entry["path"].split("/")
                node = tree
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = ckpt_lib._to_tensor(data[entry["key"]], entry["dtype"])
        return {"global_peft": tree, "device_peft": {}}

    def get(self, name: str) -> dict:
        return self._entries[name]

    def names(self):
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)


class AdapterPoolCache:
    """LRU slot cache mapping registry adapters into device pools.

    ``n_slots`` bounds concurrent tenants per batch; ``r_max`` (default: the
    registry's largest rank) sizes the shared rank padding; ``dtype`` is the
    pools' dtype (the serving compute dtype) and ``device`` their device.
    """

    def __init__(self, registry: AdapterRegistry, n_slots: int, r_max: Optional[int] = None,
                 *, dtype=torch.float32, device=None):
        if len(registry) == 0:
            raise ValueError("registry is empty")
        self.registry = registry
        self.n_slots = int(n_slots)
        self.r_max = int(
            r_max if r_max is not None else max(registry.get(n)["rank"] for n in registry.names())
        )
        self.device = torch.device(device) if device is not None else None
        self._slots: "OrderedDict[str, int]" = OrderedDict()  # name -> slot (LRU order)
        self._pins: Dict[str, int] = {}  # name -> refcount (>0 blocks eviction)
        template = registry.get(registry.names()[0])["peft"]

        # every LoRA leaf grows a slot axis after the layer axis:
        # a (L, K, r) -> (L, NS, K, r_max)
        def pool_leaf(node, _path):
            a, b = node["a"], node["b"]
            lnum = a.shape[0]
            return {
                "a": torch.zeros((lnum, self.n_slots, a.shape[1], self.r_max), dtype=dtype, device=device),
                "b": torch.zeros((lnum, self.n_slots, self.r_max, b.shape[-1]), dtype=dtype, device=device),
            }

        self._pool = _walk(template, pool_leaf)
        self._ranks = torch.zeros((self.n_slots,), dtype=torch.int32, device=device)
        self.swaps = 0  # slot writes performed (steady-state swap telemetry)

    # ------------------------------------------------------------ slots
    def _padded(self, entry):
        """Zero-pad an adapter to r_max and fold alpha/rank into b."""
        scale = entry["alpha"] / entry["rank"]
        pad_r = self.r_max - entry["rank"]

        def pad(node, _path):
            a, b = node["a"], node["b"]
            b = b * torch.tensor(scale, dtype=b.dtype, device=b.device)
            return {"a": F.pad(a, (0, pad_r)), "b": F.pad(b, (0, 0, 0, pad_r))}

        return _walk(entry["peft"], pad)

    def _write_slot(self, padded, slot: int):
        """``pool[:, slot] = adapter`` on every leaf, in place."""

        def write(pool_node, path):
            node = padded
            for key in path:
                node = node[key]
            pool_node["a"][:, slot].copy_(node["a"])
            pool_node["b"][:, slot].copy_(node["b"])
            return pool_node

        _walk(self._pool, write)

    def slot_of(self, name: str) -> int:
        """Slot holding ``name``, loading (and possibly evicting) if absent."""
        if name in self._slots:
            self._slots.move_to_end(name)
            return self._slots[name]
        entry = self.registry.get(name)
        if entry["rank"] > self.r_max:
            raise ValueError(f"adapter {name!r} rank {entry['rank']} exceeds pool r_max {self.r_max}")
        if len(self._slots) < self.n_slots:
            slot = len(self._slots)
        else:
            victim = next((n for n in self._slots if self._pins.get(n, 0) == 0), None)
            if victim is None:
                raise RuntimeError("all pool slots are pinned; cannot evict")
            slot = self._slots.pop(victim)
        self._write_slot(self._padded(entry), slot)
        self._ranks[slot] = entry["rank"]
        self._slots[name] = slot
        self.swaps += 1
        return slot

    def lookup(self, names) -> torch.Tensor:
        """Row -> slot map for a batch of adapter names, loading as needed.

        Every distinct name is pinned while the batch resolves, so loading
        name k+1 never evicts the slot just handed out for name k.  The pins
        drop on return; callers interleaving loads with use hold their own
        ``acquire``/``release`` pins (the batcher does).
        """
        distinct = list(dict.fromkeys(names))
        if len(distinct) > self.n_slots:
            raise ValueError(
                f"batch references {len(distinct)} distinct adapters but the "
                f"pool has only {self.n_slots} slots"
            )
        held = []
        try:
            for n in distinct:
                self.pin(n)
                held.append(n)
            return torch.tensor([self._slots[n] for n in names], dtype=torch.int32, device=self.device)
        finally:
            for n in held:
                self.unpin(n)

    def acquire(self, name: str) -> int:
        """``slot_of`` + a refcounted pin: the slot cannot be evicted until a
        matching :meth:`release`.  Every live request row holds one."""
        slot = self.slot_of(name)
        self._pins[name] = self._pins.get(name, 0) + 1
        return slot

    def release(self, name: str):
        """Drop one ``acquire`` pin; the slot becomes evictable at zero."""
        count = self._pins.get(name, 0) - 1
        if count > 0:
            self._pins[name] = count
        else:
            self._pins.pop(name, None)

    def pin(self, name: str):
        self.acquire(name)

    def unpin(self, name: str):
        self.release(name)

    # ------------------------------------------------------------- peft
    def pooled_peft(self, row_slots):
        """Peft tree with :class:`AdapterPool` nodes for a batch whose row i
        serves the adapter in slot ``row_slots[i]``.  The pools are shared
        (no copies); ``idx``/``ranks`` are expanded over the layer axis."""
        row_slots = torch.as_tensor(row_slots, dtype=torch.int32, device=self.device)

        def wrap(node, _path):
            lnum = node["a"].shape[0]
            return AdapterPool(
                a=node["a"],
                b=node["b"],
                idx=row_slots[None].expand(lnum, row_slots.shape[0]),
                ranks=self._ranks[None].expand(lnum, self.n_slots),
            )

        return _walk(self._pool, wrap)
