"""Cohort execution engine: how one round's selected devices are trained,
as ``repro.federated.engine``.

The engine owns the client programs, the per-device datasets and the
dispatch; the *what* of a round (cohort, dropout rates, aggregation rule)
lives in :mod:`repro_torch.federated.algorithms`.  ``cohort_mode`` selects
the dispatch:

* ``"batched"`` — the cohort's PEFT trees are stacked on a leading device
  axis and one ``cohort_round_eval`` trains and evaluates them all
  (FedAdaOPT: ``cohort_round``, the progressive-depth truncation, then
  ``cohort_evaluate``), on validation rows padded to one size.  In gather
  mode each device keeps its own static active-layer count: the reference
  runs one call per group of equal count, the port the whole cohort in one
  call, and each device's outputs are the same.
* ``"sequential"`` — one ``local_round`` and one ``evaluate`` per device, in
  cohort order.  FedHetLoRA runs here only (``enable_hetlora``): each
  device trains and evaluates with the client programs of its own LoRA
  rank, at that rank's ``lora_alpha / r``.

Both modes consume the same streams: one key fan-out a round, device i's
STLD gates from a CPU generator seeded with its key (``state.split_key``)
and drawn in the same order, its global-step offset ``global_step + i *
local_steps``, its batches from its own numpy stream, in cohort order; and
both give each device a fresh AdamW state.  So they give the same
per-device PEFT trees, metrics, importances and accuracies
(``tests/test_torch_cohort.py``).

PEFT trees stay on the device; a round's metrics, importances and
accuracies come to the host in one transfer (one per device in the
sequential mode).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import stld as stld_lib
from repro_torch.federated import server as server_lib
from repro_torch.federated.client import METRICS, make_client_fns
from repro_torch.federated.state import split_key
from repro_torch.models import stacking
from repro_torch.models.registry import default_stack_mode
from repro_torch.optim import adamw_init


class CohortEngine:
    """Executes cohorts of local rounds; owns the client programs and the
    device data."""

    def __init__(self, cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, task, devices, base_params, *,
                 cohort_mode: str, stld_enabled: bool = True, device=None):
        if cohort_mode not in ("batched", "sequential"):
            raise ValueError(f"cohort_mode must be 'batched' or 'sequential', got {cohort_mode!r}")
        self.cfg = cfg
        self.base_params = base_params
        self.peft_cfg = peft_cfg
        self.stld_cfg = stld_cfg
        self.fed_cfg = fed_cfg
        self.train_cfg = train_cfg
        self.task = task
        self.devices = devices
        self.cohort_mode = cohort_mode
        self.stld_enabled = stld_enabled
        self.device = torch.device("cuda" if device is None else device)
        self.stack_mode = default_stack_mode(cfg)
        self.client = make_client_fns(cfg, peft_cfg, stld_cfg, train_cfg, stack_mode=self.stack_mode,
                                      device=self.device)
        self.local_round, self.evaluate = self.client.local_round, self.client.evaluate
        # one validation pad size for every device, as the reference's
        self._val_pad = max(len(d.val_batch()["labels"]) for d in devices)
        self._val_cache: Dict[int, dict] = {}
        # FedHetLoRA: each device's LoRA rank and the client programs of each rank
        self.device_rank: Optional[List[int]] = None
        self._het_fns: Dict[int, object] = {}

    def enable_hetlora(self, device_rank: List[int]):
        """Build one set of client programs per LoRA rank of a
        rank-heterogeneous cohort (each at its rank's ``alpha / r``)."""
        self.device_rank = list(device_rank)
        for r in sorted(set(self.device_rank)):
            peft_cfg = dataclasses.replace(self.peft_cfg, lora_rank=r)
            self._het_fns[r] = make_client_fns(self.cfg, peft_cfg, self.stld_cfg, self.train_cfg,
                                               stack_mode=self.stack_mode, device=self.device)

    def _device_fns(self, dev: int):
        """(local_round, evaluate) of device ``dev``: its rank's under
        FedHetLoRA, else the engine's."""
        if self.device_rank is None:
            return self.local_round, self.evaluate
        fns = self._het_fns[self.device_rank[dev]]
        return fns.local_round, fns.evaluate

    # ------------------------------------------------------------- execution
    def run_cohort(self, key, global_step, cohort, rates, start_pefts, num_classes, adaopt_depth):
        """Train one round's cohort; returns ``(new_key, new_global_step,
        outs)`` where ``outs`` is a list (len N) of per-device ``(peft,
        metrics, importance, accuracy)``: one key fan-out for the devices,
        global-step offsets in cohort order."""
        fed = self.fed_cfg
        n = len(cohort)
        key, *keys = split_key(key, n + 1)
        gsteps = [global_step + i * fed.local_steps for i in range(n)]
        if self.cohort_mode == "batched":
            outs = self._run_cohort_batched(cohort, rates, start_pefts, keys, gsteps, num_classes, adaopt_depth)
        else:
            outs = [
                self._run_device(cohort[i], rates[i], start_pefts[i], keys[i], gsteps[i], num_classes, adaopt_depth)
                for i in range(n)
            ]
        return key, global_step + n * fed.local_steps, outs

    def _adaopt_truncate(self, peft_i, start_peft, adaopt_depth: int, axis: int = 0):
        """Progressive depth (FedAdaOPT): layers beyond the active depth keep
        their incoming values; exact copies in either layout (``axis`` 1 for
        a cohort's stacked ``(N, L, ...)`` leaves)."""
        if isinstance(peft_i, (list, tuple)):
            return [peft_i[l] if l < adaopt_depth else start_peft[l] for l in range(self.cfg.num_layers)]
        keep = np.arange(self.cfg.num_layers) < adaopt_depth
        return stacking.select_layers(keep, peft_i, start_peft, axis=axis)

    def _stacked_train_batches(self, dev: int):
        fed = self.fed_cfg
        batches = list(self.devices[dev].train_batches(fed.batch_size, fed.local_steps))
        return {k: np.stack([b[k] for b in batches]) for k in ("tokens", "targets", "mask")}

    def _padded_val_batch(self, dev: int):
        """Device ``dev``'s validation rows padded to the pad size, with
        their ``valid`` mask; built once per device (the split is fixed)."""
        cached = self._val_cache.get(dev)
        if cached is None:
            val = self.devices[dev].val_batch()
            b = len(val["labels"])
            valid = np.zeros((self._val_pad,), dtype=np.float32)
            valid[:b] = 1.0
            cached = self._val_cache[dev] = {
                "tokens": np.pad(val["tokens"], ((0, self._val_pad - b), (0, 0))),
                "labels": np.pad(val["labels"], (0, self._val_pad - b)),
                "valid": valid,
            }
        return cached

    def _static_active_counts(self, rates) -> List[Optional[int]]:
        """Gather mode's static active-layer count per device (None in cond
        mode, or when the algorithm runs no STLD)."""
        if self.stld_cfg.mode == "gather" and self.stld_enabled:
            return [
                stld_lib.static_active_count(rate, self.cfg.num_layers, self.stld_cfg.gather_bucket,
                                             self.stld_cfg.min_active_layers)
                for rate in rates
            ]
        return [None] * len(rates)

    def _val_stack(self, devs):
        vals = [self._padded_val_batch(dev) for dev in devs]
        return tuple(np.stack([v[k] for v in vals]) for k in ("tokens", "labels", "valid"))

    def _run_cohort_batched(self, cohort, rates, start_pefts, keys, gsteps, num_classes, adaopt_depth):
        """One ``cohort_round_eval`` (FedAdaOPT: ``cohort_round``, the
        truncation, ``cohort_evaluate``) trains and evaluates the cohort."""
        n = len(cohort)
        batch_list = [self._stacked_train_batches(dev) for dev in cohort]
        batch_stack = {k: np.stack([b[k] for b in batch_list]) for k in ("tokens", "targets", "mask")}
        val_args = self._val_stack(cohort)
        peft_stack = stack_trees(start_pefts)
        rngs = [torch.Generator().manual_seed(k) for k in keys]
        rates = [float(r) for r in rates]
        num_active = self._static_active_counts(rates)
        if adaopt_depth < self.cfg.num_layers:
            # the deep layers' updates are discarded before the evaluation,
            # so train, truncate, then evaluate the retained adapters
            peft_out, metrics, importances = self.client.cohort_round(
                self.base_params, peft_stack, batch_stack, rates, rngs, gsteps, num_active)
            peft_out = self._adaopt_truncate(peft_out, peft_stack, adaopt_depth, axis=1)
            accs = self.client.cohort_evaluate(self.base_params, peft_out, *val_args, num_classes)
        else:
            peft_out, metrics, importances, accs = self.client.cohort_round_eval(
                self.base_params, peft_stack, batch_stack, rates, rngs, gsteps, *val_args, num_classes,
                num_active)
        # one host pull for the cohort's metrics, importances and accuracies
        host = torch.cat([torch.stack([metrics[k] for k in METRICS], dim=1), importances, accs[:, None]],
                         dim=1).cpu().numpy()
        accs = host[:, -1].tolist()
        outs = []
        for i, peft_i in enumerate(unstack_tree(peft_out, n)):
            dev_metrics = {k: host[i, j] for j, k in enumerate(METRICS)}
            outs.append((peft_i, dev_metrics, host[i, len(METRICS):-1], accs[i]))
        return outs

    def _run_device(self, dev: int, rate: float, start_peft, key: int, gstep: int, num_classes, adaopt_depth):
        local_round, evaluate = self._device_fns(dev)
        peft_i, _, metrics, importance = local_round(
            self.base_params, start_peft, adamw_init(start_peft), self._stacked_train_batches(dev), float(rate),
            torch.Generator().manual_seed(key), gstep, self._static_active_counts([rate])[0],
        )
        if adaopt_depth < self.cfg.num_layers:
            peft_i = self._adaopt_truncate(peft_i, start_peft, adaopt_depth)
        # one host pull for the round's scalars and importances
        host = torch.cat([torch.stack([metrics[k] for k in METRICS]), importance]).cpu().numpy()
        metrics = {k: host[j] for j, k in enumerate(METRICS)}
        importance = host[len(METRICS):]
        val = self.devices[dev].val_batch()
        acc = float(evaluate(self.base_params, peft_i, val["tokens"], val["labels"], num_classes))
        return peft_i, metrics, importance, acc

    # ------------------------------------------------------------ evaluation
    def final_accuracy(self, global_peft, device_peft, num_classes) -> float:
        """Paper protocol: mean accuracy across ALL devices' local test sets,
        each device using its personalized model (global for
        non-participants, cut to its rank under FedHetLoRA).  Batched:
        ``cohort_evaluate`` over chunks of ``devices_per_round`` devices
        (the reference takes all devices in one call, whose logits at a
        full-size vocabulary would not fit one card); the mean is taken
        over Python floats in both modes."""
        devs = range(self.fed_cfg.num_devices)
        hetlora = self.device_rank is not None
        if self.cohort_mode == "batched" and not hetlora:
            accs: List[float] = []
            chunk = max(1, self.fed_cfg.devices_per_round)
            for start in range(0, len(devs), chunk):
                part = devs[start:start + chunk]
                peft_stack = stack_trees([device_peft.get(dev, global_peft) for dev in part])
                # repro-lint: disable=TXH002 — one read of a chunk's accuracies
                accs += self.client.cohort_evaluate(self.base_params, peft_stack, *self._val_stack(part),
                                                    num_classes).tolist()
            return float(np.mean(accs))
        accs = []
        for dev in devs:
            val = self.devices[dev].val_batch()
            peft_d = device_peft.get(dev, global_peft)
            if hetlora and dev not in device_peft:
                peft_d = server_lib.truncate_lora_rank(global_peft, self.device_rank[dev])
            evaluate = self._device_fns(dev)[1]
            accs.append(float(evaluate(self.base_params, peft_d, val["tokens"], val["labels"], num_classes)))
        return float(np.mean(accs))


def stack_trees(trees: list):
    """Identically shaped trees stacked on a new leading device axis, in
    either layout (a per-layer list stays a list of layers)."""
    return stacking.tree_map(lambda *xs: torch.stack(xs), *trees)


def unstack_tree(tree, n: int) -> list:
    """The n device trees of a stacked cohort tree (views of its leaves)."""
    return [stacking.tree_map(lambda x, i=i: x[i], tree) for i in range(n)]
