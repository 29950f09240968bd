"""Cohort execution engine: how one round's selected devices are trained,
as ``repro.federated.engine``.

The engine owns the client programs, the per-device datasets and the
dispatch; the *what* of a round (cohort, dropout rates, aggregation rule)
lives in :mod:`repro_torch.federated.algorithms`.  The port runs the
``sequential`` cohort mode: one ``local_round`` and one ``evaluate`` per
device, in cohort order.  Each device starts from a fresh AdamW state at
the global-step offset ``global_step + i * local_steps``, and draws its
STLD gates from a CPU generator seeded with its own key of the round's
fan-out (``state.split_key``).  The batched mode is not ported.

PEFT trees stay on the device; each device's round metrics and
importances come to the host in one transfer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.federated.client import make_client_fns
from repro_torch.federated.state import split_key
from repro_torch.models import stacking
from repro_torch.optim import adamw_init

_METRICS = ("loss", "accuracy", "grad_norm", "active_layers")


class CohortEngine:
    """Executes cohorts of local rounds; owns the client programs and the
    device data."""

    def __init__(self, cfg, peft_cfg, stld_cfg, fed_cfg, train_cfg, task, devices, base_params, *, device=None):
        self.cfg = cfg
        self.base_params = base_params
        self.peft_cfg = peft_cfg
        self.stld_cfg = stld_cfg
        self.fed_cfg = fed_cfg
        self.train_cfg = train_cfg
        self.task = task
        self.devices = devices
        self.device = torch.device("cuda" if device is None else device)
        self.client = make_client_fns(cfg, peft_cfg, stld_cfg, train_cfg, device=self.device)
        self.local_round, self.evaluate = self.client.local_round, self.client.evaluate

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
        outs = [
            self._run_device(cohort[i], rates[i], start_pefts[i], keys[i], gsteps[i], num_classes, adaopt_depth)
            for i in range(n)
        ]
        return key, global_step + n * fed.local_steps, outs

    def _adaopt_truncate(self, peft_i, start_peft, adaopt_depth: int):
        """Progressive depth (FedAdaOPT): layers beyond the active depth keep
        their incoming values; exact copies in either layout."""
        if isinstance(peft_i, (list, tuple)):
            return [peft_i[l] if l < adaopt_depth else start_peft[l] for l in range(self.cfg.num_layers)]
        keep = np.arange(self.cfg.num_layers) < adaopt_depth
        return stacking.select_layers(keep, peft_i, start_peft)

    def _stacked_train_batches(self, dev: int):
        fed = self.fed_cfg
        batches = list(self.devices[dev].train_batches(fed.batch_size, fed.local_steps))
        return {k: np.stack([b[k] for b in batches]) for k in ("tokens", "targets", "mask")}

    def _run_device(self, dev: int, rate: float, start_peft, key: int, gstep: int, num_classes, adaopt_depth):
        peft_i, _, metrics, importance = self.local_round(
            self.base_params, start_peft, adamw_init(start_peft), self._stacked_train_batches(dev), float(rate),
            torch.Generator().manual_seed(key), gstep,
        )
        if adaopt_depth < self.cfg.num_layers:
            peft_i = self._adaopt_truncate(peft_i, start_peft, adaopt_depth)
        # one host pull for the round's scalars and importances
        host = torch.cat([torch.stack([metrics[k] for k in _METRICS]), importance]).cpu().numpy()
        metrics = {k: host[j] for j, k in enumerate(_METRICS)}
        importance = host[len(_METRICS):]
        val = self.devices[dev].val_batch()
        acc = float(self.evaluate(self.base_params, peft_i, val["tokens"], val["labels"], num_classes))
        return peft_i, metrics, importance, acc

    # ------------------------------------------------------------ evaluation
    def final_accuracy(self, global_peft, device_peft, num_classes) -> float:
        """Paper protocol: mean accuracy across ALL devices' local test sets,
        each device using its personalized model (global for
        non-participants)."""
        accs = []
        for dev in range(self.fed_cfg.num_devices):
            val = self.devices[dev].val_batch()
            peft_d = device_peft.get(dev, global_peft)
            accs.append(float(self.evaluate(self.base_params, peft_d, val["tokens"], val["labels"], num_classes)))
        return float(np.mean(accs))
