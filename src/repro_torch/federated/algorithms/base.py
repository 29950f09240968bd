"""The federated-algorithm API: registry and lifecycle hooks, as
``repro.federated.algorithms.base``.

A federated method is a :class:`FederatedAlgorithm` subclass registered by
name.  The scheduler calls five lifecycle hooks in a fixed order each
round:

    1. ``configure_round(state) -> RoundPlan``   cohort + dropout rates
    2. ``client_init(state, dev) -> peft``       per-device start tree
    3. ``cohort_step(state, plan)``              train the cohort (engine)
    4. ``aggregate(state, results)``             masks + new global model
    5. ``report(state, results)``                costs, bandit feedback, row

Hooks take a :class:`~repro_torch.federated.state.RoundState` and return a
new one.  The base class is the generic FedPEFT loop (uniform cohort
sampling, no layer dropout, FedAvg) through small overridable policies
(``round_rates``, ``active_depth``, ``compute_masks``, ``merge``,
``feedback``).  Every draw of ``state.rng`` is the reference's, in its
order: the cohort in ``configure_round``, then one bandwidth per member in
``round_cost``.  ``compress_uplink`` compresses each device's PEFT delta
when the run has a ``compression`` level (error feedback threads through
``state.ef_residual``), and ``merge`` takes the uplinks' reconstructions
and the staleness weights of the deadline and async-buffer schedules when
they are set.  With a joint configurator ``round_arms`` draws each
device's (dropout rate, compression level) arm from one bandit.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Type

import numpy as np

from repro_torch.federated import compression as compression_lib
from repro_torch.federated import server as server_lib
from repro_torch.federated.state import CohortResults, RoundPlan, RoundState
from repro_torch.federated.system_model import sample_bandwidth
from repro_torch.models.stacking import tree_map

_REGISTRY: Dict[str, Type["FederatedAlgorithm"]] = {}


def _signature(tree):
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(_signature(t) for t in tree)
    return tuple(tree.shape)


def _trees_congruent(a, b) -> bool:
    """Same structure and leaf shapes: an EF residual saved for one PEFT
    geometry must not be reused for another."""
    return _signature(a) == _signature(b)


def register(name: str):
    """Class decorator: add a FederatedAlgorithm to the method registry."""

    def deco(cls):
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


def get_algorithm(name: str) -> Type["FederatedAlgorithm"]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown federated method {name!r}; registered: {sorted(_REGISTRY)}") from None


def registered_methods() -> List[str]:
    """Registered method names, in registration order."""
    return list(_REGISTRY)


class FederatedAlgorithm:
    """Base algorithm: plain federated PEFT (FedAvg, no dropout, no PTLS)."""

    name = "fedpeft"
    stld = False                 # STLD layer dropout during local training
    use_configurator = False     # online bandit picks the dropout rate
    use_ptls = False             # personalized two-stage layer sharing
    fixed_rate = 0.5             # dropout rate when the bandit is off
    requires_sequential = False  # per-device trees can't share a device axis

    def __init__(self):
        self.ctx = None

    # ---------------------------------------------------------------- binding
    def bind(self, ctx):
        """Attach the experiment context; returns the initial global PEFT."""
        self.ctx = ctx
        return ctx.init_global_peft

    def build_configurator(self, ctx):
        """The bandit rate configurator, or None for fixed-policy methods."""
        return None

    # ------------------------------------------------------- lifecycle hooks
    def configure_round(self, state: RoundState, *, size=None, exclude=()) -> RoundPlan:
        """Sample the cohort and pick per-device dropout rates.  The
        scheduler passes ``size`` (an async-buffer refill dispatches as many
        devices as just arrived) and ``exclude`` (devices in flight, backing
        off or churned out); the call without them draws ``state.rng`` as
        the sync round always has."""
        fed = self.ctx.fed_cfg
        want = fed.devices_per_round if size is None else size
        if exclude:
            free = [d for d in range(fed.num_devices) if d not in exclude]
            n = min(want, len(free))
            cohort = [int(d) for d in np.asarray(free)[state.rng.choice(len(free), size=n, replace=False)]]
        else:
            cohort = [int(d) for d in state.rng.choice(fed.num_devices, size=min(want, fed.num_devices),
                                                       replace=False)]
        rates, levels = self.round_arms(state, len(cohort))
        return RoundPlan(
            round_index=state.round_index,
            cohort=cohort,
            rates=rates,
            adaopt_depth=self.active_depth(state),
            compression=levels,
        )

    def client_init(self, state: RoundState, dev: int):
        """The PEFT tree a device starts its local round from."""
        return state.global_peft

    def cohort_step(self, state: RoundState, plan: RoundPlan):
        """Train the planned cohort through the execution engine."""
        key, gstep, outs = self.ctx.engine.run_cohort(
            state.key, state.global_step, plan.cohort, plan.rates, plan.start_pefts, self.ctx.num_classes,
            plan.adaopt_depth,
        )
        results = CohortResults(
            plan=plan,
            pefts=[o[0] for o in outs],
            metrics=[o[1] for o in outs],
            importances=[o[2] for o in outs],
            accuracies=[o[3] for o in outs],
        )
        return replace(state, key=key, global_step=gstep), results

    def compress_uplink(self, state: RoundState, results: CohortResults):
        """Compress each device's PEFT *delta* for the uplink, between
        ``cohort_step`` and ``aggregate``.

        Without ``ctx.compression`` (or with every level ``"none"``) a
        strict no-op: ``uplink_pefts`` stays None and the merge and billing
        are the uncompressed path's, bit for bit.  Otherwise it fills
        ``results.uplink_pefts`` with the server-side reconstructions (start
        tree + lossy delta) and ``results.uplink_ratio`` with each device's
        compressed/fp32 factor, and threads the error-feedback residuals
        through ``state.ef_residual`` (a residual of another geometry is
        reset)."""
        comp = getattr(self.ctx, "compression", None)
        if comp is None:
            return state, results
        plan = results.plan
        levels = plan.compression or [comp.kind] * len(plan.cohort)
        plan.compression = levels
        if all(lv == "none" for lv in levels):
            return state, results
        starts = plan.start_pefts
        if starts is None:
            starts = [self.client_init(state, dev) for dev in plan.cohort]
        ef_residual = dict(state.ef_residual)
        uplinks, ratios = [], []
        for i, dev in enumerate(plan.cohort):
            kind = levels[i]
            if kind == "none":
                uplinks.append(results.pefts[i])
                ratios.append(1.0)
                continue
            start = starts[i]
            delta = tree_map(lambda a, b: a.float() - b.float(), results.pefts[i], start)
            if comp.error_feedback:
                residual = ef_residual.get(dev)
                if residual is None or not _trees_congruent(residual, delta):
                    residual = compression_lib.ErrorFeedback.init(delta)
                sent, ef_residual[dev] = compression_lib.ef_step(delta, residual, kind=kind,
                                                                 fraction=comp.topk_fraction, decay=comp.ef_decay)
            else:
                sent = compression_lib.compress_decompress(delta, kind=kind, fraction=comp.topk_fraction)
            uplinks.append(tree_map(lambda s_, b: (b.float() + s_).to(b.dtype), sent, start))
            ratios.append(compression_lib.uplink_ratio(
                delta, compression_lib.CompressionConfig(kind=kind, topk_fraction=comp.topk_fraction)))
        results.uplink_pefts = uplinks
        results.uplink_ratio = np.asarray(ratios, dtype=np.float64)
        return replace(state, ef_residual=ef_residual), results

    def aggregate(self, state: RoundState, results: CohortResults) -> RoundState:
        """Compute share masks (unless the scheduler did at dispatch),
        persist device models, merge the global."""
        masks = results.masks if results.masks is not None else self.compute_masks(state, results)
        results.masks = masks
        device_peft = dict(state.device_peft)
        last_mask = dict(state.last_mask)
        for i, dev in enumerate(results.plan.cohort):
            device_peft[dev] = results.pefts[i]
            last_mask[dev] = masks[i]
        global_peft = self.merge(state, results)
        return replace(state, device_peft=device_peft, last_mask=last_mask, global_peft=global_peft)

    def round_cost(self, state: RoundState, results: CohortResults):
        """System-model cost accounting for a trained cohort: one bandwidth
        draw per member (in cohort order, from ``state.rng``) and the
        vectorized ``SystemModel`` round cost; fills ``results.cost`` and
        returns ``(cost, active_fracs)``."""
        ctx, fed = self.ctx, self.ctx.fed_cfg
        cohort = results.plan.cohort
        n = len(cohort)
        bandwidths = np.array([sample_bandwidth(state.rng) for _ in cohort])
        active = np.asarray([m["active_layers"] for m in results.metrics], dtype=np.float64)
        active_fracs = (active / ctx.cfg.num_layers).tolist()
        if results.masks is None:
            results.masks = self.compute_masks(state, results)
        cost = ctx.system.cohort_round_cost(
            devices=[ctx.device_profile[dev] for dev in cohort],
            bandwidth_mbps=bandwidths,
            batch=fed.batch_size,
            seq=ctx.task.seq_len,
            local_steps=fed.local_steps,
            peft=True,
            active_fraction=np.asarray(active_fracs) if self.stld else np.ones(n),
            share_fraction=results.masks.mean(axis=1),
            uplink_ratio=1.0 if results.uplink_ratio is None else np.asarray(results.uplink_ratio, dtype=np.float64),
        )
        results.cost = cost
        return cost, active_fracs

    def report(self, state: RoundState, results: CohortResults):
        """System-model accounting + feedback; returns (state, history row)."""
        plan = results.plan
        cohort = plan.cohort
        cost, active_fracs = self.round_cost(state, results)
        round_times = cost.total_time_s
        cum_time = state.cum_time + float(round_times.max())  # synchronous round
        mean_acc = float(np.mean(results.accuracies))
        self.feedback(state, results, round_times)
        prev_acc = dict(state.prev_acc)
        for i, dev in enumerate(cohort):
            prev_acc[dev] = results.accuracies[i]
        row = {
            "time": cum_time,
            "acc": mean_acc,
            "loss": float(np.mean(np.asarray([m["loss"] for m in results.metrics], dtype=np.float64))),
            "rate": float(np.mean(plan.rates)),
            "active": float(np.mean(active_fracs)),
            "traffic": float(cost.traffic_mb.sum()),
            "energy": float(cost.energy_j.sum()),
            "memory": float(cost.memory_gb.max()),
            "arrivals": len(cohort),  # synchronous barrier: everyone arrives
        }
        return replace(state, cum_time=cum_time, prev_acc=prev_acc), row

    # ------------------------------------------------------- policy methods
    def round_rates(self, state: RoundState, n: int) -> List[float]:
        if state.configurator is not None:
            return state.configurator.next_round(n)
        if self.stld:
            return [self.fixed_rate] * n
        return [0.0] * n

    def round_arms(self, state: RoundState, n: int):
        """Per-device (dropout rates, compression levels): both from one
        draw of a joint configurator; otherwise the rates from
        :meth:`round_rates` (the rate-only stream) and no levels
        (``compress_uplink`` takes the run's fixed level)."""
        cfgor = state.configurator
        if cfgor is not None and getattr(cfgor, "joint", False):
            return cfgor.next_round_joint(n)
        return self.round_rates(state, n), None

    def active_depth(self, state: RoundState) -> int:
        return self.ctx.cfg.num_layers

    def compute_masks(self, state: RoundState, results: CohortResults):
        n = len(results.plan.cohort)
        return np.ones((n, self.ctx.cfg.num_layers), dtype=bool)

    def _merge_trees(self, results: CohortResults) -> list:
        """What the server aggregates: the uplinks' reconstructions when
        compression ran, else the devices' trees."""
        return results.pefts if results.uplink_pefts is None else results.uplink_pefts

    def merge(self, state: RoundState, results: CohortResults):
        trees = self._merge_trees(results)
        if results.weights is not None:
            return server_lib.weighted_fedavg(trees, results.weights)
        return server_lib.fedavg(trees)

    def feedback(self, state: RoundState, results: CohortResults, round_times):
        """Hook for online controllers (bandit reward updates)."""
