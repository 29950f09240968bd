"""Analytic device/communication system model (paper §6.1, Table 1-2).

A numpy copy of ``repro.federated.system_model`` (the LoRA branch of the
PEFT count): the same cohort, bandwidths and fractions give the same times,
memory, energy and traffic, float for float.  On-device times in the paper
were measured on Jetson boards; here they are derived from per-round FLOPs
and bytes and the boards' published capabilities (Table 2).

All quantities honour STLD: a round with expected active-layer fraction
``rho = E[L-tilde]/L`` scales layer compute, layer activations, and
layer-local PEFT state by ``rho`` (paper §3.2); PTLS scales upload traffic
by the shared-layer fraction (paper §4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    flops: float          # effective trainable FLOP/s (bf16, incl. utilisation)
    memory_gb: float
    compute_watts: float
    radio_watts: float


# Jetson boards from paper Table 2.  "flops" folds a ~30% training
# utilisation factor into the headline TOPS number.
DEVICE_PROFILES = {
    "tx2": DeviceProfile("tx2", 0.6e12, 8.0, 15.0, 2.0),
    "nx": DeviceProfile("nx", 6.3e12, 16.0, 20.0, 2.0),
    "agx": DeviceProfile("agx", 9.6e12, 32.0, 30.0, 2.0),
}


@dataclass
class RoundCost:
    compute_time_s: float
    comm_time_s: float
    memory_gb: float
    energy_j: float
    traffic_mb: float

    @property
    def total_time_s(self) -> float:
        return self.compute_time_s + self.comm_time_s


@dataclass
class CohortCost:
    """Vectorized :class:`RoundCost` over a cohort: every field is (N,)."""

    compute_time_s: np.ndarray
    comm_time_s: np.ndarray
    memory_gb: np.ndarray
    energy_j: np.ndarray
    traffic_mb: np.ndarray

    @property
    def total_time_s(self) -> np.ndarray:
        return self.compute_time_s + self.comm_time_s


@dataclass
class MemoryBreakdown:
    params_gb: float
    activations_gb: float
    gradients_gb: float
    optimizer_gb: float

    @property
    def total_gb(self) -> float:
        return self.params_gb + self.activations_gb + self.gradients_gb + self.optimizer_gb


class SystemModel:
    """Per-round cost model for one (model config, LoRA config) pair."""

    def __init__(self, cfg, peft_cfg=None, *, peft_params: int = 0, dtype_bytes: int = 2):
        self.cfg = cfg
        self.peft_cfg = peft_cfg
        self.dtype_bytes = dtype_bytes
        counts = cfg.param_counts()
        self.total_params = counts["total"]
        self.active_params = counts["active"]
        self.peft_params = peft_params or self._default_peft_params()

    def _default_peft_params(self) -> int:
        """Trainable parameters of ``peft_cfg.method``: LoRA over
        ``lora_targets``, the two bottleneck adapters a layer, BitFit's two
        biases a layer, or none."""
        if self.peft_cfg is None:
            return 0
        cfg, p = self.cfg, self.peft_cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        if p.method == "lora":
            per_layer = 0
            for t in p.lora_targets:
                if t == "q":
                    per_layer += p.lora_rank * (d + cfg.num_heads * hd)
                elif t in ("k", "v"):
                    per_layer += p.lora_rank * (d + cfg.num_kv_heads * hd)
                elif t == "o":
                    per_layer += p.lora_rank * (cfg.num_heads * hd + d)
                elif t in ("up", "gate"):
                    per_layer += p.lora_rank * (d + cfg.d_ff)
                elif t == "down":
                    per_layer += p.lora_rank * (cfg.d_ff + d)
            return per_layer * cfg.num_layers
        if p.method == "adapter":
            return 2 * (2 * cfg.d_model * p.adapter_dim) * cfg.num_layers
        if p.method == "bitfit":
            return 2 * cfg.d_model * cfg.num_layers
        return 0

    # ------------------------------------------------------------- pieces
    def flops_per_token(self, *, training: bool, peft: bool, active_fraction=1.0):
        """Forward (+backward) FLOPs per token: forward 2 N_active; a full
        backward 4 N; a PEFT backward skips the frozen weights' gradients
        (~2 N + small).  STLD scales the layer part by ``active_fraction``;
        the LM head (one embedding-sized matmul) is never dropped."""
        emb = self.cfg.param_counts()["embedding"]
        layer_params = max(self.active_params - emb, 0)
        fwd = 2 * (layer_params * active_fraction + emb)
        if not training:
            return fwd
        if peft:
            bwd = fwd + 6 * self.peft_params * active_fraction
        else:
            bwd = 2 * fwd
        return fwd + bwd

    def activation_bytes_per_token(self, active_fraction=1.0):
        """Stored-activation bytes per token for the backward pass, about
        20 d + 4 ff per token per layer in the compute dtype (HF-style
        training, which keeps every sublayer intermediate)."""
        cfg = self.cfg
        per_layer = (20 * cfg.d_model + 4 * cfg.d_ff) * self.dtype_bytes
        if cfg.num_experts > 0:
            per_layer += 2 * cfg.num_experts * self.dtype_bytes  # router probs
        return per_layer * cfg.num_layers * active_fraction + 2 * cfg.d_model * self.dtype_bytes

    def memory_breakdown(self, *, batch: int, seq: int, peft: bool, full_ft: bool = False,
                         active_fraction=1.0) -> MemoryBreakdown:
        gb = 1024.0**3
        params = self.total_params * self.dtype_bytes / gb
        act = self.activation_bytes_per_token(active_fraction) * batch * seq / gb
        if full_ft:
            grads = self.total_params * self.dtype_bytes / gb
            opt = self.total_params * 2 * self.dtype_bytes / gb  # bf16 m+v (paper Fig. 3)
        elif peft:
            grads = self.peft_params * active_fraction * 4 / gb
            opt = self.peft_params * active_fraction * 8 / gb
        else:
            grads = opt = 0.0
        return MemoryBreakdown(params, act, grads, opt)

    def comm_bytes(self, *, peft: bool, share_fraction=1.0, uplink_ratio=1.0):
        """Per-round up+down traffic (fp32 updates, paper §2.2);
        ``uplink_ratio`` scales the up part only."""
        n = self.peft_params if peft else self.total_params
        up = n * share_fraction * 4 * uplink_ratio
        down = n * 4
        return up + down

    # -------------------------------------------------------------- rounds
    def round_cost(self, *, device: str = "nx", bandwidth_mbps: float = 40.0, batch: int = 16, seq: int = 128,
                   local_steps: int = 4, peft: bool = True, full_ft: bool = False, active_fraction: float = 1.0,
                   share_fraction: float = 1.0) -> RoundCost:
        cohort = self.cohort_round_cost(
            devices=[device], bandwidth_mbps=bandwidth_mbps, batch=batch, seq=seq, local_steps=local_steps,
            peft=peft, full_ft=full_ft, active_fraction=active_fraction, share_fraction=share_fraction,
        )
        return RoundCost(
            compute_time_s=float(cohort.compute_time_s[0]),
            comm_time_s=float(cohort.comm_time_s[0]),
            memory_gb=float(cohort.memory_gb[0]),
            energy_j=float(cohort.energy_j[0]),
            traffic_mb=float(cohort.traffic_mb[0]),
        )

    def cohort_round_cost(self, *, devices: Sequence[str], bandwidth_mbps, batch: int = 16, seq: int = 128,
                          local_steps: int = 4, peft: bool = True, full_ft: bool = False, active_fraction=1.0,
                          share_fraction=1.0, uplink_ratio=1.0) -> CohortCost:
        """:meth:`round_cost` over a cohort: ``devices`` is a length-N list
        of profile names; ``bandwidth_mbps``, ``active_fraction``,
        ``share_fraction`` and ``uplink_ratio`` broadcast as (N,) arrays."""
        n = len(devices)
        af = np.broadcast_to(np.asarray(active_fraction, dtype=np.float64), (n,))
        sf = np.broadcast_to(np.asarray(share_fraction, dtype=np.float64), (n,))
        ur = np.broadcast_to(np.asarray(uplink_ratio, dtype=np.float64), (n,))
        bw = np.broadcast_to(np.asarray(bandwidth_mbps, dtype=np.float64), (n,))
        profs = [DEVICE_PROFILES[d] for d in devices]
        cap = np.array([p.flops for p in profs])
        compute_watts = np.array([p.compute_watts for p in profs])
        radio_watts = np.array([p.radio_watts for p in profs])

        tokens = batch * seq * local_steps
        peft_train = peft and not full_ft
        flops = tokens * self.flops_per_token(training=True, peft=peft_train, active_fraction=af)
        compute_time = flops / cap
        bytes_ = self.comm_bytes(peft=peft_train, share_fraction=sf, uplink_ratio=ur)
        comm_time = bytes_ * 8 / (bw * 1e6)
        mem = self.memory_breakdown(batch=batch, seq=seq, peft=peft_train, full_ft=full_ft, active_fraction=af)
        energy = compute_watts * compute_time + radio_watts * comm_time
        return CohortCost(
            compute_time_s=compute_time,
            comm_time_s=comm_time,
            memory_gb=np.broadcast_to(np.asarray(mem.total_gb, dtype=np.float64), (n,)),
            energy_j=energy,
            traffic_mb=np.broadcast_to(np.asarray(bytes_ / 1024.0**2, dtype=np.float64), (n,)),
        )


def sample_bandwidth(rng: np.random.Generator, low: float = 1.0, high: float = 100.0) -> float:
    """Per-device bandwidth fluctuating in [1, 100] Mbps (paper §6.1)."""
    return float(rng.uniform(low, high))


def sample_device(rng: np.random.Generator) -> str:
    return str(rng.choice(list(DEVICE_PROFILES)))
