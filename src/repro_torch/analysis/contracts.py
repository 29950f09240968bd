"""Program contracts over the registered algorithms' programs, as
``repro.analysis.jaxpr_contracts``.

A "traced program" here is one run on the ``meta`` device at the
reference's smoke dims (``_SMOKE_DIMS``) under the recording dispatch mode
(``analysis.trace.MetaRecorder``), which sees every aten op the program
dispatches, its outputs' shapes and dtypes and every host read.  Every
registered :class:`~repro_torch.federated.algorithms.base.FederatedAlgorithm`
gets its client step, aggregation body and uplink run that way, and the
serving decode loop and batched decode once (shared), and the records are
held to these contracts:

``restack``         no ``cat`` or ``stack`` whose output shape is a stacked
                    base leaf's shape: a stacked tree rebuilt inside the
                    program.
``dtype64``         no float64 output of a device op: a silent f32 -> f64
                    promotion doubles memory and work.
``callback``        no host read of device data (``.item()``, ``.cpu()``,
                    ``.tolist()``, a copy off the device) inside a round's
                    body: one host round trip per round times the
                    population.
``uplink-callback`` the same over the uplink: compress, then decompress,
                    then aggregate.
``leaf-budget``     a gather-mode client step at the same k takes the same
                    number of tensors and dispatches the same number of ops
                    at L and at 2L layers (the batched decode: the same
                    number of tensors).
``flops-linear``    the client step's FLOPs fit a line of positive slope in
                    the STLD active fraction (gather mode).
``bytes-linear``    the same for the bytes its ops move.
``finite-guard``    every aggregation program calls ``torch.isfinite``
                    (``federated/server.py`` ``screen_finite``), the screen
                    that keeps a corrupted client update out of the global
                    PEFT.

FLOPs and bytes are ``analysis.trace.run_on_meta``'s: ``FlopCounterMode``
plus the kernels' counted work, and the bytes of every device op's inputs
and outputs.  The linearity fit and its tolerance are the reference's.

An exemption is an ``ALLOWLIST`` entry, keyed ``"<algorithm>/<program>"``
with a written reason, never a bare pass.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from repro_torch.analysis.report import Violation
from repro_torch.analysis.trace import run_on_meta, tree_tensors

FRACTIONS = (0.25, 0.5, 1.0)

# the reference's smoke-scale trace config: tiny dims so that one run is
# well under a second; num_layers stays free for the leaf-budget doubling
_SMOKE_ARCH = "qwen3-1.7b"
_SMOKE_DIMS = dict(d_model=32, d_ff=64, num_heads=2, num_kv_heads=2, vocab_size=128, dtype="float32")


@dataclass(frozen=True)
class ContractRule:
    """One contract: id, description and fix hint (for reports and docs)."""

    rule_id: str
    description: str
    hint: str


CONTRACT_RULES: Dict[str, ContractRule] = {
    r.rule_id: r
    for r in (
        ContractRule(
            "restack",
            "no cat or stack in a program may rebuild a stacked base-layer leaf",
            "keep params in the stacked layout end to end; stack once outside "
            "the round (models/stacking.py), never inside a step",
        ),
        ContractRule(
            "dtype64",
            "no float64 output of a device op",
            "an op promoted to float64 (a float64 tensor or numpy constant "
            "meeting a float32 one); cast the operand to the compute dtype",
        ),
        ContractRule(
            "callback",
            "no host read of device data inside a round's body",
            "keep the value on the device (torch.where instead of an if on "
            "a tensor), or read it once after the round",
        ),
        ContractRule(
            "leaf-budget",
            "a client step's tensors and ops must not scale with the layer count",
            "a per-layer list leaked into the call, or the step walks every "
            "layer where it should walk the k active ones; pass the stacked "
            "(L, ...) tree and loop over the active layers only",
        ),
        ContractRule(
            "flops-linear",
            "program FLOPs must scale linearly with the STLD active fraction",
            "a dense-over-L computation ignores the gather-mode active set; "
            "route layer work through the k active layers",
        ),
        ContractRule(
            "bytes-linear",
            "bytes moved must scale linearly with the STLD active fraction",
            "per-layer params are touched even for dropped layers; read the "
            "k active layers only",
        ),
        ContractRule(
            "finite-guard",
            "an aggregation program must contain the non-finite screen",
            "route the aggregated tree through server.screen_finite (or an "
            "equivalent torch.isfinite select) as the last step of the "
            "aggregation",
        ),
        ContractRule(
            "uplink-callback",
            "the uplink (compress, decompress, aggregate) must not round-trip through the host",
            "a copy to the host between dequantization and the reduce "
            "serializes every cohort member through host memory; keep the "
            "dequantize-and-merge pipeline on the device",
        ),
    )
}

# rule id -> {"<algorithm>/<program>": reason}.  An entry exempts one
# program from one rule; the reason is printed with --list.
ALLOWLIST: Dict[str, Dict[str, str]] = {
    "restack": {},
    "dtype64": {},
    "callback": {},
    "finite-guard": {},
    "uplink-callback": {},
}


def allowlisted(rule_id: str, where: str) -> bool:
    return where in ALLOWLIST.get(rule_id, {})


class _FunctionNames(TorchFunctionMode):
    """Records the names of the torch functions a program calls (the
    aten level decomposes ``torch.isfinite``)."""

    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.names.add(getattr(func, "__name__", str(func)))
        return func(*args, **(kwargs or {}))


# ------------------------------------------------------------- trace records
@dataclass(frozen=True)
class ProgramTrace:
    """One program's run on ``meta`` plus what the rules need."""

    where: str                     # "<algorithm>/<program>" report key
    ops: tuple                     # the recorder's OpRecords
    host_reads: tuple
    functions: frozenset           # torch-level function names
    stacked_shapes: frozenset      # restack targets; empty disables
    num_inputs: int                # tensors the program takes
    num_device_ops: Optional[int]  # ops it dispatches on the device (None: not compared)


@dataclass(frozen=True)
class ScalingCurve:
    """Cost measurements of one program family across active fractions."""

    where: str
    fractions: Tuple[float, ...]
    flops: Tuple[float, ...]
    bytes_accessed: Tuple[float, ...]


def trace_program(where: str, fn, *args, stacked_shapes=frozenset(), count_ops: bool = False, **kwargs):
    """Run ``fn(*args, **kwargs)`` on ``meta`` and record it."""
    names = _FunctionNames()
    with names:
        run = run_on_meta(fn, *args, keep_ops=True, **kwargs)
    ops = tuple(run.recorder.ops)
    return ProgramTrace(
        where=where, ops=ops, host_reads=tuple(run.host_reads), functions=frozenset(names.names),
        stacked_shapes=frozenset(tuple(s) for s in stacked_shapes),
        num_inputs=len(tree_tensors((args, kwargs))),
        num_device_ops=sum(op.on_device for op in ops) if count_ops else None,
    )


def stacked_leaf_shapes(tree) -> frozenset:
    """Shapes of the stacked leaves of a layer tree: its leaves where it is
    stacked, else each leaf of a layer with a leading layer count."""
    from repro_torch.models import stacking

    if stacking.is_stacked(tree):
        return frozenset(tuple(x.shape) for x in stacking.tree_leaves(tree))
    return frozenset((len(tree), *x.shape) for x in stacking.tree_leaves(tree[0]))


# -------------------------------------------------------------- rule checks
def stacking_concats(trace: ProgramTrace) -> List:
    return [op for op in trace.ops if op.name in ("cat", "stack") and any(s in trace.stacked_shapes for s in op.shapes)]


def check_trace_rules(trace: ProgramTrace) -> List[Violation]:
    """The structural rules (restack, dtype64, callback) on one trace."""
    out: List[Violation] = []
    if trace.stacked_shapes and not allowlisted("restack", trace.where):
        concats = stacking_concats(trace)
        if concats:
            shapes = sorted({s for op in concats for s in op.shapes if s in trace.stacked_shapes})
            out.append(Violation("restack", trace.where,
                                 f"{len(concats)} cat/stack op(s) rebuild stacked layer leaves (shapes {shapes})",
                                 CONTRACT_RULES["restack"].hint))
    if not allowlisted("dtype64", trace.where):
        bad = sorted({op.name for op in trace.ops if op.on_device and torch.float64 in op.dtypes})
        if bad:
            out.append(Violation("dtype64", trace.where, f"float64 outputs produced by: {', '.join(bad)}",
                                 CONTRACT_RULES["dtype64"].hint))
    if trace.host_reads and not allowlisted("callback", trace.where):
        out.append(Violation("callback", trace.where,
                             f"host read(s) of device data in the program: {', '.join(sorted(set(trace.host_reads)))}",
                             CONTRACT_RULES["callback"].hint))
    return out


def check_finite_guard(trace: ProgramTrace) -> List[Violation]:
    """finite-guard: requires ``torch.isfinite`` to be present."""
    if allowlisted("finite-guard", trace.where) or "isfinite" in trace.functions:
        return []
    return [Violation("finite-guard", trace.where,
                      "no torch.isfinite anywhere in the aggregation program: a non-finite client update would "
                      "flow straight into the global PEFT", CONTRACT_RULES["finite-guard"].hint)]


def check_uplink(trace: ProgramTrace) -> List[Violation]:
    """uplink-callback: no host read between dequantize and the reduce."""
    if allowlisted("uplink-callback", trace.where) or not trace.host_reads:
        return []
    return [Violation("uplink-callback", trace.where,
                      f"host round trip between dequantize and reduce: {', '.join(sorted(set(trace.host_reads)))}",
                      CONTRACT_RULES["uplink-callback"].hint)]


def check_leaf_budget(trace: ProgramTrace, trace_2l: ProgramTrace) -> List[Violation]:
    """O(k) dispatch: the tensors a program takes, and where both traces
    counted them its device ops, may not grow with L."""
    out = []
    if trace.num_inputs != trace_2l.num_inputs:
        out.append(f"program inputs grow with the layer count: {trace.num_inputs} at L vs "
                   f"{trace_2l.num_inputs} at 2L")
    if None not in (trace.num_device_ops, trace_2l.num_device_ops) and trace.num_device_ops != trace_2l.num_device_ops:
        out.append(f"device ops grow with the layer count at the same k: {trace.num_device_ops} at L vs "
                   f"{trace_2l.num_device_ops} at 2L")
    return [Violation("leaf-budget", trace.where, msg, CONTRACT_RULES["leaf-budget"].hint) for msg in out]


def _linearity(xs: Sequence[float], ys: Sequence[float]):
    """Least-squares line through (xs, ys): (slope, max relative residual)."""
    n = len(xs)
    xm, ym = sum(xs) / n, sum(ys) / n
    sxx = sum((x - xm) ** 2 for x in xs)
    sxy = sum((x - xm) * (y - ym) for x, y in zip(xs, ys))
    slope = sxy / sxx
    intercept = ym - slope * xm
    scale = max(abs(ym), 1e-30)
    resid = max(abs(intercept + slope * x - y) for x, y in zip(xs, ys)) / scale
    return slope, resid


def check_curve(curve: ScalingCurve, *, tol: float = 0.02) -> List[Violation]:
    """flops-linear and bytes-linear: both cost measures must fit a
    positive-slope line over the active fractions within ``tol`` relative
    residual."""
    out: List[Violation] = []
    for rule_id, ys in (("flops-linear", curve.flops), ("bytes-linear", curve.bytes_accessed)):
        if allowlisted(rule_id, curve.where):
            continue
        slope, resid = _linearity(curve.fractions, ys)
        points = list(zip(curve.fractions, ys))
        if slope <= 0:
            out.append(Violation(rule_id, curve.where,
                                 f"cost does not grow with the active fraction (slope {slope:.3g}; points {points})",
                                 CONTRACT_RULES[rule_id].hint))
        elif resid > tol:
            out.append(Violation(rule_id, curve.where,
                                 f"cost is not linear in the active fraction (relative residual {resid:.3g} > {tol}; "
                                 f"points {points})", CONTRACT_RULES[rule_id].hint))
    return out


# ------------------------------------------------------- program construction
_trace_cache: Dict[tuple, object] = {}


def _train_cfg():
    from repro_torch.configs import TrainConfig

    return TrainConfig(learning_rate=5e-3, total_steps=100, warmup_steps=2)


def smoke_cfg(num_layers: int = 4):
    from repro_torch.configs import get_config

    return get_config(_SMOKE_ARCH, smoke=True).replace(num_layers=num_layers, **_SMOKE_DIMS)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _client_setup(num_layers, peft_method, lora_rank, stld_cfg):
    """Client fns and arguments on ``meta`` at smoke scale."""
    from repro_torch.configs import PEFTConfig
    from repro_torch.federated.client import make_client_fns
    from repro_torch.models.registry import param_shapes, peft_shapes
    from repro_torch.optim import adamw_init

    cfg = smoke_cfg(num_layers)
    pcfg = PEFTConfig(method=peft_method, lora_rank=lora_rank, adapter_dim=4)
    fns = make_client_fns(cfg, pcfg, stld_cfg, _train_cfg(), device="meta")
    base, peft = param_shapes(cfg), peft_shapes(cfg, pcfg)
    batches = {"tokens": _meta((2, 4, 8), torch.int32), "targets": _meta((2, 4, 8), torch.int32),
               "mask": _meta((2, 4, 8), torch.float32)}
    return fns, base, (base, peft, adamw_init(peft), batches, 0.5)


def _peft_family(name: str) -> Tuple[str, int]:
    """(peft method, lora rank) the algorithm's client programs run with."""
    if name in ("fedadapter", "fedadaopt"):
        return "adapter", 2
    if name == "fedhetlora":
        return "lora", 16  # the max-rank tier's client program
    return "lora", 2


def _merge_family(name: str) -> str:
    if name == "fedhetlora":
        return "hetlora"
    if name.startswith("droppeft") and name != "droppeft_b3":
        return "ptls"
    return "fedavg"


def client_trace(peft_method, lora_rank, stld_enabled, *, num_layers=4, num_active=None,
                 where="client_step") -> ProgramTrace:
    """The local round in cond mode, or in gather mode at ``num_active``."""
    from repro_torch.configs import STLDConfig

    key = ("client", peft_method, lora_rank, stld_enabled, num_layers, num_active)
    if key not in _trace_cache:
        mode = "cond" if num_active is None else "gather"
        scfg = STLDConfig(mode=mode, mean_rate=0.5, enabled=stld_enabled, gather_bucket=1)
        fns, base, args = _client_setup(num_layers, peft_method, lora_rank, scfg)
        _trace_cache[key] = trace_program(where, fns.local_round, *args, torch.Generator().manual_seed(0), 0,
                                          num_active=num_active, stacked_shapes=stacked_leaf_shapes(base["layers"]),
                                          count_ops=num_active is not None)
    return _retag(_trace_cache[key], where)


def _retag(trace: ProgramTrace, where: str) -> ProgramTrace:
    return dataclasses.replace(trace, where=where)


def client_scaling_curve(peft_method, lora_rank, *, fractions=FRACTIONS, num_layers=4,
                         where="client_step") -> ScalingCurve:
    """Gather-mode cost curve: the local round at each active count k =
    round(fraction · L), its FLOPs and bytes."""
    from repro_torch.configs import STLDConfig

    key = ("curve", peft_method, lora_rank, tuple(fractions), num_layers)
    if key not in _trace_cache:
        scfg = STLDConfig(mode="gather", mean_rate=0.5, gather_bucket=1)
        fns, _, args = _client_setup(num_layers, peft_method, lora_rank, scfg)
        flops, nbytes = [], []
        for frac in fractions:
            k = max(1, round(frac * num_layers))
            run = run_on_meta(fns.local_round, *args, torch.Generator().manual_seed(0), 0, num_active=k)
            flops.append(run.flops)
            nbytes.append(run.bytes_accessed)
        _trace_cache[key] = (tuple(flops), tuple(nbytes))
    flops, nbytes = _trace_cache[key]
    return ScalingCurve(where, tuple(fractions), flops, nbytes)


def _smoke_peft(rank: int):
    from repro_torch.configs import PEFTConfig
    from repro_torch.models.registry import peft_shapes

    return peft_shapes(smoke_cfg(4), PEFTConfig(method="lora", lora_rank=rank))


def aggregation_trace(family: str, *, where="aggregate") -> ProgramTrace:
    """The merge family's aggregation body over a 3-client cohort."""
    from repro_torch.federated import server as server_lib
    from repro_torch.models import stacking

    key = ("agg", family)
    if key not in _trace_cache:
        n = 3
        if family == "hetlora":
            ranks = (2, 4)
            clients = [_smoke_peft(r) for r in ranks]
            trace = trace_program(where, lambda cs: server_lib.hetlora_aggregate(cs, list(ranks), max(ranks)),
                                  clients, stacked_shapes=stacked_leaf_shapes(clients[-1]))
        else:
            gpeft = _smoke_peft(2)
            if family == "ptls":
                cohort = stacking.tree_map(lambda x: torch.stack([x] * n), gpeft)
                masks = np.ones((n, smoke_cfg(4).num_layers), dtype=bool)
                trace = trace_program(where, lambda cp, gp: server_lib.ptls_aggregate(cp, masks, gp), cohort, gpeft,
                                      stacked_shapes=stacked_leaf_shapes(gpeft))
            else:
                trace = trace_program(where, server_lib.fedavg, [gpeft] * n,
                                      stacked_shapes=stacked_leaf_shapes(gpeft))
        _trace_cache[key] = trace
    return _retag(_trace_cache[key], where)


def uplink_trace(family: str, *, where="uplink") -> ProgramTrace:
    """The compressed uplink of one merge family: each client's top-k'd
    tree quantized to int8 (outside the program), then in the program
    dequantized and aggregated."""
    from repro_torch.federated import compression as comp_lib
    from repro_torch.federated import server as server_lib
    from repro_torch.models import stacking

    key = ("uplink", family)
    if key not in _trace_cache:
        n = 3
        ranks = (2, 4, 4)
        clients = [_smoke_peft(r) for r in ranks] if family == "hetlora" else [_smoke_peft(2)] * n
        wire = [comp_lib.quantize_int8(comp_lib.topk_sparsify(c, 0.25)) for c in clients]
        vals, scales = [v for v, _ in wire], [s for _, s in wire]

        def dense(vals, scales):
            return [comp_lib.dequantize_int8(v, s) for v, s in zip(vals, scales)]

        if family == "hetlora":
            def fn(vals, scales):
                return server_lib.hetlora_aggregate(dense(vals, scales), list(ranks), max(ranks))
        elif family == "ptls":
            masks = np.ones((n, smoke_cfg(4).num_layers), dtype=bool)

            def fn(vals, scales, gp=clients[0]):
                cohort = stacking.tree_map(lambda *xs: torch.stack(xs), *dense(vals, scales))
                return server_lib.ptls_aggregate(cohort, masks, gp)
        else:
            def fn(vals, scales):
                return server_lib.fedavg(dense(vals, scales))

        _trace_cache[key] = trace_program(where, fn, vals, scales, stacked_shapes=stacked_leaf_shapes(clients[-1]))
    return _retag(_trace_cache[key], where)


def decode_trace(*, where="serving/decode", num_tokens=4) -> ProgramTrace:
    """The greedy decode loop (``serving.decode.generate``) at smoke scale,
    shared across algorithms: serving is method-independent."""
    key = ("decode", num_tokens)
    if key not in _trace_cache:
        from repro_torch.launch.steps import make_serve_step
        from repro_torch.models.registry import param_shapes
        from repro_torch.models.transformer import init_caches
        from repro_torch.serving.decode import generate

        cfg = smoke_cfg(4)
        params = param_shapes(cfg)
        caches = init_caches(cfg, 2, 16, dtype=torch.float32, device="meta")
        first = _meta((2, 1), torch.int32)
        _trace_cache[key] = trace_program(
            where, lambda p, c, t: generate(make_serve_step(cfg), p, c, t, 8, num_tokens)[0], params, caches, first,
            stacked_shapes=stacked_leaf_shapes(params["layers"]))
    return _retag(_trace_cache[key], where)


def batched_decode_trace(*, where="serving/batched_decode", num_layers=4, num_tokens=4) -> ProgramTrace:
    """One multi-tenant batched decode step: pooled mixed-rank adapters
    (the segmented kernel), stacked batched caches, per-row positions.
    ``num_tokens`` keys the cache only, as the reference's does."""
    key = ("batched_decode", num_layers, num_tokens)
    if key not in _trace_cache:
        from repro_torch.configs import PEFTConfig
        from repro_torch.launch.steps import make_serve_step
        from repro_torch.models.registry import param_shapes, peft_shapes
        from repro_torch.serving.adapters import AdapterPoolCache, AdapterRegistry
        from repro_torch.serving.batcher import batched_caches

        cfg = smoke_cfg(num_layers)
        params = param_shapes(cfg)
        registry = AdapterRegistry()
        for i, rank in enumerate((2, 4)):  # hetlora mixed ranks in one pool
            registry.register(f"client{i}", peft_shapes(cfg, PEFTConfig(method="lora", lora_rank=rank)))
        pool = AdapterPoolCache(registry, n_slots=2, dtype=torch.float32, device="meta")
        peft = pool.pooled_peft(torch.tensor([0, 1], dtype=torch.int32, device="meta"))
        caches = batched_caches(cfg, 2, 16, dtype=torch.float32, device="meta")
        serve = make_serve_step(cfg)
        _trace_cache[key] = trace_program(
            where, lambda p, pf, t, ps, c: serve(p, t, ps, c, peft=pf)[0], params, peft, _meta((2, 1), torch.int32),
            _meta((2,), torch.int32), caches, stacked_shapes=stacked_leaf_shapes(params["layers"]))
    return _retag(_trace_cache[key], where)


# ----------------------------------------------------------------- top level
def check_algorithms(algorithms: Optional[Sequence[str]] = None, *, fractions: Sequence[float] = FRACTIONS,
                     include_decode: bool = True, progress=None) -> List[Violation]:
    """Run every contract over every (or the named) registered algorithms.
    Runs are cached per program family (droppeft and its ablations share
    one client program), so the whole registry costs a handful."""
    from repro_torch.federated import algorithms as alg_pkg

    names = list(algorithms) if algorithms else alg_pkg.registered_methods()
    violations: List[Violation] = []
    for name in names:
        if progress:
            progress(name)
        cls = alg_pkg.get_algorithm(name)
        method, rank = _peft_family(name)
        where = f"{name}/client_step"
        violations += check_trace_rules(client_trace(method, rank, cls.stld, where=where))
        k = 2  # the same active count at L and 2L
        violations += check_leaf_budget(client_trace(method, rank, True, num_active=k, where=where),
                                        client_trace(method, rank, True, num_layers=8, num_active=k, where=where))
        violations += check_curve(client_scaling_curve(method, rank, fractions=tuple(fractions), where=where))
        agg_tr = aggregation_trace(_merge_family(name), where=f"{name}/aggregate")
        violations += check_trace_rules(agg_tr)
        violations += check_finite_guard(agg_tr)
        violations += check_uplink(uplink_trace(_merge_family(name), where=f"{name}/uplink"))
    if include_decode:
        if progress:
            progress("serving/decode")
        violations += check_trace_rules(decode_trace())
        if progress:
            progress("serving/batched_decode")
        btr, btr_2l = batched_decode_trace(), batched_decode_trace(num_layers=8)
        violations += check_trace_rules(btr)
        violations += check_leaf_budget(btr, btr_2l)
    return violations
