"""Negative fixtures: one deliberately violating toy program per rule, as
``repro.analysis.fixtures``.

Each fixture runs the real analyzer machinery (never a stub) over a program
built to violate exactly one rule and returns the violations found, so

* ``python -m repro_torch.analysis --fixture RULE`` exits 1: proof that the
  analyzer catches that class of bug, and
* ``python -m repro_torch.analysis --self-test`` asserts that every fixture
  is caught: proof that a change to the analyzer did not blind a rule.

The lint fixtures' planted bugs live in strings, so the package itself
stays lint-clean; the contract fixtures are programs run on ``meta``.
"""
from __future__ import annotations

import textwrap
from typing import Callable, Dict, List

import torch

from repro_torch.analysis import contracts, lint_torch
from repro_torch.analysis.recompile_guard import CompilationCounter
from repro_torch.analysis.report import Violation
from repro_torch.analysis.trace import run_on_meta

FIXTURES: Dict[str, Callable[[], List[Violation]]] = {}


def _fixture(rule_id: str):
    def deco(fn):
        FIXTURES[rule_id] = fn
        return fn

    return deco


def _lint(source: str) -> List[Violation]:
    return lint_torch.lint_source(textwrap.dedent(source), "fixture.py")


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ------------------------------------------------------------- lint fixtures
@_fixture("TXH001")
def global_generator_draw() -> List[Violation]:
    return _lint(
        """
        import torch

        def gates(rates):
            return torch.bernoulli(rates)
        """
    )


@_fixture("TXH002")
def host_sync_loop() -> List[Violation]:
    return _lint(
        """
        def pull(rates, pos):
            return [rates[i].item() for i in pos]
        """
    )


@_fixture("TXH004")
def mutable_default() -> List[Violation]:
    return _lint(
        """
        def accumulate(x, acc=[]):
            acc.append(x)
            return acc
        """
    )


@_fixture("TXH005")
def device_fallback() -> List[Violation]:
    return _lint(
        """
        import torch

        def pick_device():
            return "cuda" if torch.cuda.is_available() else "cpu"
        """
    )


@_fixture("TXH006")
def package_boundary() -> List[Violation]:
    return _lint(
        """
        import jaxlib

        def version():
            return jaxlib.__version__
        """
    )


@_fixture("PYL001")
def unused_import() -> List[Violation]:
    return _lint(
        """
        import os

        def f():
            return 1
        """
    )


@_fixture("PYL002")
def shadowed_builtin() -> List[Violation]:
    return _lint(
        """
        def head(list):
            return list[0]
        """
    )


# --------------------------------------------------------- contract fixtures
@_fixture("restack")
def traced_restack() -> List[Violation]:
    """A per-layer list stacked inside the program: the layout bug the
    stacked layout removed."""
    num_layers, d = 4, 8
    layers = [_meta(d) for _ in range(num_layers)]
    trace = contracts.trace_program("fixture/restack", lambda ls: torch.sum(torch.stack(ls) * 2.0), layers,
                                    stacked_shapes={(num_layers, d)})
    return contracts.check_trace_rules(trace)


@_fixture("dtype64")
def silent_f64() -> List[Violation]:
    """A float32 input promoted to float64 mid-program."""
    trace = contracts.trace_program("fixture/dtype64", lambda x: torch.sum(x.double() * 2.0), _meta(4))
    return contracts.check_trace_rules(trace)


@_fixture("callback")
def host_read_in_body() -> List[Violation]:
    """A host read smuggled into a program: one round trip per run."""
    trace = contracts.trace_program("fixture/callback", lambda x: x * float(x.sum()), _meta(4))
    return contracts.check_trace_rules(trace)


@_fixture("leaf-budget")
def per_layer_signature() -> List[Violation]:
    """A client signature that takes one tensor per layer: the O(L · k)
    dispatch that the stacked layout retired."""

    def trace(num_layers):
        layers = [_meta(8) for _ in range(num_layers)]
        return contracts.trace_program("fixture/leaf-budget", lambda ls: sum(ls) * 2.0, layers)

    return contracts.check_leaf_budget(trace(4), trace(8))


def _flat_cost_curve() -> contracts.ScalingCurve:
    """A fake gather-mode program that runs every layer and only pretends to
    honor the active count: its cost curve is flat."""
    num_layers, d = 4, 16
    weights, x = _meta(num_layers, d, d), _meta(d)

    def f(x, weights, k: int):  # k never selects anything
        h = x
        for w in weights:
            h = torch.tanh(h @ w)
        return h

    flops, nbytes = [], []
    for frac in contracts.FRACTIONS:
        run = run_on_meta(f, x, weights, max(1, round(frac * num_layers)))
        flops.append(run.flops)
        nbytes.append(run.bytes_accessed)
    return contracts.ScalingCurve("fixture/flat-cost", contracts.FRACTIONS, tuple(flops), tuple(nbytes))


@_fixture("flops-linear")
def flat_flops() -> List[Violation]:
    return [v for v in contracts.check_curve(_flat_cost_curve()) if v.rule == "flops-linear"]


@_fixture("bytes-linear")
def flat_bytes() -> List[Violation]:
    return [v for v in contracts.check_curve(_flat_cost_curve()) if v.rule == "bytes-linear"]


def _clients(n: int = 3, d: int = 8):
    return [{"a": _meta(d), "b": _meta(d)} for _ in range(n)]


def _mean(trees):
    return {k: sum(t[k] for t in trees) / len(trees) for k in trees[0]}


@_fixture("finite-guard")
def unguarded_aggregation() -> List[Violation]:
    """An aggregation with the screen deleted: a NaN client update would
    average straight into the global PEFT."""
    trace = contracts.trace_program("fixture/finite-guard", _mean, _clients())
    return contracts.check_finite_guard(trace)


@_fixture("uplink-callback")
def host_roundtrip_in_uplink() -> List[Violation]:
    """A dequantize-then-aggregate uplink with a copy to the host wedged
    between the two: the silent transfer the uplink contract forbids."""
    from repro_torch.federated import compression as comp_lib

    wire = [comp_lib.quantize_int8(c) for c in _clients()]

    def fn(wire):
        dense = [comp_lib.dequantize_int8(v, s) for v, s in wire]
        # repro-lint: disable=TXH002 — the planted round trip
        dense = [{k: x.cpu().to(x.device) for k, x in t.items()} for t in dense]
        return _mean(dense)

    return contracts.check_uplink(contracts.trace_program("fixture/uplink-callback", fn, wire))


# -------------------------------------------------------- recompile fixture
@_fixture("recompile")
def plan_churn() -> List[Violation]:
    """A launch plan keyed on a value that changes every call: one plan
    miss (a set-up) each, through the port's own plan cache."""
    from repro_torch.kernels import ops

    plans: dict = {}
    with CompilationCounter() as counter:
        for s in range(5):
            ops._plan(plans, 100 + s, lambda s=s: s, "fixture")
    if counter.count > 1:
        return [Violation("recompile", "fixture/plan-churn",
                          f"{counter.count} set-up(s) for 5 calls varying one plan key (budget 1)",
                          "make the varying value a tensor argument, or bucket it so the set of plans is bounded")]
    return []


def run_fixture(rule_id: str) -> List[Violation]:
    """Run one fixture; raises KeyError for an unknown rule id."""
    return FIXTURES[rule_id]()


def self_test() -> Dict[str, bool]:
    """rule id -> was the deliberately bad program caught by that rule?"""
    return {rule_id: any(v.rule == rule_id for v in fn()) for rule_id, fn in FIXTURES.items()}
