"""The port's analysis passes (``repro_torch.analysis``) on the CPU.

* Lint: on the reference's own fixture sources and on a few more, the
  rules the two lints share (host sync in a loop, JXH002 -> TXH002; mutable
  default, JXH004 -> TXH004; PYL001; PYL002) give the same rule ids (under
  that mapping) and the same lines as ``repro.analysis.lint_jax.lint_source``;
  the suppression syntax is the reference's; ``src/repro_torch`` lints clean.
* Fixtures: each rule's planted bug is caught by that rule, ``self_test()``
  catches all (the reference's ``dtype64`` fixture and self-test fail in the
  reference; the port's pass), and every rule has a fixture.
* The CLI: ``python -m repro_torch.analysis`` exits 0 on the tree (lint,
  the program contracts over every registered algorithm, the steady-state
  guard on the CPU), ``--fixture restack`` exits 1, ``--self-test`` 0.
"""
import textwrap

import pytest

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.analysis import fixtures as jax_fixtures
from repro.analysis import lint_jax
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import contracts, fixtures, lint_torch
from repro_torch.analysis.recompile_guard import DEFAULT_BUDGETS
from repro.analysis.recompile_guard import DEFAULT_BUDGETS as JAX_DEFAULT_BUDGETS

SHARED = {"JXH002": "TXH002", "JXH004": "TXH004", "PYL001": "PYL001", "PYL002": "PYL002"}

_EXTRA_SOURCES = {
    "float_of_subscript_in_for": """
        def total(xs, idx):
            out = 0.0
            for i in idx:
                out += float(xs[i])
            return out
        """,
    "item_in_while_and_genexp": """
        def drain(q):
            while q:
                v = q.pop().item()
            return sum(int(t[0]) for t in q)
        """,
    "defaults_and_shadows": """
        import json
        import os
        import sys  # noqa: F401 - a deliberate re-export

        def f(a, b={}, *, c=set(), d=list()):
            max = a
            return max

        def g(id, type=None):
            return os.path.join(id, type)
        """,
    "clean": """
        import math

        def norm(xs):
            return math.sqrt(sum(x * x for x in xs))
        """,
}


def _reference_fixture_sources():
    """The sources the reference's lint fixtures plant, captured as its
    ``_lint`` receives them."""
    seen = {}

    def capture(source):
        seen[len(seen)] = textwrap.dedent(source)
        return []

    original = jax_fixtures._lint
    jax_fixtures._lint = capture
    try:
        for rule_id, fn in jax_fixtures.FIXTURES.items():
            if rule_id.startswith(("JXH", "PYL")):
                fn()
    finally:
        jax_fixtures._lint = original
    return [src for _, src in sorted(seen.items())]


def _shared(found, rules):
    return sorted((v.where, v.rule) for v in found if v.rule in rules)


@pytest.mark.parametrize("source", _reference_fixture_sources() + [textwrap.dedent(s) for s in _EXTRA_SOURCES.values()])
def test_shared_rules_match_the_reference_lint(source):
    theirs = [(where, SHARED[rule]) for where, rule in _shared(lint_jax.lint_source(source, "s.py"), SHARED)]
    ours = _shared(lint_torch.lint_source(source, "s.py"), SHARED.values())
    assert ours == sorted(theirs)


def test_extra_sources_exercise_every_shared_rule():
    found = {v.rule for s in _EXTRA_SOURCES.values() for v in lint_torch.lint_source(textwrap.dedent(s), "s.py")}
    assert set(SHARED.values()) <= found


@pytest.mark.parametrize("src,clean", [
    ("def pull(r, pos):\n    return [r[i].item() for i in pos]  # repro-lint: disable=TXH002\n", True),
    ("def pull(r, pos):\n    # repro-lint: disable=TXH002 - host list\n    return [r[i].item() for i in pos]\n", True),
    ("def acc(x, a=[]):  # repro-lint: disable=all\n    return a\n", True),
    ("def pull(r, pos):\n    return [r[i].item() for i in pos]  # repro-lint: disable=TXH004\n", False),
    ("def pull(r):\n    return [t for t in r.tolist()]\n", True),  # the iterable is read once
])
def test_suppression_and_per_iteration_parts(src, clean):
    assert (lint_torch.lint_source(src, "t.py") == []) == clean


def test_port_package_lints_clean():
    violations = lint_torch.lint_paths()
    assert violations == [], "\n".join(v.render() for v in violations)


# ----------------------------------------------------------------- fixtures
@pytest.mark.parametrize("rule_id", list(fixtures.FIXTURES))
def test_fixture_caught(rule_id):
    """Each deliberately bad program fires its own rule."""
    assert any(v.rule == rule_id for v in fixtures.run_fixture(rule_id)), rule_id


def test_self_test_catches_every_fixture():
    assert all(fixtures.self_test().values())


def test_rule_catalog_complete():
    """Every lint and contract rule, and the guard, has a fixture."""
    assert set(fixtures.FIXTURES) == set(lint_torch.LINT_RULES) | set(contracts.CONTRACT_RULES) | {"recompile"}
    assert "JXH003" not in fixtures.FIXTURES  # no static_argnames: the port jits nothing
    assert DEFAULT_BUDGETS == JAX_DEFAULT_BUDGETS


def test_violation_carries_location_and_hint():
    (v,) = [v for v in fixtures.run_fixture("TXH004") if v.rule == "TXH004"]
    assert "fixture.py" in v.where and v.hint


# ---------------------------------------------------------------------- CLI
def test_cli_exits_zero_on_the_tree(capsys):
    assert cli.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "== lint: 0 violation(s) ==" in out and "== program contracts: 0 violation(s) ==" in out
    assert "== steady-state guard: 0 violation(s) ==" in out


@pytest.mark.parametrize("argv,code", [(["--fixture", "restack"], 1), (["--self-test"], 0), (["--list"], 0),
                                       (["--fixture", "nope"], 2)])
def test_cli_fixture_self_test_and_list(argv, code, capsys):
    assert cli.main(argv) == code
