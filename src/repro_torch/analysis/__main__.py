"""The command line: run every analysis pass, exit non-zero on violations, as
``python -m repro.analysis``::

    PYTHONPATH=src python -m repro_torch.analysis              # lint + contracts + guard (sync)
    PYTHONPATH=src python -m repro_torch.analysis --full       # the guard under every schedule policy
    PYTHONPATH=src python -m repro_torch.analysis --self-test  # every negative fixture must be caught
    PYTHONPATH=src python -m repro_torch.analysis --fixture restack   # exit 1 iff the rule fires
    PYTHONPATH=src python -m repro_torch.analysis --list       # rule catalog + allowlist

The guard's experiment runs on the card unless ``--device cpu`` asks for
the CPU (where the kernels' twins set nothing up).
"""
from __future__ import annotations

import argparse
import sys
import time


def _progress(label: str) -> None:
    print(f"  .. {label}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="program contracts on meta + PyTorch-hazard lint + steady-state guard",
    )
    parser.add_argument("--skip-lint", action="store_true")
    parser.add_argument("--skip-contracts", action="store_true")
    parser.add_argument("--skip-recompile", action="store_true")
    parser.add_argument("--full", action="store_true",
                        help="steady-state guard under every schedule policy (default: sync only)")
    parser.add_argument("--algorithms", nargs="*", default=None,
                        help="restrict the contract pass to these registered methods")
    parser.add_argument("--paths", nargs="*", default=None,
                        help="lint these paths instead of the default (src/repro_torch)")
    parser.add_argument("--fixture", metavar="RULE",
                        help="run one negative fixture; exit 1 when the analyzer catches it (expected), 2 when it "
                             "does not (an analyzer bug)")
    parser.add_argument("--self-test", action="store_true",
                        help="run every negative fixture; exit 0 iff all are caught")
    parser.add_argument("--list", action="store_true", help="list rules and allowlist entries")
    parser.add_argument("--device", default=None, help="the guard's device (default: the card)")
    args = parser.parse_args(argv)

    from repro_torch.analysis import contracts, lint_torch
    from repro_torch.analysis.report import render_report

    if args.list:
        print("== lint rules ==")
        for rule in lint_torch.LINT_RULES.values():
            print(f"  {rule.id}  {rule.name}: {rule.description}")
        print("== contract rules ==")
        for crule in contracts.CONTRACT_RULES.values():
            print(f"  {crule.rule_id}: {crule.description}")
        print("  recompile: steady-state runs must not set up new builds, loads or launch plans")
        print("== contract allowlist ==")
        entries = [(rule_id, where, why) for rule_id, m in contracts.ALLOWLIST.items() for where, why in m.items()]
        for rule_id, where, why in entries:
            print(f"  {rule_id} @ {where}: {why}")
        if not entries:
            print("  (empty)")
        return 0

    if args.fixture or args.self_test:
        from repro_torch.analysis import fixtures

        if args.self_test:
            results = fixtures.self_test()
            width = max(len(r) for r in results)
            for rule_id, caught in results.items():
                print(f"  {rule_id:{width}s}  {'caught' if caught else 'MISSED'}")
            missed = [r for r, ok in results.items() if not ok]
            if missed:
                print(f"self-test FAILED: fixtures not caught: {missed}")
                return 2
            print(f"self-test OK: all {len(results)} fixtures caught")
            return 0
        try:
            found = fixtures.run_fixture(args.fixture)
        except KeyError:
            print(f"unknown fixture {args.fixture!r}; one of {sorted(fixtures.FIXTURES)}")
            return 2
        print(render_report(found, title=f"fixture {args.fixture}"))
        if any(v.rule == args.fixture for v in found):
            return 1  # the analyzer caught the planted bug: expected
        print(f"fixture {args.fixture!r} NOT caught — analyzer regression")
        return 2

    failed = False
    t0 = time.time()

    if not args.skip_lint:
        violations = lint_torch.lint_paths(tuple(args.paths) if args.paths else lint_torch.DEFAULT_PATHS)
        print(render_report(violations, title="lint"))
        failed |= bool(violations)

    if not args.skip_contracts:
        print("program contracts:", flush=True)
        violations = contracts.check_algorithms(args.algorithms, progress=_progress)
        print(render_report(violations, title="program contracts"))
        failed |= bool(violations)

    if not args.skip_recompile:
        from repro_torch.analysis.recompile_guard import check_experiment_recompiles

        policies = ("sync", "deadline", "async-buffer") if args.full else ("sync",)
        print("steady-state guard:", flush=True)
        report: dict = {}
        violations = check_experiment_recompiles(policies=policies, device=args.device, progress=_progress,
                                                 report=report)
        for policy, row in report.items():
            print(f"  {policy}: {row}")
        print(render_report(violations, title="steady-state guard"))
        failed |= bool(violations)

    status = "FAILED" if failed else "OK"
    print(f"analysis {status} in {time.time() - t0:.1f}s")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
