"""End-to-end federated fine-tuning driver, as ``repro.launch.train``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --method droppeft --rounds 20 --peft lora

Runs the whole DropPEFT system (STLD local fine-tuning, the bandit
dropout-rate configurator, PTLS aggregation) over the synthetic federated
task through ``repro_torch.api.build``, with the same options, defaults and
output as the reference's CLI: the per-round report, the global PEFT tree
saved under ``--ckpt-dir`` and the history JSON at ``--out``.  Without
``--smoke`` the assigned full config runs, at full width; ``--smoke``
selects the reduced per-arch config.  Either runs on the CUDA card
(``--device cuda``, the default), or on the kernels' plain twins with
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --rounds 3 --devices 4 \\
        --cohort 4 --local-steps 2 --batch-size 8 --device cpu

``--state-dir`` saves the resumable run state each round, and ``--resume``
continues bit-exactly from the newest snapshot there.  ``--schedule``
selects the virtual-clock scheduling policy (``sync`` barrier, ``deadline``
with ``--deadline``/``--straggler``, FedBuff-style ``async-buffer`` with
``--buffer-size``/``--staleness-alpha``).  ``--fault-plan`` (a JSON
:class:`~repro_torch.federated.faults.FaultPlan` file) or the ``--fault-*``
shorthand probabilities inject seeded client dropout, bandwidth collapse
and NaN updates; rejected updates land in the report.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import replace as dc_replace

from repro_torch import api
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import ARCH_IDS, FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.federated.faults import FaultPlan


def build_parser() -> argparse.ArgumentParser:
    """The reference CLI's options, defaults and choices, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--method", default="droppeft", choices=api.list_methods())
    ap.add_argument("--peft", default="lora", choices=["lora", "adapter", "bitfit"])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--devices", type=int, default=16)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=1.0, help="Dirichlet non-IIDness")
    ap.add_argument("--stld-mode", default="cond", choices=["cond", "gather"])
    ap.add_argument("--schedule", default=None, choices=["sync", "deadline", "async-buffer"],
                    help="virtual-clock scheduling policy (default sync; --deadline/--straggler imply deadline, "
                         "--buffer-size implies async-buffer)")
    ap.add_argument("--deadline", type=float, default=None, help="round budget in virtual seconds (deadline policy)")
    ap.add_argument("--straggler", default=None, choices=["drop", "carry"],
                    help="what happens to updates that miss the deadline (default drop)")
    ap.add_argument("--buffer-size", type=int, default=None, help="async-buffer: aggregate every K arrivals")
    ap.add_argument("--staleness-alpha", type=float, default=None,
                    help="staleness discount exponent: w = 1/(1+s)^alpha")
    ap.add_argument("--compression", default=None, choices=["none", "int8", "topk", "int8+topk", "auto"],
                    help="uplink delta compression; 'auto' lets the joint bandit pick (dropout rate x level) arms; "
                         "omit for the bit-exact uncompressed path")
    ap.add_argument("--topk-fraction", type=float, default=None,
                    help="fraction of entries top-k sparsification keeps per leaf (default 0.1)")
    ap.add_argument("--fault-plan", default=None,
                    help="JSON FaultPlan file (repro_torch.federated.faults); the --fault-* flags override its fields")
    ap.add_argument("--fault-dropout", type=float, default=None, help="per-job client mid-round dropout probability")
    ap.add_argument("--fault-nan", type=float, default=None, help="per-job corrupted (NaN) update probability")
    ap.add_argument("--fault-bandwidth", type=float, default=None, help="per-job bandwidth-collapse probability")
    ap.add_argument("--fault-seed", type=int, default=None, help="fault-plan RNG seed (default: --seed)")
    ap.add_argument("--mean-rate", type=float, default=0.5)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--target-acc", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="results/checkpoints")
    ap.add_argument("--state-dir", default=None, help="save resumable run state each round to this dir")
    ap.add_argument("--resume", action="store_true", help="resume from the newest run-state checkpoint")
    ap.add_argument("--out", default="results/train_history.json")
    ap.add_argument("--device", default="cuda", help="cuda (the default, the card) or cpu (the plain twins)")
    return ap


def fault_plan_from(args):
    """``--fault-plan``'s plan with the ``--fault-*`` overrides, or a plan
    of the shorthand flags alone (its seed ``--seed`` unless
    ``--fault-seed``), or None."""
    fault_kw = {k: v for k, v in (("dropout_prob", args.fault_dropout), ("nan_update_prob", args.fault_nan),
                                  ("bandwidth_collapse_prob", args.fault_bandwidth), ("seed", args.fault_seed))
                if v is not None}
    if args.fault_plan:
        plan = FaultPlan.from_file(args.fault_plan)
        return dc_replace(plan, **fault_kw) if fault_kw else plan
    if fault_kw:
        fault_kw.setdefault("seed", args.seed)
        return FaultPlan(**fault_kw)
    return None


def build_kwargs(args, fault_plan) -> dict:
    """The keywords ``main`` hands ``api.build`` (the method first)."""
    return dict(
        cfg=get_config(args.arch, smoke=args.smoke),
        peft_cfg=PEFTConfig(method=args.peft),
        stld_cfg=STLDConfig(mode=args.stld_mode, mean_rate=args.mean_rate),
        fed_cfg=FederatedConfig(num_devices=args.devices, devices_per_round=args.cohort,
                                local_steps=args.local_steps, batch_size=args.batch_size, rounds=args.rounds,
                                dirichlet_alpha=args.alpha, seed=args.seed),
        train_cfg=TrainConfig(learning_rate=args.lr, total_steps=args.rounds * args.local_steps),
        cost_model=args.arch,
        seed=args.seed,
        schedule=args.schedule,
        deadline_s=args.deadline,
        straggler=args.straggler,
        buffer_size=args.buffer_size,
        staleness_alpha=args.staleness_alpha,
        compression=args.compression,
        topk_fraction=args.topk_fraction,
        checkpoint_dir=args.state_dir,
        resume=args.resume,
        fault_plan=fault_plan,
        device=args.device,
    )


def history(args, cfg, runner, res) -> dict:
    """The history JSON, with the reference's keys."""
    return {
        "arch": cfg.name,
        "method": args.method,
        "schedule": runner.schedule.policy,
        "compression": args.compression,
        "accuracy": res.accuracy.tolist(),
        "cum_time_s": res.cum_time_s.tolist(),
        "final_accuracy": res.final_accuracy,
        "traffic_mb": res.traffic_mb.tolist(),
        "energy_j": res.energy_j.tolist(),
        "fault_log": runner.scheduler.fault_log,
    }


def main(argv=None):
    args = build_parser().parse_args(argv)
    fault_plan = fault_plan_from(args)
    kwargs = build_kwargs(args, fault_plan)
    cfg = kwargs["cfg"]

    print(f"== DropPEFT federated fine-tuning: {cfg.name} ({args.method}, {args.peft}) ==")
    t0 = time.time()
    runner = api.build(args.method, **kwargs)
    res = runner.run(rounds=args.rounds, target_accuracy=args.target_acc)

    for r in range(res.rounds):
        print(f"round {r:3d}  acc={res.accuracy[r]:.3f} loss={res.loss[r]:.3f} "
              f"rate={res.rates[r]:.2f} active={res.active_fraction[r]:.2f} "
              f"t={res.cum_time_s[r]/3600:.2f}h mem={res.memory_gb[r]:.1f}GB")
    print(f"final accuracy (all devices): {res.final_accuracy:.3f}")
    if fault_plan is not None:
        rejected = [e for e in runner.scheduler.fault_log if e["reason"] in ("dropout", "non-finite-update")]
        print(f"faults: {len(runner.scheduler.fault_log)} events, {len(rejected)} rejected updates "
              f"({sum(e['burned_compute_s'] for e in rejected):.0f}s compute burned)")
    print(f"wall time: {time.time()-t0:.1f}s (simulated federated: {res.cum_time_s[-1]/3600:.2f}h)")

    os.makedirs(args.ckpt_dir, exist_ok=True)
    save_pytree(runner.state.global_peft, os.path.join(args.ckpt_dir, cfg.name), res.rounds)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(history(args, cfg, runner, res), f, indent=2)
    print(f"history -> {args.out}")
    return runner, res


if __name__ == "__main__":
    main()
