"""Entry points of the port, as ``repro.api``.

``experiment`` runs one federated fine-tuning experiment and returns its
:class:`~repro_torch.federated.runner.SimResult`; ``build`` returns the
:class:`~repro_torch.federated.runner.ExperimentRunner` when the caller
needs the trained state afterwards::

    from repro_torch import api

    result = api.experiment("droppeft", "qwen3-1.7b", smoke=False, rounds=3)
    print(result.final_accuracy, result.accuracy, result.cum_time_s)

    runner = api.build("droppeft", "qwen3-1.7b", smoke=False, seed=0)
    result = runner.run(rounds=3)
    peft = runner.state.global_peft  # the global LoRA tree, on the card

They take the reference's keywords plus ``device``.  ``checkpoint_dir``
saves the round state every ``checkpoint_every`` rounds, and ``resume=True``
continues from the newest snapshot there, bit-identically::

    api.build("droppeft", smoke=False, checkpoint_dir="ckpts").run(rounds=2)
    runner = api.build("droppeft", smoke=False, checkpoint_dir="ckpts", resume=True)
    result = runner.run(rounds=3)  # rounds 3 only; as one run of 3 rounds

``stld_mode="gather"`` draws a static count of active layers a round;
``schedule="deadline"`` (``deadline_s``, ``straggler="drop"`` or
``"carry"``) and ``schedule="async-buffer"`` (``buffer_size``,
``staleness_alpha``) run the virtual clock's straggler-tolerant policies;
``compression="int8"``, ``"topk"`` or ``"int8+topk"`` (``topk_fraction``)
compresses the uplink with error feedback, and ``compression="auto"`` (or
``{"tune": True}``) lets a joint bandit pick each device's (dropout rate,
compression level) arm; ``fault_plan`` injects client dropouts, bandwidth
collapses, NaN updates, churn and server kills::

    runner = api.build("droppeft", smoke=False, stld_mode="gather", schedule="deadline", deadline_s=60.0,
                       straggler="carry", compression="int8+topk", fault_plan={"dropout_prob": 0.1})

``peft`` picks the PEFT kind: ``"lora"`` (``lora_rank``), ``"adapter"``
(Houlsby bottlenecks of ``adapter_dim``), ``"bitfit"`` (biases) or
``"none"``.  Every method of ``list_methods()`` runs; ``fedhetlora`` gives
each device the LoRA rank of its hardware tier (4, 8 or 16).
``cohort_mode="auto"`` runs ``"batched"`` (one grouped launch a layer for
the whole cohort) for every method but one that ``requires_sequential``
(``fedhetlora``), which runs ``"sequential"``, as the reference does.

``serve`` builds a ready multi-tenant LoRA server, its adapters given as
trees or read from a federated run's checkpoint (every client as
``client<id>``, the global adapter as ``client_global``)::

    from repro_torch import api
    from repro_torch.serving.batcher import Request

    batcher = api.serve(adapters={"client0": tree0, "client1": tree1}, batch=8)
    batcher = api.serve(smoke=False, checkpoint_dir="ckpts", batch=8)
    batcher.submit(Request(prompt=[5, 7, 11], adapter="client0", max_new_tokens=32))
    for c in batcher.run():  # Completion(uid, adapter, tokens, finish_reason)
        print(c.adapter, c.finish_reason, c.tokens)

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``; it never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from repro_torch.configs import FederatedConfig, PEFTConfig, STLDConfig, TrainConfig, get_config
from repro_torch.federated.algorithms import FederatedAlgorithm, get_algorithm, registered_methods
from repro_torch.federated.compression import CompressionConfig, resolve_compression
from repro_torch.federated.runner import ExperimentRunner, SimResult, fresh_algorithm
from repro_torch.federated.scheduler import ScheduleConfig, resolve_schedule

__all__ = ["build", "experiment", "replicate", "serve", "list_methods", "ScheduleConfig", "CompressionConfig"]


def list_methods() -> List[str]:
    """Names accepted by ``method=`` (the algorithm registry)."""
    return registered_methods()


def _resolve_algorithm(method, fixed_rate: Optional[float]) -> FederatedAlgorithm:
    if isinstance(method, str):
        algorithm: FederatedAlgorithm = get_algorithm(method)()
    elif isinstance(method, FederatedAlgorithm):
        algorithm = method
    else:
        raise TypeError(f"method must be a registered name or a FederatedAlgorithm, got {method!r}")
    if fixed_rate is not None:
        # an explicit fixed rate overrides the bandit (0.0 is a valid
        # point); copy first so a caller-owned instance is never mutated
        algorithm = fresh_algorithm(algorithm)
        algorithm.use_configurator = False
        algorithm.fixed_rate = float(fixed_rate)
    return algorithm


def build(
    method: Union[str, FederatedAlgorithm] = "droppeft",
    model: str = "qwen3-1.7b",
    *,
    smoke: bool = True,
    cfg=None,
    model_overrides: Optional[dict] = None,
    # PEFT
    peft: str = "lora",
    lora_rank: Optional[int] = None,
    adapter_dim: Optional[int] = None,
    peft_cfg: Optional[PEFTConfig] = None,
    # STLD
    stld_mode: str = "cond",
    mean_rate: Optional[float] = None,
    distribution: str = "incremental",
    stld_cfg: Optional[STLDConfig] = None,
    # federated round structure
    fed_cfg: Optional[FederatedConfig] = None,
    train_cfg: Optional[TrainConfig] = None,
    # method policy
    fixed_rate: Optional[float] = None,
    # scheduling: a policy name or a ScheduleConfig; the scalar kwargs
    # override fields of whichever config `schedule` resolves to
    schedule: Union[str, ScheduleConfig, None] = None,
    deadline_s: Optional[float] = None,
    straggler: Optional[str] = None,
    buffer_size: Optional[int] = None,
    staleness_alpha: Optional[float] = None,
    compression=None,
    topk_fraction: Optional[float] = None,
    # pinned hardware mix (one profile name per device); None -> sampled
    device_profile: Optional[Sequence[str]] = None,
    # system-model cost scale: None -> the training cfg; an arch name or a
    # ModelConfig -> cost accounting at that scale
    cost_model=None,
    task=None,
    seed: int = 0,
    cohort_mode: str = "auto",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1,
    resume: bool = False,
    fault_plan=None,
    params=None,
    device=None,
) -> ExperimentRunner:
    """A fully wired :class:`ExperimentRunner` (not run yet) on ``device``
    (None = the card).  ``params`` (float32 base weights) replaces the
    weights drawn from ``seed``."""
    if cfg is None:
        cfg = get_config(model, smoke=smoke)
    if model_overrides:
        cfg = cfg.replace(**model_overrides)
    if peft_cfg is None:
        kw = {"method": peft}
        if lora_rank is not None:
            kw["lora_rank"] = lora_rank
        if adapter_dim is not None:
            kw["adapter_dim"] = adapter_dim
        peft_cfg = PEFTConfig(**kw)
    if stld_cfg is None:
        if mean_rate is None:
            mean_rate = 0.5 if fixed_rate is None else fixed_rate
        stld_cfg = STLDConfig(mode=stld_mode, mean_rate=mean_rate, distribution=distribution)
    if isinstance(cost_model, str):
        cost_model = get_config(cost_model)
    return ExperimentRunner(
        cfg,
        peft_cfg,
        stld_cfg,
        fed_cfg or FederatedConfig(),
        train_cfg or TrainConfig(),
        algorithm=_resolve_algorithm(method, fixed_rate),
        task=task,
        cost_cfg=cost_model,
        seed=seed,
        cohort_mode=cohort_mode,
        schedule=resolve_schedule(schedule, deadline_s=deadline_s, straggler=straggler, buffer_size=buffer_size,
                                  staleness_alpha=staleness_alpha),
        device_profile=device_profile,
        checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
        resume=resume,
        fault_plan=fault_plan,
        compression=resolve_compression(compression, topk_fraction=topk_fraction),
        params=params,
        device=device,
    )


def experiment(
    method: Union[str, FederatedAlgorithm] = "droppeft",
    model: str = "qwen3-1.7b",
    *,
    rounds: Optional[int] = None,
    target_accuracy: Optional[float] = None,
    **kwargs,
) -> SimResult:
    """Build and run one federated experiment; returns its SimResult."""
    return build(method, model, **kwargs).run(rounds=rounds, target_accuracy=target_accuracy)


def replicate(
    method: Union[str, FederatedAlgorithm] = "droppeft",
    model: str = "qwen3-1.7b",
    *,
    seeds: Sequence[int] = (0, 1, 2),
    rounds: Optional[int] = None,
    target_accuracy: Optional[float] = None,
    **kwargs,
) -> List[SimResult]:
    """Multi-seed replication: one independent experiment per seed."""
    results = []
    for seed in seeds:
        runner = build(fresh_algorithm(method), model, **dict(kwargs, seed=seed))
        results.append(runner.run(rounds=rounds, target_accuracy=target_accuracy))
    return results

def serve(
    model: str = "qwen3-1.7b",
    *,
    smoke: bool = True,
    cfg=None,
    model_overrides: Optional[dict] = None,
    params=None,
    checkpoint_dir: Optional[str] = None,
    adapters: Optional[dict] = None,
    lora_alpha: float = 16.0,
    batch: int = 4,
    max_len: int = 256,
    n_slots: Optional[int] = None,
    stack_mode: str = "scan",
    cache_dtype: str = "bfloat16",
    seed: int = 0,
    device=None,
):
    """Multi-tenant adapter serving: a ready
    :class:`~repro_torch.serving.batcher.ContinuousBatcher`, for the
    ``dense``, ``moe`` and ``vlm`` families, whose layers carry no recurrent
    state (``ssm`` and ``hybrid`` raise ``NotImplementedError``, and so does
    ``audio``: the reference's batcher decodes without the encoder's cross
    K/V).  A ``vlm`` model serves text prompts, with no patches, as the
    reference serves it.

    Adapters come from a federated ``save_state`` checkpoint
    (``checkpoint_dir``: every client's adapter registers as
    ``client<id>``, the global one as ``client_global``) and/or a
    ``{name: LoRA tree}`` dict.  ``params=None`` draws random weights from
    ``seed`` on the device, each part cast to ``cfg.dtype`` as it is drawn;
    given weights are cast once here.  The float32 masters are not kept.
    ``model_overrides`` replace fields of the config, as ``build``'s do;
    ``stack_mode`` is the serve step's (``check_stack_mode``; every mode
    runs the one layer loop).
    """
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.registry import init_params, place_params
    from repro_torch.models.transformer import check_stack_mode
    from repro_torch.serving.adapters import AdapterPoolCache, AdapterRegistry
    from repro_torch.serving.batcher import ContinuousBatcher

    check_stack_mode(stack_mode)
    device = torch.device("cuda" if device is None else device)
    if cfg is None:
        cfg = get_config(model, smoke=smoke)
    if model_overrides:
        cfg = cfg.replace(**model_overrides)
    if cfg.family in ("ssm", "hybrid"):
        # the reference's batcher resets only a recycled row's position, so
        # the row would carry the previous request's recurrent state
        raise NotImplementedError(
            f"multi-tenant serving of the {cfg.family!r} family is not ported: the continuous batcher resets "
            "only a recycled row's position, and a recurrent state (RWKV6 wkv and shifts, Mamba conv and ssm) "
            "would carry the previous request into the next; serve it with launch.serve's prefill and generate")
    if cfg.family == "audio":
        # the reference's batcher calls serve_step without enc_kvs, so its
        # decoder would skip cross-attention and ignore the audio
        raise NotImplementedError(
            "multi-tenant serving of the 'audio' family is not ported: the continuous batcher decodes without the "
            "encoder's cross K/V; serve it with launch.serve's prefill and generate")
    registry = AdapterRegistry()
    if checkpoint_dir is not None:
        registry.load_checkpoint(checkpoint_dir, alpha=lora_alpha)
    for name, tree in (adapters or {}).items():
        registry.register(name, tree, alpha=lora_alpha)
    if len(registry) == 0:
        raise ValueError("no adapters: pass checkpoint_dir and/or adapters")
    compute_dtype = getattr(torch, cfg.dtype)
    if params is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        params = init_params(cfg, generator, place=True)
    params = place_params(params, cfg, device)
    pool = AdapterPoolCache(
        registry,
        n_slots=n_slots if n_slots is not None else max(batch, len(registry)),
        dtype=compute_dtype,
        device=device,
    )
    return ContinuousBatcher(
        make_serve_step(cfg, stack_mode=stack_mode),
        params,
        cfg,
        pool,
        batch=batch,
        max_len=max_len,
        cache_dtype=getattr(torch, cache_dtype),
    )
