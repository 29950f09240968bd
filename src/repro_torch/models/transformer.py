"""The decoders of the port (dense, the ``ssm`` family of RWKV6, the
``hybrid`` family of jamba, the ``moe`` family of granite-moe and
llama4-scout, and the ``vlm`` family's dense decoder behind its patch
prefix): init, decode caches and the forward pass.  ``stack_apply`` also
runs whisper's encoder and decoder stacks (``models.encdec``), the
decoder's layers with their encoder K/V (``enc_kvs``).

Homogeneous stacks (dense, ``ssm``, ``moe``) keep the stacked ``(L, ...)``
layout of the JAX package; jamba's heterogeneous stack is a per-layer
list, as there.
``stack_apply`` loops over the layers in Python for every ``stack_mode``
of the JAX package: ``unroll``, ``scan`` (a ``lax.scan`` over the stacked
layers), ``group`` (a ``lax.scan`` over periods of the layer pattern) and
``gather`` (gather-mode STLD: the active layers' indices) compute the same
thing there, and each raises here where it raises there.  STLD gates
(``drops``) are host-side booleans: a dropped layer is skipped by
``stld.gate``'s Python branch, so it launches no kernel and saves no
activation; a gathered step is the step whose gates drop every layer
outside its indices.

A cohort of N devices (``devices``) folds its devices into the batch: the
gates are (N, L), and each layer runs once, on the rows of the devices
whose gate is open (gathered by ``index_select`` and written back out of
place by ``index_copy``); a layer no device opens runs nothing, and one
every device opens runs on ``h`` itself.  Each device's rows see exactly
the layers its own gates open, as its own forward would.

Decode caches (``init_caches``) come in the reference's two layouts: a
per-layer list (any stack; jamba's is heterogeneous) or one stacked tree
(homogeneous stacks).  ``stack_apply`` runs them for every family: an
attention layer's KV ring is written in place, an RWKV6 or Mamba layer
returns its new state, and a dropped layer passes its cache through, as
``stld.gate`` does.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import stld
from repro_torch.models import stacking
from repro_torch.models.layers import init_layer, init_layer_cache, layer_apply, model_norm
from repro_torch.nn.initializers import normal_init
from repro_torch.nn.norms import apply_norm


def _stack_layers(layers, num_layers: int):
    """Per-layer trees, taken one at a time, copied into one stacked
    ``(L, ...)`` tree allocated when the first arrives: at most one layer
    is held beside the stack."""
    stack = None
    for l, layer in enumerate(layers):
        if stack is None:
            stack = stacking.tree_map(lambda t: t.new_empty((num_layers, *t.shape)), layer)
        stacking.tree_map(lambda dst, src: dst[l].copy_(src), stack, layer)
    return stack


def init_lm(cfg, generator: torch.Generator, layout: str = "auto", place=None):
    """Parameters with the shapes and dtypes of ``transformer.init_lm``
    (float32), drawn on the generator's device, in the reference's
    ``layout`` (``stacking.in_layout``: ``auto`` stacks a homogeneous stack
    and keeps a hybrid stack's per-layer list, ``stacked`` raises for a
    hybrid stack, ``list`` keeps one tree a layer; every layout holds the
    same draws).  ``place(name, tree)``, when given, takes each top-level
    entry (``embed``, ``lm_head``, ``final_norm``, and ``layers`` whole or,
    for a hybrid or ``moe`` stack, layer by layer) as soon as it is drawn
    and returns what to keep, so that the float32 draws of a large hybrid,
    MoE or VLM model are never held whole: a ``moe`` or ``vlm`` stack's
    placed layers go one by one into a stack allocated at the first (a
    stacked float32 draw of one of internvl2-76b's MLP projections is
    ~0.9 GB a layer)."""
    stacking.check_layout(layout)
    place = place or (lambda name, tree: tree)
    L = cfg.num_layers
    params = {"embed": place("embed", normal_init(generator, (cfg.vocab_size, cfg.d_model)))}
    if cfg.family == "hybrid" or (cfg.family in ("moe", "vlm") and layout == "list"):
        layers = [place("layers", init_layer(cfg, l, generator)) for l in range(L)]
        params["layers"] = stacking.maybe_stack(layers, layout)
    elif cfg.family in ("moe", "vlm"):
        params["layers"] = _stack_layers((place("layers", init_layer(cfg, l, generator)) for l in range(L)), L)
    elif cfg.family == "ssm":
        params["layers"] = stacking.in_layout(place("layers", init_layer(cfg, 0, generator, lead=(L,))), layout, L)
    else:  # each stacked projection placed as drawn, then the rest of the stack
        layers = init_layer(cfg, 0, generator, lead=(L,), place=lambda tree: place("layers", tree))
        params["layers"] = stacking.in_layout(place("layers", layers), layout, L)
    params["final_norm"] = place("final_norm", model_norm(cfg, generator))
    if not cfg.tie_embeddings:
        params["lm_head"] = place("lm_head", normal_init(generator, (cfg.d_model, cfg.vocab_size)))
    return params


def init_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None, layout: str = "list"):
    """Per-layer decode caches (``init_layer_cache``), as
    ``repro.models.transformer.init_caches``: a list, or with
    ``layout="stacked"`` (homogeneous stacks only) one tree whose leaves
    carry a leading ``(L, ...)`` axis, e.g. ``{"k", "v": (L, B, S, KV, hd),
    "pos": (L,)}``."""
    caches = [init_layer_cache(cfg, l, batch, max_len, dtype, device) for l in range(cfg.num_layers)]
    if layout == "stacked":
        if not stacking.is_stackable(caches):
            raise ValueError("stacked caches need a homogeneous stack")
        return stacking.from_layer_list(caches, stacked=True)
    if layout != "list":
        raise ValueError(f"unknown cache layout {layout!r}")
    return caches


def _write_layer_cache(caches, l: int, new):
    """Layer ``l``'s new cache into a stacked cache tree, in place; a leaf
    already written in place (a KV ring, a dropped layer's cache) is left
    as it is."""
    for name, t in new.items():
        dst = caches[name][l]
        if t.data_ptr() != dst.data_ptr():
            dst.copy_(t)


# ``gather_unroll`` is the reference's gather over a Python loop (its
# ``make_train_step`` picks it for a gathered step under ``unroll``): here
# it is ``gather``
STACK_MODES = ("unroll", "scan", "group", "gather", "gather_unroll")
GATHER_MODES = ("gather", "gather_unroll")


def check_stack_mode(stack_mode: str):
    """``ValueError`` for a ``stack_mode`` that is not one of
    ``STACK_MODES``."""
    if stack_mode not in STACK_MODES:
        raise ValueError(f"unknown stack_mode {stack_mode!r}")


def _mode_gates(layers, cfg, stack_mode: str, drops, active_idx, devices):
    """The gates a ``stack_mode`` runs: ``drops`` as given, or for
    ``gather`` the complement of ``active_idx`` (one index tensor, or one
    per device of a cohort; their counts may differ).  Raises
    ``ValueError`` where the reference's ``stack_apply`` does: ``scan`` and
    the gather modes on a heterogeneous stack, ``group`` when the layer
    pattern's period does not divide the depth."""
    check_stack_mode(stack_mode)
    num_layers = stacking.stack_size(layers)
    if stack_mode in ("scan", *GATHER_MODES) and not (stacking.is_stacked(layers)
                                                      or stacking.is_stackable(list(layers))):
        raise ValueError(f"stack_mode={stack_mode!r} requires a homogeneous stack")
    if stack_mode == "group" and num_layers % cfg.layer_period:
        raise ValueError("group mode requires num_layers % layer_period == 0")
    if stack_mode not in GATHER_MODES:
        return drops
    if active_idx is None:
        raise ValueError("gather mode needs active_idx")
    if devices is None:
        return stld.drops_from_indices(active_idx, num_layers)
    return torch.stack([stld.drops_from_indices(idx, num_layers) for idx in active_idx])


def _cohort_stack_apply(layers, cfg, h, *, positions, causal, drops, peft, lora_scale, devices: int, enc_kvs=None):
    """``stack_apply`` for a cohort: ``h`` (N * B, S, d) device-major, drops
    None or (N, L) host-side gates, ``peft`` None or a per-layer list of
    trees with (N, ...) leaves, ``enc_kvs`` None or each layer's encoder
    K/V of (N * B, ...) rows, device-major.  The aux loss is (N,), each
    device's summed over its own active layers (0.0 without MoE)."""
    num_layers = stacking.stack_size(layers)
    gates = torch.zeros((devices, num_layers), dtype=torch.bool) if drops is None else torch.as_tensor(drops)
    if tuple(gates.shape) != (devices, num_layers):
        raise ValueError(f"gates of shape {tuple(gates.shape)} for {devices} devices and {num_layers} layers")
    open_rows = (~gates.bool()).t().tolist()  # per layer, per device
    aux_sum = 0.0
    for l in range(num_layers):
        take = [i for i, is_open in enumerate(open_rows[l]) if is_open]
        if not take:
            continue
        params_l = stacking.layer_view(layers, l)
        peft_l = stacking.layer_view(peft, l) if peft is not None else None
        enc_kv_l = stacking.layer_view(enc_kvs, l) if enc_kvs is not None else None
        if len(take) == devices:
            h, aux, _ = layer_apply(params_l, cfg, h, positions=positions, causal=causal, enc_kv=enc_kv_l,
                                    peft=peft_l, lora_scale=lora_scale, devices=devices)
            aux_sum = aux_sum + aux
            continue
        idx = torch.tensor(take, device=h.device)
        hd = h.view(devices, -1, *h.shape[1:])
        sub = hd.index_select(0, idx).view(-1, *h.shape[1:])
        if peft_l is not None:
            peft_l = stacking.tree_map(lambda t: t.index_select(0, idx), peft_l)
        if enc_kv_l is not None:  # the open devices' rows of the encoder K/V
            enc_kv_l = stacking.tree_map(
                lambda t: t.reshape(devices, -1, *t.shape[1:]).index_select(0, idx).reshape(-1, *t.shape[1:]), enc_kv_l)
        out, aux, _ = layer_apply(params_l, cfg, sub, positions=positions, causal=causal, enc_kv=enc_kv_l,
                                  peft=peft_l, lora_scale=lora_scale, devices=len(take))
        h = hd.index_copy(0, idx, out.view(len(take), *hd.shape[1:])).view(h.shape)
        if isinstance(aux, torch.Tensor):  # 0.0 for a layer without MoE
            aux_sum = aux_sum + torch.zeros((devices,), dtype=aux.dtype, device=aux.device).index_copy(0, idx, aux)
    return h, aux_sum, None


def _run_layer(h, params_l, enc_kv_l, peft_l, cfg, positions, causal: bool, lora_scale: float, tp=None):
    """One cache-free layer for ``torch.utils.checkpoint`` (``remat``): the
    layer's tensors come in as arguments, none closed over, so the
    recompute in the backward takes the ones the forward took."""
    return layer_apply(params_l, cfg, h, positions=positions, causal=causal, enc_kv=enc_kv_l, peft=peft_l,
                       lora_scale=lora_scale, tp=tp)


def stack_apply(layers, cfg, h, *, positions, causal: bool = True, drops=None, caches=None, enc_kvs=None,
                peft=None, lora_scale: float = 1.0, devices=None, stack_mode: str = "unroll", active_idx=None,
                remat: bool = False, tp=None):
    """Run the layer stack (either layout).  Returns (h, the MoE aux loss
    summed over the active layers, new_caches).  ``caches`` in the stacked
    layout are updated in place and returned; in the list layout a new
    list comes back (the KV rings written in place, the recurrent states
    new tensors).  ``enc_kvs`` (either layout) gives each ``encdec``
    layer its encoder K/V.

    ``drops``: None or L host-side gates (a CPU bool tensor or a sequence),
    True = the layer is dropped and passes ``h`` (and its cache) through.
    ``stack_mode`` ``"gather"`` takes ``active_idx`` (the active layers'
    indices) instead of ``drops`` (``_mode_gates``).
    ``devices`` N: a cohort (``_cohort_stack_apply``), with (N, L) gates
    (or N index tensors), no caches and a per-layer list PEFT tree; the aux
    loss is then (N,).

    ``remat``: each active layer runs under ``torch.utils.checkpoint``
    (non-reentrant: ``torch.autograd.grad`` takes the gradients), as the
    reference wraps ``layer_apply`` in ``jax.checkpoint``.  Autograd then
    keeps only the layer's input, and the backward runs the layer's
    forward again, its kernels included, up to the last tensor it saved.
    A dropped layer stays a skip; without gradients (``torch.no_grad``) or
    with decode caches it changes nothing.  A cohort (``devices``) takes no
    ``remat``: the reference's vmapped client step never passes it.

    ``tp`` (a ``sharding.collectives.Comm``) runs each layer's part of a
    tensor-parallel step (``layer_apply``), ``remat`` included (the
    recompute runs the layer's collectives again); a cohort takes none.
    """
    drops = _mode_gates(layers, cfg, stack_mode, drops, active_idx, devices)
    if devices is not None and tp is not None:
        raise ValueError("a cohort (devices) runs unsharded, as the reference's vmapped client step does")
    if devices is not None:
        if remat:
            raise ValueError("a cohort (devices) runs without remat, as the reference's client step does")
        if caches is not None:
            raise ValueError("a cohort runs without decode caches")
        return _cohort_stack_apply(layers, cfg, h, positions=positions, causal=causal, drops=drops, peft=peft,
                                   lora_scale=lora_scale, devices=devices, enc_kvs=enc_kvs)
    num_layers = stacking.stack_size(layers)
    gates = [False] * num_layers if drops is None else [bool(d) for d in torch.as_tensor(drops).tolist()]
    if len(gates) != num_layers:
        raise ValueError(f"{len(gates)} gates for {num_layers} layers")
    stacked_caches = caches is not None and stacking.is_stacked(caches)
    remat = remat and caches is None and torch.is_grad_enabled()
    aux_sum, new_caches = 0.0, []
    for l in range(num_layers):
        cache_l = stacking.layer_view(caches, l) if caches is not None else None

        def block(h, cache_l):
            params_l = stacking.layer_view(layers, l)
            enc_kv_l = stacking.layer_view(enc_kvs, l) if enc_kvs is not None else None
            peft_l = stacking.layer_view(peft, l) if peft is not None else None
            if remat:  # the layers draw no random numbers: no RNG state to stash
                h, aux, _ = torch.utils.checkpoint.checkpoint(
                    _run_layer, h, params_l, enc_kv_l, peft_l, cfg, positions, causal, lora_scale, tp,
                    use_reentrant=False, preserve_rng_state=False)
                return h, aux, cache_l
            return layer_apply(params_l, cfg, h, positions=positions, causal=causal, cache=cache_l, enc_kv=enc_kv_l,
                               peft=peft_l, lora_scale=lora_scale, tp=tp)

        h, aux, cache_l = stld.gate(block, gates[l], h, cache_l)
        if not gates[l]:  # a dropped layer's aux is 0: the sum keeps the type of the kept layers'
            aux_sum = aux_sum + aux
        if stacked_caches:
            _write_layer_cache(caches, l, cache_l)
        new_caches.append(cache_l)
    if caches is None:
        return h, aux_sum, None
    return h, aux_sum, caches if stacked_caches else new_caches


def lm_apply(params, cfg, tokens, *, positions=None, prefix_embeds=None, drops=None, caches=None, peft=None,
             lora_scale: float = 1.0, devices=None, stack_mode: str = "unroll", active_idx=None,
             remat: bool = False, tp=None):
    """Decoder-only LM forward.  tokens: (B, S) int.  Returns (logits, the
    MoE aux loss, new_caches); the caches' K/V tensors are updated in place.
    ``prefix_embeds`` (B, P, d) (the VLM's patch embeddings) go before the
    token embeddings, so positions run 0 .. P+S-1 and the logits cover the
    prefix too.

    ``devices`` N: a cohort, tokens (N, B, S) (and a prefix of N * B rows,
    device-major); the logits come back (N * B, S, V), device-major, and
    the aux loss (N,) (``stack_apply``, as is ``remat``).

    ``tp`` (a ``sharding.collectives.Comm``) runs this rank's part of a
    tensor-parallel forward: ``embed`` (and ``lm_head``) hold the rank's
    V / tp rows (columns), the lookup is ``Comm.embed``'s, the layers are
    ``stack_apply``'s, and the logits come back as the rank's (B, S, V /
    tp) slice of the vocabulary (``losses.softmax_xent`` takes them so);
    the decode caches are the rank's parts (``nn.attention``)."""
    compute_dtype = getattr(torch, cfg.dtype)
    if devices is not None:
        tokens = tokens.reshape(-1, tokens.shape[-1])
    if tp is not None:
        if prefix_embeds is not None:
            raise NotImplementedError("the tensor-parallel forward takes no prefix")
        h = tp.embed(params["embed"], tokens, compute_dtype)
    else:
        h = params["embed"][tokens].to(compute_dtype)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(device=h.device, dtype=compute_dtype), h], dim=1)
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    h, aux, new_caches = stack_apply(
        params["layers"], cfg, h, positions=positions, causal=True, drops=drops, caches=caches,
        peft=peft, lora_scale=lora_scale, devices=devices, stack_mode=stack_mode, active_idx=active_idx,
        remat=remat, tp=tp,
    )
    h = apply_norm(params["final_norm"], h, cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if tp is not None:
        h = tp.enter(h)
    return h @ head.to(compute_dtype), aux, new_caches
