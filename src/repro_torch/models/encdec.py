"""Whisper's encoder-decoder (the ``audio`` family; its mel and conv
frontend is a stub), as ``repro.models.encdec``.

The encoder takes frame embeddings (B, frontend_seq, d_model) (zeros from
the stub) plus sinusoidal positions and runs bidirectional ``attn`` layers
with a GELU MLP; the model's own paths give it no PEFT and no gates, as
the reference's do, and ``encode`` takes both.  Each decoder layer (``encdec``)
runs causal self-attention, cross-attention over its encoder K/V
(``encoder_cross_kvs``, computed once a sequence) and a GELU MLP; the
decoder adds learned positions and ties its head to the token embedding.
Both stacks keep the reference's stacked ``(L, ...)`` layout (or with
``layout="list"`` one tree a layer)::

    {"encoder": {"layers", "final_norm"},
     "decoder": {"embed", "pos_embed", "layers", "final_norm"}}
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import stacking
from repro_torch.models.layers import init_layer, init_layer_cache, model_norm
from repro_torch.models.transformer import stack_apply
from repro_torch.nn.attention import cross_slot_positions, encode_cross_kv
from repro_torch.nn.initializers import normal_init
from repro_torch.nn.norms import apply_norm


def sinusoidal_positions(length: int, dim: int, device=None):
    """(length, dim) float32: sin on the even columns, cos on the odd, as
    the reference computes them (float32 throughout)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((length, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def init_encdec(cfg, generator: torch.Generator, layout: str = "auto", place=None):
    """Parameters with the shapes and dtypes of the reference's
    ``init_encdec`` (float32), drawn on the generator's device: the
    encoder's layers by ``init_layer(..., force_kind="attn")`` and the
    decoder's (``encdec``) each drawn stacked, in ``layout``
    (``stacking.in_layout``; both stacks are homogeneous, so ``auto`` and
    ``stacked`` stack them and ``list`` cuts the same draws into one tree a
    layer).  ``place(name, tree)``, when given, takes each part as soon as
    it is drawn and returns what to keep (``init_lm``'s contract)."""
    stacking.check_layout(layout)
    place = place or (lambda name, tree: tree)
    L_enc, L = cfg.num_encoder_layers, cfg.num_layers
    enc_layers = init_layer(cfg, 0, generator, force_kind="attn", lead=(L_enc,))
    encoder = {"layers": stacking.in_layout(place("layers", enc_layers), layout, L_enc),
               "final_norm": place("final_norm", model_norm(cfg, generator))}
    layers = init_layer(cfg, 0, generator, lead=(L,))
    decoder = {"embed": place("embed", normal_init(generator, (cfg.vocab_size, cfg.d_model))),
               "pos_embed": place("pos_embed", normal_init(generator, (cfg.max_seq_len, cfg.d_model))),
               "layers": stacking.in_layout(place("layers", layers), layout, L),
               "final_norm": place("final_norm", model_norm(cfg, generator))}
    return {"encoder": encoder, "decoder": decoder}


def encode(params, cfg, frames, *, drops=None, peft=None, lora_scale: float = 1.0, stack_mode: str = "unroll"):
    """frames: (B, S_enc, d) stub embeddings -> (B, S_enc, d) encoder
    states, bidirectional, as the reference's ``encode``: ``drops`` (the
    encoder layers' STLD gates) skip layers, and a ``peft`` tree laid out
    like the encoder's layers adds its LoRA to their projections
    (``lora_matmul``, forward and backward) at ``lora_scale``;
    ``stack_mode`` as ``stack_apply`` takes it.  The registry passes
    neither gates nor PEFT, as the reference's does."""
    compute_dtype = getattr(torch, cfg.dtype)
    s = frames.shape[1]
    h = frames.to(compute_dtype) + sinusoidal_positions(s, cfg.d_model, frames.device).to(compute_dtype)
    h, _, _ = stack_apply(params["encoder"]["layers"], cfg, h, positions=torch.arange(s, device=h.device),
                          causal=False, drops=drops, peft=peft, lora_scale=lora_scale, stack_mode=stack_mode)
    return apply_norm(params["encoder"]["final_norm"], h, cfg.norm_eps)


def encoder_cross_kvs(params, cfg, enc_out):
    """Each decoder layer's cross-attention K/V over ``enc_out``, computed
    once a sequence: a per-layer list of ``{"k", "v"}`` of (B, S_enc, KV,
    hd), each with the decode's ``cross_slot_positions`` (one pair of
    tensors shared by every layer)."""
    layers = params["decoder"]["layers"]
    slots = cross_slot_positions(enc_out.shape[0], enc_out.shape[1], enc_out.device)
    return [{**encode_cross_kv(stacking.layer_view(layers, l)["cross"], cfg, enc_out), **slots}
            for l in range(stacking.stack_size(layers))]


def decode(params, cfg, tokens, enc_kvs, *, positions=None, drops=None, caches=None, peft=None,
           lora_scale: float = 1.0, devices=None, stack_mode: str = "unroll"):
    """tokens: (B, S_dec) (or (N, B, S_dec) for a cohort of ``devices`` N,
    with enc_kvs of N * B rows).  Returns (logits, aux, new_caches): learned
    positions ``pos_embed[positions]`` (0 .. S_dec-1 when None), the
    decoder stack (``stack_mode`` as ``stack_apply`` takes it), then the
    head tied to ``embed``."""
    compute_dtype = getattr(torch, cfg.dtype)
    dec = params["decoder"]
    if devices is not None:
        tokens = tokens.reshape(-1, tokens.shape[-1])
    h = dec["embed"][tokens].to(compute_dtype)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=h.device)
    h = h + dec["pos_embed"][positions.to(h.device)].to(compute_dtype)
    h, aux, new_caches = stack_apply(dec["layers"], cfg, h, positions=positions, causal=True, drops=drops,
                                     caches=caches, enc_kvs=enc_kvs, peft=peft, lora_scale=lora_scale,
                                     devices=devices, stack_mode=stack_mode)
    h = apply_norm(dec["final_norm"], h, cfg.norm_eps)
    return h @ dec["embed"].T.to(compute_dtype), aux, new_caches


def init_decoder_caches(cfg, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    """The decoder layers' KV rings (``init_layer_cache``), a list."""
    return [init_layer_cache(cfg, l, batch, max_len, dtype, device) for l in range(cfg.num_layers)]
