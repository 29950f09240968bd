"""The Mamba (selective SSM) block of jamba, as ``repro.nn.mamba``.

The cache-free path (training, evaluation): ``in_proj`` (with its LoRA),
the depthwise causal convolution, SiLU, the input-dependent (dt, B, C),
then the selective scan through ``ops.mamba_scan`` -- the ``mamba_scan``
kernel forward and ``mamba_scan_bwd`` backward on the card, their plain
twins on the CPU -- gated by SiLU(z) and projected by ``out_proj`` (with
its LoRA).  The JAX package runs the scan as an associative scan over
materialised (B, S, d_in, N) tensors; the kernel keeps the state on chip,
so those tensors never exist.

Serving carries ``init_mamba_state``'s ``{"conv", "ssm"}``: the conv
history is prepended to the input, and the scan runs from ``h0 =
state["ssm"]`` through the same kernel for a prompt (S > 1) and for each
decode step (S = 1), where the reference runs a ``lax.scan`` and a
one-token step.  The state comes back in float32, as there.  A scan from
a state takes no gradient (``ops.mamba_scan``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.nn.initializers import truncated_lecun
from repro_torch.nn.linear import apply_linear


def init_mamba(cfg, generator: torch.Generator):
    """One layer's Mamba parameters (float32), with the shapes of
    ``repro.nn.mamba.init_mamba``, drawn on the generator's device."""
    m, d = cfg.mamba, cfg.d_model
    d_in, dtr, device = m.expand * d, m.resolved_dt_rank(d), generator.device
    a = torch.arange(1, m.d_state + 1, dtype=torch.float32, device=device).expand(d_in, m.d_state)
    return {
        "in_proj": {"w": truncated_lecun(generator, (d, 2 * d_in))},
        "conv_w": truncated_lecun(generator, (m.d_conv, d_in)),
        "conv_b": torch.zeros((d_in,), device=device),
        "x_proj": {"w": truncated_lecun(generator, (d_in, dtr + 2 * m.d_state))},
        "dt_proj": {
            "w": truncated_lecun(generator, (dtr, d_in)),
            "b": torch.log(torch.expm1(torch.full((d_in,), 0.01, device=device))),
        },
        "A_log": torch.log(a),
        "D": torch.ones((d_in,), device=device),
        "out_proj": {"w": truncated_lecun(generator, (d_in, d))},
    }


def _ssm_inputs(params, cfg, x_conv):
    """(dt, B, C) from the convolved input.  x_conv: (..., d_in); dt in
    ``x_conv.dtype``, B and C float32."""
    m = cfg.mamba
    dtr = m.resolved_dt_rank(cfg.d_model)
    dbc = apply_linear(params["x_proj"], x_conv)
    dt, b, c = torch.split(dbc, [dtr, m.d_state, m.d_state], dim=-1)
    dt = F.softplus(dt @ params["dt_proj"]["w"].to(dt.dtype) + params["dt_proj"]["b"].to(dt.dtype))
    return dt, b.float(), c.float()


def _causal_conv(params, cfg, x, conv_state=None):
    """Depthwise causal convolution over time from the history
    ``conv_state`` (B, d_conv - 1, d_in), or a zero one, summed in the
    order of ``repro.nn.mamba._causal_conv``.  x: (B, S, d_in).  Returns
    (out, history): the history is the last ``d_conv - 1`` inputs."""
    m = cfg.mamba
    w = params["conv_w"].to(x.dtype)  # (d_conv, d_in)
    if conv_state is None:
        pad = torch.zeros((x.shape[0], m.d_conv - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S + d_conv - 1, d_in)
    out = sum(xp[:, i : i + x.shape[1]] * w[i] for i in range(m.d_conv))
    out = out + params["conv_b"].to(x.dtype)
    new_state = xp[:, -(m.d_conv - 1) :] if m.d_conv > 1 else pad
    return out, new_state


def mamba_apply(params, cfg, x, state: Optional[dict] = None, peft: Optional[dict] = None,
                lora_scale: float = 1.0):
    """x: (B, S, d).  Returns (out, {"conv", "ssm"}), the final conv
    history and SSM state in float32, as ``repro.nn.mamba.mamba_apply``.
    ``state`` (``init_mamba_state``'s layout), when given, is the history
    and state the sequence continues from.  LoRA (``peft["in"]``,
    ``peft["out"]``) on the two projections."""
    peft = peft or {}
    d_in = cfg.mamba.expand * cfg.d_model
    xz = apply_linear(params["in_proj"], x, peft.get("in"), lora_scale)
    xr, z = torch.split(xz, d_in, dim=-1)
    x_conv, new_conv = _causal_conv(params, cfg, xr, None if state is None else state["conv"])
    x_conv = F.silu(x_conv)
    dt, bmat, cmat = _ssm_inputs(params, cfg, x_conv)
    a = -torch.exp(params["A_log"])  # (d_in, N) float32
    h0 = None if state is None else state["ssm"].float().contiguous()
    y, new_ssm = ops.mamba_scan(dt.contiguous(), x_conv.contiguous(), bmat.contiguous(), cmat.contiguous(),
                                a.contiguous(), params["D"].float().contiguous(), h0)
    y = y * F.silu(z)
    out = apply_linear(params["out_proj"], y, peft.get("out"), lora_scale)
    return out, {"conv": new_conv.float(), "ssm": new_ssm}


def init_mamba_state(cfg, batch: int, device=None):
    """The decode state of one Mamba layer, zero, float32, as
    ``repro.nn.mamba.init_mamba_state``: ``{"conv": (B, d_conv - 1, d_in),
    "ssm": (B, d_in, N)}``."""
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, d_in), device=device),
        "ssm": torch.zeros((batch, d_in, m.d_state), device=device),
    }
