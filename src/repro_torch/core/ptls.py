"""Personalized Transformer Layer Sharing (PTLS), paper §4: the client half.

Per-layer importance (Eq. 6) is the STLD-masked average gradient norm

    I_l = (1 / sum_b (1 - d_l^b)) * sum_b g_l^b (1 - d_l^b)

The server half (the shared-layer mask and the masked layer mean) is not
ported yet.  PEFT trees are in either layout of ``models.stacking``.
"""
from __future__ import annotations

import torch

from repro_torch.models import stacking


def layer_grad_norms(peft_grads) -> torch.Tensor:
    """L2 norm of each layer's PEFT gradient, shape ``(L,)`` float32.

    Stacked layout: per-leaf trailing-axis sums of squares, added over the
    leaves.  Per-layer list (a heterogeneous hybrid stack), as the
    reference's list branch: each layer's per-leaf sums of squares added
    in leaf order (0 for a layer without leaves), stacked.
    """
    if not stacking.is_stacked(peft_grads):
        device = next((x.device for x in stacking.tree_leaves(peft_grads)), None)
        norms = []
        for layer in peft_grads:
            leaves = stacking.tree_leaves(layer)
            sq = sum(torch.sum(torch.square(x.float())) for x in leaves)
            norms.append(torch.sqrt(sq) if leaves else torch.zeros((), dtype=torch.float32, device=device))
        return torch.stack(norms)
    leaves = stacking.tree_leaves(peft_grads)
    if not leaves:
        raise ValueError("layer_grad_norms needs a tree with leaves (the port's PEFT method is LoRA)")
    sq = sum(torch.sum(torch.square(x.float()), dim=tuple(range(1, x.ndim))) for x in leaves)
    return torch.sqrt(sq)


class ImportanceAccumulator:
    """Running Eq.-6 accumulator over the local batches of one round."""

    @staticmethod
    def init(num_layers: int, device=None):
        device = torch.device("cuda" if device is None else device)
        return {
            "g_sum": torch.zeros((num_layers,), dtype=torch.float32, device=device),
            "count": torch.zeros((num_layers,), dtype=torch.float32, device=device),
        }

    @staticmethod
    def update(state, grad_norms, drops):
        active = 1.0 - drops.to(device=grad_norms.device, dtype=torch.float32)
        return {"g_sum": state["g_sum"] + grad_norms * active, "count": state["count"] + active}

    @staticmethod
    def importance(state):
        return state["g_sum"] / torch.clamp(state["count"], min=1.0)
