"""JAX parameter and PEFT trees, given as numpy arrays, into the port's tensors.

The trees keep their structure and their stacked ``(L, ...)`` leaves (or
per-layer lists), so the conversion is leaf by leaf, whatever the tree: a
decoder's ``{"embed", "layers", ...}``, an encoder-decoder's ``{"encoder",
"decoder"}``, a PEFT tree with whisper's ``cross`` group.  A bfloat16 leaf arrives either as an
``ml_dtypes.bfloat16`` array (what ``np.asarray`` of a JAX array gives) or
as its ``uint16`` bit pattern (what the JAX checkpoint format stores); both
become ``torch.bfloat16`` with the same bits.  No leaf of a parameter or
PEFT tree is an unsigned 16-bit integer, so a ``uint16`` leaf is read as
bfloat16 bits.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _leaf_to_torch(arr, device, dtype):
    arr = np.array(arr)  # a writable copy: torch shares its memory
    if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _tree_to_torch(tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to_torch(v, device, dtype) for v in tree]
    return _leaf_to_torch(tree, device, dtype)


def params_from_jax(np_tree, device, dtype: Optional[torch.dtype] = None):
    """Base-model params (``{"embed", "layers", "final_norm", ...}``, or an
    encoder-decoder's ``{"encoder", "decoder"}``) as tensors on ``device``;
    floating leaves cast to ``dtype`` when given."""
    return _tree_to_torch(np_tree, torch.device(device), dtype)


def peft_from_jax(np_tree, device, dtype: Optional[torch.dtype] = None):
    """A PEFT tree of any method (LoRA, adapter, BitFit or the empty tree
    of ``none``), in either layout (stacked leaves or a per-layer list), as
    tensors on ``device``; floating leaves cast to ``dtype`` when given."""
    return _tree_to_torch(np_tree, torch.device(device), dtype)
