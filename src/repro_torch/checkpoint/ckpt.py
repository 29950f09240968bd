"""Checkpoints in the JAX package's format: an npz payload and a json manifest.

Layout: ``<dir>/step_<n>/manifest.json`` + ``arrays.npz``, as
``repro.checkpoint.ckpt`` writes it, byte for byte: a directory written
by either package loads into the other, and loaded and saved again it
keeps its bytes.  Leaves go in as torch tensors (any device), numpy arrays
or scalars and come out as CPU torch tensors.  A bfloat16 leaf is stored
as its ``uint16`` bits under the manifest's dtype ``bfloat16``, and loads
back as ``torch.bfloat16`` with the same bits.

Writes are atomic: each snapshot is staged in a ``.tmp-`` sibling
directory and renamed into place with ``os.replace`` only after every file
landed.  Readers (:func:`latest_state_dir`, :func:`restore_latest`)
validate each candidate and fall back to the newest complete snapshot, so
a torn directory cannot poison resume.

``save_state``/``load_state`` record the container structure (dict, list,
tuple) as a JSON skeleton beside the leaves, plus a JSON ``meta`` payload;
``save_pytree``/``load_pytree`` address the leaves by their flattened
key paths, in JAX's flatten order (dict keys sorted), and restore into a
live template.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch


def _commit_dir(directory: str, step: int, write_files) -> str:
    """Atomically materialize ``<directory>/step_<step>``: ``write_files``
    stages every file in a ``.tmp-`` sibling, which is then renamed over
    the final path (an existing snapshot of the same step is removed
    first)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = os.path.join(directory, f".tmp-step_{step:08d}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    write_files(tmp)
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _snapshot_ok(path: str) -> bool:
    """True when ``path`` holds a complete snapshot: the manifest parses and
    the npz central directory is intact (a truncated write fails both)."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            data.files  # noqa: B018 — forces the zip directory read
        return True
    except Exception:
        return False


def _complete_steps(directory: str):
    """Step numbers under ``directory`` whose snapshots validate, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and _snapshot_ok(os.path.join(directory, name)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def _to_array(leaf):
    """(the array to store, the manifest's dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # numpy npz cannot hold bf16: store bits
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.contiguous().numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr, dtype_name: str) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: torch shares its memory
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# ------------------------------------------------------ key-path pytrees
def _flatten(node, path=()):
    """(path, leaf) pairs in JAX's flatten order: dict keys sorted, lists
    and tuples in order, None an empty subtree."""
    if isinstance(node, dict):
        return [p for k in sorted(node) for p in _flatten(node[k], path + (k,))]
    if isinstance(node, (list, tuple)):
        return [p for i, x in enumerate(node) for p in _flatten(x, path + (i,))]
    if node is None:
        return []
    return [(path, node)]


def _structure(node) -> str:
    """The structure as ``str(jax.tree.structure(node))`` prints it."""
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(node[k])}" for k in sorted(node)) + "}"
    if isinstance(node, list):
        return "[" + ", ".join(_structure(x) for x in node) + "]"
    if isinstance(node, tuple):
        return "(" + ", ".join(_structure(x) for x in node) + ("," if len(node) == 1 else "") + ")"
    return "None" if node is None else "*"


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken in flatten order."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        items = [_unflatten(x, leaves) for x in template]
        return items if isinstance(template, list) else tuple(items)
    if template is None:
        return None
    return next(leaves)


def save_pytree(tree: Any, directory: str, step: int) -> str:
    arrays = {}
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(tree)):
        key = f"leaf_{i}"
        arrays[key], dtype_name = _to_array(leaf)
        manifest["leaves"].append({"key": key, "path": "/".join(str(p) for p in path), "dtype": dtype_name})
    manifest["treedef"] = f"PyTreeDef({_structure(tree)})"

    def write(tmp_dir):
        np.savez(os.path.join(tmp_dir, "arrays.npz"), **arrays)
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)

    return _commit_dir(directory, step, write)


def load_pytree(template: Any, checkpoint_dir: str) -> Any:
    """Restore into the structure of ``template``: each leaf takes the
    template leaf's dtype and device (shapes must match)."""
    with open(os.path.join(checkpoint_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(checkpoint_dir, "arrays.npz")) as data:
        stored = [_to_tensor(data[e["key"]], e["dtype"]) for e in manifest["leaves"]]
    want = [leaf for _, leaf in _flatten(template)]
    if len(stored) != len(want):
        raise ValueError(f"{checkpoint_dir} holds {len(stored)} leaves, the template {len(want)}")
    cast = []
    for got, like in zip(stored, want):
        like = like if isinstance(like, torch.Tensor) else torch.as_tensor(np.asarray(like))
        if tuple(got.shape) != tuple(like.shape):
            raise ValueError(f"leaf of shape {tuple(got.shape)} for a template leaf of {tuple(like.shape)}")
        cast.append(got.to(device=like.device, dtype=like.dtype))
    return _unflatten(template, iter(cast))


def restore_latest(template: Any, directory: str) -> Optional[tuple]:
    """(tree, step) from the newest complete ``step_*`` subdir, or None;
    a partial or corrupt snapshot is skipped for the previous good one."""
    steps = _complete_steps(directory)
    if not steps:
        return None
    step = steps[-1]
    return load_pytree(template, os.path.join(directory, f"step_{step:08d}")), step


# ------------------------------------------------ templateless run state
def _skeletonize(node: Any, leaves: list):
    if isinstance(node, dict):
        keys = list(node.keys())
        return {"t": "dict", "k": keys, "v": [_skeletonize(node[k], leaves) for k in keys]}
    if isinstance(node, (list, tuple)):
        return {"t": "list" if isinstance(node, list) else "tuple", "v": [_skeletonize(x, leaves) for x in node]}
    arr, dtype_name = _to_array(node)
    leaves.append(arr)
    return {"t": "leaf", "i": len(leaves) - 1, "dtype": dtype_name}


def _unskeletonize(skel: dict, data) -> Any:
    kind = skel["t"]
    if kind == "dict":
        return {k: _unskeletonize(v, data) for k, v in zip(skel["k"], skel["v"])}
    if kind in ("list", "tuple"):
        items = [_unskeletonize(v, data) for v in skel["v"]]
        return items if kind == "list" else tuple(items)
    return _to_tensor(data[f"leaf_{skel['i']}"], skel["dtype"])


def save_state(directory: str, step: int, tree: Any, meta: Any = None) -> str:
    """Save a nested dict/list/tuple of tensors (or arrays) and a JSON
    ``meta`` payload as ``<directory>/step_<step>``."""
    leaves: list = []
    skeleton = _skeletonize(tree, leaves)

    def write(tmp_dir):
        np.savez(os.path.join(tmp_dir, "arrays.npz"), **{f"leaf_{i}": arr for i, arr in enumerate(leaves)})
        with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
            json.dump({"step": step, "skeleton": skeleton, "meta": meta}, f, indent=2)

    return _commit_dir(directory, step, write)


def load_state(checkpoint_dir: str) -> tuple:
    """(tree, meta) saved by :func:`save_state`, the leaves CPU tensors."""
    with open(os.path.join(checkpoint_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(checkpoint_dir, "arrays.npz")) as data:
        return _unskeletonize(manifest["skeleton"], data), manifest.get("meta")


def latest_state_dir(directory: str) -> Optional[str]:
    """Path of the newest complete ``step_*`` checkpoint under
    ``directory``, or None (a torn newest snapshot is skipped)."""
    steps = _complete_steps(directory)
    if not steps:
        return None
    return os.path.join(directory, f"step_{steps[-1]:08d}")
