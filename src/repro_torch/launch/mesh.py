"""Production device meshes on ``torch.distributed``, as
``repro.launch.mesh``.

``make_production_mesh`` is a function, not a module-level constant, so
that importing this module touches no process group.  A single pod is a
16 x 16 mesh (``data`` x ``model``), two pods a 2 x 16 x 16 mesh (``pod`` x
``data`` x ``model``).  In the federated mapping the ``pod`` and ``data``
axes carry the client cohort and each client's batch, and ``model`` carries
tensor and expert parallelism (``repro_torch.sharding.specs``).

The meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects over the
default process group, which the caller initializes with the mesh's world
size (``torch.distributed.init_process_group``); ``make_host_mesh``
initializes a one-process group itself when there is none, and
``make_mesh`` takes any small shape over a started group.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def production_mesh_shape(*, multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape, axes = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """1 x 1 mesh over the local device (smoke tests, examples)."""
    if not dist.is_initialized():
        dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1)
    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))


def make_mesh(shape, axes=("data", "model"), device_type: str = "cuda"):
    """A small ``DeviceMesh`` of ``shape`` (``axes``, ``model`` last) over
    the default process group, which the caller has started with as many
    ranks (e.g. ``init_process_group("gloo", ...)``: gloo ranks share one
    card, where NCCL takes one rank a GPU): the mesh of the sharded train
    step (``launch.steps.make_train_step(mesh=...)``) on a few ranks."""
    shape, axes = tuple(shape), tuple(axes)
    if not dist.is_initialized():
        raise RuntimeError("start the default process group first (torch.distributed.init_process_group)")
    if len(shape) != len(axes) or math.prod(shape) != dist.get_world_size():
        raise ValueError(f"a mesh {shape} over {axes} in a world of {dist.get_world_size()} ranks")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or ``mesh.shape`` when that
    is already such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, mesh.mesh.shape))


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch/cohort dimension."""
    return tuple(a for a in axis_sizes(mesh) if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh)["model"]
