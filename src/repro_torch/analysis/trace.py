"""Run a program on the ``meta`` device and record what it dispatches.

The port's counterpart of the reference's jaxprs and XLA cost analysis: a
program (a step, a round, an aggregation) runs on ``meta`` tensors, which
carry shapes and dtypes and no data, under :class:`MetaRecorder`, a
``TorchDispatchMode`` that sees every aten op.  It records

* each op's name and its outputs' shapes and dtypes (``ops``, when
  ``keep_ops``), what the contracts read;
* ``host_reads``: every read of device data by the host (``.item()``,
  ``.cpu()``, ``.tolist()``, a copy off the device).  On ``meta`` such a
  read has no value, so the recorder gives it zeros and the run goes on;
* ``bytes_accessed``: the bytes of each device op's tensor inputs and
  outputs (views and uninitialised allocations move nothing and are not
  counted);
* the live bytes of the device storages allocated during the run, freed
  as they die, and their peak (``peak_new_bytes``).  Storages that lived
  before the run (the arguments: ``hold``) are not counted.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, which counts
the matmuls, convolutions and attention products at the aten level, plus
the hand-written kernels' own counts (``ops.kernel_work``): a kernel's
``meta`` call allocates its outputs and scratch and dispatches no product.
``run_on_meta`` puts the three together.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

aten = torch.ops.aten
_HOST_READS = (aten._local_scalar_dense.default,)


class OpRecord(NamedTuple):
    """One dispatched op: its name and its tensor outputs' shapes and dtypes."""

    name: str
    shapes: tuple
    dtypes: tuple
    on_device: bool


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tree_tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, tuples and dataclasses (an
    ``AdapterPool``), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in tree_tensors(sub)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _zero_scalar(t: torch.Tensor):
    if t.dtype == torch.bool:
        return False
    return 0.0 if t.dtype.is_floating_point or t.dtype.is_complex else 0


class MetaRecorder(TorchDispatchMode):
    """See the module docstring."""

    device = "meta"

    def __init__(self, *, keep_ops: bool = True):
        super().__init__()
        self.keep_ops = keep_ops
        self.ops: List[OpRecord] = []
        self.host_reads: List[str] = []
        self.bytes_accessed = 0
        self.live_new_bytes = 0
        self.peak_new_bytes = 0
        self._seen = WeakIdKeyDictionary()

    # ------------------------------------------------------------ storages
    def hold(self, tree) -> int:
        """Mark the storages of ``tree``'s tensors as living before the run
        (not counted as allocated); returns their bytes, each storage once."""
        total = 0
        for t in tree_tensors(tree):
            if t.device.type != self.device:
                continue
            st = t.untyped_storage()
            if st not in self._seen:
                self._seen[st] = 0
                total += st.nbytes()
        return total

    def new_bytes(self, tree) -> int:
        """The bytes of the storages of ``tree``'s tensors allocated during
        the run, each storage once."""
        seen, total = set(), 0
        for t in tree_tensors(tree):
            if t.device.type != self.device:
                continue
            st = t.untyped_storage()
            if self._seen.get(st) and id(st) not in seen:
                seen.add(id(st))
                total += st.nbytes()
        return total

    def _free(self, nbytes: int):
        self.live_new_bytes -= nbytes

    def _track(self, outs):
        for t in outs:
            if t.device.type != self.device:
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            nbytes = st.nbytes()
            self._seen[st] = nbytes
            weakref.finalize(st, self._free, nbytes)
            self.live_new_bytes += nbytes
            self.peak_new_bytes = max(self.peak_new_bytes, self.live_new_bytes)

    # ------------------------------------------------------------ dispatch
    def _host_read(self, func, args, kwargs):
        """A zero stand-in for a host read of device data, or None."""
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if func in _HOST_READS and src is not None and src.device.type == self.device:
            self.host_reads.append(func.name())
            return _zero_scalar(src)
        if func == aten._to_copy.default and src is not None and src.device.type == self.device:
            target = kwargs.get("device")
            if target is not None and torch.device(target).type != self.device:
                self.host_reads.append(f"{func.name()} to {target}")
                return torch.zeros(src.shape, dtype=kwargs.get("dtype") or src.dtype, device=target)
        if func == aten.copy_.default and len(args) > 1 and isinstance(args[1], torch.Tensor):
            if args[1].device.type == self.device and args[0].device.type != self.device:
                self.host_reads.append(f"{func.name()} to {args[0].device}")
                return args[0]
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fake = self._host_read(func, args, kwargs)
        if fake is not None:
            return fake
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        on_device = any(t.device.type == self.device for t in ins + outs)
        if on_device:
            self._track(outs)
            name = func.overloadpacket.__name__
            if not func.is_view and not name.startswith(("empty", "new_empty")):
                self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        if self.keep_ops:
            self.ops.append(OpRecord(func.overloadpacket.__name__, tuple(tuple(t.shape) for t in outs),
                                     tuple(t.dtype for t in outs), on_device))
        return out


@dataclass
class MetaRun:
    """What ``run_on_meta`` measured of one call."""

    out: object
    flops: float
    aten_flops: float
    kernel_flops: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    peak_new_bytes: int
    kernel_launches: Dict[str, int]
    host_reads: List[str]
    seconds: float
    recorder: Optional[MetaRecorder]

    @property
    def peak_bytes(self) -> int:
        """The arguments plus the peak of the storages the call allocated."""
        return self.argument_bytes + self.peak_new_bytes

    @property
    def temp_bytes(self) -> int:
        """The peak of the call's allocations less its outputs."""
        return max(self.peak_new_bytes - self.output_bytes, 0)


def run_on_meta(fn, *args, keep_ops: bool = False, **kwargs) -> MetaRun:
    """Call ``fn(*args, **kwargs)`` (its device tensors on ``meta``) under a
    :class:`MetaRecorder` and a ``FlopCounterMode``, with the kernels'
    counters zeroed first (``ops.reset_launch_counts``)."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    recorder = MetaRecorder(keep_ops=keep_ops)
    argument_bytes = recorder.hold((args, kwargs))
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with counter, recorder:
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    kernel_flops = sum(w["flops"] for w in ops.kernel_work.values())
    kernel_bytes = sum(w["bytes"] for w in ops.kernel_work.values())
    aten_flops = float(counter.get_total_flops())
    return MetaRun(
        out=out, flops=aten_flops + kernel_flops, aten_flops=aten_flops, kernel_flops=kernel_flops,
        bytes_accessed=float(recorder.bytes_accessed) + kernel_bytes,
        argument_bytes=argument_bytes, output_bytes=recorder.new_bytes(out), peak_new_bytes=recorder.peak_new_bytes,
        kernel_launches={name: n for name, n in ops.meta_calls.items() if n}, host_reads=list(recorder.host_reads),
        seconds=seconds, recorder=recorder if keep_ops else None,
    )


def meta_like(tree):
    """``tree`` with every tensor leaf replaced by an empty ``meta`` tensor
    of its shape and dtype (dicts, lists, tuples and dataclasses kept; other
    leaves as they are)."""
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    if isinstance(tree, dict):
        return {k: meta_like(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: meta_like(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        return type(tree)(meta_like(v) for v in tree)
    return tree
