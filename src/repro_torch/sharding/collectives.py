"""The collectives of the port's sharded steps, and one rank's place in
its mesh.

The reference compiles its steps over a mesh and GSPMD inserts the
collectives; the port's steps (``launch.steps.make_train_step``,
``make_prefill_step`` and ``make_serve_step``, each with ``mesh=...``) call
them itself, all through this module:

* Megatron's two operators, as ``torch.autograd.Function``s: ``enter``
  (the identity forward, an ``all_reduce`` over ``model`` backward) in
  front of every column-parallel block, and ``reduce`` (an ``all_reduce``
  over ``model`` forward, the identity backward) behind every
  row-parallel product and wherever each rank holds a partial sum of a
  value that every rank then uses alike;
* plain ``all_reduce`` (sum, max, min) and ``all_gather`` over a mesh axis
  (``model``, the data axes taken together as ``data``, every rank of the
  mesh as ``world``, or the ranks that share a KV head as ``heads``);
* the vocabulary-parallel embedding lookup (``embed``);
* the serving steps' own (``nn.attention``'s cache paths): the
  ``all_to_all`` of a prefill's new K/V into a cache cut on its head dim
  (``head_dim_cut``), the log-sum-exp combine of decodes over slices of a
  sequence cut over the data axes (``lse_combine``), and the
  vocabulary-parallel argmax (``models.losses.vocab_parallel_argmax``).

A :class:`Comm` holds the group handles (``from_mesh``: a
``torch.distributed`` ``DeviceMesh``), or none at all on ``meta``
(``on_meta``: a mesh's axis sizes only): there every collective allocates
what the real one allocates and communicates nothing, so the dry run
(``launch.dryrun``) runs the same step.  Either way the ``counts`` add up
each call's bytes under the reference's collective kinds (an all-gather's
bytes are those of its gathered output, an all-reduce's those of its
tensor, as ``repro.launch.dryrun.collective_bytes`` reads them from the
HLO), so a run on the card and its dry run can be compared exactly.

On one card the groups are gloo's (NCCL takes one rank a GPU).  gloo
reduces and gathers CUDA tensors itself, staging them through the host;
nothing here copies a tensor to the CPU.  The STLD gates live on the
host, and their check reduces them there.
"""
from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
DATA_AXES = ("pod", "data")


def empty_counts() -> dict:
    """Bytes by collective kind (the reference's keys), with ``count``."""
    return {**{k: 0 for k in COLLECTIVES}, "count": 0}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Comm:
    """One rank of a ``(data, model)`` or ``(pod, data, model)`` mesh.

    ``sizes`` maps each axis name to its size, ``coords`` each to this
    rank's index; ``groups`` maps ``model``, ``data``, ``world`` and
    ``heads`` to process groups, or is None on ``meta``.  ``counts`` and
    ``seconds`` (the host's seconds inside real collectives) add up until
    ``reset``."""

    def __init__(self, sizes: dict, coords: dict, groups: Optional[dict] = None):
        if "model" not in sizes:
            raise ValueError(f"a mesh needs a 'model' axis, got {tuple(sizes)}")
        unknown = set(sizes) - {"model", *DATA_AXES}
        if unknown:
            raise ValueError(f"mesh axes must be 'pod', 'data' and 'model', got {tuple(sizes)}")
        self.sizes, self.coords, self.groups = dict(sizes), dict(coords), groups
        self.tp, self.tp_rank = sizes["model"], coords["model"]
        self.data_axes = tuple(a for a in DATA_AXES if a in sizes)
        self.n_data = math.prod(sizes[a] for a in self.data_axes)
        self.head_share = 1  # ranks that share one KV head (``set_heads``)
        self.seq_shard = False  # the serving caches' sequence is cut over the data axes
        self.reset()

    # ------------------------------------------------------------ building
    @classmethod
    def on_meta(cls, sizes: dict, coords: Optional[dict] = None) -> "Comm":
        """A rank (``coords``, default every index 0) that communicates
        nothing: the dry run's."""
        return cls(sizes, coords or {a: 0 for a in sizes})

    @classmethod
    def from_mesh(cls, mesh) -> "Comm":
        """This process's rank of a ``DeviceMesh`` whose dims are named
        (``pod``,) ``data`` (optional) and ``model``.  Every rank of the
        default group calls it; the mesh spans the default group when it
        has more than the ``model`` axis."""
        import torch.distributed as dist

        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, mesh.mesh.shape))
        coords = dict(zip(names, mesh.get_coordinate()))
        comm = cls(sizes, coords, {})
        comm._mesh_ranks = mesh.mesh.clone()
        comm._names = names
        comm.groups["model"] = mesh.get_group("model")
        comm._spans_world = mesh.mesh.numel() == dist.get_world_size()
        if len(names) == 1:
            comm.groups["world"] = comm.groups["model"]
            return comm
        if not comm._spans_world:
            raise ValueError(f"a mesh of {mesh.mesh.numel()} ranks in a world of {dist.get_world_size()}: a "
                             "(data, model) mesh spans the default group")
        comm.groups["world"] = dist.group.WORLD
        comm.groups["data"] = comm._line_group([a for a in names if a != "model"])
        return comm

    def _line_group(self, axes, size: Optional[int] = None):
        """The group of the ranks that differ from this one only along
        ``axes`` (in mesh order, the first axis major), or with ``size`` in
        the same block of ``size`` consecutive ones of them; every rank
        creates every such group, as ``new_group`` asks."""
        import torch.distributed as dist

        ranks = self._mesh_ranks
        keep = [i for i, a in enumerate(self._names) if a not in axes]
        vary = [i for i, a in enumerate(self._names) if a in axes]
        lines = ranks.permute(*keep, *vary).reshape(-1, size or math.prod(ranks.shape[i] for i in vary))
        mine = None
        for line in lines.tolist():
            group = dist.new_group(line)
            if dist.get_rank() in line:
                mine = group
        return mine

    def set_heads(self, cfg):
        """Check that the dense decoder ``cfg`` splits over ``model`` as
        the port runs it, and make the groups of the ranks that share a KV
        head: with ``num_kv_heads`` below the ``model`` size, ``wk`` and
        ``wv``'s column shards cut heads in parts, and each block of
        ``tp / num_kv_heads`` ranks gathers its head once a step."""
        h, kv, tp = cfg.num_heads, cfg.num_kv_heads, self.tp
        if h % tp:
            raise NotImplementedError(f"{h} query heads do not split over model {tp}")
        if kv % tp and tp % kv:
            raise NotImplementedError(f"{kv} KV heads and model {tp}: neither divides the other")
        if cfg.d_ff % tp:
            raise NotImplementedError(f"d_ff {cfg.d_ff} does not split over model {tp}: the spec replicates the "
                                      "MLP, which the sharded step does not run")
        if cfg.vocab_size % tp:
            raise NotImplementedError(f"a vocabulary of {cfg.vocab_size} does not split over model {tp}: the "
                                      "spec falls back to the hidden dim, which the sharded step does not run")
        self.head_share = max(tp // kv, 1)
        if self.head_share > 1 and self.groups is not None:
            if not self._spans_world:
                raise ValueError("KV heads gathered among model ranks: the mesh spans the default group")
            self.groups["heads"] = self._line_group(["model"], self.head_share)

    # ------------------------------------------------------------ layout
    def cols(self, width: int) -> tuple:
        """(lo, hi) of this rank's shard of ``width`` columns (or rows)."""
        part = width // self.tp
        return self.tp_rank * part, (self.tp_rank + 1) * part

    def kv_cols(self, cfg) -> tuple:
        """(lo, hi) of the K/V columns this rank computes: its KV heads
        whole, those its query heads read."""
        hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
        if self.head_share > 1:
            head = self.tp_rank // self.head_share
            return head * hd, (head + 1) * hd
        return self.cols(kv * hd)

    @property
    def data_index(self) -> int:
        """This rank's index over the data axes taken together, the first
        major (as a spec's tuple of data axes cuts a dim)."""
        i = 0
        for a in self.data_axes:
            i = i * self.sizes[a] + self.coords[a]
        return i

    def rows(self, t: torch.Tensor, batch: int) -> torch.Tensor:
        """This rank's ``batch`` rows of ``t``, which its spec replicates
        over the data axes (the serving caches' (B,) positions), where the
        batch's rows are cut over them."""
        if t.shape[0] == batch:
            return t
        return t[self.data_index * batch:(self.data_index + 1) * batch]

    def axis_size(self, axis: str) -> int:
        return {"model": self.tp, "data": self.n_data, "world": self.tp * self.n_data,
                "heads": self.head_share}[axis]

    # ------------------------------------------------------------ collectives
    @property
    def is_meta(self) -> bool:
        return self.groups is None

    def reset(self):
        self.counts, self.seconds = empty_counts(), 0.0

    def _record(self, kind: str, nbytes: int):
        self.counts[kind] += nbytes
        self.counts["count"] += 1

    def all_reduce(self, t: torch.Tensor, axis: str = "model", op: str = "sum") -> torch.Tensor:
        """A new tensor: ``t`` reduced (``sum``, ``max`` or ``min``) over
        ``axis``."""
        out = t.clone()
        if self.axis_size(axis) == 1:
            return out
        self._record("all-reduce", _nbytes(t))
        if not self.is_meta:
            import torch.distributed as dist

            t0 = time.perf_counter()
            dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()), group=self.groups[axis])
            self.seconds += time.perf_counter() - t0
        return out

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ranks' ``t`` along ``axis``, concatenated along ``dim`` in
        rank order."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        self._record("all-gather", n * _nbytes(t))
        if not self.is_meta:
            import torch.distributed as dist

            t0 = time.perf_counter()
            dist.all_gather(parts, t, group=self.groups[axis])
            self.seconds += time.perf_counter() - t0
        return torch.cat(parts, dim=dim)

    def head_dim_cut(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (..., hd), this rank's KV head (with ``head_share`` > 1
        each block of that many ranks holds one head alike), as a cache cut
        on its head dim holds it: (..., KV, hd / tp), this rank's slice of
        every KV head.  One ``all_to_all`` over ``model``: rank (k, i), the
        i-th of head k's block, sends slice j of its head to each rank j
        with j % head_share == i, so each rank receives its slice of every
        head once, in head order."""
        share, tp = self.head_share, self.tp
        i = self.tp_rank % share
        send = x.reshape(*x.shape[:-1], tp, x.shape[-1] // tp)[..., i::share, :].movedim(-2, 0).contiguous()
        recv = torch.empty_like(send)
        self._record("all-to-all", _nbytes(send))
        if not self.is_meta:
            import torch.distributed as dist

            splits = [send[0].numel() if j % share == i else 0 for j in range(tp)]
            t0 = time.perf_counter()
            dist.all_to_all_single(recv.reshape(-1), send.reshape(-1), splits, splits, group=self.groups["model"])
            self.seconds += time.perf_counter() - t0
        return recv.movedim(0, -2)

    def lse_combine(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """The attention output over the whole sequence from each data
        rank's over its slice of it (``out`` (B, H, D), ``lse`` (B, H) its
        log-sum-exp): the max over the data axes, then one sum of the
        weighted outputs and weights together.  In ``out.dtype``."""
        if self.n_data == 1:
            return out
        w = torch.exp(lse - self.all_reduce(lse, "data", "max"))
        both = self.all_reduce(torch.cat([out.float() * w[..., None], w[..., None]], dim=-1), "data")
        return (both[..., :-1] / both[..., -1:]).to(out.dtype)

    # ------------------------------------------------------------ Megatron's operators
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel block: the identity forward, its
        gradient summed over ``model`` backward."""
        return _Enter.apply(x, self) if self.tp > 1 else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over ``model`` forward (each rank holds a partial
        sum that every rank then uses alike); the identity backward."""
        return _Reduce.apply(x, self) if self.tp > 1 else x

    def embed(self, table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
        """The rows of ``tokens`` from a vocabulary-sharded ``table`` (this
        rank's (V / tp, d) rows): each rank looks up the tokens it holds,
        zeros the others, and the sum over ``model`` gives every row, in
        ``dtype``."""
        lo = self.tp_rank * table.shape[0]
        local = tokens - lo
        held = (local >= 0) & (local < table.shape[0])
        rows = table[torch.where(held, local, 0)].to(dtype)
        return self.reduce(torch.where(held[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device)))

    # ------------------------------------------------------------ the step's own
    def check_gates(self, gates):
        """Raise unless every rank drew the same STLD gates (an ``all_reduce``
        of their max and of their min over the mesh, on the host)."""
        if gates is None or self.axis_size("world") == 1:
            return
        g = torch.as_tensor(gates).to(torch.int32).reshape(-1)
        hi, lo = self.all_reduce(g, "world", "max"), self.all_reduce(g, "world", "min")
        if not self.is_meta and not torch.equal(hi, lo):
            raise RuntimeError(f"the ranks drew different STLD gates (max {hi.tolist()}, min {lo.tolist()}): seed "
                               "every rank's generator alike")

    def mean_grads(self, leaves: list) -> list:
        """The full gradients, the same on every rank, from each rank's
        part: each LoRA gradient is a sum over ``model`` of the ranks'
        parts (a partial product, or a slice with zeros around it), and the
        step's gradient the mean over the data axes, so one ``all_reduce``
        over the mesh of every leaf, flattened, over the data axes' size."""
        if not leaves or self.axis_size("world") == 1:
            return leaves
        flat = self.all_reduce(torch.cat([g.reshape(-1) for g in leaves]), "world")
        if self.n_data > 1:
            flat = flat / self.n_data
        return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in leaves]), leaves)]

    def global_metrics(self, metrics: dict) -> dict:
        """The loss and accuracy of the global batch: token-weighted sums
        over the data axes (every ``model`` rank holds them alike)."""
        if self.n_data == 1:
            return metrics
        tok = metrics["tokens"]
        sums = self.all_reduce(torch.stack([metrics["loss"] * tok, metrics["accuracy"] * tok, tok]), "data")
        return dict(metrics, loss=sums[0] / sums[2], accuracy=sums[1] / sums[2], tokens=sums[2])


def comm_for(mesh) -> Comm:
    """This rank's ``Comm`` of a ``DeviceMesh``, or rank 0's on ``meta``
    for a mesh given by its axis sizes alone (an object whose ``shape``
    maps axis names to sizes)."""
    if hasattr(mesh, "mesh_dim_names"):
        return Comm.from_mesh(mesh)
    return Comm.on_meta(dict(mesh.shape))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad.contiguous()), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class Shard(NamedTuple):
    """How one projection splits over ``model``: ``kind`` ``col`` (this
    rank's output columns ``lo:hi``) or ``row`` (its input rows
    ``lo:hi``; the output summed over ``model``), for ``comm``."""

    comm: Comm
    kind: str
    lo: int
    hi: int
