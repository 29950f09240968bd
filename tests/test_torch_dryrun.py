"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.input_specs``,
``analysis.trace``) and its configs against the JAX package, on the CPU.

* configs: ``INPUT_SHAPES``, ``LONG_CONTEXT_SKIPS``, ``RunConfig``'s
  defaults and ``shape_applicable`` over all 10 x 4 cells equal the
  reference's.
* input specs: for every arch at smoke size, and for qwen3-1.7b and
  granite-moe-3b-a800m at full width, each step's input trees (leaf paths,
  shapes, dtypes) and spec trees equal the reference's ``input_specs``
  trees on the 16 x 16 mesh (train on the 2 x 16 x 16 mesh too).  Stated
  mapping where the torch idiom differs: the train step's ``rng`` is a
  ``torch.Generator`` where the reference's is a (2,) uint32 key; the step
  count of the AdamW state and the serve step's ``pos`` are Python ints
  where the reference's are 0-d int32; a reference spec lists no trailing
  replicated dims, so it is padded with None; whisper's serve step takes
  its cross K/V as a per-layer list of (B, S_enc, KV, hd) ``k``, ``v`` with
  the decode's slot positions (the port's encoder-decoder layout) where the reference stacks
  them (L, B, S_enc, KV, hd): the layers' shapes are compared stacked, the
  positions left out, and the port's specs against the reference's
  ``cache_specs`` of the same per-layer leaves.
* FLOPs against the reference: the dry run's FLOPs of the smoke qwen3 loss
  forward (float32, 2 layers, STLD off) equal the sum of the reference's
  ``dot_general`` terms (2 · |out| · contraction) over that forward's
  jaxpr, exactly.
* FLOPs against the twins: each matmul kernel's ``meta`` count equals
  ``FlopCounterMode``'s count of its plain twin at small shapes, exactly.
* the scan wrappers' device check: a tensor on a device with no kernel
  raises "no kernel for device" from ``wkv6`` and ``mamba_scan`` (forward
  and the autograd function's backward) and never reaches ``_build``.
* the dry run at full width on ``meta``: qwen3 ``train_4k`` 16x16, jamba
  ``decode_32k``, granite ``prefill_32k`` are ``ok`` with each kernel's
  launches as ``PERF.md`` §2's formulas give (qwen3's train cell is rank 0
  of the sharded step, its collectives counted; the others say in
  ``notes`` that their weights are whole); a ``long_500k`` cell of a
  full-attention arch writes the reference's skip record.
* the sharded step's dry run against 4 gloo ranks on the CPU: a smoke
  train cell on a 2 x 2 mesh with FSDP counts the collective bytes the
  ranks count, kind by kind.
"""
import dataclasses
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro import configs as jax_configs
from repro.analysis.jaxpr_contracts import walk_eqns
from repro.launch import input_specs as jax_ispec
from repro.models.losses import softmax_xent as jax_softmax_xent
from repro.models.registry import model_apply as jax_model_apply
from repro.sharding import specs as jax_specs
from repro_torch import configs
from repro_torch.analysis.trace import run_on_meta
from repro_torch.kernels import _build, ops, ref
from repro_torch.launch import dryrun
from repro_torch.launch import input_specs as ispec
from repro_torch.models.layers import layer_kind
from repro_torch.models.losses import softmax_xent
from repro_torch.models.registry import model_apply, param_shapes, peft_shapes
from repro_torch.sharding.specs import PartitionSpec

CSRC = Path(ops.__file__).resolve().parent / "csrc"
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class _JaxMesh:
    """What the reference's input functions read of a mesh: its axis sizes
    and names (no 256 devices needed)."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


# ------------------------------------------------------------------ configs
def test_input_shapes_and_skips_equal_the_reference():
    assert list(configs.INPUT_SHAPES) == list(jax_configs.INPUT_SHAPES)
    for name, shape in configs.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jax_configs.INPUT_SHAPES[name])
    assert configs.LONG_CONTEXT_SKIPS == jax_configs.LONG_CONTEXT_SKIPS


def test_run_config_defaults_equal_the_reference():
    for arch in configs.ARCH_IDS:
        ours = configs.RunConfig(configs.get_config(arch))
        theirs = jax_configs.RunConfig(jax_configs.get_config(arch))
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), arch
    assert [f.name for f in dataclasses.fields(configs.RunConfig)] == [
        f.name for f in dataclasses.fields(jax_configs.RunConfig)]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shape_applicable_equals_the_reference(arch):
    for shape in configs.INPUT_SHAPES:
        assert configs.shape_applicable(arch, shape) == jax_configs.shape_applicable(arch, shape), (arch, shape)


# -------------------------------------------------------------- input specs
def _port_leaves(tree, path=()):
    """(path, leaf description) of the port's tree, dict keys sorted, a
    ``PartitionSpec`` a leaf; the stated mapping applied."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _port_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return [p for i, t in enumerate(tree) for p in _port_leaves(t, path + (i,))]
    if isinstance(tree, torch.Tensor):
        return [(path, (tuple(tree.shape), str(tree.dtype).removeprefix("torch.")))]
    if isinstance(tree, torch.Generator):
        return [(path, "rng")]
    if isinstance(tree, int):
        return [(path, ((), "int32"))]
    return [(path, tuple(tree))]


def _jax_leaves(tree):
    def key(k):
        return k.key if hasattr(k, "key") else k.idx

    out = []
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]:
        if isinstance(leaf, jax.sharding.PartitionSpec):
            out.append((tuple(key(k) for k in path), tuple(leaf)))
        elif path and key(path[-1]) == "rng" or (tuple(leaf.shape), np.dtype(leaf.dtype).name) == ((2,), "uint32"):
            out.append((tuple(key(k) for k in path), "rng"))
        else:
            out.append((tuple(key(k) for k in path), (tuple(leaf.shape), np.dtype(leaf.dtype).name)))
    return out


def _padded_specs(jax_leaves, port_leaves):
    """The reference's specs padded with None to the port's one entry a dim."""
    ndims = {path: len(spec) for path, spec in port_leaves}
    return [(path, spec + (None,) * (ndims.get(path, len(spec)) - len(spec))) for path, spec in jax_leaves]


def _stacked_enc_kvs(args, specs, jargs, jspecs, sizes):
    """The mapping of whisper's cross K/V (the module docstring)."""
    enc, enc_specs = args[-1], specs[-1]
    stacked = {name: torch.empty((len(enc), *enc[0][name].shape), dtype=enc[0][name].dtype, device="meta")
               for name in ("k", "v")}
    layer = {name: jax.ShapeDtypeStruct(jargs[-1][name].shape[1:], jargs[-1][name].dtype) for name in ("k", "v")}
    axes = tuple(a for a in sizes if a != "model")
    jax_specs.set_mesh_axis_sizes(_JaxMesh(sizes))
    per_layer = jax_specs.cache_specs([dict(layer) for _ in enc], axes, sizes["model"])
    ours = [{name: node[name] for name in ("k", "v")} for node in enc_specs]
    return (*args[:-1], stacked), (*specs[:-1], ours), (*jspecs[:-1], per_layer)


def _input_fns(kind):
    return {"train": (ispec.train_inputs, jax_ispec.train_inputs),
            "prefill": (ispec.prefill_inputs, jax_ispec.prefill_inputs),
            "decode": (ispec.serve_inputs, jax_ispec.serve_inputs)}[kind]


def _assert_inputs_match(arch, shape_name, mesh_name, smoke):
    shape = configs.INPUT_SHAPES[shape_name]
    ours_fn, theirs_fn = _input_fns(shape.kind)
    cfg, jcfg = configs.get_config(arch, smoke=smoke), jax_configs.get_config(arch, smoke=smoke)
    sizes = MESHES[mesh_name]
    if shape.kind == "train":
        args, specs = ours_fn(cfg, configs.PEFTConfig(), shape, ispec.MeshShape(sizes))
        jargs, jspecs = theirs_fn(jcfg, jax_configs.PEFTConfig(), shape, _JaxMesh(sizes))
    else:
        args, specs = ours_fn(cfg, shape, ispec.MeshShape(sizes))
        jargs, jspecs = theirs_fn(jcfg, shape, _JaxMesh(sizes))
    assert len(args) == len(jargs)
    if cfg.is_encoder_decoder and shape.kind == "decode":
        args, specs, jspecs = _stacked_enc_kvs(args, specs, jargs, jspecs, sizes)
    ours_args, ours_specs = _port_leaves(list(args)), _port_leaves(list(specs))
    assert ours_args == _jax_leaves(list(jargs)), (arch, shape_name)
    assert len(ours_specs) == len(_jax_leaves(list(jspecs)))
    assert ours_specs == _padded_specs(_jax_leaves(list(jspecs)), ours_specs), (arch, shape_name)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_match_the_reference_at_smoke_size(arch):
    for shape_name in configs.INPUT_SHAPES:
        _assert_inputs_match(arch, shape_name, "16x16", smoke=True)
    _assert_inputs_match(arch, "train_4k", "2x16x16", smoke=True)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "granite-moe-3b-a800m"])
def test_input_specs_match_the_reference_at_full_width(arch, monkeypatch):
    shapes, eval_shapes = {}, jax_ispec.eval_param_shapes

    def once(cfg):  # the reference's eval_shape of a full-width init (~5 s), once for the three steps
        if cfg.name not in shapes:
            shapes[cfg.name] = eval_shapes(cfg)
        return shapes[cfg.name]

    monkeypatch.setattr(jax_ispec, "eval_param_shapes", once)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        _assert_inputs_match(arch, shape_name, "16x16", smoke=False)


# --------------------------------------------------------- FLOPs, reference
def _dot_general_flops(closed) -> float:
    total = 0.0
    for eqn in walk_eqns(closed):
        if eqn.primitive.name == "dot_general":
            (lhs_contract, _), _ = eqn.params["dimension_numbers"]
            contraction = float(np.prod([eqn.invars[0].aval.shape[d] for d in lhs_contract]))
            total += 2.0 * float(np.prod(eqn.outvars[0].aval.shape)) * contraction
    return total


def test_loss_forward_flops_equal_the_reference_dot_generals():
    """qwen3 at smoke size, float32, 2 layers, LoRA on q and v, STLD off,
    batch 2 x 16 tokens: exact equality (tolerance 0)."""
    cfg = configs.get_config("qwen3-1.7b", smoke=True).replace(num_layers=2, dtype="float32")
    jcfg = jax_configs.get_config("qwen3-1.7b", smoke=True).replace(num_layers=2, dtype="float32")
    pcfg = configs.PEFTConfig()
    b, s = 2, 16

    def port_loss(params, peft, tokens):
        logits, aux, _ = model_apply(params, cfg, {"tokens": tokens[:, :-1]}, peft=peft, lora_scale=2.0)
        return softmax_xent(logits, tokens[:, 1:])[0] + cfg.router_aux_coef * aux

    tokens = torch.empty((b, s + 1), dtype=torch.int32, device="meta")
    run = run_on_meta(port_loss, param_shapes(cfg), peft_shapes(cfg, pcfg), tokens)

    def jax_loss(params, peft, tokens):
        logits, aux, _ = jax_model_apply(params, jcfg, {"tokens": tokens[:, :-1]}, peft=peft, lora_scale=2.0)
        return jax_softmax_xent(logits, tokens[:, 1:])[0] + jcfg.router_aux_coef * aux

    closed = jax.make_jaxpr(jax_loss)(jax_ispec.eval_param_shapes(jcfg),
                                      jax_ispec.eval_peft_shapes(jcfg, jax_configs.PEFTConfig()),
                                      jax.ShapeDtypeStruct((b, s + 1), jnp.int32))
    # every product of the forward: the q, k, v, o projections with the
    # LoRA's two rank-8 products on q and v, the attention's QK^T and PV
    # (in full, masked products included), the MLP and the tied head
    assert run.flops == _dot_general_flops(closed)
    assert run.kernel_flops > 0 and run.kernel_launches == {"flash_attention": 2, "lora_matmul": 4}


# ------------------------------------------------------------ FLOPs, twins
def _twin_flops(fn, *args, backward=False):
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
        if backward:
            out.float().sum().backward()
    return counter.get_total_flops()


def _meta_flops(fn, *args, backward=False):
    def call(*a):
        out = fn(*a)
        if backward:
            out.float().sum().backward()
        return out

    return run_on_meta(call, *args).kernel_flops


def _rand(*shape, dtype=torch.float32, requires_grad=False):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(sum(shape)), dtype=dtype).requires_grad_(
        requires_grad)


def _as_meta(*tensors):
    return [torch.empty(t.shape, dtype=t.dtype, device="meta").requires_grad_(t.requires_grad) for t in tensors]


def _matmul_cases():
    idx, ranks = torch.tensor([0, 1, 1, 0, 2], dtype=torch.int32), torch.tensor([2, 4, 3], dtype=torch.int32)
    return {
        "segmented_lora": (lambda x, w, a, b: ref.segmented_lora_plain(x, w, a, b, idx, ranks),
                           lambda x, w, a, b: ops.segmented_lora(x, w, a, b, idx.to("meta"), ranks.to("meta")),
                           (_rand(5, 32), _rand(32, 48), _rand(3, 32, 4), _rand(3, 4, 48)), False),
        "flash_decode": (lambda q, k, v: ref.decode_attention_plain(q, k, v, torch.full((2,), 9, dtype=torch.int32),
                                                                    torch.arange(12, dtype=torch.int32).expand(2, 12)),
                         lambda q, k, v: ops.flash_decode(q, k, v, torch.full((2,), 9, dtype=torch.int32, device="meta"),
                                                          torch.empty((2, 12), dtype=torch.int32, device="meta")),
                         (_rand(2, 4, 16), _rand(2, 12, 2, 16), _rand(2, 12, 2, 16)), False),
        "flash_attention": (lambda q, k, v: ref.attention_plain(q, k, v, causal=True),
                            lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
                            (_rand(2, 8, 4, 16), _rand(2, 8, 2, 16), _rand(2, 8, 2, 16)), False),
        "flash_attention_bwd": (lambda q, k, v: ref.attention_plain(q, k, v, causal=True),
                                lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
                                tuple(_rand(*s, requires_grad=True) for s in ((2, 8, 4, 16), (2, 8, 2, 16),
                                                                              (2, 8, 2, 16))), True),
        "flash_attention_bwd_dq": (lambda q, k, v: ref.attention_plain(q, k, v, causal=False),
                                   lambda q, k, v: ops.flash_attention(q, k, v, causal=False),
                                   (_rand(2, 8, 4, 16, requires_grad=True), _rand(2, 12, 2, 16),
                                    _rand(2, 12, 2, 16)), True),
        "lora_matmul": (lambda x, w, a, b: ref.lora_matmul_plain(x, w, a, b, alpha=2.0),
                        lambda x, w, a, b: ops.lora_matmul(x, w, a, b, alpha=2.0),
                        (_rand(6, 32), _rand(32, 48), _rand(32, 8), _rand(8, 48)), False),
        "lora_matmul_grouped": (lambda x, w, a, b: ref.lora_matmul_plain(x, w, a, b, alpha=2.0),
                                lambda x, w, a, b: ops.lora_matmul(x, w, a, b, alpha=2.0),
                                (_rand(6, 32), _rand(32, 48), _rand(3, 32, 8), _rand(3, 8, 48)), False),
    }


@pytest.mark.parametrize("case", list(_matmul_cases()))
def test_kernel_meta_flops_equal_the_twin_counted(case):
    """Exact equality: the kernel's count is the twin's products in full."""
    twin, kernel, args, backward = _matmul_cases()[case]
    want = _twin_flops(twin, *args, backward=backward)
    if backward:  # the forward's products too, as the meta run counts both launches
        want -= _twin_flops(twin, *[a.detach() for a in args])
        got = _meta_flops(kernel, *_as_meta(*args), backward=True) - _meta_flops(kernel, *_as_meta(*args))
    else:
        got = _meta_flops(kernel, *_as_meta(*args))
    assert got == want > 0


def test_meta_launch_allocates_what_the_card_path_allocates():
    """A meta ``flash_decode`` allocates its (B, H, splits, D + 2) scratch
    from the mirror of ``csrc/flash_decode.cu``'s plan, and counts one
    meta call and no launch; ``segmented_lora``'s plan mirror equals the
    source's formula."""
    assert ops.flash_decode_splits_for(32768, ops.META_SM_COUNT) == 132
    assert ops.flash_decode_splits_for(100, ops.META_SM_COUNT) == 2
    assert ops.segmented_lora_plan(2, 2048, 2048, 132) == (8, 32)  # bf16 K = N = 2 048: 256-row slabs, 64-wide tiles
    ops.reset_launch_counts()
    q, k = torch.empty((2, 4, 16), device="meta"), torch.empty((2, 100, 2, 16), device="meta")
    pos = torch.empty((2,), dtype=torch.int32, device="meta")
    out = ops.flash_decode(q, k, k, pos, torch.empty((2, 100), dtype=torch.int32, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (2, 4, 16)
    assert ops.meta_calls["flash_decode"] == 1 and ops.launch_counts["flash_decode"] == 0
    assert sum(ops.launch_counts.values()) == sum(ops.lora_matmul_routes.values()) == 0
    assert ops.kernel_work["flash_decode"]["flops"] == 4 * 2 * 4 * 100 * 16


def _source_constant(source: str, name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / source).read_text())
    assert len(found) == 1, (source, name, found)
    return int(found[0])


@pytest.mark.parametrize("source,name,mirror", [
    ("segmented_lora.cu", "THREADS", "SEGMENTED_THREADS"), ("segmented_lora.cu", "UNITS", "SEGMENTED_UNITS"),
    ("segmented_lora.cu", "STAGES", "SEGMENTED_STAGES"), ("segmented_lora.cu", "MAX_SLAB", "SEGMENTED_MAX_SLAB"),
    ("segmented_lora.cu", "BLOCKS_PER_SM", "SEGMENTED_BLOCKS_PER_SM"), ("flash_decode.cu", "SLAB", "DECODE_SLAB"),
])
def test_meta_plan_mirrors_match_the_sources(source, name, mirror):
    """The constants that size a meta call's scratch, as the CUDA sources
    size the card's."""
    assert getattr(ops, mirror) == _source_constant(source, name)


# ---------------------------------------------------- scan dispatch repair
class _OtherDevice(torch.Tensor):
    """A tensor that reports a device with no kernel (and holds no data)."""

    @staticmethod
    def __new__(cls, *shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(cls, shape, dtype=dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise AssertionError(f"{func} reached a tensor with no data")


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("reached the CUDA build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def test_scan_wrappers_raise_for_a_device_without_a_kernel(no_build):
    b, s, h, k, d, n = 1, 4, 2, 16, 8, 8
    wkv = [_OtherDevice(b, s, h, k) for _ in range(4)] + [_OtherDevice(h, k)]
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops.wkv6(*wkv)
    scan = [_OtherDevice(b, s, d), _OtherDevice(b, s, d), _OtherDevice(b, s, n), _OtherDevice(b, s, n),
            _OtherDevice(d, n), _OtherDevice(d)]
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops.mamba_scan(*scan)


def test_scan_autograd_functions_dispatch_by_device(no_build):
    """The autograd functions' own forward and backward take the same
    device dispatch (they tested ``device.type == "cpu"`` before)."""
    b, s, h, k, d, n = 1, 4, 2, 16, 8, 8
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops._WKV6.forward(type("ctx", (), {"set_materialize_grads": lambda *a: None,
                                           "save_for_backward": lambda *a: None})(),
                          *[_OtherDevice(b, s, h, k) for _ in range(4)], _OtherDevice(h, k), None)
    ctx = type("ctx", (), {"save_for_backward": lambda *a: None, "mark_non_differentiable": lambda *a: None})()
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops._MambaScan.forward(ctx, _OtherDevice(b, s, d), _OtherDevice(b, s, d), _OtherDevice(b, s, n),
                               _OtherDevice(b, s, n), _OtherDevice(d, n), _OtherDevice(d), None)


# ------------------------------------------------------------- the dry run
def _dense_train_launches(layers):
    """PERF.md §2: a dense step, every layer active (STLD off), one step."""
    return {"flash_attention": layers, "flash_attention_bwd": layers, "lora_matmul": 4 * layers - 2}


@pytest.mark.parametrize("arch,shape,expected", [
    ("qwen3-1.7b", "train_4k", lambda cfg: _dense_train_launches(cfg.num_layers)),
    ("jamba-v0.1-52b", "decode_32k", lambda cfg: {
        "flash_decode": sum(layer_kind(cfg, l) == "attn" for l in range(cfg.num_layers)),
        "mamba_scan": sum(layer_kind(cfg, l) == "mamba" for l in range(cfg.num_layers))}),
    ("granite-moe-3b-a800m", "prefill_32k", lambda cfg: {"flash_attention": cfg.num_layers}),
])
def test_full_width_cells_run_on_meta(arch, shape, expected):
    rec = dryrun.run_cell(arch, shape, multi_pod=False)
    assert rec["ok"] and rec["kernel_launches"] == expected(configs.get_config(arch))
    assert rec["flops"] > rec["kernel_flops"] > 0 and rec["bytes_accessed"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["local_argument_bytes"] > 0 and mem["argument_bytes"] > 0
    if shape == "train_4k":  # a dense train cell: rank 0 of the sharded step, its collectives counted
        assert rec["collectives"]["total"] == sum(rec["collectives"][k] for k in dryrun.COLLECTIVES) > 0
        assert mem["local_argument_bytes"] == mem["argument_bytes"] and not rec["notes"]
    else:
        assert rec["collectives"]["total"] == 0
        assert any("weights are whole" in note for note in rec["notes"])
    if arch == "jamba-v0.1-52b":  # its decode's MoE weight gather ran every expert: the record says so
        assert any("upper bound" in note for note in rec["notes"])


def test_cli_writes_the_reference_skip_record(tmp_path):
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k", "--out-dir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen3-1.7b__long_500k__16x16.json").read_text())
    assert rec == {"arch": "qwen3-1.7b", "shape": "long_500k", "mesh": "16x16", "ok": False, "skipped": True,
                   "reason": "long-context decode inapplicable (DESIGN.md skip matrix)"}


def test_long_context_decode_counts_the_sharded_combine():
    """jamba at ``long_500k``: each data rank decodes over its 1/16 of the
    cache, and the three all_reduces of each attention layer are counted."""
    rec = dryrun.run_cell("jamba-v0.1-52b", "long_500k", multi_pod=False)
    cfg = configs.get_config("jamba-v0.1-52b")
    attn = sum(layer_kind(cfg, l) == "attn" for l in range(cfg.num_layers))
    assert rec["collectives"]["count"] == 3 * attn
    assert rec["collectives"]["all-reduce"] == attn * 4 * cfg.num_heads * (2 + cfg.resolved_head_dim)


def test_sharded_smoke_cell_counts_what_its_gloo_run_counts(tmp_path):
    """A smoke train cell (qwen3-1.7b at 2 layers, ``d_ff`` 4 096 so that
    FSDP cuts leaves, float32, 4 x 16 tokens) on a 2 x 2 mesh with
    ``fsdp``: the dry run's collective bytes, kind by kind, equal those
    that 4 gloo ranks count running the same step on the CPU
    (``tests/_torch_tp_rank.py``); its ``argument_bytes`` are the
    whole-weights record's, and its peak lies below it."""
    import socket
    import subprocess
    import sys

    from _torch_tp_rank import case_config, flatten
    from repro_torch.analysis.trace import run_on_meta
    from repro_torch.configs import PEFTConfig, TrainConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.core.peft import init_peft
    from repro_torch.models.registry import init_params

    run = {"case": "c", "arch": "qwen3-1.7b", "d_ff": 4096, "mesh": [2, 2], "fsdp": True, "stld": "off"}
    cfg = case_config(run)
    gen = torch.Generator().manual_seed(0)
    data = {"runs": np.array(json.dumps([run])), "c/tokens": np.zeros((4, 17), np.int32),
            "c/gates": np.zeros((2, 2), bool)}
    flatten(init_params(cfg, gen), "c/params/", data)
    flatten(init_peft(cfg, PEFTConfig(), gen), "c/peft/", data)
    np.savez(tmp_path / "in.npz", **data)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    root = Path(__file__).resolve().parents[1]
    env = {"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(root / "tests" / "_torch_tp_rank.py"), str(r), "4", port,
                               str(tmp_path / "in.npz"), str(tmp_path / f"r{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    mesh, shape = ispec.MeshShape({"data": 2, "model": 2}), configs.InputShape("smoke_train", 16, 4, "train")
    rec = dryrun.run_config(cfg, shape, mesh, fsdp=True)
    # the whole-weights record: the unsharded step on one data rank's rows
    pcfg = PEFTConfig(method="lora", lora_rank=8)
    args, specs = ispec.train_inputs(cfg, pcfg, shape, mesh, fsdp=True)
    base, peft, opt, batch, rng = args
    rng.manual_seed(0)
    whole = run_on_meta(make_train_step(cfg, pcfg, TrainConfig()), base, peft, opt,
                        ispec.rank_slice(batch, specs[3], mesh), rng)
    logs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), [log[-2000:] for log in logs]
    for r in range(4):
        counts = json.loads(str(np.load(tmp_path / f"r{r}.npz")["0/counts"]))
        assert all(c == counts[0] for c in counts)
        assert {k: rec["collectives"][k] for k in counts[0]} == counts[0], (rec["collectives"], counts[0])
    assert rec["collectives"]["all-gather"] > 0 and rec["collectives"]["all-reduce"] > 0
    assert rec["memory"]["argument_bytes"] == dryrun.argument_bytes(args, specs, mesh)
    assert rec["memory"]["peak_bytes"] < whole.peak_bytes
    assert rec["kernel_launches"] == whole.kernel_launches


@pytest.mark.parametrize("arch,shape", [("qwen3-1.7b", "decode_32k"), ("qwen3-1.7b", "prefill_32k"),
                                        ("h2o-danube-1.8b", "long_500k")])
def test_dense_serving_cells_run_the_sharded_step(arch, shape):
    """A dense arch's serving cells run rank 0 of the sharded step at 16 x
    16: its part of the weights and caches (the head dim cut, 8 and 5 a
    rank; danube's sequence over ``data`` at ``long_500k``), every byte the
    specs give a device, collectives counted by ``Comm``; a decode runs the
    head-dim split pair once an attention layer, a prefill
    ``flash_attention``."""
    rec = dryrun.run_cell(arch, shape, multi_pod=False)
    cfg = configs.get_config(arch)
    mem = rec["memory"]
    assert rec["ok"] and not any("weights are whole" in note for note in rec["notes"])
    assert mem["local_argument_bytes"] == mem["argument_bytes"] > 0
    assert rec["collectives"]["total"] == sum(rec["collectives"][k] for k in dryrun.COLLECTIVES) > 0
    if shape == "prefill_32k":
        assert rec["kernel_launches"] == {"flash_attention": cfg.num_layers}
        assert rec["collectives"]["all-to-all"] > 0
    else:
        assert rec["kernel_launches"] == {"flash_decode_scores": cfg.num_layers, "flash_decode_combine": cfg.num_layers}
    assert (shape == "long_500k") == any("sequence is sharded" in note for note in rec["notes"])


def test_sharded_serving_smoke_cells_count_what_their_gloo_runs_count(tmp_path):
    """Smoke prefill and decode cells (qwen3-1.7b at 2 layers, float32,
    batch 4, a 12-token prompt and a 16-slot cache) on a 1 x 4 mesh, whose
    caches are cut on the head dim: the dry run's collective bytes, kind by
    kind, equal those that 4 gloo ranks count running the same steps on
    the CPU (``tests/_torch_tp_rank.py``'s ``serve_one``, bf16 caches as the
    dry run's), the prefill's and the first decode step's."""
    import socket
    import subprocess
    import sys

    from _torch_tp_rank import case_config, flatten
    from repro_torch.models.registry import init_params

    run = {"kind": "serve", "case": "c", "arch": "qwen3-1.7b", "mesh": [1, 4], "steps": 4, "cache_dtype": "bfloat16"}
    cfg = case_config(run)
    data = {"runs": np.array(json.dumps([run])), "c/prompt": np.zeros((4, 12), np.int32)}
    flatten(init_params(cfg, torch.Generator().manual_seed(0)), "c/params/", data)
    np.savez(tmp_path / "in.npz", **data)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    root = Path(__file__).resolve().parents[1]
    env = {"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(root / "tests" / "_torch_tp_rank.py"), str(r), "4", port,
                               str(tmp_path / "in.npz"), str(tmp_path / f"r{r}.npz")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(4)]
    mesh = ispec.MeshShape({"data": 1, "model": 4})
    prefill = dryrun.run_config(cfg, configs.InputShape("smoke_prefill", 12, 4, "prefill"), mesh)
    decode = dryrun.run_config(cfg, configs.InputShape("smoke_decode", 16, 4, "decode"), mesh)
    logs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), [log[-2000:] for log in logs]
    for r in range(4):
        counts = json.loads(str(np.load(tmp_path / f"r{r}.npz")["0/counts"]))
        for rec, got in ((prefill, counts[0]), (decode, counts[1])):
            assert {k: rec["collectives"][k] for k in got} == got, (rec["collectives"], got)
    assert prefill["collectives"]["all-to-all"] > 0 and decode["collectives"]["all-gather"] > 0
    assert decode["kernel_launches"] == {"flash_decode_scores": 2, "flash_decode_combine": 2}
