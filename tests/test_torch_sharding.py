"""The port's sharding layer against the JAX package, on the CPU.

Specs: ``param_specs`` (plain, with ``fsdp_axes`` and with
``expert_shard="ff"``), ``peft_specs`` and ``cache_specs`` (batch-sharded,
and sequence-sharded at batch 1) equal the reference's spec for spec, for
all ten archs at full config and TP 16: the port's from ``meta``-device
shapes (``models.registry.param_shapes``, ``init_caches(device="meta")``),
the reference's from ``jax.eval_shape`` over its own init functions, as
``tests/test_sharding_rules.py`` builds them.  A reference spec lists fewer
dims than the tensor has where the rest replicate; the port lists one entry
per dim, so the reference's is padded with None before the comparison.
The reference's own rule assertions (``tests/test_sharding_rules.py``) hold
on the port's specs.

Mesh: ``make_production_mesh`` under a fake process group of 256 and 512
ranks has the reference's shape and axis names.

Sharded decode: 4 gloo ranks on the CPU, each with a quarter of the cache
along the sequence, merge to within 1e-5 (float32) of the reference's
``_partial_attention`` over the whole cache: no window, a window of 16 (the
first shard wholly outside it) and a query in the second shard (the last
two shards wholly in its future).  The same ranks hold ``to_shardings``'s
placements against ``distribute_tensor`` on a 2 x 2 mesh.
"""
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JaxP

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import PEFTConfig as JaxPEFTConfig
from repro.configs import get_config as jax_get_config
from repro.launch import mesh as jax_mesh
from repro.launch.input_specs import eval_cache_shapes, eval_param_shapes, eval_peft_shapes
from repro.serving import decode as jax_decode
from repro.sharding import specs as JS
from repro_torch.configs import ARCH_IDS, PEFTConfig, get_config
from repro_torch.launch import mesh
from repro_torch.models.registry import param_shapes, peft_shapes
from repro_torch.models.transformer import init_caches
from repro_torch.sharding import specs as S

ROOT = Path(__file__).resolve().parents[1]
TP = 16
AXES = {"pod": 2, "data": 16, "model": 16}


class _FakeMesh:
    shape = AXES


@pytest.fixture(autouse=True)
def mesh_sizes():
    """Both packages' recorded axis sizes (module globals), for every test."""
    S.set_mesh_axis_sizes(_FakeMesh)
    JS.set_mesh_axis_sizes(_FakeMesh)
    yield


_SHAPES = {}


def _param_shapes(arch):
    """(the port's meta tree, the reference's eval_shape tree), once per arch."""
    if arch not in _SHAPES:
        _SHAPES[arch] = param_shapes(get_config(arch)), eval_param_shapes(jax_get_config(arch))
    return _SHAPES[arch]


def _flat(tree, path=()):
    """(path, leaf) pairs of the port's tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _flat(tree[k], path + (k,))]
    if isinstance(tree, list) or (isinstance(tree, tuple) and not isinstance(tree, S.PartitionSpec)):
        return [p for i, t in enumerate(tree) for p in _flat(t, path + (i,))]
    return [(path, tree)]


def _jax_flat(tree):
    out = []

    def visit(path, leaf):
        out.append((tuple(p.key if hasattr(p, "key") else p.idx for p in path), leaf))
        return leaf

    jax.tree_util.tree_map_with_path(visit, tree, is_leaf=lambda x: isinstance(x, JaxP))
    return out


def _assert_specs_equal(port_specs, port_shapes, jax_specs):
    """Spec for spec at the same key paths, the reference's padded to one
    entry per dim."""
    mine, theirs, shapes = _flat(port_specs), _jax_flat(jax_specs), dict(_flat(port_shapes))
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, got), (_, want) in zip(mine, theirs):
        ndim = len(shapes[path].shape)
        assert isinstance(got, S.PartitionSpec) and len(got) == ndim, (path, got)
        assert tuple(got) == tuple(want) + (None,) * (ndim - len(want)), (path, got, want)


def test_the_port_runs_the_reference_archs():
    assert ARCH_IDS == JAX_ARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch):
    ours, theirs = _param_shapes(arch)
    assert [(p, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in _flat(ours)] == \
        [(p, tuple(t.shape), str(t.dtype)) for p, t in _jax_flat(theirs)]
    assert {t.device.type for _, t in _flat(ours)} == {"meta"}
    for kw in ({}, {"fsdp_axes": ("data",)}, {"fsdp_axes": ("pod", "data")}, {"expert_shard": "ff"}):
        _assert_specs_equal(S.param_specs(ours, TP, **kw), ours, JS.param_specs(theirs, TP, **kw))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_peft_and_cache_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ours, theirs = peft_shapes(cfg, PEFTConfig()), eval_peft_shapes(jcfg, JaxPEFTConfig())
    specs = S.peft_specs(ours)
    _assert_specs_equal(specs, ours, JS.peft_specs(theirs))
    assert all(all(e is None for e in spec) for _, spec in _flat(specs))
    for batch, max_len, axes, seq in ((128, 1024, ("data",), False), (1, 4096, ("data",), True),
                                      (64, 256, ("pod", "data"), False)):
        ours = init_caches(cfg, batch, max_len, device="meta")
        theirs = eval_cache_shapes(jcfg, batch, max_len)
        assert [(p, tuple(t.shape)) for p, t in _flat(ours)] == [(p, tuple(t.shape)) for p, t in _jax_flat(theirs)]
        _assert_specs_equal(S.cache_specs(ours, axes, TP, shard_seq_on_data=seq), ours,
                            JS.cache_specs(theirs, axes, TP, shard_seq_on_data=seq))


# the reference's rule assertions (tests/test_sharding_rules.py) on the port's specs
def _find(specs, *needles):
    return [(tuple(map(str, p)), s) for p, s in _flat(specs) if all(n in tuple(map(str, p)) for n in needles)]


def _drop_layer_lead(parts, spec):
    if S._stacked_layer_lead(parts):
        assert spec[0] is None
        return tuple(spec[1:])
    return tuple(spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_all_specs_divisible(arch):
    shapes, _ = _param_shapes(arch)
    leaves = dict(_flat(shapes))
    for path, spec in _flat(S.param_specs(shapes, TP)):
        for dim, axes in enumerate(spec):
            if axes is not None:
                assert leaves[path].shape[dim] % TP == 0, (path, spec)


def test_rule_fallbacks_as_the_reference_states_them():
    specs = S.param_specs(_param_shapes("yi-6b")[0], TP)
    (wq_parts, wq), = _find(specs, "wq", "w")
    (wo_parts, wo), = _find(specs, "wo", "w")
    assert _drop_layer_lead(wq_parts, wq) == (None, "model")   # column parallel
    assert _drop_layer_lead(wo_parts, wo) == ("model", None)   # row parallel
    parts, eg = _find(S.param_specs(_param_shapes("llama4-scout-17b-a16e")[0], TP), "experts", "gate")[0]
    assert _drop_layer_lead(parts, eg) == ("model", None, None)  # 16 experts over 16
    granite = S.param_specs(_param_shapes("granite-moe-3b-a800m")[0], TP)
    parts, eg = _find(granite, "experts", "gate")[0]
    assert _drop_layer_lead(parts, eg) == (None, None, "model")  # 40 experts: within-expert d_ff
    assert _find(granite, "embed")[0][1] == (None, "model")      # vocab 49 155: d_model
    whisper = _find(S.param_specs(_param_shapes("whisper-tiny")[0], TP), "wq", "w")
    assert whisper and all(_drop_layer_lead(p, s) == (None, "model") for p, s in whisper)


def test_expert_shard_ff_moves_experts_off_the_expert_dim():
    shapes = _param_shapes("llama4-scout-17b-a16e")[0]
    parts, eg = _find(S.param_specs(shapes, TP, expert_shard="ff"), "experts", "gate")[0]
    assert _drop_layer_lead(parts, eg) == (None, None, "model")


def test_cache_specs_decode_vs_long_context():
    cfg = get_config("yi-6b")
    sp = S.cache_specs(init_caches(cfg, 128, 1024, device="meta"), ("data",), TP)
    assert sp[0]["k"][0] == "data" and sp[0]["k"][3] == "model"  # batch; kv 4 < 16 -> head_dim
    sp1 = S.cache_specs(init_caches(cfg, 1, 4096, device="meta"), ("data",), TP, shard_seq_on_data=True)
    assert sp1[0]["k"][1] == "data"  # sequence sharded at batch 1
    rwkv = S.cache_specs(init_caches(get_config("rwkv6-3b"), 128, 16, device="meta"), ("data",), TP)
    assert rwkv[0]["shift_tm"][0] == "data"


def test_batch_spec_equals_the_reference():
    for axes, ndim, dim in ((("data",), 2, 0), (("pod", "data"), 3, 1)):
        assert tuple(S.batch_spec(axes, ndim, batch_dim=dim)) == tuple(JS.batch_spec(axes, ndim, batch_dim=dim))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_has_the_reference_shape_and_axes(monkeypatch, multi_pod):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    world = 512 if multi_pod else 256
    shape, axes = mesh.production_mesh_shape(multi_pod=multi_pod)
    assert world == int(np.prod(shape))
    # the shape and names the reference's make_production_mesh hands jax.make_mesh
    seen = {}
    monkeypatch.setattr(jax, "make_mesh", lambda s, a: seen.update(shape=tuple(s), axes=tuple(a)))
    jax_mesh.make_production_mesh(multi_pod=multi_pod)
    assert (shape, axes) == (seen["shape"], seen["axes"])
    dist.init_process_group("fake", store=FakeStore(), rank=world - 1, world_size=world)
    try:
        m = mesh.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert m.mesh_dim_names == axes and tuple(m.mesh.shape) == shape
        assert mesh.data_axes(m) == axes[:-1] and mesh.model_axis_size(m) == 16
        assert mesh.axis_sizes(m) == dict(zip(axes, shape))
    finally:
        dist.destroy_process_group()


def test_host_mesh_is_one_by_one_over_the_local_device():
    """``make_host_mesh`` starts a one-process group when there is none."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        m = mesh.make_host_mesh(device_type="cpu")
        assert dist.get_world_size() == 1
        assert mesh.axis_sizes(m) == {"data": 1, "model": 1} and mesh.data_axes(m) == ("data",)
        assert mesh.model_axis_size(m) == 1
    finally:
        dist.destroy_process_group()


_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.serving.decode import sharded_decode_attention
from repro_torch.sharding import specs

rank, port, inputs, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=4)
data = np.load(inputs)
q, k, v, kpos = (torch.from_numpy(data[n]) for n in ("q", "k", "v", "kpos"))
shard = k.shape[1] // 4
sl = slice(rank * shard, (rank + 1) * shard)
seq_mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
results = {}
for i, (q_position, window) in enumerate(data["cases"]):
    results[f"out{i}"] = sharded_decode_attention(seq_mesh, q, k[:, sl], v[:, sl], kpos[sl], int(q_position),
                                                  window=int(window) or None).numpy()
grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
specs.set_mesh_axis_sizes(grid)
tree = {"layers": {"attn": {"wq": {"w": torch.from_numpy(data["wq"])}}}, "embed": torch.from_numpy(data["embed"])}
placed = specs.to_shardings(grid, specs.param_specs(tree, 2, fsdp_axes=("data",)))
results["wq"] = distribute_tensor(tree["layers"]["attn"]["wq"]["w"], grid,
                                  placed["layers"]["attn"]["wq"]["w"]).to_local().numpy()
results["embed"] = distribute_tensor(tree["embed"], grid, placed["embed"]).to_local().numpy()
results["placements"] = np.array([repr(placed["layers"]["attn"]["wq"]["w"]), repr(placed["embed"])])
np.savez(out, **results)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_sharded_decode_on_four_gloo_ranks_equals_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    b, h, kv, d, s = 2, 4, 2, 16, 64
    cases = np.array([(40, 0), (40, 16), (20, 0)])  # window 0 = none
    data = {"q": rng.standard_normal((b, h, d), dtype=np.float32),
            "k": rng.standard_normal((b, s, kv, d), dtype=np.float32),
            "v": rng.standard_normal((b, s, kv, d), dtype=np.float32),
            "kpos": np.arange(s, dtype=np.int64), "cases": cases,
            "wq": rng.standard_normal((3, 2048, 1024), dtype=np.float32),
            "embed": rng.standard_normal((512, 64), dtype=np.float32)}
    np.savez(tmp_path / "in.npz", **data)
    port = str(_free_port())
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(r), port, str(tmp_path / "in.npz"),
                               str(tmp_path / f"out{r}.npz")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    logs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(4)]
    for i, (q_position, window) in enumerate(cases):
        acc, m, l = jax_decode._partial_attention(jnp.asarray(data["q"]), jnp.asarray(data["k"]),
                                                  jnp.asarray(data["v"]), jnp.asarray(data["kpos"]),
                                                  int(q_position), int(window) or None)
        want = np.asarray(acc / jnp.maximum(l, 1e-30)[..., None])
        for r in range(4):
            np.testing.assert_allclose(outs[r][f"out{i}"], want, rtol=0, atol=1e-5, err_msg=f"case {i} rank {r}")
    # the wholly masked shards the cases were built to have
    assert window_masked(cases[1], s) == [0] and future_masked(cases[2], s) == [2, 3]
    # wq (3, 2048, 1024): stacked lead, columns over model, FSDP rows over data;
    # embed (512, 64): rows over model (a vocab of 512 divides 2)
    for r in range(4):
        di, mi = divmod(r, 2)
        assert str(outs[r]["placements"][0]) == "(Shard(dim=1), Shard(dim=2))"
        np.testing.assert_array_equal(outs[r]["wq"], data["wq"][:, di * 1024:(di + 1) * 1024, mi * 512:(mi + 1) * 512])
        np.testing.assert_array_equal(outs[r]["embed"], data["embed"][mi * 256:(mi + 1) * 256])


def window_masked(case, s):
    q_position, window = case
    shard = s // 4
    return [r for r in range(4) if (r + 1) * shard - 1 <= q_position - window]


def future_masked(case, s):
    shard = s // 4
    return [r for r in range(4) if r * shard > case[0]]
