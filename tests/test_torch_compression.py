"""The port's uplink compression against the JAX package, on the CPU.

* Every function of ``compression.py`` on seeded random trees of both
  layouts (stacked ``(L, ...)`` leaves and a per-layer list), with tied
  magnitudes and zeros: ``topk_sparsify``, the int8 values and scales,
  ``dequantize_int8`` and ``compress_decompress`` bit for bit;
  ``ef_step``'s sent tree and residual (decays 1.0 and 0.5) within two ulps
  of the leaf's largest ``|update + decay·residual|``: inside the fused
  ``ef_step`` XLA's CPU backend may take ``/ 127`` as a multiplication by
  its rounded reciprocal (the scale one ulp off) and contracts ``corrected
  - v * scale`` into one fused multiply-add, where the port (as the
  reference's unfused functions) rounds each operation; ``compressed_bytes`` and
  ``uplink_ratio`` equal to the reference's and ``compressed_bytes`` to the
  port's ``serialize_compressed``, whose buffers equal the reference's.
* ``compression="auto"`` and ``{"tune": True}`` (the joint bandit) run a
  round with the bandit's startup arms (``tests/test_torch_joint_bandit.py``
  holds it to the reference).  The runner at ``int8+topk`` with error feedback
  is held to JAX's under the deadline schedule in
  ``tests/test_torch_schedules.py``, and ``compression="none"`` to no
  compression there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fed_parity import one_torch_thread  # noqa: F401 (an autouse fixture)
from _torch_fed_parity import CFG_KW, assert_trees_equal, leaves
from repro.federated import compression as jax_comp
from repro_torch import api
from repro_torch.configs import FederatedConfig, get_config
from repro_torch.federated import compression as comp

KINDS = ("int8", "topk", "int8+topk")


def _tree(layout, seed=0):
    """A LoRA-shaped tree with ties (magnitudes from a small set) and
    zeros; numpy float32."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        x = rng.integers(-6, 7, size=shape).astype(np.float32) * np.float32(0.125)
        x += (rng.random(shape) < 0.3) * rng.standard_normal(shape).astype(np.float32)
        return x

    if layout == "stacked":
        return {"attn": {"q": {"a": leaf(4, 32, 2), "b": leaf(4, 2, 32)}, "v": {"a": leaf(4, 32, 2),
                                                                              "b": leaf(4, 2, 16)}}}
    return [{"attn": {"q": {"a": leaf(32, 2), "b": leaf(2, 32)}}, "tiny": leaf(3)} for _ in range(3)]


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_topk_k_matches_jax_on_a_grid():
    for n in (1, 2, 3, 7, 10, 64, 100, 1000, 65536):
        for f in (0.01, 0.05, 0.1, 0.25, 0.5, 0.999, 1.0):
            assert comp.topk_k(n, f) == jax_comp.topk_k(n, f)


def test_topk_exact_k_on_ties():
    """The reference's case: four tied magnitudes at the threshold, k = 3,
    the lowest flat indices kept."""
    x = {"w": torch.tensor([2.0, -2.0, 2.0, 2.0, 0.1, 0.2, 0.0, 0.3, 0.1, 0.05])}
    assert np.flatnonzero(comp.topk_sparsify(x, 0.25)["w"].numpy()).tolist() == [0, 1, 2]


@pytest.mark.parametrize("layout,fraction", [("stacked", 0.05), ("list", 0.25)])
def test_functions_match_jax_bit_for_bit(layout, fraction):
    tree = _tree(layout)
    jt, pt = jax.tree.map(jnp.asarray, tree), _torch(tree)
    assert_trees_equal(comp.topk_sparsify(pt, fraction), jax_comp.topk_sparsify(jt, fraction))
    vals, scales = comp.quantize_int8(pt)
    jvals, jscales = jax_comp.quantize_int8(jt)
    assert_trees_equal(vals, jvals)
    assert_trees_equal(scales, jscales)
    assert all(v.dtype == np.int8 for _, v in leaves(vals))
    assert_trees_equal(comp.dequantize_int8(vals, scales), jax_comp.dequantize_int8(jvals, jscales))
    residual = _tree(layout, seed=1)
    for kind in KINDS:
        assert_trees_equal(comp.compress_decompress(pt, kind=kind, fraction=fraction),
                           jax_comp.compress_decompress(jt, kind=kind, fraction=fraction))
        for decay in (1.0, 0.5):
            sent, res = comp.ef_step(pt, _torch(residual), kind=kind, fraction=fraction, decay=decay)
            jsent, jres = jax_comp.ef_step(jt, jax.tree.map(jnp.asarray, residual), kind=kind, fraction=fraction,
                                           decay=decay)
            _assert_ef(sent, jsent, tree, residual, decay)
            _assert_ef(res, jres, tree, residual, decay)


def _assert_ef(got, want, tree, residual, decay):
    """Within two ulps of each leaf's largest ``|update + decay·residual|``."""
    for (path, g), (_, w), (_, x), (_, r) in zip(leaves(got), leaves(want), leaves(tree), leaves(residual)):
        ulp = np.spacing(np.abs(x + np.float32(decay) * r).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * ulp, err_msg=str(path))


@pytest.mark.parametrize("layout", ["stacked", "list"])
@pytest.mark.parametrize("kind", comp.LEVELS)
def test_byte_accounting_matches_jax_and_the_serialized_buffers(layout, kind):
    tree = _tree(layout, seed=2)
    jt, pt = jax.tree.map(jnp.asarray, tree), _torch(tree)
    cfg = comp.CompressionConfig(kind=kind, topk_fraction=0.1)
    jcfg = jax_comp.CompressionConfig(kind=kind, topk_fraction=0.1)
    buffers, jbuffers = comp.serialize_compressed(pt, cfg), jax_comp.serialize_compressed(jt, jcfg)
    assert comp.compressed_bytes(pt, cfg) == jax_comp.compressed_bytes(jt, jcfg) == sum(b.nbytes for b in buffers)
    assert len(buffers) == len(jbuffers)
    for b, w in zip(buffers, jbuffers):
        assert b.dtype == w.dtype
        np.testing.assert_array_equal(b, w)
    assert comp.uplink_ratio(pt, cfg) == jax_comp.uplink_ratio(jt, jcfg)


def test_error_feedback_helpers_match_jax():
    tree, residual = _tree("stacked", 3), _tree("stacked", 4)
    jt = jax.tree.map(jnp.asarray, tree)
    assert_trees_equal(comp.ErrorFeedback.init(_torch(tree)), jax_comp.ErrorFeedback.init(jt))
    sent, res = comp.ErrorFeedback.compress(_torch(tree), _torch(residual), comp.int8_roundtrip)
    jsent, jres = jax_comp.ErrorFeedback.compress(jt, jax.tree.map(jnp.asarray, residual), jax_comp.int8_roundtrip)
    assert_trees_equal(sent, jsent)
    _assert_ef(res, jres, tree, residual, 1.0)


def test_resolve_compression_follows_jax():
    for spec in (None, "none", "int8", "topk", "int8+topk", "auto", {"kind": "topk", "topk_fraction": 0.2}):
        got, want = comp.resolve_compression(spec), jax_comp.resolve_compression(spec)
        assert (got is None and want is None) or vars(got) == vars(want)
    assert vars(comp.resolve_compression("topk", topk_fraction=0.3)) == vars(
        jax_comp.resolve_compression("topk", topk_fraction=0.3))
    for bad in ({"kind": "int4"}, {"topk_fraction": 0.0}, {"ef_decay": 2.0}):
        with pytest.raises(ValueError):
            comp.resolve_compression(bad)
    with pytest.raises(ValueError, match="no effect"):
        comp.resolve_compression(None, topk_fraction=0.1)


# ------------------------------------------------------------- the runner
@pytest.mark.parametrize("spec", ["auto", {"kind": "int8", "tune": True}])
def test_joint_bandit_raises(spec):
    """The joint bandit, which raised until it was ported, runs a round:
    its first arms are the startup pairs, round-robin over the cohort, and
    each device's uplink ratio follows its level (1 for ``none``).  The
    name is the one the test had while the bandit raised: each case now
    asserts that it runs."""
    cfg = get_config("qwen3-1.7b", smoke=True).replace(**CFG_KW)
    runner = api.build("droppeft", cfg=cfg, fed_cfg=FederatedConfig(num_devices=4, devices_per_round=3, local_steps=1,
                                                                     batch_size=2), device="cpu", compression=spec)
    assert runner.state.configurator.joint
    plans, compress = [], runner.algorithm.compress_uplink

    def recorded(state, results):
        state, results = compress(state, results)
        plans.append((list(results.plan.rates), list(results.plan.compression), results.uplink_ratio.tolist()))
        return state, results

    runner.algorithm.compress_uplink = recorded
    assert runner.run(rounds=1).rounds == 1
    rates, levels, ratios = plans[0]
    assert list(zip(rates, levels)) == [(0.2, "none"), (0.5, "int8"), (0.7, "topk")]
    assert ratios[0] == 1.0 and max(ratios[1:]) < 1.0
