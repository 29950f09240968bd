"""Checks behind ``chip_smoke.py`` phase 5m's choices, on a CUDA card.

1. A random full-width internvl2-76b fed the zero patches of the
   reference's client overflows its backward: a zero patch row stays zero
   through every layer (it attends to zero rows only), and the RMSNorm
   backward of a zero row multiplies its gradient by 1 / sqrt(eps), so the
   gradient at a layer's output grows a few hundred times a layer down.
   At 19 layers (batch 4 x (256 + 512) tokens, rate 0.0) the gradient
   reaching layer 0 is inf with ``remat`` and without it; with patches
   drawn at the token embeddings' scale (``chip_smoke.remat_batches``)
   every gradient is finite.  Phase 5m draws its patches for that reason.
2. A caching allocator filled with NaN (its free blocks written with NaN
   before the step) changes no bit of qwen3-1.7b's gradients (full depth,
   16 x 512) nor of internvl2-76b's at 9 layers, with ``remat`` and
   without: no kernel of these steps reads memory it did not write.

It prints one JSON line per run (the largest gradient at each layer's
output, the layers whose PEFT gradients are not finite) and exits 0 only
if both claims hold.  With ``--meta`` it needs no card: it prints the
``run_on_meta`` peaks that phase 5m's prediction took, qwen3-1.7b's train
step at 16 x 512 and rate 0.0 with and without ``remat`` and
internvl2-76b's ``remat`` step at 8, 16, 29 and 30 layers::

    PYTHONPATH=src python3 tests/cuda_remat_checks.py [--meta]
"""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import InputShape, PEFTConfig, TrainConfig, get_config  # noqa: E402
from repro_torch.core.peft import init_peft, lora_scale  # noqa: E402
from repro_torch.launch.steps import make_train_step, token_logits, value_and_grad  # noqa: E402
from repro_torch.models import stacking, transformer  # noqa: E402
from repro_torch.models.losses import softmax_xent  # noqa: E402
from repro_torch.models.registry import init_params, model_apply  # noqa: E402

SEQ = 512


class OutputGrads:
    """The largest gradient at each layer's output (forward order), through
    hooks on ``stack_apply``'s layer calls, checkpointed or not."""

    def __init__(self):
        self.seen, self.run_layer, self.layer_apply = [], transformer._run_layer, transformer.layer_apply

    def _hooked(self, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if out[0].requires_grad:
                i = len(self.seen)
                self.seen.append(None)
                out[0].register_hook(lambda g, i=i: self.seen.__setitem__(i, float(g.float().abs().max())))
            return out

        return call

    def __enter__(self):
        transformer._run_layer, transformer.layer_apply = self._hooked(self.run_layer), self._hooked(self.layer_apply)
        return self

    def __exit__(self, *exc):
        transformer._run_layer, transformer.layer_apply = self.run_layer, self.layer_apply
        return False


def nan_fill(gib: int) -> int:
    """Writes NaN into up to ``gib`` GiB of fresh allocations and frees
    them: the caching allocator keeps the blocks for the next step."""
    blocks = []
    try:
        for _ in range(gib):
            blocks.append(torch.full((1 << 28,), float("nan"), device="cuda"))
    except torch.cuda.OutOfMemoryError:
        pass
    n = len(blocks)
    del blocks
    return n


def gradients(arch: str, layers, batch: int, remat: bool, zero_patches: bool = False, nan_gib: int = 0) -> dict:
    """The PEFT gradients of one loss at rate 0.0 (every layer), weights
    and batch from seed 0, and the largest gradient at each layer's
    output."""
    cs.free_memory("cuda")
    cfg = get_config(arch)
    cfg = cfg.replace(num_layers=layers) if layers else cfg
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(cfg, gen, place=True)
    peft = init_peft(cfg, PEFTConfig(), gen)
    batch = cs.remat_batches(cfg, gen, 1, batch, SEQ)[0]
    if zero_patches:
        batch[cfg.frontend_key] = torch.zeros_like(batch[cfg.frontend_key])
    tokens = batch["tokens"]
    inputs = dict(batch, tokens=tokens[:, :-1])
    filled = nan_fill(nan_gib) if nan_gib else 0

    def loss(pf):
        logits, _, _ = model_apply(params, cfg, inputs, peft=pf, lora_scale=lora_scale(PEFTConfig()), remat=remat)
        return softmax_xent(token_logits(cfg, logits, SEQ), tokens[:, 1:])

    with OutputGrads() as hooks:
        _, grads = value_and_grad(loss)(peft)
    leaves = stacking.tree_leaves(grads)
    bad = sorted({l for g in leaves for l in range(g.shape[0]) if not bool(torch.isfinite(g[l]).all())})
    return {"arch": arch, "layers": cfg.num_layers, "batch": tokens.shape[0], "remat": remat,
            "zero_patches": zero_patches, "nan_filled_gib": filled, "nonfinite_grad_layers": bad,
            "max_output_grad_by_layer": hooks.seen, "grads": [g.cpu() for g in leaves]}


def show(run: dict):
    print(json.dumps({k: v for k, v in run.items() if k != "grads"}), flush=True)


def meta_peaks(seed: int = 0):
    from repro_torch.analysis.trace import run_on_meta
    from repro_torch.launch import input_specs as ispec

    mesh = ispec.MeshShape({"data": 1, "model": 1})

    def peak(cfg, remat: bool) -> float:
        args, _ = ispec.train_inputs(cfg, PEFTConfig(), InputShape("remat", SEQ, 16, "train"), mesh,
                                     weights_dtype="placed")
        step = make_train_step(cfg, PEFTConfig(), TrainConfig(), stld_mode="cond", mean_rate=0.0, remat=remat)
        return run_on_meta(step, *args[:4], torch.Generator().manual_seed(seed)).peak_bytes / 2**30

    qwen3, internvl = get_config("qwen3-1.7b"), get_config("internvl2-76b")
    print(json.dumps({"qwen3-1.7b peak GiB": {"plain": peak(qwen3, False), "remat": peak(qwen3, True)},
                      "internvl2-76b remat peak GiB by layers": {
                          n: peak(internvl.replace(num_layers=n), True) for n in (8, 16, 29, 30)}}), flush=True)
    return 0


def main() -> int:
    if "--meta" in sys.argv:
        return meta_peaks()
    if not torch.cuda.is_available():
        print("cuda_remat_checks: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    _build.build()
    ok = True
    for remat in (False, True):  # claim 1
        for zero in (True, False):
            run = gradients("internvl2-76b", 19, 4, remat, zero_patches=zero)
            show(run)
            ok &= (0 in run["nonfinite_grad_layers"]) if zero else not run["nonfinite_grad_layers"]
    for arch, layers in (("qwen3-1.7b", None), ("internvl2-76b", 9)):  # claim 2
        for remat in (False, True):
            clean, filled = gradients(arch, layers, 16, remat), gradients(arch, layers, 16, remat, nan_gib=75)
            show(filled)
            same = all(torch.equal(a, b) for a, b in zip(clean["grads"], filled["grads"]))
            print(json.dumps({"arch": arch, "remat": remat, "nan_filled_bit_identical": same}), flush=True)
            ok &= same and not filled["nonfinite_grad_layers"] and filled["nan_filled_gib"] > 0
    print(json.dumps({"ok": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
