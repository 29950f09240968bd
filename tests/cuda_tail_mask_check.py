"""Mutation check of the key-length tail masks, on a CUDA card.

Over 1 500 keys of N(0, 1) inputs a typical |out| of bidirectional
attention is ~0.04, as small as the bf16 allclose limit (3e-2 + 1e-2
|ref|).  A key past S_kv left visible (the zero-filled rows of the last
K/V tile) scales every output by ~0.986 and passes that limit; the
relative L2 limits of ``chip_smoke.py`` phase 3 (``BF16_REL_L2``) and of
``tests/test_torch_cuda.py`` (``_rel_l2_close``) are there to catch it.

This script shows that they do.  It copies ``src/repro_torch`` under
``build/tail_mask/`` three times: sound; with the attention forward's
tail mask dropped (both routes); with ``flash_decode`` counting the slots
past a chunk's end.  On each copy it runs, in processes of their own,
``chip_smoke.attention_case`` and ``chip_smoke.decode_case`` at
whisper-tiny's phase-3 shapes and the CUDA tests of keys of their own
length and of every slot live, and prints one JSON line per copy: the
relative L2 errors of the output and the gradients, and which checks
failed.  It exits 0 only if the sound copy passes everything and each
faulty copy fails both ``chip_smoke.py``'s check and the CUDA tests::

    python3 tests/cuda_tail_mask_check.py
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "tail_mask"
KERNELS = ("flash_attention", "flash_attention_bwd", "flash_decode")
CUDA_TESTS = "key_length_of_its_own_matches_twin or every_slot_live"
FAULTS = {  # copy -> {source file: [(sound text, faulty text, occurrences)]}
    "sound": {},
    "attention_tail_visible": {"flash_attention.cu": [
        ("const bool full = k0 + BK <= Skv &&", "const bool full = k0 + BK <= (Skv + BK - 1) / BK * BK &&", 1),
        ("(lane & 3) + (e & 1), Skv, causal, window))", "(lane & 3) + (e & 1), (Skv + BK - 1) / BK * BK, causal, window))",
         1),
        ("key_visible(qi, k0 + col, Skv, causal, window)", "key_visible(qi, k0 + col, nk * BK, causal, window)", 1),
    ]},
    "decode_chunk_tail_counted": {"flash_decode.cu": [
        ("const bool slot_live = js < nb && live_s[js];", "const bool slot_live = js >= nb || live_s[js];", 1),
        ("p[r] = js < nb ? expf(s - m_new) : 0.f;", "p[r] = expf(s - m_new);", 1),
    ]},
}


def make_copy(name: str) -> Path:
    """``build/tail_mask/<name>/src/repro_torch`` with ``FAULTS[name]`` applied."""
    src = OUT / name / "src"
    shutil.rmtree(OUT / name, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", src / "repro_torch", ignore=shutil.ignore_patterns("__pycache__"))
    for fname, edits in FAULTS[name].items():
        path = src / "repro_torch" / "kernels" / "csrc" / fname
        text = path.read_text()
        for sound, faulty, count in edits:
            assert text.count(sound) == count, (fname, sound)
            text = text.replace(sound, faulty)
        path.write_text(text)
    return src


def worker(src: str) -> dict:
    """chip_smoke's phase-3 checks at whisper-tiny's shapes on the copy at
    ``src``, with the relative L2 errors measured apart from them: at those
    shapes and at the CUDA tests' (their draws)."""
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs

    sys.path[:0] = [src, str(ROOT / "tests")]
    import test_torch_cuda as tc
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.nn.attention import ring_positions

    assert Path(ops.__file__).resolve().is_relative_to(Path(src).resolve()), ops.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(KERNELS)
    timer, out = cs.Timer(), {"rel_l2": {}, "failed": []}
    bf16 = torch.bfloat16

    def draw(shapes):
        gen = torch.Generator(device="cuda").manual_seed(8)
        return [torch.randn(shape, generator=gen, device="cuda").to(bf16) for shape in shapes]

    attention = {f"whisper {b}x{s}x{skv}": draw(((b, s, 6, 64), (b, skv, 6, 64), (b, skv, 6, 64), (b, s, 6, 64)))
                 for b, s, skv in ((16, 1500, 1500), (16, 512, 1500))}
    for b, sq, skv, h, kv, d in tc.CROSS_CASES:
        attention[f"test {b}x{sq}x{skv} H{h} KV{kv} D{d}"] = tc._cross(np.random.default_rng(14), b, sq, skv, h, kv, d,
                                                                      "bfloat16", "cuda")
    for tag, (q, k, v, g) in attention.items():
        leaves, twins = ([t.clone().requires_grad_(True) for t in (q, k, v)] for _ in range(2))
        got = ops.flash_attention(*leaves, causal=False)
        want = ref.attention_plain(*twins, causal=False)
        pairs = [(got, want), *zip(torch.autograd.grad(got, leaves, g), torch.autograd.grad(want, twins, g))]
        out["rel_l2"][f"attention {tag} (out, dq, dk, dv)"] = [cs.rel_l2(x, y) for x, y in pairs]
    decode = {"whisper 8x1500": draw(((8, 6, 64), (8, 1500, 6, 64), (8, 1500, 6, 64)))}
    for s in (1500, 77):
        decode[f"test 8x{s}"] = [torch.from_numpy(t).to("cuda", bf16)
                                 for t in tc._decode_inputs(np.random.default_rng(17), 8, 6, 6, 64, s)]
    for tag, (q, kc, vc) in decode.items():
        s = kc.shape[1]
        pos = torch.full((8,), s - 1, dtype=torch.int32, device="cuda")
        kpos = torch.arange(s, dtype=torch.int32, device="cuda").expand(8, s).contiguous()
        out["rel_l2"][f"decode {tag}, every slot live"] = [
            cs.rel_l2(ops.flash_decode(q, kc, vc, pos, kpos), ref.decode_attention_plain(q, kc, vc, pos, kpos))]
    checks = {
        "attention_case encoder": lambda gen: cs.attention_case(ops, ref, timer, gen, dtype=bf16, s=1500, h=6, kv=6,
                                                                d=64, causal=False, time_it=False),
        "attention_case cross": lambda gen: cs.attention_case(ops, ref, timer, gen, dtype=bf16, s=512, skv=1500, h=6,
                                                              kv=6, d=64, causal=False, dq_only=True, time_it=False),
        "decode_case all_live": lambda gen: cs.decode_case(ops, ref, ring_positions, timer, gen, q_dtype=bf16, h=6,
                                                           kv=6, d=64, s=1500, all_live=True),
    }
    for name, fn in checks.items():
        try:
            fn(torch.Generator(device="cuda").manual_seed(8))
        except RuntimeError as err:
            out["failed"].append(f"{name}: {err}")
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])), flush=True)
        return 0
    results = {}
    for name in FAULTS:
        src = make_copy(name)
        run = subprocess.run([sys.executable, __file__, "--worker", str(src)], capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout, run.stderr, file=sys.stderr)
            return 1
        res = json.loads(run.stdout.strip().splitlines()[-1])
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p", "no:cacheprovider", "-m", "cuda",
             str(ROOT / "tests" / "test_torch_cuda.py"), "-k", CUDA_TESTS],
            capture_output=True, text=True, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(src)})
        res["cuda_tests"] = tests.stdout.strip().splitlines()[-1] if tests.stdout.strip() else tests.stderr[-2000:]
        res["cuda_tests_failed"] = [line.split(" - ")[0] for line in tests.stdout.splitlines()
                                    if line.startswith("FAILED")]
        res["cuda_tests_rc"] = tests.returncode
        results[name] = res
        print(f"tail_mask {name} {json.dumps(res)}", flush=True)
    sound = results["sound"]
    ok = not sound["failed"] and sound["cuda_tests_rc"] == 0
    ok = ok and all(results[name]["failed"] and results[name]["cuda_tests_rc"] == 1 for name in FAULTS if name != "sound")
    print(json.dumps({"tail_mask_check_ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
