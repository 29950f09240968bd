"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, under ``build/repro_torch/`` at the root of the
checkout.  The file name carries a hash of the sources and the flags, so an
edited source builds anew and an unchanged one loads what is there.  All
missing libraries build in parallel, one ``nvcc`` each.  Nothing here runs
at import time: this module imports on machines without a CUDA toolkit.

Every one-time set-up the kernels need at first use is reported to
``setup_listeners`` as ``(kind, what)``: ``"build"`` and ``"load"`` here
for a library compiled or loaded, ``"entry"`` and ``"plan"`` from
``ops`` for an entry point's first lookup and a launch-plan cache's miss.
``repro_torch.analysis.recompile_guard`` counts them: a steady-state run
does none.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List

KERNELS = (
    "segmented_lora", "flash_decode", "flash_attention", "flash_attention_bwd", "lora_matmul", "wkv6", "wkv6_bwd",
    "mamba_scan", "mamba_scan_bwd",
)
CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
setup_listeners: List[Callable[[str, str], None]] = []


def fire_setup(kind: str, what: str):
    """Tell every listener of a one-time set-up (see the module docstring)."""
    for listener in list(setup_listeners):
        listener(kind, what)


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (torch.utils.cpp_extension.CUDA_HOME is None)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(name: str) -> Path:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; known: {KERNELS}")
    digest = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, all at once.

    Returns the seconds each build took (0.0 for a library already built).
    The compiler's resource report (``-Xptxas=-v``) is kept beside each
    library as ``<library>.log``.  Raises with the compiler's output if a
    build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    jobs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, target, start) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - start
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        target.with_name(target.name + ".log").write_text(log)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
            fire_setup("build", name)
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
        fire_setup("load", name)
    return lib
