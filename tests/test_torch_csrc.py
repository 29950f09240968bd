"""The constants of the port's CUDA sources that size buffers on the Python
side, read from the headers and held against their mirrors in
``repro_torch.kernels.ops``, on the CPU.

The wrappers allocate each kernel's scratch from the mirrors; a kernel whose
chunk or block changed while its mirror did not would write past a buffer
sized for the old one, and nothing but the card would show it.
"""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import ops

CSRC = Path(ops.__file__).resolve().parent / "csrc"


def header_constant(header: str, name: str) -> int:
    """The value of ``constexpr int <name> = <integer>;`` in ``csrc/<header>``."""
    found = re.findall(rf"constexpr int {name} = (\d+);", (CSRC / header).read_text())
    assert len(found) == 1, f"{name} defined {len(found)} times in {header}"
    return int(found[0])


@pytest.mark.parametrize("header,name", [
    ("mamba_common.cuh", "MAMBA_BWD_THREADS"),
    ("mamba_common.cuh", "MAMBA_BWD_CHUNK"),
    ("mamba_common.cuh", "MAMBA_LANE_STATES"),
    ("mamba_common.cuh", "MAMBA_LANE_CHANNELS"),
    ("wkv6_common.cuh", "WKV_CHUNK"),
])
def test_mirror_matches_header(header, name):
    assert getattr(ops, name) == header_constant(header, name)


@pytest.mark.parametrize("name,mirror", [("GM", "LORA_TILE_ROWS"), ("MAX_R", "MAX_LORA_RANK")])
def test_lora_matmul_mirror_matches_source(name, mirror):
    """The wgmma route's tile rows and the largest rank, which
    ``ops.lora_matmul_route`` reads to send a grouped call whose B_g would
    not fit the kernel's staging to the WMMA route."""
    assert getattr(ops, mirror) == header_constant("lora_matmul.cu", name)


@pytest.mark.parametrize("b,s,d,n", [
    (16, 512, 8192, 16),  # jamba-v0.1-52b's training shape
    (2, 70, 200, 8),  # S off the chunk, D off the block
    (1, 1, 64, 16),
])
def test_mamba_bwd_scratch_follows_the_header(b, s, d, n):
    """The backward's scratch as the header's constants size it: one state
    per chunk of MAMBA_BWD_CHUNK tokens, dB, dC partials per block of
    MAMBA_BWD_THREADS * MAMBA_LANE_STATES * MAMBA_LANE_CHANNELS / N
    channels."""
    chunk = header_constant("mamba_common.cuh", "MAMBA_BWD_CHUNK")
    channels = (header_constant("mamba_common.cuh", "MAMBA_BWD_THREADS")
                * header_constant("mamba_common.cuh", "MAMBA_LANE_STATES")
                * header_constant("mamba_common.cuh", "MAMBA_LANE_CHANNELS") // n)
    assert ops.mamba_bwd_scratch_shapes(b, s, d, n) == {
        "states": (b, -(-s // chunk), d, n),
        "bc_part": (b, -(-d // channels), s, 2 * n),
        "da_part": (b, d, n),
        "dd_part": (b, d),
    }
