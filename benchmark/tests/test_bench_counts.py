"""The kernels' byte and operation counts (``benchmark/kernels``) at the
1080p configurations' sizes, held to the counts PERF.md's kernel table
(``chip_smoke.py``) gives: band_inverse 41.6 MB, band_forward 33.2 MB a
picture."""

from __future__ import annotations

import json
import os

import pytest

import measure
from reference.codec import Codec
from tiny import BENCH


def run_of(name: str) -> measure.Run:
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        config = json.load(f)
    codec = Codec(config["coding"], "cpu")
    return measure.Run({"name": "x"}, config, {}, None, codec=codec,
                       coded=[])


@pytest.mark.parametrize("kernel,megabytes", [("band_inverse", 41.6),
                                              ("band_forward", 33.2)])
def test_band_bytes_at_1080p(kernel, megabytes):
    for name in ("hq_cbr_1080p50", "ld_1080p50"):
        nbytes, ops = measure.load("kernels", kernel).count(run_of(name))
        assert round(nbytes / 1e6, 1) == megabytes
        # bound by bytes: the ladders' operations take less time at the
        # peaks than the bytes do
        assert ops / measure.OP_RATE < nbytes / measure.MEM_RATE


def test_launches_a_picture():
    run = run_of("hq_cbr_1080p50")
    assert measure.load("kernels", "band_inverse").launches(run) == 2
    assert measure.load("kernels", "hq_unpack").launches(run) == 1


@pytest.mark.parametrize("kernel,name,other", [
    ("band_inverse", "void (anonymous namespace)::band_level_kernel<Ladder"
     "<1, 1, Step<0, -1, 2, 2, -1, 1, 0, 1> > >(BandTable)", "band_forward"),
    ("band_forward", "void (anonymous namespace)::band_level_kernel<Ladder"
     "<0, 1, Step<1, -1, 1, 1, 0, 1, 1, 1> > >(BandTable)", "band_inverse"),
    ("hq_pack", "(anonymous namespace)::hq_pack((anonymous namespace)::"
     "PackArgs)", "hq_unpack"),
    ("hq_cbr", "(anonymous namespace)::hq_cbr_held((anonymous namespace)::"
     "CbrArgs)", "hq_pack"),
    ("hq_unpack", "(anonymous namespace)::hq_unpack_kernel(unsigned char "
     "const*, long long, int const*, int const*, int)", "ld_unpack"),
])
def test_kernel_names_match_one_count(kernel, name, other):
    """A profiler's kernel name (as the card's trace gives it) is counted
    by its own count file and not by another's."""
    assert measure.load("kernels", kernel).matches(name)
    assert not measure.load("kernels", other).matches(name)


def test_card_control(tmp_path):
    """On a card: the control at the cell's own size comes out not
    correct (skips without a card)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at 1080p on it")
    import subprocess
    import sys

    from tiny import ROOT
    p = subprocess.run([sys.executable, "benchmark/control.py", "--workload",
                        "hq1080.decode", "--seconds", "1", "--seeds",
                        str(2**31 + 77)], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is False
test_card_control = pytest.mark.cuda(test_card_control)
