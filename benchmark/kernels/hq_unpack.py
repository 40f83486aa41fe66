"""hq_unpack (``csrc/hq_unpack.cu``): every HQ slice's three components
decoded from their exp-Golomb codes into lanes.

Bytes (``chip_smoke.py``'s count): the slices' coded bytes, two int32
fields (start, length) a component of a slice, the lanes written once.
Operations, for these pictures' data: ~20 a lane and 3 a data bit of a
code (floor(log2(|v| + 1)) of each quantised value).
"""

import torch


def matches(name: str) -> bool:
    return "hq_unpack_kernel" in name


def launches(run) -> int:
    return 1


def data_bits(lanes) -> int:
    return sum(int(torch.floor(torch.log2(t.abs().double() + 1)).sum())
               for t in lanes)


def count(run) -> tuple:
    n_lanes = sum(run.plane_samples())
    coded = run.mean_over_pictures(
        lambda c: len(c.body) - len(run.codec.params)
        - 4 * run.codec.n - run.codec.prefix * run.codec.n)
    ndata = run.mean_over_pictures(lambda c: data_bits(c.lanes))
    nbytes = coded + 8 * 3 * run.codec.n + 4 * n_lanes
    return nbytes, 20 * n_lanes + 3 * ndata
