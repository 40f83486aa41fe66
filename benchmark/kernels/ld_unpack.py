"""ld_unpack (``csrc/ld_unpack.cu``): every LD slice's luma and
interleaved chroma regions decoded from their exp-Golomb codes into lanes.

Bytes (``chip_smoke.py``'s count): the payload, the host scan's four
int32 bit fields a slice, the lanes written once. Operations as
``hq_unpack``'s: ~20 a lane and 3 a data bit of a code.
"""

import torch


def matches(name: str) -> bool:
    return "ld_unpack_kernel" in name


def launches(run) -> int:
    return 1


def data_bits(lanes) -> int:
    return sum(int(torch.floor(torch.log2(t.abs().double() + 1)).sum())
               for t in lanes)


def count(run) -> tuple:
    n_lanes = sum(run.plane_samples())
    payload = run.coding["compressed_bytes"]
    ndata = run.mean_over_pictures(lambda c: data_bits(c.lanes))
    return payload + 16 * run.codec.n + 4 * n_lanes, 20 * n_lanes + 3 * ndata
