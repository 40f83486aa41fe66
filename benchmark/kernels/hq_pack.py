"""hq_pack (``csrc/hq_pack.cu``): every HQ slice quantised (at its index,
in the load) and packed into exp-Golomb codes.

Bytes (``chip_smoke.py``'s count): the transform lanes, the q indices,
the quant matrix of a slice's lanes and the budgets read once, the
totals and the payload written once. Operations, for these pictures'
data: a lane's quantise and code length (20), a non-zero quantised lane's
code and its append (30) and the append of the run of zeros before it
(8).
"""

import torch


def matches(name: str) -> bool:
    n = name.replace(" ", "")
    return n.startswith("hq_pack(") or "::hq_pack(" in n


def launches(run) -> int:
    return 1


def count(run) -> tuple:
    n_lanes = sum(run.plane_samples())
    n = run.codec.n
    qm = sum(int(t.numel()) for t in run.codec.qm)
    nonzero = run.mean_over_pictures(
        lambda c: sum(int(torch.count_nonzero(t)) for t in c.lanes))
    payload = run.coding["compressed_bytes"]
    nbytes = 4 * n_lanes + 4 * n + 4 * qm + 4 * n + payload
    return nbytes, 20 * n_lanes + 38 * nonzero
