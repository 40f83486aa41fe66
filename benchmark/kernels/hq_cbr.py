"""hq_cbr (``csrc/hq_cbr.cu``): the HQ CBR rate control, each slice's
quantisation index.

Bytes (``chip_smoke.py``'s count): the transform lanes, the budgets (and
the flags) and the quant matrix of a slice's lanes read once, the q
indices written once. Operations, for these pictures' data: each of the
7 probes ~15 a lane (the trial quantise, the code length, the sums), and
~20 a luma lane for each luma error pass a slice makes (its climb + 2,
which the reference's search counts).
"""


def matches(name: str) -> bool:
    return "hq_cbr_held" in name or "hq_cbr_streamed" in name


def launches(run) -> int:
    return 1


def count(run) -> tuple:
    n_lanes = sum(run.plane_samples())
    n = run.codec.n
    qm = sum(int(t.numel()) for t in run.codec.qm)
    luma = run.codec.sizes[0]
    passes = run.mean_over_pictures(lambda c: int(c.passes.sum()))
    nbytes = 4 * n_lanes + 8 * n + 4 * qm
    return nbytes, 7 * 15 * n_lanes + 20 * sum(luma) * passes
