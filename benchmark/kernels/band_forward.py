"""band_forward (``csrc/band_lift.cu``, a level a launch): the encode's
forward LeGall DWT of the uploaded int16 samples into the slices' lanes.

Bytes (``chip_smoke.py``'s count): the samples read once (2 bytes each),
every lane written once, each coarser level's LL written and read once
more. Operations: the forward ladders (7 a pair of samples a step, two
steps) and the accuracy shift (1 a sample) on every level.
"""


def matches(name: str) -> bool:
    n = name.replace(" ", "")
    return "band_level_kernel<Ladder<0," in n


def launches(run) -> int:
    return run.coding["wavelet_depth"]


def count(run) -> tuple:
    depth = run.coding["wavelet_depth"]
    sizes = [n >> (2 * level) for n in run.plane_samples()
             for level in range(depth)]
    samples = sum(run.plane_samples())
    coarse = sum(4 * n for n in sizes) - 4 * samples
    ops = sum(2 * 2 * (n // 2) * 7 + n for n in sizes)
    return 2 * samples + 4 * samples + 2 * coarse, ops
