"""band_inverse (``csrc/band_lift.cu``, a level a launch): the decode's
dequantise and inverse LeGall DWT of a picture's three components.

Bytes (``chip_smoke.py``'s count): each launch reads its lanes, the q
indices and, below the coarsest level, the coarser level's result, and
writes its level's result; a picture's lanes once, its q indices once,
each level's result written once and, but the finest, read once more.
Operations: the inverse ladders (two LeGall steps of two taps, 7 a pair
of samples, and the rounded unshift, 2 a sample) on every level and the
dequantise (~12 a lane).
"""


def matches(name: str) -> bool:
    n = name.replace(" ", "")
    return "band_level_kernel<Ladder<1," in n


def launches(run) -> int:
    return run.coding["wavelet_depth"]


def level_sizes(run) -> list:
    return [n >> (2 * level) for n in run.plane_samples()
            for level in range(run.coding["wavelet_depth"])]


def lift_ops(run) -> int:
    # two ladder steps of two taps: 2 * (n // 2) * (2 * 2 + 3) each, and
    # the rounded unshift, 2 a sample
    return sum(2 * 2 * (n // 2) * 7 + 2 * n for n in level_sizes(run))


def count(run) -> tuple:
    samples = sum(run.plane_samples())
    levels = sum(4 * n for n in level_sizes(run))
    coarse = levels - 4 * samples
    nbytes = 4 * samples + 4 * run.codec.n + levels + coarse
    return nbytes, lift_ops(run) + 12 * samples
