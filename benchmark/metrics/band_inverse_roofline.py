"""band_inverse_roofline (%; the kernels): band_inverse's roofline bound over its device
time in the traced window (kernels/band_inverse.py counts its bytes and
operations; integer operations against the float32 peak)."""

SPANS = {}


def read(run):
    return run.roofline(["band_inverse"])
