"""band_forward_roofline (%; the kernels): band_forward's roofline bound over its device
time in the traced window (kernels/band_forward.py counts its bytes and
operations; integer operations against the float32 peak)."""

SPANS = {}


def read(run):
    return run.roofline(["band_forward"])
