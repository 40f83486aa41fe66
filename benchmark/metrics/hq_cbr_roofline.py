"""hq_cbr_roofline (%; the kernels): hq_cbr's roofline bound over its device
time in the traced window (kernels/hq_cbr.py counts its bytes and
operations; integer operations against the float32 peak)."""

SPANS = {}


def read(run):
    return run.roofline(["hq_cbr"])
