"""ld_unpack_roofline (%; the kernels): ld_unpack's roofline bound over its device
time in the traced window (kernels/ld_unpack.py counts its bytes and
operations; integer operations against the float32 peak)."""

SPANS = {}


def read(run):
    return run.roofline(["ld_unpack"])
