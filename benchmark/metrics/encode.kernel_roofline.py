"""encode.kernel_roofline (%; the kernels: every kernel of kernels/ that
ran in the traced window): the sum of their roofline bounds over the sum
of their device time, the bound max(bytes / 3.35 TB/s, operations / 67
T/s) from each kernel's count (integer operations counted against the
float32 peak). Moves encode_fps."""

SPANS = {}


def read(run):
    return run.roofline(run.kernels_run())
