"""encode.device_idle (%; the device): the share of the traced window in which
the card ran no operation, from the profiler's trace. Moves
encode_fps."""

SPANS = {}


def read(run):
    return run.idle_percent()
