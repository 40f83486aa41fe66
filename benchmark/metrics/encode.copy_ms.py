"""encode.copy_ms (ms; the upload and the copy back: host to device and device
to host copies of the encode): the profiler's memcpy device time (HtoD and
DtoH) a picture completed in the traced window. Moves encode_fps."""

SPANS = {}


def read(run):
    return run.device_ms_per_picture(lambda name: name.startswith("Memcpy"))
