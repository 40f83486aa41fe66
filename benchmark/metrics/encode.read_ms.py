"""encode.read_ms (ms; the input read, ``core/planario.PlanarReader.
read_frame``: the planar bytes to int32 NumPy planes): host ms a picture,
a span around the method, over the traced window. Moves ``encode_fps``."""

SPANS = {"encode.read": [("vc2tpu_torch.core.planario",
                          "PlanarReader.read_frame")]}


def read(run):
    return run.span_ms("encode.read")
