"""live.held_pictures (pictures; the stream loop, ``cli/decode_stream.
Decoder``: its output FIFO and ``_flush``): the mean number of pictures
handed to the decoder and not yet out when a picture's output completes,
over the pictures completed in the traced window, from the harness's own
stamps.
Moves ``decode_p95_ms`` in the paced cell."""

import bisect

SPANS = {}


def read(run):
    w = run.window
    held = [bisect.bisect_right(w.handed, w.done[i]) - (i + 1)
            for i in run.traced_window()]
    return sum(held) / len(held) if held else None
