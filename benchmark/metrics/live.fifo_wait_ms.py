"""live.fifo_wait_ms (ms; the stream loop, ``cli/decode_stream.Decoder``'s
output FIFO): mean ms from a picture's output being queued
(``_emit_words``) to its copy back starting (``_flush``), the program's
record ``dec.fifo``, over the traced window: the time the output waits.
Moves decode_p95_ms in the paced cell."""

import program_spans

SPANS = {}


def read(run):
    return program_spans.mean_ms(run, "dec.fifo")
