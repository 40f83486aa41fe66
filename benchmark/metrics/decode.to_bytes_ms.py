"""decode.to_bytes_ms (ms; the upload and copy back: ``Decoder._flush``'s
``.numpy().tobytes()`` of the copied output): mean host ms of the
program's span ``dec.to_bytes`` over the traced window. Moves
decode_fps."""

import program_spans

SPANS = {}


def read(run):
    return program_spans.mean_ms(run, "dec.to_bytes")
