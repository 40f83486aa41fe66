"""decode.issue_ms (ms; the dispatch: ``pipeline/decoder``'s upload, unpack,
inverse and format, as ``Decoder._decode_picture`` calls them): mean host
ms of the program's span ``dec.issue`` over the traced window, the host's
time to issue one picture's device work, without the copy back of an
older picture that the same call makes. Moves decode_fps."""

import program_spans

SPANS = {}


def read(run):
    return program_spans.mean_ms(run, "dec.issue")
