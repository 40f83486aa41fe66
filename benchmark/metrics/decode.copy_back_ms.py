"""decode.copy_back_ms (ms; the upload and copy back: ``Decoder._flush``'s
``words.cpu()`` into pageable memory): mean host ms of the program's span
``dec.copy_back`` over the traced window, the wait for the picture's
device work included. Moves decode_fps."""

import program_spans

SPANS = {}


def read(run):
    return program_spans.mean_ms(run, "dec.copy_back")
