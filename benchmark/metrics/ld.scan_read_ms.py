"""ld.scan_read_ms (ms; the host scan: the slice walk of ``slices/ld.ld_scan``,
``ld_read`` of ``csrc/ld_scan.cpp``): mean host ms of the program's span
``dec.ld_read`` over the traced window, the header fields, q indices and
LL codes of every slice of an LD picture; one of the two parts of
``decode.scan_ms`` in an LD cell. Moves decode_fps."""

import program_spans

SPANS = {}


def read(run):
    return program_spans.mean_ms(run, "dec.ld_read")
