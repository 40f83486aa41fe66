"""ld.scan_dc_ms (ms; the host scan: the DC prediction of ``slices/ld.ld_scan``,
``ld_dequantise_grid`` of ``csrc/ld_scan.cpp`` on each of the three LL
grids): mean host ms of the program's span ``dec.ld_dc`` over the traced
window, the serial recurrence that dequantises an LD picture's LL band;
one of the two parts of ``decode.scan_ms`` in an LD cell. Moves
decode_fps."""

import program_spans

SPANS = {}


def read(run):
    return program_spans.mean_ms(run, "dec.ld_dc")
