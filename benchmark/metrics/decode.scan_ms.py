"""decode.scan_ms (ms; the host scan: ``slices/hq.scan_hq_slice_offsets`` on
``csrc/hq_scan.cpp``, ``slices/ld.ld_scan`` on ``csrc/ld_scan.cpp``): mean
host ms of the program's span ``dec.scan`` (``Decoder._locate``, around
the scan) over the traced window; the program's own reading of what
``decode.host_scan_ms`` reads from outside. Moves decode_fps."""

import program_spans

SPANS = {}


def read(run):
    return program_spans.mean_ms(run, "dec.scan")
