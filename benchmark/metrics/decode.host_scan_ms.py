"""decode.host_scan_ms (ms; the host scan: ``slices/hq.scan_hq_slice_
offsets`` on ``csrc/hq_scan.cpp``, ``slices/ld.ld_scan`` on
``csrc/ld_scan.cpp``): host ms a picture of the scan, a span around the
name the decode CLI calls (``cli.decode_stream.scan_hq_slice_offsets`` /
``cli.decode_stream.ld_scan``), over the traced window. Moves
``decode_fps``."""

SPANS = {"decode.scan": [("vc2tpu_torch.cli.decode_stream",
                          "scan_hq_slice_offsets"),
                         ("vc2tpu_torch.cli.decode_stream", "ld_scan")]}


def read(run):
    return run.span_ms("decode.scan")
