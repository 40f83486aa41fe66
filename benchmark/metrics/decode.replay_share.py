"""decode.replay_share (%; the dispatch: ``Decoder._decode_picture``'s one
CUDA graph replay a picture, ``pipeline/replay``): 100 x the program's
records ``dec.replay`` over its records ``dec.issue`` held wholly within
the traced window, the share of the window's pictures whose device work
was one replay. Nothing where the program has no graph route (no
``vc2tpu_torch.pipeline.replay``) or issued no picture in the window.
Moves decode_fps."""

import importlib.util

SPANS = {}


def read(run):
    if run.trace is None:
        return None
    try:
        if importlib.util.find_spec("vc2tpu_torch.pipeline.replay") is None:
            return None
        from vc2tpu_torch.core import trace
    except ImportError:
        return None
    t0, t1 = run.trace.host
    held = [r.name for r in trace.records()
            if t0 <= r.start and r.end <= t1]
    issued = held.count("dec.issue")
    return 100.0 * held.count("dec.replay") / issued if issued else None
