"""One CUDA graph replay a picture: the single-device picture decode's
device work, captured once a stream geometry and replayed.

The device half of a picture decode (``pipeline.decoder.hq_words`` /
``ld_words``: component offsets, the unpack kernel, the LD grids, the
band inverse and the format; some fifty host calls) is the same for
every picture of a geometry: the same shapes, kernels and arguments, but
for the payload's bytes and the slice fields. ``PictureGraphs`` keys it
on what the decoder observes of the input (the route, device, slice
geometry, depth, wavelet, quant matrix, bit depth, output geometry,
slice prefix, first slice's offset and the payload's exact length, which
the unpack kernels take as its bound):

* the first picture of a key decodes eagerly: the upload
  (``pipeline.decoder.upload_rows``), then the chain, as the library
  does;
* the second is uploaded into static device inputs of the key's shapes,
  its chain run once over them as it is (which remakes any table a cache
  dropped since), then captured over them (``torch.cuda.graph``) and
  replayed;
* every later picture of the key is its upload into those inputs and one
  replay (span ``dec.replay``).

At most ``SIZE`` keys are held, the least recently used going first, so
a stream whose payload lengths never repeat stays eager. A graph's
output bytes are static: before a replay the current stream waits for
the event of the last read of its previous output (``read``: the
decoder's copy back). What the capture learns of the chain it learns
from the capture itself (``core.capture``): the graph holds every cached
device table the chain was given while captured, which it reads by
address at each replay, and a replay adds to each kernel wrapper's
``launches`` the launches the capture counted, so those counts stay one
a picture. Which pictures may replay is the decoder's choice
(``eligible``).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from vc2tpu_torch.core import trace
from vc2tpu_torch.core.capture import holding, launch_counts
from vc2tpu_torch.core.config import DecOutput
from vc2tpu_torch.pipeline.decoder import upload_rows

SIZE = 8                     # keys held
_SEEN = object()             # a key decoded once, eagerly


def eligible(device: torch.device, mesh, output: DecOutput,
             interlace: bool) -> bool:
    """Whether a picture may replay: the DECODED output of a progressive
    picture on one card. A mesh route, a tap, interlaced fields (the
    first field's bytes are held across the second's decode) and the CPU
    stay eager."""
    return (device.type == "cuda" and mesh is None
            and output == DecOutput.DECODED and not interlace)


def capture_cuda(chain, pay: torch.Tensor, fields: torch.Tensor) -> tuple:
    """(replay, output) of ``chain(pay, fields)`` captured in a CUDA
    graph, whose replay runs on the current stream."""
    with torch.cuda.device(pay.device):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            words = chain(pay, fields)
    return graph.replay, words


class _Graph:
    """A captured chain: its static inputs (``pay``, ``fields``), its
    output ``words``, its replay, {wrapper: launches} of a replay, the
    cached tables it reads by address, and the event behind the last
    read of ``words``."""

    def __init__(self, pay, fields, replay, words, launches, tables):
        self.pay, self.fields = pay, fields
        self.replay, self.words = replay, words
        self.launches, self.tables = launches, tables
        self.copied = None


class PictureGraphs:
    """The decoder's graphs, at most ``SIZE`` keys; ``captures`` and
    ``replays`` count graphs captured and pictures decoded by a replay.
    ``capture`` is ``capture_cuda`` or a stand-in of its form."""

    def __init__(self, capture=capture_cuda):
        self._capture = capture
        self._keys: collections.OrderedDict = collections.OrderedDict()
        self._last = None            # the graph of the last replay
        self.captures = 0
        self.replays = 0

    def run(self, key, words, args: tuple, payload: np.ndarray,
            fields: np.ndarray, device: torch.device) -> torch.Tensor:
        """One picture's output bytes on ``device``: ``words(pay, rows,
        *args)`` over the upload of its ``payload`` (uint8 [P]) and slice
        ``fields`` (int32 [R, N]). Eager the first time ``key`` is seen,
        else a replay of the graph of that call, captured the second
        time."""
        entry = self._keys.get(key)
        self._last = None
        if entry is None:
            self._keys[key] = _SEEN
            if len(self._keys) > SIZE:
                self._keys.popitem(last=False)
            return words(*upload_rows(payload, fields, device), *args)
        self._keys.move_to_end(key)
        if entry is _SEEN:
            entry = self._keys[key] = self._record(
                lambda pay, rows: words(pay, rows, *args), payload, fields,
                device)
        else:
            upload_rows(payload, fields, device, (entry.pay, entry.fields))
        if entry.copied is not None:
            torch.cuda.current_stream(device).wait_event(entry.copied)
        with trace.span("dec.replay"):
            entry.replay()
        for wrapper, n in entry.launches.items():
            wrapper.launches += n
        self.replays += 1
        self._last = entry
        return entry.words

    def _record(self, chain, payload, fields, device) -> _Graph:
        """The graph of ``chain`` over static inputs that hold this
        picture's upload, holding the cached tables the chain was given.
        The chain first runs once as it is, which remakes any table a
        cache dropped since the key's first picture: a capture may not
        copy one up from pageable host memory. That run's launches and
        the capture's, which runs nothing, are taken back off the
        wrappers' counts; each replay adds the capture's."""
        pay = torch.empty(payload.shape, dtype=torch.uint8, device=device)
        rows = torch.empty(fields.shape, dtype=torch.int32, device=device)
        upload_rows(payload, fields, device, (pay, rows))
        before = launch_counts()
        chain(pay, rows)
        warm = launch_counts()
        with holding() as tables:
            replay, words = self._capture(chain, pay, rows)
        launches = {w: w.launches - n for w, n in warm.items()
                    if w.launches != n}
        for w, n in before.items():
            w.launches = n
        self.captures += 1
        return _Graph(pay, rows, replay, words, launches, tables)

    def read(self, words: torch.Tensor, event) -> None:
        """Work behind ``event`` (a CUDA event, or None for none) reads
        ``words``: where they are the last replay's output, that graph's
        next replay waits for it."""
        if self._last is not None and self._last.words is words:
            self._last.copied = event
        self._last = None
