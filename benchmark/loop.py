"""The stream loop's harness: the reader the CLI takes for its standard
input, the sinks it takes for its standard output, and the window.

The reader hands over a cell's input a picture at a time (never a byte of
the next picture in the same read) and stamps the moment it hands over
each picture's last byte; in a paced loop it hands over no byte of
picture i before it is due. A sink stamps the moment each picture's output
is complete. The window opens when the last warm-up picture's output is
complete, in the same CLI call, and closes ``seconds`` later: the reader
then ends the input at the next picture. A sink keeps references to a
seeded sample of the pictures completed in the window (no copy): each is
kept with the same chance, one in ``sample_every``, so that what keeping
costs the program (an output whose memory is not freed has to be
allocated afresh) is spread evenly over the window. ``check.py`` compares
the sample with the reference once the CLI has returned.
"""

from __future__ import annotations

import random
import resource
import time

clock = time.perf_counter


class Window:
    """The measured window and every picture's stamps (seconds on
    ``clock``): ``handed[i]`` when the reader handed over picture i's last
    byte, ``due[i]`` when it was due (paced loops), ``late[i]`` how late
    the reader began handing it over, ``done[i]`` when its output was
    complete."""

    def __init__(self, warmup: int, seconds: float, on_open=None,
                 on_close=None, traced: float = 0.0):
        self.warmup = warmup
        self.seconds = seconds
        self.on_open, self.on_close = on_open, on_close
        self.traced = traced        # on_close this long after the opening
        self.open_at = self.close_at = None
        self.trace_closed = on_close is None
        self.closed_at = None           # when the reader ended the input
        self.usage = []                 # getrusage at the opening, the close
        self.handed, self.due, self.late, self.done = [], [], [], []

    def completed(self, now: float) -> int:
        """Stamp the next picture's output complete; returns its index."""
        i = len(self.done)
        self.done.append(now)
        if i == self.warmup - 1:
            if self.on_open is not None:
                self.on_open()
            self.usage.append(resource.getrusage(resource.RUSAGE_SELF))
            self.open_at = clock()
            self.close_at = self.open_at + self.seconds
        return i

    def host_usage(self) -> dict:
        """The process's CPU seconds, page faults and context switches
        between the window's opening and its close."""
        if len(self.usage) < 2:
            return {}
        a, b = self.usage
        return {k: getattr(b, f"ru_{k}") - getattr(a, f"ru_{k}")
                for k in ("utime", "stime", "minflt", "majflt", "nvcsw",
                          "nivcsw")}

    def in_window(self, i: int) -> bool:
        return (self.open_at is not None
                and self.open_at < self.done[i] <= self.close_at)

    def ending(self, now: float) -> bool:
        """True once the window has closed: the reader ends the input.
        Called before each picture; ``on_close`` runs before the first
        picture that starts ``traced`` seconds or more after the opening,
        or at the close."""
        if self.close_at is None:
            return False
        closing = now >= self.close_at
        if closing and self.closed_at is None:
            self.closed_at = clock()
            self.usage.append(resource.getrusage(resource.RUSAGE_SELF))
        if not self.trace_closed and (closing or now >= self.open_at
                                      + self.traced):
            self.trace_closed = True
            self.on_close()
        return closing


class Reader:
    """The CLI's binary standard input. ``pieces(i)`` gives picture i's
    input as a list of bytes objects, handed over whole where a read asks
    for at least their length (so a picture the distinct set holds is not
    copied). ``rate`` paces the pictures after the warm-up: picture
    ``warmup + k`` is due ``k / rate`` seconds after the reader was first
    asked for picture ``warmup``."""

    def __init__(self, pieces, window: Window, rate: float | None = None):
        self.pieces = pieces
        self.window = window
        self.rate = rate
        self.t0 = None
        self.index = 0                # the picture being handed over
        self.queue = []               # its pieces not yet handed over
        self.offset = 0               # bytes of queue[0] handed over
        self.ended = False

    def _next_picture(self) -> bool:
        w, i = self.window, self.index
        now = clock()
        if self.ended or w.ending(now):
            self.ended = True
            return False
        due = now
        if self.rate is not None and i >= w.warmup:
            if self.t0 is None:
                self.t0 = now
            due = self.t0 + (i - w.warmup) / self.rate
            if due > now:
                time.sleep(due - now)
                now = clock()
        w.due.append(due)
        w.late.append(now - due)
        self.queue = list(self.pieces(i))
        self.offset = 0
        return True

    def read(self, n: int = -1):
        if not self.queue and not self._next_picture():
            return b""
        piece = self.queue[0]
        left = len(piece) - self.offset
        if n is None or n < 0 or n >= left:
            out = piece if self.offset == 0 else memoryview(piece)[
                self.offset:]
            self.queue.pop(0)
            self.offset = 0
        else:
            out = memoryview(piece)[self.offset:self.offset + n]
            self.offset += n
        if not self.queue:
            self.window.handed.append(clock())
            self.index += 1
        return out

    def readable(self) -> bool:
        return True


class _Sample:
    """Pictures completed in the window, each kept with the chance one in
    ``every``, drawn from the seed: (index, output pieces)."""

    def __init__(self, every: int, seed: int):
        self.every = every
        self.rng = random.Random(seed)
        self.kept: list = []

    def offer(self, index: int, parts: list) -> None:
        if self.rng.randrange(self.every) == 0:
            self.kept.append((index, parts))


class PlanarSink:
    """The decode CLI's binary standard output: planar pictures of
    ``picture_bytes`` each."""

    def __init__(self, picture_bytes: int, window: Window, sample_every: int,
                 seed: int):
        self.picture_bytes = picture_bytes
        self.window = window
        self.sample = _Sample(sample_every, seed)
        self.parts: list = []
        self.have = 0

    def write(self, data) -> int:
        n = len(data)
        at = 0
        while at < n:
            take = min(n - at, self.picture_bytes - self.have)
            self.parts.append(data if take == n else
                              memoryview(data)[at:at + take])
            self.have += take
            at += take
            if self.have == self.picture_bytes:
                i = self.window.completed(clock())
                if self.window.in_window(i):
                    self.sample.offer(i, self.parts)
                self.parts, self.have = [], 0
        return n

    def flush(self) -> None:
        pass

    def leftover(self) -> int:
        return self.have


class UnitSink:
    """The encode CLI's binary standard output: a VC-2 stream, parsed
    data unit by data unit as it arrives. A picture is complete when the
    last byte of its data unit (the next-parse offset of its parse info)
    is written; the sequence header and the end of the sequence are
    skipped."""

    PICTURES = (0xC8, 0xE8)      # LD and HQ picture data units

    def __init__(self, window: Window, sample_every: int, seed: int):
        self.window = window
        self.sample = _Sample(sample_every, seed)
        self.head = bytearray()       # the parse info being read
        self.left = 0                 # body bytes of the unit still due
        self.picture = False
        self.parts: list = []
        self.bad = 0                  # bytes that were not a data unit

    def write(self, data) -> int:
        n = len(data)
        at = 0
        while at < n:
            if self.left == 0:
                take = min(13 - len(self.head), n - at)
                self.head += bytes(memoryview(data)[at:at + take])
                at += take
                if len(self.head) < 13:
                    break
                head = bytes(self.head)
                self.head = bytearray()
                if head[:4] != b"BBCD":
                    self.bad += 13
                    continue
                nxt = int.from_bytes(head[5:9], "big")
                self.picture = head[4] in self.PICTURES
                self.parts = [head]
                self.left = max(nxt - 13, 0)
                if self.left == 0:
                    continue
            take = min(self.left, n - at)
            if self.picture:
                self.parts.append(data if take == n else
                                  memoryview(data)[at:at + take])
            self.left -= take
            at += take
            if self.left == 0 and self.picture:
                i = self.window.completed(clock())
                if self.window.in_window(i):
                    self.sample.offer(i, self.parts)
                self.parts = []
        return n

    def flush(self) -> None:
        pass

    def leftover(self) -> int:
        return self.left + len(self.head)


class Stdin:
    """A stand-in for ``sys.stdin`` whose ``buffer`` is the reader."""

    def __init__(self, reader):
        self.buffer = reader


class Stdout:
    """A stand-in for ``sys.stdout`` whose ``buffer`` is a sink; text the
    CLI prints (the encode CLI prints its errors there) goes to
    ``text``."""

    def __init__(self, sink, text):
        self.buffer = sink
        self.text = text

    def write(self, s: str) -> int:
        return self.text.write(s)

    def flush(self) -> None:
        self.text.flush()
