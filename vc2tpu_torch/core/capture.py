"""What a CUDA graph's capture has to learn of the code it captures.

A captured graph replays its kernels with the arguments they were
launched with, device addresses included, and runs no Python. Two things
the eager code keeps in Python need the capture's help:

* the cached device tables a kernel reads by address (a run map, a
  plan's constants, a quant matrix's entries). A function that makes
  them is a ``device_cache``: an ``lru_cache`` whose every result, made
  or found, is also noted in each open ``holding()`` block of the
  calling thread. What captures a graph holds the list the block gives,
  so a table the graph reads lives as long as the graph, whatever the
  cache drops;
* the kernel wrappers' launch counts. A wrapper whose ``launches``
  counts its kernel's launches is ``counted``; ``launch_counts()`` reads
  every one, so a capture sees the launches it recorded without a list
  of the wrappers it calls.
"""

from __future__ import annotations

import contextlib
import functools
import threading

_COUNTED: list = []          # every counted wrapper
_open = threading.local()    # .blocks: the open holding() lists


def counted(fn):
    """``fn``, a kernel wrapper whose ``launches`` (0 to start) counts
    its kernel's launches, noted for ``launch_counts``."""
    fn.launches = 0
    _COUNTED.append(fn)
    return fn


def launch_counts() -> dict:
    """{wrapper: its ``launches``} of every counted wrapper."""
    return {fn: fn.launches for fn in _COUNTED}


def device_cache(maxsize: int | None):
    """``functools.lru_cache(maxsize)`` for a function that returns
    device tables, each result also noted in the open ``holding()``
    blocks; ``cache_clear`` and ``cache_info`` are the cache's."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kwargs):
            out = cached(*args, **kwargs)
            for held in getattr(_open, "blocks", ()):
                held.append(out)
            return out
        get.cache_clear, get.cache_info = cached.cache_clear, \
            cached.cache_info
        return get
    return wrap


@contextlib.contextmanager
def holding():
    """A list of every ``device_cache`` result this thread is given
    inside the block."""
    if not hasattr(_open, "blocks"):
        _open.blocks = []
    held = []
    _open.blocks.append(held)
    try:
        yield held
    finally:
        _open.blocks.pop()           # blocks nest: this one is last
