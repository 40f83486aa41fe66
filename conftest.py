"""Each pytest-xdist worker's share of the host's cores for torch.

Left alone, torch's intra-op pool in each of the workers takes every core
the process may run on, and a test that makes thousands of small parallel
torch calls (the plain versions of the port's kernels, such as the LD rate
control's) spins against the other workers' pools: six copies of one such
test on eight cores did not finish in 240 s, where each takes 25 s with a
thread apiece. So a worker takes ``cores // workers`` threads, at least
one: torch's, and, unless it is set already, ``OMP_NUM_THREADS`` for the
processes its tests start (the two-process mesh harness). Without xdist
nothing changes.

This is the tests' setting only: the program sets no thread count, since
its host copy out of the pinned slot runs on torch's intra-op threads.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _share = max(1, len(os.sched_getaffinity(0)) // int(_workers))
    os.environ.setdefault("OMP_NUM_THREADS", str(_share))
    import torch

    torch.set_num_threads(_share)
