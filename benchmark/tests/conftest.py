"""The benchmark's tests run from the repository's root
(``python -m pytest benchmark/tests``): the benchmark's modules import as
``run``, ``loop``, ``reference`` ..., as ``benchmark/run.py`` imports
them, and the port as ``vc2tpu_torch``."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]
