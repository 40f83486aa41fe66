"""Regenerate the 1080p fixtures of this directory.

Makes one synthetic 1920x1080 4:2:2 10-bit frame (sinusoid + noise, a
saturated block and a gradient band; seed 42, the content of the JAX
package's 1080p parity test), encodes it with the JAX package's encoder
CLI in HQ ConstQ, HQ CBR and LD (the LD configuration ``bench.py`` runs),
decodes each stream with the JAX package's
decoder CLI, and writes ``fixtures_1080p.json`` with the SHA-256 of each
decode and the exact commands. Both CLIs run as subprocesses; this script
imports neither. Run from the repository root:

    JAX_PLATFORMS=cpu python vc2tpu_torch/testdata/make_1080p.py
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

ARGS = ["-x", "1920", "-y", "1080", "-f", "4:2:2", "-l", "10", "-n", "2",
        "-k", "LeGall", "-d", "2", "-u", "2", "-a", "2"]
MODES = {
    "constq_1080p": ["-m", "HQ_ConstQ", "-q", "40"],
    "cbr_1080p": ["-m", "HQ_CBR", "-S", "2", "-s", "829440"],
    "ld_1080p": ["-m", "LD", "-s", "829440"],
}


def make_input(path: str) -> None:
    rng = np.random.default_rng(42)
    h, w = 1080, 1920
    with open(path, "wb") as f:
        for (hh, ww) in ((h, w), (h, w // 2), (h, w // 2)):
            yy, xx = np.mgrid[0:hh, 0:ww]
            base = 512 + 400 * np.sin(yy / 17.0) * np.cos(xx / 23.0)
            v = base.astype(np.int64) + rng.integers(-30, 30, (hh, ww))
            v[100:200, 100:300] = 1023            # saturated block
            v[300:400, :] = (np.arange(ww) * 1023 // ww)[None, :]  # gradient
            v = np.clip(v, 0, 1023).astype(np.uint16) << 6
            f.write(v.astype(">u2").tobytes())


def make_sequence(path: str, n: int = 16, seed: int = 1) -> None:
    """``n`` distinct 1920x1080 4:2:2 10-bit frames in one planar file:
    ``make_input``'s sinusoid moved a few samples a frame, with seeded
    noise (the encode pipeline's input in ``chip_smoke.py``)."""
    rng = np.random.default_rng(seed)
    h, w = 1080, 1920
    with open(path, "wb") as f:
        for k in range(n):
            for ww in (w, w // 2, w // 2):
                base = 512 + 400 * np.outer(
                    np.sin((np.arange(h) + 3 * k) / 17.0),
                    np.cos((np.arange(ww) + 5 * k) / 23.0))
                v = base.astype(np.int64) + rng.integers(-30, 30, (h, ww))
                v = np.clip(v, 0, 1023).astype(np.uint16) << 6
                f.write(v.astype(">u2").tobytes())


def main() -> int:
    work = os.path.join(HERE, "_work")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "hd.16p2")
    make_input(src)
    record = {"input": "make_1080p.make_input: 1920x1080 4:2:2 10-bit, "
                       "1 frame, numpy seed 42",
              "streams": {}}
    try:
        for name, mode in MODES.items():
            stream = os.path.join(HERE, f"{name}.vc2")
            dec = os.path.join(work, f"{name}.16p2")
            enc_cmd = [sys.executable, "-m", "vc2tpu.cli.encode_stream",
                       *ARGS, *mode, src, stream]
            dec_cmd = [sys.executable, "-m", "vc2tpu.cli.decode_stream",
                       stream, dec]
            subprocess.run(enc_cmd, check=True)
            subprocess.run(dec_cmd, check=True)
            with open(dec, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            record["streams"][name] = {
                "stream": f"{name}.vc2",
                "decoded_sha256": digest,
                "decoded_bytes": os.path.getsize(dec),
                "encode": ["python", "-m", "vc2tpu.cli.encode_stream",
                           *ARGS, *mode, "hd.16p2", f"{name}.vc2"],
                "decode": ["python", "-m", "vc2tpu.cli.decode_stream",
                           f"{name}.vc2", f"{name}.16p2"],
            }
    finally:
        shutil.rmtree(work, ignore_errors=True)
    with open(os.path.join(HERE, "fixtures_1080p.json"), "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
