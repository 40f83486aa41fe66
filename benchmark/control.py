"""The control of ``correct``: the reference computed in lower precision
(``reference/lowered.py``: the wavelet in float16) put in the program's
place, through the rest of a run. Its runs have to come out not correct.

    python3 benchmark/control.py --workload <cell> --seconds 3 \\
        --seeds <n> [<n> ...]

runs, in one process, a run of the cell a seed whose CLI is ``Control``:
a stand-in with the stream CLIs' ``main(argv)`` that reads the same input
the harness hands the program and writes, for each picture, what the
lowered codec gives for it (a decode cell: its decode of the reference's
stream; an encode cell: its stream). Each run's result line (and the
numbers compared, with their limits) is printed as a run prints it. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import sys

import run as harness


class Control:
    """A stand-in for a stream CLI module: ``main(argv)`` serves one run of
    ``cell`` (configuration ``config``, traffic ``traffic``, seed
    ``seed``) with the lowered codec's outputs."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device

    def main(self, argv) -> int:
        import pictures
        from reference import codec as ref
        from reference.lowered import LoweredCodec

        lowered = LoweredCodec(self.config["coding"], self.device)
        planes, _planar = pictures.make(self.config["coding"],
                                        self.traffic["pictures"], self.seed,
                                        self.device)
        fin, out = sys.stdin.buffer, sys.stdout.buffer
        if self.traffic["direction"] == "decode":
            exact = ref.Codec(self.config["coding"], self.device)
            decoded = []
            for c in exact.encode(planes):
                bands = [lowered._dequantise(x, c.q, k)
                         for k, x in enumerate(c.lanes)]
                decoded.append(lowered.decode_bands(bands))
            return self._decode(fin, out, decoded)
        bodies = [c.body for c in lowered.encode(planes)]
        return self._encode(fin, out, lowered, bodies)

    @staticmethod
    def _decode(fin, out, decoded: list) -> int:
        """Read the stream a data unit at a time; for each picture write the
        lowered decode of its distinct picture (by picture number)."""
        buf = bytearray()
        while True:
            while len(buf) < 13:
                chunk = fin.read(1 << 20)
                if not chunk:
                    return 0
                buf += chunk
            size = max(int.from_bytes(buf[5:9], "big"), 13)
            while len(buf) < size:
                chunk = fin.read(size - len(buf))
                if not chunk:
                    return 0
                buf += chunk
            if buf[4] in (0xC8, 0xE8):
                number = int.from_bytes(buf[13:17], "big")
                out.write(decoded[number % len(decoded)])
            del buf[:size]

    @staticmethod
    def _encode(fin, out, lowered, bodies: list) -> int:
        """Read planar pictures; write the lowered codec's stream of them."""
        frame = sum(h * w for h, w in lowered.dims) * (
            1 if lowered.bits == 8 else 2)
        out.write(lowered.header_unit())
        prev = 13 + len(lowered.header)
        k = 0
        while True:
            data = fin.read(frame)
            if len(data) < frame:
                break
            body = bodies[k % len(bodies)]
            out.write(lowered.unit(k & 0xFFFFFFFF, body, prev))
            prev = 13 + 4 + len(body)
            k += 1
        return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    manifest, cell, config, traffic = harness.cell_of(a.workload)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    for seed in a.seeds:
        args = argparse.Namespace(workload=a.workload, seed=seed,
                                  seconds=a.seconds, trace=0)
        harness.measure(args, manifest, cell, config, traffic, device,
                        cli_module=Control(config, traffic, seed, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
