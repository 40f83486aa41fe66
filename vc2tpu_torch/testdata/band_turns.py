"""Time the band route's kernels of several checkouts in turns on the card.

    python vc2tpu_torch/testdata/band_turns.py ROOT [ROOT ...]

One process a turn: the roots in the order given, then reversed,
``--rounds`` times (A B B A for two roots and one round). Each process
builds or loads its checkout's kernels and times, with its own
``chip_smoke.time_device``, one 1080p picture's launches of
``bands.inverse_lanes`` on the unpacked lanes of the ConstQ fixture (one q
index for every slice) and of the CBR fixture (a q index a slice),
``bands.forward_lanes`` on the 1080p picture's uploaded int16 samples,
the in-place ``lifting.lift_levels`` decode levels, and both band kernels
at the 8K geometry (BASELINE config #5, 7680x4320 4:2:2, -u 1 -a 2,
LeGall depth 2) on seeded lanes and samples: ``*_ms`` as the host issues
them, ``*_device_ms`` queued (the device's time alone). Every result is
held against the plain version first. The script prints each
turn's numbers, the medians and the card's name and power limit. Compare
commits only within one run: a checkout unpacked with ``git archive``
into a git-ignored directory is a root like any other.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile


def time_root(root: str) -> dict:
    """In this process: the kernel times of ``root``'s checkout."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from vc2tpu_torch.core.config import ColourFormat, PictureGeometry
    from vc2tpu_torch.core.planario import PlanarReader, SampleFormat
    from vc2tpu_torch.pipeline import decoder as pipe
    from vc2tpu_torch.pipeline import encoder as enc_mod
    from vc2tpu_torch.vlc import device_unpack as du
    from vc2tpu_torch.wavelet import bands, lifting, matrices

    sys.path.insert(0, cs.TESTDATA)
    import make_1080p

    dev = torch.device("cuda")
    with open(os.path.join(cs.TESTDATA, "fixtures_1080p.json")) as f:
        fixtures = json.load(f)["streams"]
    out = {}
    for key in ("constq_1080p", "cbr_1080p"):
        with open(os.path.join(cs.TESTDATA, fixtures[key]["stream"]),
                  "rb") as f:
            job = cs.pictures_of(f.read(), dev)[0][2]
        pre, geo = job.pre, job.geo
        pay, fields = pipe.upload(job.payload, job.q_idx, job.cbytes, dev)
        clen = fields[1:].contiguous()
        dstart = du.hq_component_offsets(clen, pre.slice_prefix, job.start)
        lanes = du.unpack_hq(pay, dstart, clen,
                             geo.luma_slice[0] * geo.luma_slice[1],
                             geo.chroma_slice[0] * geo.chroma_slice[1])
        q, kernel, depth = fields[0], pre.wavelet_kernel, pre.depth
        qm = matrices.quant_matrix(kernel, depth)

        def inverse():
            return bands.inverse_lanes(lanes, q, qm, geo, kernel, depth)

        want = bands.inverse_lanes_plain(lanes, q, qm, geo, kernel, depth)
        cs.check(all(torch.equal(a, b) for a, b in zip(inverse(), want)),
                 f"{root}: band_inverse differs on {key}")
        name = key.split("_")[0]
        out[f"band_inverse_{name}_ms"] = cs.time_device(torch, inverse)
        out[f"band_inverse_{name}_device_ms"] = cs.time_device(
            torch, inverse, cs.KERNEL_INNER, queued=True)
        if name == "constq":
            planes = pipe.dequantise_planes(lanes, q, qm, depth, geo)

            def lift():
                coarse = None
                for level in range(depth - 1, -1, -1):
                    coarse = lifting.lift_levels(planes, kernel, True,
                                                 1 << level, coarse)
            out["lift_level_device_ms"] = cs.time_device(
                torch, lift, cs.KERNEL_INNER, queued=True)
    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "hd.16p2")
        make_1080p.make_input(path)
        with open(path, "rb") as f:
            data = f.read()
    picture = PlanarReader(
        io.BytesIO(data), PictureGeometry.of(1080, 1920, ColourFormat.CF422),
        SampleFormat(word_width=2, bit_depth=10)).read_frame()
    enc = cs.fixture_lanes(dev, picture, "constq_1080p")[0]
    samples = enc_mod.upload_picture(picture, 2, dev)
    cfg = enc.cfg

    def forward():
        return bands.forward_lanes(samples, cfg.kernel, cfg.wavelet_depth,
                                   enc.geo)

    want = bands.forward_lanes_plain(samples, cfg.kernel, cfg.wavelet_depth,
                                     enc.geo)
    cs.check(all(torch.equal(a, b) for a, b in zip(forward(), want)),
             f"{root}: band_forward differs")
    out["band_forward_ms"] = cs.time_device(torch, forward)
    out["band_forward_device_ms"] = cs.time_device(torch, forward,
                                                   cs.KERNEL_INNER,
                                                   queued=True)
    out.update(time_8k(torch, cs, bands, dev))
    return out


def time_8k(torch, cs, bands, dev) -> dict:
    """Both band kernels' device ms at the 8K geometry on seeded inputs."""
    import numpy as np

    from vc2tpu_torch.core.config import WaveletKernel
    from vc2tpu_torch.slices.hq import SliceGeometry
    from vc2tpu_torch.wavelet import matrices

    geo = SliceGeometry(1080, 960, (4320, 7680), (4320, 3840), (4, 8),
                        (4, 4))
    kernel, depth = WaveletKernel.LeGall, 2
    rng = np.random.default_rng(8)
    lanes = [torch.as_tensor(rng.integers(-2000, 2000, (geo.n_slices, n))
                             .astype(np.int32), device=dev)
             for n in (32, 16, 16)]
    q = torch.as_tensor(rng.integers(0, 60, geo.n_slices).astype(np.int32),
                        device=dev)
    qm = matrices.quant_matrix(kernel, depth)
    planes = [torch.as_tensor(rng.integers(-512, 512, shape)
                              .astype(np.int16), device=dev)
              for shape in ((4320, 7680), (4320, 3840), (4320, 3840))]

    def inverse():
        return bands.inverse_lanes(lanes, q, qm, geo, kernel, depth)

    def forward():
        return bands.forward_lanes(planes, kernel, depth, geo)

    for fn, plain in ((inverse, bands.inverse_lanes_plain(
            lanes, q, qm, geo, kernel, depth)), (forward,
            bands.forward_lanes_plain(planes, kernel, depth, geo))):
        cs.check(all(torch.equal(a, b) for a, b in zip(fn(), plain)),
                 "a band kernel differs at 8K")
    return {"band_inverse_8k_device_ms": cs.time_device(
                torch, inverse, cs.KERNEL_INNER, queued=True),
            "band_forward_8k_device_ms": cs.time_device(
                torch, forward, cs.KERNEL_INNER, queued=True)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--time-root", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.time_root:
        print(json.dumps(time_root(a.time_root)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("band_turns: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    roots = [os.path.abspath(r) for r in a.roots]
    order = []
    for _ in range(a.rounds):
        order += roots + roots[::-1]
    samples = {r: {} for r in roots}
    for turn, root in enumerate(order):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root,
             "--time-root", root], capture_output=True, text=True, cwd=root)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        got = json.loads(res.stdout.strip().splitlines()[-1])
        for key, ms in got.items():
            samples[root].setdefault(key, []).append(ms)
        print(f"turn {turn} {root}: " + json.dumps(
            {k: round(v, 5) for k, v in got.items()}))
    for root in roots:
        print(f"band kernels, medians of {len(order) // len(roots)} turns: "
              f"{root}: " + json.dumps(
                  {k: round(statistics.median(v), 5)
                   for k, v in samples[root].items()}) + f" ({card})")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
