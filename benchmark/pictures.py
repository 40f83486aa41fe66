"""The traffic generator: a traffic file's pictures, made from the seed.

A copy of the port's ``testdata/make_1080p.make_sequence`` (a sinusoid
moved a few samples a picture, plus seeded noise), made on the device with
a ``torch.Generator`` in a few large calls. Every parameter comes from the
traffic file (``pictures``: its ``distinct``, ``amplitude``, ``periods``,
``motion``, ``noise``) and the configuration's sizes, so a new mix is a
new data file.
"""

from __future__ import annotations

import torch


def make(coding: dict, spec: dict, seed: int, device) -> tuple:
    """(planes, planar) of ``spec["distinct"]`` pictures: ``planes`` the
    int32 sample planes of each (offset removed, as the reference codes
    them), ``planar`` the bytes of each as the CLIs read them (MSB-justified
    offset-binary big-endian words)."""
    bits = coding["depth_bits"]
    h, w = coding["height"], coding["width"]
    cw = w // 2 if coding["chroma"] in ("4:2:2", "4:2:0") else w
    ch = h // 2 if coding["chroma"] == "4:2:0" else h
    zero, top = 1 << (bits - 1), (1 << bits) - 1
    scale = 1 << (bits - 10)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    py, px = spec["periods"]
    my, mx = spec["motion"]
    noise = spec["noise"]
    planes, planar = [], []
    for k in range(spec["distinct"]):
        pic, raw = [], []
        for hh, ww in ((h, w), (ch, cw), (ch, cw)):
            rows = torch.sin((torch.arange(hh, device=device,
                                           dtype=torch.float64) + my * k) / py)
            cols = torch.cos((torch.arange(ww, device=device,
                                           dtype=torch.float64) + mx * k) / px)
            base = zero + spec["amplitude"] * scale * torch.outer(rows, cols)
            v = base.to(torch.int64) + scale * torch.randint(
                -noise, noise, (hh, ww), generator=gen, device=device)
            v = v.clamp(0, top)
            pic.append((v - zero).to(torch.int32))
            word = v << (16 - bits) if bits > 8 else v
            raw.append(torch.stack([word >> 8, word & 0xFF], -1).to(
                torch.uint8).reshape(-1) if bits > 8 else word.to(
                torch.uint8).reshape(-1))
        planes.append(pic)
        planar.append(torch.cat(raw).cpu().numpy().tobytes())
    return planes, planar
