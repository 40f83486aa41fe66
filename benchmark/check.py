"""What decides ``correct``: the window's own outputs against the reference.

Every picture the reader handed over has to come out, and no other
(``missing``: the difference of the two counts), the output has to hold
whole pictures and nothing else (``stray_bytes``), and each picture of
the seeded sample of those completed in the window has to equal, byte
for byte, what the reference codec gives for it: a decode's
planar picture, or an encode's picture data unit, parse info and picture
number included (``differ``). Each number's limit is 0: the
configuration's guarantee is byte identity.
"""

from __future__ import annotations

LIMITS = {"missing": 0, "stray_bytes": 0, "differ": 0}


def expected(direction: str, codec, coded, index: int) -> bytes:
    """The bytes the program has to give for picture ``index`` of a cell
    whose ``coded`` pictures it cycles."""
    c = coded[index % len(coded)]
    if direction == "decode":
        return c.decoded
    if index == 0:
        prev = 13 + len(codec.header)
    else:
        prev = 13 + 4 + len(coded[(index - 1) % len(coded)].body)
    return codec.unit(index & 0xFFFFFFFF, c.body, prev)


def judge(direction: str, window, sink, codec, coded) -> dict:
    """The numbers compared: {name: (value, limit)}, and ``sampled``."""
    missing = abs(len(window.handed) - len(window.done))
    stray = sink.leftover() + getattr(sink, "bad", 0)
    differ = 0
    for index, parts in sink.sample.kept:
        if b"".join(parts) != expected(direction, codec, coded, index):
            differ += 1
    return {"missing": (missing, LIMITS["missing"]),
            "stray_bytes": (stray, LIMITS["stray_bytes"]),
            "differ": (differ, LIMITS["differ"]),
            "sampled": (len(sink.sample.kept), None)}


def passed(numbers: dict) -> bool:
    return all(limit is None or value <= limit
               for value, limit in numbers.values())
