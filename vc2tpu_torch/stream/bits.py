"""Host bit-level stream engine with bounded regions.

Explicit-state replacement for the reference's iostream iword bit engine
(reference src/Library/src/VLC.cpp:96-257). Semantics preserved:

* writes past a bound: 1-bits silently dropped, 0-bits are an error;
* reads past a bound return 1-bits (this is what makes truncated slices
  decode to zeros instead of desyncing);
* ``flush`` writes/skips zero bits to the end of the bound;
* ``align`` clears the bound and pads/skips to the next byte boundary.
"""

from __future__ import annotations

from vc2tpu_torch.vlc.golomb import encode_signed_scalar, encode_unsigned_scalar


class BitWriter:
    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cache = 0
        self._cached_bits = 0
        self._bounded = False
        self._bits_left = 0

    def bounded(self, nbits: int) -> None:
        self._bounded = True
        self._bits_left = nbits

    def unbounded(self) -> None:
        self._bounded = False

    def put_bit(self, bit: int) -> None:
        if self._bounded and self._bits_left < 1:
            if bit:
                return
            raise ValueError("Attempt to write beyond end of bounded write")
        self._cache = ((self._cache << 1) | (1 if bit else 0)) & 0xFF
        self._cached_bits += 1
        self._bits_left -= 1
        if self._cached_bits == 8:
            self._bytes.append(self._cache)
            self._cached_bits = 0

    def put_bits(self, n: int, value: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put_bit((value >> i) & 1)

    def put_uvlc(self, value: int) -> None:
        self.put_bits(*encode_unsigned_scalar(value))

    def put_svlc(self, value: int) -> None:
        self.put_bits(*encode_signed_scalar(value))

    def put_bool(self, b: bool) -> None:
        self.put_bit(1 if b else 0)

    def flush(self) -> None:
        if self._bounded:
            while self._bits_left > 0:
                self.put_bit(0)

    def align(self) -> None:
        self._bounded = False
        while self._cached_bits:
            self.put_bit(0)

    def put_bytes_value(self, n: int, value: int) -> None:
        """Fixed-width big-endian bytes; aligns first (reference
        VLC.cpp:326)."""
        self.align()
        for i in range(n - 1, -1, -1):
            self._bytes.append((value >> (8 * i)) & 0xFF)

    def put_raw(self, data: bytes) -> None:
        self.align()
        self._bytes.extend(data)

    def getvalue(self) -> bytes:
        if self._cached_bits:
            raise ValueError("unaligned stream")
        return bytes(self._bytes)

    def __len__(self) -> int:
        return len(self._bytes)


class BitReader:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self._data = data
        self._pos = pos            # byte position
        self._cache = 0
        self._cached_bits = 0
        self._bounded = False
        self._bits_left = 0

    @property
    def byte_pos(self) -> int:
        return self._pos

    def seek(self, byte_pos: int) -> None:
        self._pos = byte_pos
        self._cached_bits = 0
        self._bounded = False

    def eof(self) -> bool:
        return self._pos >= len(self._data) and self._cached_bits == 0

    def bounded(self, nbits: int) -> None:
        self._bounded = True
        self._bits_left = nbits

    def unbounded(self) -> None:
        self._bounded = False

    def get_bit(self) -> int:
        if self._bounded and self._bits_left < 1:
            return 1
        if self._cached_bits == 0:
            self._cache = self._data[self._pos] if self._pos < len(self._data) else 0xFF
            self._pos += 1
            self._cached_bits = 8
        self._cached_bits -= 1
        self._bits_left -= 1
        return (self._cache >> self._cached_bits) & 1

    def get_bits(self, n: int) -> int:
        value = 0
        for _ in range(n):
            value = (value << 1) | self.get_bit()
        return value

    def get_uvlc(self) -> int:
        value = 1
        while not self.get_bit():
            value = (value << 1) | self.get_bit()
        return value - 1

    def get_svlc(self) -> int:
        value = self.get_uvlc()
        if value and self.get_bit():
            return -value
        return value

    def get_bool(self) -> bool:
        return bool(self.get_bit())

    def flush(self) -> None:
        if self._bounded:
            while self._bits_left > 0:
                self.get_bit()

    def align(self) -> None:
        self._bounded = False
        while self._cached_bits:
            self.get_bit()

    def get_bytes_value(self, n: int) -> int:
        self.align()
        end = self._pos + n
        if end > len(self._data):
            # the reference reads fixed fields with `value |= stream.get()`
            # (VLC.cpp operator>>(istream, Bytes&)); get() returns -1 at
            # EOF, which sets EVERY bit of the accumulator — a field read
            # past the end is all-ones, not zero-padded
            self._pos = end
            return (1 << (8 * n)) - 1
        value = 0
        for b in self._data[self._pos:end]:
            value = (value << 8) | b
        self._pos = end
        return value

    def get_raw(self, n: int) -> bytes:
        self.align()
        out = self._data[self._pos:self._pos + n]
        self._pos += n
        return out
