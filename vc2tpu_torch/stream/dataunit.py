"""Data-unit framing: parse_info headers, sequence headers and picture
preambles, both directions.

Port of the reference stream syntax layer
(reference src/Library/src/DataUnit.cpp:80-123, 1086-1144, 1339-1410). The
iostream iword state of the reference (prev_parse_offset,
major_version_number) becomes explicit fields of StreamWriter and
StreamReader. The writer writes HQ pictures, whole or as a series of
fragments (``fragment_length`` > 0, HQ CBR; ``FragmentWriter``, reference
DataUnit.cpp:125-343), and not yet LD pictures; the reader reads fragment
headers (``read_fragment_header``).
"""

from __future__ import annotations

import dataclasses
import enum

from vc2tpu_torch.core.config import WaveletKernel
from vc2tpu_torch.core.intmath import rationalise
from vc2tpu_torch.stream.bits import BitReader, BitWriter
from vc2tpu_torch.stream.headers import (SequenceHeader, read_video_format,
                                         sequence_header_of, video_format_of,
                                         write_video_format)


class DataUnitType(enum.Enum):
    UNKNOWN = "unknown"
    SEQUENCE_HEADER = "sequence_header"
    END_OF_SEQUENCE = "end_of_sequence"
    AUXILIARY_DATA = "auxiliary_data"
    PADDING_DATA = "padding_data"
    HQ_PICTURE = "hq_picture"
    LD_PICTURE = "ld_picture"
    HQ_FRAGMENT = "hq_fragment"
    LD_FRAGMENT = "ld_fragment"


# parse codes (reference DataUnit.cpp:92-109, 1127-1139)
PARSE_CODES = {
    DataUnitType.SEQUENCE_HEADER: 0x00,
    DataUnitType.END_OF_SEQUENCE: 0x10,
    DataUnitType.AUXILIARY_DATA: 0x20,
    DataUnitType.PADDING_DATA: 0x30,
    DataUnitType.LD_PICTURE: 0xC8,
    DataUnitType.HQ_PICTURE: 0xE8,
    DataUnitType.LD_FRAGMENT: 0xCC,
    DataUnitType.HQ_FRAGMENT: 0xEC,
}
_CODE_TO_TYPE = {v: k for k, v in PARSE_CODES.items()}


@dataclasses.dataclass
class Fragment:
    n_slices: int = 0
    slice_offset_x: int = 0
    slice_offset_y: int = 0
    data_length: int = 0


@dataclasses.dataclass
class PicturePreamble:
    """Transform parameters (reference PicturePreamble, DataUnit.h:221-234)."""

    wavelet_kernel: WaveletKernel = WaveletKernel.NullKernel
    depth: int = 0
    slices_x: int = 0
    slices_y: int = 0
    slice_prefix: int = 0
    slice_size_scalar: int = 0
    slice_bytes_numerator: int = 0
    slice_bytes_denominator: int = 1
    wavelet_kernel_ho: WaveletKernel = WaveletKernel.NullKernel
    depth_ho: int = 0


class StreamWriter:
    """Writes a VC-2 stream to a file object."""

    def __init__(self, fileobj) -> None:
        self.f = fileobj
        self.prev_parse_offset = 0
        self.major_version = 0
        self.fragment_length = 0      # > 0: pictures go out as fragments

    def _parse_info(self, du_type: DataUnitType, data_size: int | None) -> None:
        """Reference ParseInfoIO (DataUnit.cpp:80-123)."""
        next_off = 0 if data_size is None else data_size + 13
        self.f.write(b"BBCD" + bytes([PARSE_CODES[du_type]])
                     + next_off.to_bytes(4, "big")
                     + self.prev_parse_offset.to_bytes(4, "big"))
        self.prev_parse_offset = next_off

    def start_sequence(self) -> None:
        self.prev_parse_offset = 0

    def end_sequence(self) -> None:
        self._parse_info(DataUnitType.END_OF_SEQUENCE, None)
        self.prev_parse_offset = 0

    def write_sequence_header(self, hdr: SequenceHeader) -> None:
        vf = video_format_of(hdr)
        if self.fragment_length > 0 and hdr.major_version < 3:
            vf.major_version = 3      # fragments need version 3 syntax
        self.major_version = vf.major_version
        w = BitWriter()
        write_video_format(w, vf)
        payload = w.getvalue()
        self._parse_info(DataUnitType.SEQUENCE_HEADER, len(payload))
        self.f.write(payload)

    def _transform_params(self, preamble: PicturePreamble,
                          force_asym_flags: bool = False,
                          hq: bool = True) -> bytes:
        """The preamble's transform parameters, the write twin of
        ``StreamReader.read_preamble``: HQ's slice prefix and scalar, or
        LD's slice bytes numerator and denominator; a fragment series
        writes the asymmetric-transform flags whatever the version."""
        w = BitWriter()
        w.unbounded()
        w.put_uvlc(int(preamble.wavelet_kernel))
        w.put_uvlc(preamble.depth)
        if force_asym_flags or self.major_version >= 3:
            w.put_bool(False)   # asym_transform_index_flag
            w.put_bool(False)   # asym_transform_flag
        w.put_uvlc(preamble.slices_x)
        w.put_uvlc(preamble.slices_y)
        if hq:
            w.put_uvlc(preamble.slice_prefix)
            w.put_uvlc(preamble.slice_size_scalar)
        else:
            w.put_uvlc(preamble.slice_bytes_numerator)
            w.put_uvlc(preamble.slice_bytes_denominator)
        w.put_bool(False)       # custom quant matrix
        w.align()
        return w.getvalue()

    def write_picture(self, picture_number: int, preamble: PicturePreamble,
                      slice_payload: bytes, slice_sizes=None,
                      hq: bool = True) -> None:
        """One HQ (or, with ``hq`` False, LD) picture data unit (picture
        number, transform parameters and the slice payload), or a fragment
        series when ``fragment_length`` > 0 (reference HQ/LDWrappedPictureIO
        in DataUnit.cpp:125-343). ``slice_sizes`` (each slice's bytes,
        raster order) is needed for fragments."""
        if self.fragment_length == 0:
            body = (picture_number.to_bytes(4, "big")
                    + self._transform_params(preamble, hq=hq)
                    + slice_payload)
            self._parse_info(DataUnitType.HQ_PICTURE if hq
                             else DataUnitType.LD_PICTURE, len(body))
            self.f.write(body)
            return
        if slice_sizes is None:
            raise ValueError("fragmented output needs the slice sizes")
        fw = self.begin_fragments(picture_number, preamble, hq)
        fw.feed(slice_sizes, slice_payload)
        fw.close()

    def begin_fragments(self, picture_number: int,
                        preamble: PicturePreamble,
                        hq: bool = True) -> "FragmentWriter":
        """Start the fragment series of one picture: writes the
        transform-parameters fragment, returns the FragmentWriter."""
        return FragmentWriter(self, picture_number, preamble, hq)


class FragmentWriter:
    """The fragments of ONE HQ or LD picture (reference DataUnit.cpp:
    267-342).

    The first fragment holds the transform parameters and no slices.
    ``feed`` takes runs of (slice sizes, their payload) in raster order and
    writes each fragment as soon as it is complete: as many whole slices
    as fit in ``fragment_length`` bytes, and at least one, even a slice
    larger than that. ``close`` writes the last fragment, which the
    reference writes even when it holds no slice."""

    def __init__(self, writer: StreamWriter, picture_number: int,
                 preamble: PicturePreamble, hq: bool = True) -> None:
        self.w = writer
        self.pic = picture_number
        self.slices_x = preamble.slices_x
        self.du = DataUnitType.HQ_FRAGMENT if hq else DataUnitType.LD_FRAGMENT
        params = writer._transform_params(preamble, force_asym_flags=True,
                                          hq=hq)
        writer._parse_info(self.du, len(params) + 8)
        writer.f.write(picture_number.to_bytes(4, "big")
                       + len(params).to_bytes(2, "big")
                       + (0).to_bytes(2, "big") + params)
        self._first = 0              # first slice of the open fragment
        self._count = 0              # its slices
        self._chunks: list[bytes] = []
        self._bytes = 0
        self._next = 0               # the next slice feed() takes
        self._closed = False

    def _emit(self) -> None:
        sy, sx = divmod(self._first, self.slices_x)
        body = (self.pic.to_bytes(4, "big") + self._bytes.to_bytes(2, "big")
                + self._count.to_bytes(2, "big") + sx.to_bytes(2, "big")
                + sy.to_bytes(2, "big") + b"".join(self._chunks))
        self.w._parse_info(self.du, self._bytes + 12)
        self.w.f.write(body)
        self._first = self._next
        self._count = 0
        self._chunks = []
        self._bytes = 0

    def feed(self, slice_sizes, payload) -> None:
        """Append the next run of slices: their sizes and their payload
        bytes, contiguous, raster order. The sizes are checked against the
        payload before any fragment is written."""
        payload = bytes(payload)
        sizes = [int(s) for s in slice_sizes]
        if sum(sizes) != len(payload):
            raise ValueError(f"fragment span: {len(payload)} payload bytes "
                             f"but slice sizes sum to {sum(sizes)}")
        pos = 0
        limit = self.w.fragment_length
        for size in sizes:
            if self._count and self._bytes + size > limit:
                self._emit()
            self._chunks.append(payload[pos:pos + size])
            self._bytes += size
            self._count += 1
            self._next += 1
            pos += size

    def close(self) -> None:
        """Write the last fragment, once."""
        if not self._closed:
            self._emit()
            self._closed = True


class StreamReader:
    """Reads a VC-2 stream from a byte buffer."""

    def __init__(self, data: bytes) -> None:
        self.r = BitReader(data)
        self.data = data
        self.major_version = 0

    def read_data_unit(self):
        """(type, next_parse_offset, prev_parse_offset); checks the prefix
        (reference operator>>(istream&, DataUnit&), DataUnit.cpp:1111-1144)."""
        prefix = self.r.get_raw(4)
        if prefix != b"\x42\x42\x43\x44":
            raise ValueError("Read bytes do not match expected parse_info_header.")
        code = self.r.get_bytes_value(1)
        if code not in _CODE_TO_TYPE:
            raise ValueError("Stream Error: Unknown data unit type.")
        next_off = self.r.get_bytes_value(4)
        prev_off = self.r.get_bytes_value(4)
        return _CODE_TO_TYPE[code], next_off, prev_off

    def read_sequence_header(self) -> SequenceHeader:
        vf = read_video_format(self.r)
        hdr = sequence_header_of(vf)
        self.major_version = hdr.major_version
        return hdr

    def read_picture_number(self) -> int:
        return self.r.get_bytes_value(4)

    def read_fragment_header(self) -> Fragment:
        """A fragment's data length, slice count and, when it holds
        slices, the first slice's position."""
        frag = Fragment()
        frag.data_length = self.r.get_bytes_value(2)
        frag.n_slices = self.r.get_bytes_value(2)
        if frag.n_slices != 0:
            frag.slice_offset_x = self.r.get_bytes_value(2)
            frag.slice_offset_y = self.r.get_bytes_value(2)
        return frag

    def read_preamble(self, hq: bool) -> PicturePreamble:
        """Reference operator>>(istream&, PicturePreamble&), DataUnit.cpp:1339-1410."""
        r = self.r
        r.unbounded()
        p = PicturePreamble()
        p.wavelet_kernel = WaveletKernel(r.get_uvlc())
        p.depth = r.get_uvlc()
        p.wavelet_kernel_ho = p.wavelet_kernel
        p.depth_ho = 0
        if self.major_version >= 3:
            if r.get_bool():
                p.wavelet_kernel_ho = WaveletKernel(r.get_uvlc())
            if r.get_bool():
                p.depth_ho = r.get_uvlc()
        p.slices_x = r.get_uvlc()
        p.slices_y = r.get_uvlc()
        if hq:
            p.slice_prefix = r.get_uvlc()
            p.slice_size_scalar = r.get_uvlc()
            p.slice_bytes_numerator, p.slice_bytes_denominator = 0, 1
        else:
            num = r.get_uvlc()
            den = r.get_uvlc()
            p.slice_bytes_numerator, p.slice_bytes_denominator = rationalise(num, den)
            p.slice_prefix = 0
            p.slice_size_scalar = 0
        if r.get_bool():
            raise ValueError("DataUnitIO: Custom Quantisation Matrix flag not supported")
        r.align()
        # a corrupt header that would leave no slices, or divide by zero,
        # is a corrupt picture: the decoder skips it, as the JAX package's
        # does (it catches the ZeroDivisionError that follows)
        if p.slices_x == 0 or p.slices_y == 0:
            raise ValueError(f"picture of {p.slices_x} x {p.slices_y} slices")
        if not hq and p.slice_bytes_denominator == 0:
            raise ValueError("LD slice_bytes_denominator is 0")
        return p
