"""The stream syntax the reference encoder writes: parse info, the
sequence header and the picture data unit (SMPTE ST 2042-1 sections 10-12;
bbc/vc2-reference src/Library/src/DataUnit.cpp).

A frozen copy of the write side of the port's ``stream/bits.py``,
``stream/headers.py`` and ``stream/dataunit.py`` (and the enums of
``core/config.py`` they use), kept here so that the yardstick does not move
when the program does. Nothing of the program is imported.
"""

from __future__ import annotations

import dataclasses
import enum

class ColourFormat(enum.IntEnum):
    CF444 = 0
    CF422 = 1
    CF420 = 2

    @staticmethod
    def parse(text: str) -> "ColourFormat":
        table = {"4:4:4": ColourFormat.CF444, "4:2:2": ColourFormat.CF422,
                 "4:2:0": ColourFormat.CF420}
        if text not in table:
            raise ValueError(f"invalid colour format: {text!r}")
        return table[text]

    def __str__(self) -> str:
        return {0: "4:4:4", 1: "4:2:2", 2: "4:2:0"}[int(self)]


class Profile(enum.IntEnum):
    PROFILE_UNKNOWN = 0
    PROFILE_LD = 1
    PROFILE_HQ = 2



class FrameRate(enum.IntEnum):
    FR0 = 0
    FR24000_1001 = 1
    FR24 = 2
    FR25 = 3
    FR30000_1001 = 4
    FR30 = 5
    FR50 = 6
    FR60000_1001 = 7
    FR60 = 8
    FR15000_1001 = 9
    FR25_2 = 10
    FR48 = 11
    FR48_1001 = 12
    FR96 = 13
    FR100 = 14
    FR120_1001 = 15
    FR120 = 16


MAX_V2_FRAMERATE = FrameRate.FR48


class PixelAspectRatio(enum.IntEnum):
    AR_UNSET = -1
    AR0 = 0
    AR1_1 = 1
    AR10_11 = 2
    AR12_11 = 3
    AR40_33 = 4
    AR16_11 = 5
    AR4_3 = 6


class ColorSpec(enum.IntEnum):
    CS_UNSET = -1
    CS_CUSTOM = 0
    CS_SDTV_525 = 1
    CS_SDTV_625 = 2
    CS_HDTV = 3
    CS_D_CINEMA = 4
    CS_UHDTV = 5
    CS_HDRTV_PQ = 6
    CS_HDRTV_HLG = 7


def encode_unsigned_scalar(value: int) -> tuple[int, int]:
    """(nbits, bits) of the unsigned code of one value."""
    if value == 0:
        return 1, 1
    u = value + 1
    k = u.bit_length()
    bits = 0
    for j in range(k - 2, -1, -1):
        bits <<= 2
        if (u >> j) & 1:
            bits |= 1
    bits = (bits << 1) | 1
    return 2 * (k - 1) + 1, bits


def encode_signed_scalar(value: int) -> tuple[int, int]:
    if value == 0:
        return 1, 1
    nbits, bits = encode_unsigned_scalar(abs(value))
    bits <<= 1
    if value < 0:
        bits |= 1
    return nbits + 1, bits


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


@dataclasses.dataclass
class SequenceHeader:
    """Mirror of the reference SequenceHeader (DataUnit.h:105-161)."""

    profile: Profile = Profile.PROFILE_UNKNOWN
    height: int = 0
    width: int = 0
    chroma_format: ColourFormat = ColourFormat.CF444
    interlace: bool = False
    frame_rate: FrameRate = FrameRate.FR0
    top_field_first: bool = False
    bitdepth: int = 0
    pixel_aspect_ratio: int = int(PixelAspectRatio.AR_UNSET)
    clean_width: int = -1
    clean_height: int = -1
    left_offset: int = -1
    top_offset: int = -1
    color_spec: int = int(ColorSpec.CS_UNSET)
    color_primaries: int = 0
    color_matrix: int = 0
    transfer_function: int = 0
    major_version: int = 1
    minor_version: int = 0
    frame_rate_numer: int = 0
    frame_rate_denom: int = 0
    luma_excursion: int = 0
    luma_offset: int = 0
    color_diff_excursion: int = 0
    color_diff_offset: int = 0
    pixel_aspect_ratio_numer: int = 0
    pixel_aspect_ratio_denom: int = 0

    def __post_init__(self):
        # version policy (reference DataUnit.cpp:425-433)
        if self.major_version == 1:
            if self.profile == Profile.PROFILE_HQ:
                self.major_version = 2
            if self.frame_rate > MAX_V2_FRAMERATE or self.bitdepth > 12:
                self.major_version = 3


def _base(profile, h, w, cf, intl, fr, tff, bd, par, cw, chh, lo, to, cs):
    return SequenceHeader(profile=profile, height=h, width=w, chroma_format=cf,
                          interlace=intl, frame_rate=fr, top_field_first=tff,
                          bitdepth=bd, pixel_aspect_ratio=int(par), clean_width=cw,
                          clean_height=chh, left_offset=lo, top_offset=to,
                          color_spec=int(cs))


_U = Profile.PROFILE_UNKNOWN
_CF444, _CF422, _CF420 = ColourFormat.CF444, ColourFormat.CF422, ColourFormat.CF420
FR = FrameRate
AR = PixelAspectRatio
CS = ColorSpec

# Base video formats 0..22 (reference DataUnit.cpp:435-464)
_BASE_FORMATS = [
    _base(_U, 480, 640, _CF420, False, FR.FR24000_1001, False, 8, AR.AR1_1, 640, 480, 0, 0, CS.CS_CUSTOM),
    _base(_U, 120, 176, _CF420, False, FR.FR15000_1001, False, 8, AR.AR10_11, 176, 120, 0, 0, CS.CS_SDTV_525),
    _base(_U, 144, 176, _CF420, False, FR.FR25_2, True, 8, AR.AR12_11, 176, 144, 0, 0, CS.CS_SDTV_625),
    _base(_U, 240, 352, _CF420, False, FR.FR15000_1001, False, 8, AR.AR10_11, 352, 240, 0, 0, CS.CS_SDTV_525),
    _base(_U, 288, 352, _CF420, False, FR.FR25_2, True, 8, AR.AR12_11, 352, 288, 0, 0, CS.CS_SDTV_625),
    _base(_U, 480, 704, _CF420, False, FR.FR15000_1001, False, 8, AR.AR10_11, 704, 480, 0, 0, CS.CS_SDTV_525),
    _base(_U, 576, 704, _CF420, False, FR.FR25_2, True, 8, AR.AR12_11, 704, 576, 0, 0, CS.CS_SDTV_625),
    _base(_U, 480, 720, _CF422, True, FR.FR30000_1001, False, 10, AR.AR10_11, 704, 480, 8, 0, CS.CS_SDTV_525),
    _base(_U, 576, 720, _CF422, True, FR.FR25, True, 10, AR.AR12_11, 704, 576, 8, 0, CS.CS_SDTV_625),
    _base(_U, 720, 1280, _CF422, False, FR.FR60000_1001, True, 10, AR.AR1_1, 1280, 720, 0, 0, CS.CS_HDTV),
    _base(_U, 720, 1280, _CF422, False, FR.FR50, True, 10, AR.AR1_1, 1280, 720, 0, 0, CS.CS_HDTV),
    _base(_U, 1080, 1920, _CF422, True, FR.FR30000_1001, True, 10, AR.AR1_1, 1920, 1080, 0, 0, CS.CS_HDTV),
    _base(_U, 1080, 1920, _CF422, True, FR.FR25, True, 10, AR.AR1_1, 1920, 1080, 0, 0, CS.CS_HDTV),
    _base(_U, 1080, 1920, _CF422, False, FR.FR60000_1001, True, 10, AR.AR1_1, 1920, 1080, 0, 0, CS.CS_HDTV),
    _base(_U, 1080, 1920, _CF422, False, FR.FR50, True, 10, AR.AR1_1, 1920, 1080, 0, 0, CS.CS_HDTV),
    _base(_U, 1080, 2048, _CF444, False, FR.FR24, True, 12, AR.AR1_1, 2048, 1080, 0, 0, CS.CS_D_CINEMA),
    _base(_U, 2160, 4096, _CF444, False, FR.FR24, True, 12, AR.AR1_1, 4096, 2160, 0, 0, CS.CS_D_CINEMA),
    _base(_U, 2160, 3840, _CF422, False, FR.FR60000_1001, True, 10, AR.AR1_1, 3840, 2160, 0, 0, CS.CS_UHDTV),
    _base(_U, 2160, 3840, _CF422, False, FR.FR50, True, 10, AR.AR1_1, 3840, 2160, 0, 0, CS.CS_UHDTV),
    _base(_U, 4320, 7680, _CF422, False, FR.FR60000_1001, True, 10, AR.AR1_1, 7680, 4320, 0, 0, CS.CS_UHDTV),
    _base(_U, 4320, 7680, _CF422, False, FR.FR50, True, 10, AR.AR1_1, 7680, 4320, 0, 0, CS.CS_UHDTV),
    _base(_U, 1080, 1920, _CF422, False, FR.FR24000_1001, True, 10, AR.AR1_1, 1920, 1080, 0, 0, CS.CS_HDTV),
    _base(_U, 486, 720, _CF422, True, FR.FR30000_1001, False, 10, AR.AR10_11, 720, 486, 0, 0, CS.CS_HDTV),
]


def default_source_parameters(index: int) -> SequenceHeader:
    if not (0 <= index < len(_BASE_FORMATS)):
        raise ValueError("DataUnitIO: unknown base video format")
    return dataclasses.replace(_BASE_FORMATS[index])


@dataclasses.dataclass
class VideoFormat:
    """Wire-level video format (reference video_format struct, DataUnit.h:165)."""

    major_version: int = 0
    minor_version: int = 0
    profile: int = 0
    level: int = 0
    base_video_format: int = 0
    custom_dimensions_flag: bool = False
    frame_width: int = 0
    frame_height: int = 0
    custom_color_diff_format_flag: bool = False
    color_diff_format: int = 0
    custom_scan_format_flag: bool = False
    source_sampling: int = 0
    custom_frame_rate_flag: bool = False
    frame_rate: int = 0
    frame_rate_numer: int = 0
    frame_rate_denom: int = 0
    custom_pixel_aspect_ratio_flag: bool = False
    pixel_aspect_ratio: int = 0
    pixel_aspect_ratio_numer: int = 0
    pixel_aspect_ratio_denom: int = 0
    custom_clean_area_flag: bool = False
    clean_width: int = 0
    clean_height: int = 0
    left_offset: int = 0
    top_offset: int = 0
    custom_signal_range_flag: bool = False
    bitdepth: int = 0
    luma_excursion: int = 0
    luma_offset: int = 0
    color_diff_excursion: int = 0
    color_diff_offset: int = 0
    custom_color_spec_flag: bool = False
    color_spec: int = 0
    custom_color_primaries_flag: bool = False
    color_primaries: int = 0
    custom_color_matrix_flag: bool = False
    color_matrix: int = 0
    custom_transfer_function_flag: bool = False
    transfer_function: int = 0


def _matches_fields(fmt: SequenceHeader, w, h, cf, r, bd, tff) -> bool:
    return (fmt.width == w and fmt.height == h and fmt.chroma_format == cf
            and fmt.frame_rate == r and fmt.bitdepth == bd
            and fmt.top_field_first == tff)


def _unset_or(value: int, base: int) -> bool:
    return value == -1 or value == base


def _matches_index(fmt: SequenceHeader, index: int) -> bool:
    b = _BASE_FORMATS[index]
    return (fmt.width == b.width and fmt.height == b.height
            and fmt.chroma_format == b.chroma_format
            and fmt.frame_rate == b.frame_rate and fmt.bitdepth == b.bitdepth
            and fmt.interlace == b.interlace
            and fmt.top_field_first == b.top_field_first
            and _unset_or(fmt.pixel_aspect_ratio, b.pixel_aspect_ratio)
            and _unset_or(fmt.clean_width, b.clean_width)
            and _unset_or(fmt.clean_height, b.clean_height)
            and _unset_or(fmt.left_offset, b.left_offset)
            and _unset_or(fmt.top_offset, b.top_offset)
            and _unset_or(fmt.color_spec, b.color_spec))


def _check_match(fmt: SequenceHeader, index: int) -> int:
    """Fields of ``fmt`` that differ from base format ``index``; -1 when the
    field order differs."""
    b = _BASE_FORMATS[index]
    if fmt.top_field_first != b.top_field_first:
        return -1
    return ((fmt.width != b.width) + (fmt.height != b.height)
            + (fmt.chroma_format != b.chroma_format)
            + (fmt.frame_rate != b.frame_rate)
            + (fmt.bitdepth != b.bitdepth) + (fmt.interlace != b.interlace)
            + (not _unset_or(fmt.pixel_aspect_ratio, b.pixel_aspect_ratio))
            + (not _unset_or(fmt.clean_width, b.clean_width))
            + (not _unset_or(fmt.clean_height, b.clean_height))
            + (not _unset_or(fmt.left_offset, b.left_offset))
            + (not _unset_or(fmt.top_offset, b.top_offset))
            + (not _unset_or(fmt.color_spec, b.color_spec)))


# Base formats tried in order by video_format_of: (index, level, match
# the interlaced "scan format" of a progressive stream by fields only).
_INTERLACED_BASES = ((7, 2), (8, 2), (22, 2))
_PROGRESSIVE_BASES = (
    (1, 1, None), (2, 1, None), (3, 1, None), (4, 1, None), (5, 1, None),
    (6, 1, None),
    (7, 2, (720, 480, _CF422, FR.FR30000_1001, 10, False)),
    (8, 2, (720, 576, _CF422, FR.FR25, 10, True)),
    (22, 2, (720, 486, _CF422, FR.FR30000_1001, 10, False)),
    (9, 3, None), (10, 3, None),
    (11, 3, (1920, 1080, _CF422, FR.FR30000_1001, 10, True)),
    (12, 3, (1920, 1080, _CF422, FR.FR25, 10, True)),
    (13, 3, None), (14, 3, None), (21, 3, None), (15, 4, None))
_UHD_BASES = ((16, 5), (17, 6), (18, 6), (19, 7), (20, 7))
_BITDEPTH_TO_INDEX = {0: 0, 8: 1, 10: 3, 12: 4, 16: 7}


def video_format_of(fmt: SequenceHeader) -> VideoFormat:
    """Base-format matching and custom-flag minimisation (reference
    video_format::video_format(SequenceHeader), DataUnit.cpp:563-784)."""
    vf = VideoFormat()
    vf.major_version = fmt.major_version
    vf.minor_version = fmt.minor_version
    vf.profile = 3 if fmt.profile == Profile.PROFILE_HQ else 0

    def setm(i, lvl, scan=False):
        vf.base_video_format = i
        vf.level = lvl
        if scan:
            vf.custom_scan_format_flag = True
            vf.source_sampling = 0

    if fmt.interlace:
        for i, lvl in _INTERLACED_BASES:
            if _matches_index(fmt, i):
                setm(i, lvl)
                break
        else:
            if (fmt.chroma_format == _CF422 and fmt.width == 720
                    and 480 <= fmt.height <= 486
                    and fmt.frame_rate == FR.FR30000_1001
                    and fmt.bitdepth == 10):
                vf.base_video_format = 7
                vf.level = 2
                vf.custom_dimensions_flag = True
                vf.frame_width = fmt.width
                vf.frame_height = fmt.height
            elif _matches_index(fmt, 11):
                setm(11, 3)
            elif _matches_index(fmt, 12):
                setm(12, 3)
    else:
        for i, lvl, fields in _PROGRESSIVE_BASES:
            if fields is None and _matches_index(fmt, i):
                setm(i, lvl)
                break
            if fields is not None and _matches_fields(fmt, *fields):
                setm(i, lvl, scan=True)
                break
        else:
            if _matches_fields(fmt, 2048, 1080, _CF444, FR.FR48, 12, True):
                vf.base_video_format = 15
                vf.level = 4
                vf.custom_frame_rate_flag = True
                vf.frame_rate = int(FR.FR48)
            else:
                for i, lvl in _UHD_BASES:
                    if _matches_index(fmt, i):
                        setm(i, lvl)
                        break

    if vf.base_video_format == 0:
        vf.level = 0
        best = 999
        for i in range(1, 23):
            nm = _check_match(fmt, i)
            if nm != -1 and nm < best:
                vf.base_video_format = i
                best = nm
        base = default_source_parameters(vf.base_video_format)
        if fmt.interlace != base.interlace:
            vf.custom_scan_format_flag = True
            vf.source_sampling = int(fmt.interlace)
        if fmt.width != base.width or fmt.height != base.height:
            vf.custom_dimensions_flag = True
            vf.frame_width = fmt.width
            vf.frame_height = fmt.height
        if fmt.chroma_format != base.chroma_format:
            vf.custom_color_diff_format_flag = True
            vf.color_diff_format = int(fmt.chroma_format)
        if fmt.frame_rate != base.frame_rate:
            vf.custom_frame_rate_flag = True
            vf.frame_rate = int(fmt.frame_rate)
            if vf.frame_rate == 0:
                vf.frame_rate_numer = fmt.frame_rate_numer
                vf.frame_rate_denom = fmt.frame_rate_denom
        if fmt.bitdepth != base.bitdepth:
            vf.custom_signal_range_flag = True
            if fmt.bitdepth not in _BITDEPTH_TO_INDEX:
                raise ValueError("DataUnitIO: invalid bit depth")
            vf.bitdepth = _BITDEPTH_TO_INDEX[fmt.bitdepth]
            if vf.bitdepth == 0:
                vf.luma_excursion = fmt.luma_excursion
                vf.luma_offset = fmt.luma_offset
                vf.color_diff_excursion = fmt.color_diff_excursion
                vf.color_diff_offset = fmt.color_diff_offset
        if not _unset_or(fmt.pixel_aspect_ratio, base.pixel_aspect_ratio):
            vf.custom_pixel_aspect_ratio_flag = True
            vf.pixel_aspect_ratio = int(fmt.pixel_aspect_ratio)
            if vf.pixel_aspect_ratio == 0:
                vf.pixel_aspect_ratio_numer = fmt.pixel_aspect_ratio_numer
                vf.pixel_aspect_ratio_denom = fmt.pixel_aspect_ratio_denom
        clean_set = (fmt.clean_height != -1 or fmt.clean_width != -1
                     or fmt.left_offset != -1 or fmt.top_offset != -1)
        clean_differs = (fmt.clean_height != base.clean_height
                         or fmt.clean_width != base.clean_width
                         or fmt.left_offset != base.left_offset
                         or fmt.top_offset != base.top_offset)
        if clean_set and clean_differs:
            vf.custom_clean_area_flag = True
            vf.clean_height = fmt.clean_height
            vf.clean_width = fmt.clean_width
            vf.left_offset = fmt.left_offset
            vf.top_offset = fmt.top_offset
        elif vf.custom_dimensions_flag and not clean_set:
            vf.custom_clean_area_flag = True
            vf.clean_height = vf.frame_height
            vf.clean_width = vf.frame_width
            vf.left_offset = 0
            vf.top_offset = 0
        if not _unset_or(fmt.color_spec, base.color_spec):
            vf.custom_color_spec_flag = True
            vf.color_spec = int(fmt.color_spec)
        if fmt.color_spec == int(CS.CS_CUSTOM):
            if fmt.color_primaries != base.color_primaries:
                vf.custom_color_primaries_flag = True
                vf.color_primaries = fmt.color_primaries
            if fmt.color_matrix != base.color_matrix:
                vf.custom_color_matrix_flag = True
                vf.color_matrix = fmt.color_matrix
            if fmt.transfer_function != base.transfer_function:
                vf.custom_transfer_function_flag = True
                vf.transfer_function = fmt.transfer_function
    return vf


def write_video_format(w: BitWriter, vf: VideoFormat) -> None:
    """Reference operator<<(ostream&, const video_format&)
    DataUnit.cpp:786-881."""
    w.unbounded()
    for v in (vf.major_version, vf.minor_version, vf.profile, vf.level,
              vf.base_video_format):
        w.put_uvlc(v)
    w.put_bool(vf.custom_dimensions_flag)
    if vf.custom_dimensions_flag:
        w.put_uvlc(vf.frame_width)
        w.put_uvlc(vf.frame_height)
    w.put_bool(vf.custom_color_diff_format_flag)
    if vf.custom_color_diff_format_flag:
        w.put_uvlc(vf.color_diff_format)
    w.put_bool(vf.custom_scan_format_flag)
    if vf.custom_scan_format_flag:
        w.put_uvlc(vf.source_sampling)
    w.put_bool(vf.custom_frame_rate_flag)
    if vf.custom_frame_rate_flag:
        w.put_uvlc(vf.frame_rate)
        if vf.frame_rate == 0:
            w.put_uvlc(vf.frame_rate_numer)
            w.put_uvlc(vf.frame_rate_denom)
    w.put_bool(vf.custom_pixel_aspect_ratio_flag)
    if vf.custom_pixel_aspect_ratio_flag:
        w.put_uvlc(vf.pixel_aspect_ratio)
        if vf.pixel_aspect_ratio == 0:
            w.put_uvlc(vf.pixel_aspect_ratio_numer)
            w.put_uvlc(vf.pixel_aspect_ratio_denom)
    w.put_bool(vf.custom_clean_area_flag)
    if vf.custom_clean_area_flag:
        for v in (vf.clean_width, vf.clean_height, vf.left_offset,
                  vf.top_offset):
            w.put_uvlc(v)
    w.put_bool(vf.custom_signal_range_flag)
    if vf.custom_signal_range_flag:
        w.put_uvlc(vf.bitdepth)
        if vf.bitdepth == 0:
            for v in (vf.luma_offset, vf.luma_excursion, vf.color_diff_offset,
                      vf.color_diff_excursion):
                w.put_uvlc(v)
    w.put_bool(vf.custom_color_spec_flag)
    if vf.custom_color_spec_flag:
        w.put_uvlc(vf.color_spec)
        if vf.color_spec == int(CS.CS_CUSTOM):
            w.put_bool(vf.custom_color_primaries_flag)
            if vf.custom_color_primaries_flag:
                w.put_uvlc(vf.color_primaries)
            w.put_bool(vf.custom_color_matrix_flag)
            if vf.custom_color_matrix_flag:
                w.put_uvlc(vf.color_matrix)
            w.put_bool(vf.custom_transfer_function_flag)
            if vf.custom_transfer_function_flag:
                w.put_uvlc(vf.transfer_function)
    # picture coding mode, reusing source_sampling (reference quirk)
    w.put_uvlc(vf.source_sampling)
    w.align()




# --- data units (the write side of the port's stream/dataunit.py) -----------

PARSE_CODES = {"sequence_header": 0x00, "end_of_sequence": 0x10,
               "ld_picture": 0xC8, "hq_picture": 0xE8}


def parse_info(kind: str, data_size: int | None, prev: int) -> bytes:
    """The 13-byte parse info of a data unit of ``data_size`` bytes after
    it (None: the end of the sequence), ``prev`` the previous unit's
    next-parse offset (reference DataUnit.cpp:80-123)."""
    next_off = 0 if data_size is None else data_size + 13
    return (b"BBCD" + bytes([PARSE_CODES[kind]]) + next_off.to_bytes(4, "big")
            + prev.to_bytes(4, "big"))


def sequence_header_payload(hdr: SequenceHeader) -> bytes:
    """The sequence header's bytes after its parse info."""
    w = BitWriter()
    write_video_format(w, video_format_of(hdr))
    return w.getvalue()


def transform_params(major_version: int, kernel: int, depth: int,
                     slices_x: int, slices_y: int, first: int,
                     second: int) -> bytes:
    """A picture's transform parameters: HQ's (slice prefix, scalar) or
    LD's (slice bytes numerator, denominator) as ``first``, ``second``."""
    w = BitWriter()
    w.unbounded()
    w.put_uvlc(kernel)
    w.put_uvlc(depth)
    if major_version >= 3:
        w.put_bool(False)   # asym_transform_index_flag
        w.put_bool(False)   # asym_transform_flag
    w.put_uvlc(slices_x)
    w.put_uvlc(slices_y)
    w.put_uvlc(first)
    w.put_uvlc(second)
    w.put_bool(False)       # custom quant matrix
    w.align()
    return w.getvalue()


def picture_unit(kind: str, number: int, params: bytes, payload: bytes,
                 prev: int) -> bytes:
    """One whole picture data unit: parse info, picture number, transform
    parameters, slices."""
    size = 4 + len(params) + len(payload)
    return (parse_info(kind, size, prev) + number.to_bytes(4, "big") + params
            + payload)
