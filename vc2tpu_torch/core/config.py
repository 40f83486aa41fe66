"""Configuration model: the wire enums and picture geometry.

Enum integer values follow the VC-2 wire format / reference enums:
* WaveletKernel — reference src/Library/WaveletTransform.h:26
* ColourFormat  — reference src/Library/Picture.h:17
* FrameRate / PixelAspectRatio / ColorSpec / Profile —
  reference src/Library/DataUnit.h:97-103
"""

from __future__ import annotations

import dataclasses
import enum


class WaveletKernel(enum.IntEnum):
    DD97 = 0
    LeGall = 1
    DD137 = 2
    Haar0 = 3
    Haar1 = 4
    Fidelity = 5
    Daub97 = 6
    NullKernel = 7

    @staticmethod
    def parse(text: str) -> "WaveletKernel":
        try:
            return WaveletKernel[text]
        except KeyError:
            raise ValueError(f"invalid wavelet kernel: {text!r}")


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


class Mode(enum.Enum):
    HQ_CBR = "HQ_CBR"
    HQ_ConstQ = "HQ_ConstQ"
    LD = "LD"


class EncOutput(enum.Enum):
    TRANSFORM = "Transform"
    QUANTISED = "Quantised"
    INDICES = "Indices"
    PACKAGED = "Packaged"
    STREAM = "Stream"
    DECODED = "Decoded"
    PSNR = "PSNR"


class DecOutput(enum.Enum):
    TRANSFORM = "Transform"
    QUANTISED = "Quantised"
    INDICES = "Indices"
    DECODED = "Decoded"


def chroma_dims(height: int, width: int, fmt: ColourFormat) -> tuple[int, int]:
    """Chroma plane geometry (reference src/Library/src/Picture.cpp:49-73)."""
    if fmt == ColourFormat.CF444:
        return height, width
    if fmt == ColourFormat.CF422:
        return height, width // 2
    if fmt == ColourFormat.CF420:
        return height // 2, width // 2
    raise ValueError("invalid colour format")


@dataclasses.dataclass(frozen=True)
class PictureGeometry:
    """Static geometry of one coded picture (frame or field)."""

    luma_height: int
    luma_width: int
    chroma_height: int
    chroma_width: int
    chroma_format: ColourFormat

    @staticmethod
    def of(height: int, width: int, fmt: ColourFormat) -> "PictureGeometry":
        ch, cw = chroma_dims(height, width, fmt)
        return PictureGeometry(height, width, ch, cw, fmt)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Mirror of the reference encoder CLI parameter matrix
    (reference src/EncodeStream/EncodeParams.cpp:139-204)."""

    height: int
    width: int
    chroma_format: ColourFormat
    kernel: WaveletKernel
    wavelet_depth: int
    y_size: int                       # vertical slice size, units of 2**depth
    x_size: int                       # horizontal slice size, units of 2**depth
    mode: Mode = Mode.HQ_ConstQ
    bytes_per_sample: int = 2
    luma_depth: int = 16
    chroma_depth: int = 16
    interlaced: bool = False
    top_field_first: bool = True
    frame_rate: FrameRate = FrameRate.FR25
    slice_scalar: int = 1             # HQ modes only
    slice_prefix: int = 0             # HQ modes only
    fragment_length: int = 0          # HQ_CBR / LD, 0 = no fragments
    compressed_bytes: int = 0         # HQ_CBR / LD
    q_index: int = 0                  # HQ_ConstQ

    def validate(self) -> None:
        if self.height < 1:
            raise ValueError("picture height must be > 0")
        if self.width < 1:
            raise ValueError("picture width must be > 0")
        if not (1 <= self.bytes_per_sample <= 4):
            raise ValueError("bytes must be in range 1 to 4")
        for name, d in (("luma", self.luma_depth),
                        ("chroma", self.chroma_depth)):
            if not (1 <= d <= 8 * self.bytes_per_sample):
                raise ValueError(f"{name} bit depth must be in range 1 to "
                                 "8*(bytes per sample)")
        if self.kernel == WaveletKernel.NullKernel:
            raise ValueError("invalid wavelet kernel")
        if self.wavelet_depth < 1:
            raise ValueError("wavelet depth must be 1 or more")
        if self.mode in (Mode.HQ_CBR, Mode.HQ_ConstQ):
            if self.slice_scalar < 1:
                raise ValueError("slice scalar must be >=1")
            if self.slice_prefix < 0:
                raise ValueError("slice prefix must be >=0")
        if self.mode in (Mode.HQ_CBR, Mode.LD) and self.compressed_bytes < 1:
            raise ValueError("number of compressed bytes must be >0")
        if self.mode == Mode.HQ_ConstQ and not (0 <= self.q_index <= 119):
            raise ValueError("quantisation index must be in the range 0 to "
                             "119")

    @property
    def geometry(self) -> PictureGeometry:
        return PictureGeometry.of(self.height, self.width, self.chroma_format)
