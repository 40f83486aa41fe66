"""HQ and LD picture decode on the device: payload bytes -> planar output
bytes.

Ports of ``vc2tpu.pipeline.decoder.synthesise_payload_to_words`` and
``synthesise_ld_payload_to_words``, covering the HQ picture tail of the
reference decoder (src/DecodeStream/DecodeStream.cpp:451-609):

    upload (one H2D of the payload, one of the slice fields)
    -> component offsets -> unpack kernel       (``unpack_payload``)
    -> bands.inverse_lanes: dequantise + inverse DWT in the band layout
       (one launch a level of csrc/band_lift.cu, dequantising the lanes
       in its load)
    -> crop -> clip, offset, MSB-justify, big-endian bytes (uint8)

and its LD picture tail (:289-450), after the host's header walk
(``slices.ld.ld_fields``: the q indices and bit fields):

    upload (one H2D each of the payload and the fields)
    -> LD unpack kernel                          (``unpack_ld_payload``)
    -> the LL grids dequantised with DC prediction from the lanes
       (``quant.ld_dc``, csrc/ld_dc.cu)
    -> bands.inverse_lanes with the LL grids as band 0
    -> crop and format, as for HQ

That is the JAX package's band route (``_lanes_words_tail``: scale_banded,
lanes_to_bands, inverse_bands). The JAX package keeps its in-place route
(``_synthesis_fn``) for its taps, ``DecodeFrame`` and the encoder's
in-process decode, and so does this port: ``dequantise_planes`` /
``dequantise_ld_planes`` (dequantise, ``lanes_to_plane``, the LD grids
into the LL sub-lattice) then ``lifting.inverse_planes`` (one
csrc/lift_level.cu launch a level) serve the decoder's TRANSFORM and
QUANTISED outputs, ``cli.decode_frame``, ``Encoder.decode_inprocess``
and the LD mesh decode whose slice rows do not divide over the mesh
(``shard.halo``'s in-place lift); ``pipeline.sharded`` runs the band
route a band at a time, an LD picture's lanes and LL grids coming from
``unpack_ld_payload`` on the mesh's first device. The stages are
separate functions, each a span of ``core.trace`` (``dec.upload``,
``dec.unpack``, ``dec.ld_dc``, ``dec.inverse``, ``dec.format``) that a
profiler's trace
shows; the caller makes the one D2H copy of the returned bytes.

Each picture decode is its host half, the upload (``upload_rows`` of the
payload and the slice fields, ``hq_field_rows`` / ``ld_field_rows``),
then its device half (``hq_words`` / ``ld_words``), which reads nothing
from the host and does not synchronise: the decode CLI captures that
half in a CUDA graph (``pipeline.replay``). The cached device tables
the kernels read by address come from ``core.capture.device_cache``
functions, so a capture holds the ones it read.
"""

from __future__ import annotations

import numpy as np
import torch

from vc2tpu_torch.core import capture
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core import trace
from vc2tpu_torch.core.config import PictureGeometry, WaveletKernel
from vc2tpu_torch.core.planario import SampleFormat, encode_plane
from vc2tpu_torch.quant import ld_dc
from vc2tpu_torch.quant.quantiser import adjust_quant_index, scale
from vc2tpu_torch.slices import layout
from vc2tpu_torch.slices.hq import SliceGeometry
from vc2tpu_torch.slices.ld import LDScan
from vc2tpu_torch.vlc import device_unpack
from vc2tpu_torch.wavelet import bands


def _make_fmt(bitdepth: int):
    """Output-sample formatter: clip to the signal range, then the wire
    form (offset binary, uint8 for 8-bit video, else MSB-justified
    big-endian 16-bit words), as flat uint8 bytes on the device."""
    fmt = SampleFormat(word_width=1 if bitdepth == 8 else 2,
                       bit_depth=bitdepth)

    def run(p: torch.Tensor) -> torch.Tensor:
        return encode_plane(torch.clamp(p, -fmt.zero, fmt.zero - 1), fmt)

    return run


def hq_field_rows(q_indices, cbytes) -> np.ndarray:
    """An HQ picture's slice fields as ``upload`` sends them: int32 [4, N],
    the q indices, then the chain scan's three component byte lengths."""
    return np.concatenate([np.asarray(q_indices)[None],
                           np.asarray(cbytes)]).astype(np.int32)


def ld_field_rows(scan: LDScan) -> np.ndarray:
    """An LD picture's slice fields as ``upload_ld`` sends them: int32
    [5, N], q, s_bits, len_bits, y_bits, uv_bits."""
    return np.concatenate([scan.q[None], scan.fields]).astype(np.int32)


def upload_rows(payload: np.ndarray, fields: np.ndarray,
                device: torch.device, into: tuple | None = None) -> tuple:
    """A picture's host data to the device, one copy each: its payload
    bytes (uint8 [P]) and its slice fields (int32 [R, N]). Into ``into``,
    a (payload, fields) pair of device tensors of those shapes, where
    given; else into new tensors. Returns the pair."""
    with trace.span("dec.upload"):
        pay = torch.from_numpy(np.array(payload, dtype=np.uint8, copy=True))
        rows = torch.from_numpy(fields)
        if into is None:
            return pay.to(device), rows.to(device)
        into[0].copy_(pay)
        into[1].copy_(rows)
        return into


def upload(payload: np.ndarray, q_indices, cbytes, device: torch.device):
    """The picture's host data to the device: payload bytes (uint8 [P]) and
    the chain scan's fields as int32 [4, N] (``hq_field_rows``), one copy
    each."""
    return upload_rows(payload, hq_field_rows(q_indices, cbytes), device)


@capture.device_cache(maxsize=64)
def qm_lanes(qmatrix_key: tuple, slice_h: int, slice_w: int, depth: int,
              device: torch.device) -> torch.Tensor:
    """Quant matrix entry of every lane of a slice block, int64 [L]."""
    _, band = layout.lane_order(slice_h, slice_w, depth)
    qm = np.asarray(qmatrix_key, np.int64)[band]
    return torch.as_tensor(qm, device=device)


def dequantise_planes(lanes, q_idx: torch.Tensor, qmatrix: np.ndarray,
                      depth: int, geo: SliceGeometry):
    """(qy, qu, qv) lanes -> dequantised transform planes, in-place layout:
    ``scale`` at each lane's adjusted quant index, then ``lanes_to_plane``."""
    key = tuple(int(v) for v in qmatrix)
    planes = []
    for comp, lanes_c in enumerate(lanes):
        sh, sw = geo.luma_slice if comp == 0 else geo.chroma_slice
        qm = qm_lanes(key, sh, sw, depth, lanes_c.device)
        aq = adjust_quant_index(q_idx.to(torch.int64)[:, None], qm[None, :])
        planes.append(layout.lanes_to_plane(scale(lanes_c, aq), geo.y_slices,
                                            geo.x_slices, sh, sw, depth))
    return planes


def format_planes(planes, out_geometry: PictureGeometry,
                  bitdepth: int) -> torch.Tensor:
    """Crop each synthesised plane to the picture and format it; returns the
    frame's (or field's) output bytes, uint8 on the device."""
    fmt = _make_fmt(bitdepth)
    g = out_geometry
    y, c1, c2 = planes
    with trace.span("dec.format"):
        return torch.cat([fmt(y[:g.luma_height, :g.luma_width]),
                          fmt(c1[:g.chroma_height, :g.chroma_width]),
                          fmt(c2[:g.chroma_height, :g.chroma_width])])


def unpack_payload(payload: np.ndarray, q_indices, cbytes,
                   geo: SliceGeometry, prefix: int, start: int = 0,
                   device=None):
    """The unpack half of a picture's decode: upload, component offsets
    and the unpack kernel. Returns ((y, u, v) int32 lanes, q indices int32
    [N]) on ``device`` (default the card), without synchronising; the
    arguments are ``synthesise_payload_to_words``'s."""
    pay, fields = upload(payload, q_indices, cbytes, devices.resolve(device))
    return _unpack_hq(pay, fields, geo, prefix, start)


def _unpack_hq(pay: torch.Tensor, fields: torch.Tensor, geo: SliceGeometry,
               prefix: int, start: int):
    with trace.span("dec.unpack"):
        clen = fields[1:]
        dstart = device_unpack.hq_component_offsets(clen, prefix, start)
        ly = geo.luma_slice[0] * geo.luma_slice[1]
        lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        return device_unpack.unpack_hq(pay, dstart, clen, ly, lc), fields[0]


def synthesise_payload_to_words(payload: np.ndarray, q_indices, cbytes,
                                qmatrix, kernel: WaveletKernel, depth: int,
                                geo: SliceGeometry,
                                out_geometry: PictureGeometry, bitdepth: int,
                                prefix: int, start: int = 0,
                                device=None) -> torch.Tensor:
    """Full device decode of one HQ picture from its compressed payload.
    ``payload`` is the data unit's bytes; ``start`` the byte offset of the
    first slice; ``q_indices``/``cbytes`` come from the host chain scan.
    Returns the output bytes as a uint8 tensor on ``device`` (default the
    card), without synchronising."""
    pay, fields = upload(payload, q_indices, cbytes, devices.resolve(device))
    return hq_words(pay, fields, qmatrix, kernel, depth, geo, out_geometry,
                    bitdepth, prefix, start)


def hq_words(pay: torch.Tensor, fields: torch.Tensor, qmatrix,
             kernel: WaveletKernel, depth: int, geo: SliceGeometry,
             out_geometry: PictureGeometry, bitdepth: int, prefix: int,
             start: int = 0) -> torch.Tensor:
    """The device half of ``synthesise_payload_to_words``, from the
    uploaded payload and fields (``upload``): component offsets, unpack,
    inverse and format, with no host data and no synchronisation."""
    lanes, q_idx = _unpack_hq(pay, fields, geo, prefix, start)
    planes = synthesise_lanes(lanes, q_idx, qmatrix, kernel, depth, geo)
    return format_planes(planes, out_geometry, bitdepth)


def synthesise_lanes(lanes, q_idx: torch.Tensor, qmatrix,
                     kernel: WaveletKernel, depth: int, geo: SliceGeometry,
                     grids=None) -> list:
    """A picture's three padded planes from its (y, u, v) lanes and q
    indices: ``bands.inverse_lanes`` (LD: ``grids`` as band 0). At depth 0
    there is no transform, and the dequantised lanes (LD: the grids) are
    the planes."""
    with trace.span("dec.inverse"):
        if depth == 0:
            if grids is not None:
                return list(grids)
            return dequantise_planes(lanes, q_idx, qmatrix, 0, geo)
        return bands.inverse_lanes(lanes, q_idx, qmatrix, geo, kernel, depth,
                                   grids)


def upload_ld(payload: np.ndarray, scan: LDScan, device: torch.device):
    """An LD picture's host data to the device, one copy each: the payload
    bytes (uint8 [P]) and the scan's fields as int32 [5, N]
    (``ld_field_rows``)."""
    return upload_rows(payload, ld_field_rows(scan), device)


def unpack_ld_payload(payload: np.ndarray, scan: LDScan, geo: SliceGeometry,
                      qmatrix, depth: int, device=None):
    """The unpack half of an LD picture's decode: upload, the LD unpack
    kernel, then the LL grids from its lanes (``quant.ld_dc.ll_grids``,
    span ``dec.ld_dc``; ``scan`` needs only its q indices and fields).
    Returns ((y, u, v) int32 lanes, q indices int32 [N], the three LL
    grids) on ``device`` (default the card), without synchronising."""
    pay, fields = upload_ld(payload, scan, devices.resolve(device))
    return _unpack_ld(pay, fields, geo, qmatrix, depth)


def _unpack_ld(pay: torch.Tensor, fields: torch.Tensor, geo: SliceGeometry,
               qmatrix, depth: int):
    with trace.span("dec.unpack"):
        ly = geo.luma_slice[0] * geo.luma_slice[1]
        lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        lanes = device_unpack.unpack_ld(pay, fields[1:], ly, lc)
    with trace.span("dec.ld_dc"):
        plan = ld_dc.plan(geo, depth, tuple(int(v) for v in qmatrix),
                          fields.device)
        grids = ld_dc.ll_grids(lanes, fields[0], plan)
    return lanes, fields[0], grids


def dequantise_ld_planes(lanes, q_idx: torch.Tensor, grids, qmatrix,
                         depth: int, geo: SliceGeometry):
    """``dequantise_planes``, then every plane's LL samples (the
    ``(::2^depth, ::2^depth)`` sub-lattice, where the reference's
    ``ld_ll_dequantise`` writes them) replaced by the LL grids, which
    carry the DC prediction the lanes lack."""
    planes = dequantise_planes(lanes, q_idx, qmatrix, depth, geo)
    ts = 1 << depth
    for plane, grid in zip(planes, grids):
        plane[::ts, ::ts] = grid
    return planes


def synthesise_ld_payload_to_words(payload: np.ndarray, scan: LDScan,
                                   qmatrix, kernel: WaveletKernel,
                                   depth: int, geo: SliceGeometry,
                                   out_geometry: PictureGeometry,
                                   bitdepth: int, device=None) -> torch.Tensor:
    """Full device decode of one LD picture from its compressed payload and
    its host header walk (``slices.ld.ld_fields``, whose bit offsets index
    ``payload``). Returns the output bytes as a uint8 tensor on ``device``
    (default the card), without synchronising."""
    pay, fields = upload_ld(payload, scan, devices.resolve(device))
    return ld_words(pay, fields, qmatrix, kernel, depth, geo, out_geometry,
                    bitdepth)


def ld_words(pay: torch.Tensor, fields: torch.Tensor, qmatrix,
             kernel: WaveletKernel, depth: int, geo: SliceGeometry,
             out_geometry: PictureGeometry, bitdepth: int) -> torch.Tensor:
    """The device half of ``synthesise_ld_payload_to_words``, from the
    uploaded payload and fields (``upload_ld``): unpack, LL grids, inverse
    and format, with no host data and no synchronisation."""
    lanes, q_idx, grids = _unpack_ld(pay, fields, geo, qmatrix, depth)
    planes = synthesise_lanes(lanes, q_idx, qmatrix, kernel, depth, geo,
                              grids)
    return format_planes(planes, out_geometry, bitdepth)

