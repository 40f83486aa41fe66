"""HQ picture encode on the device: planar samples -> slice payload.

Port of ``vc2tpu.pipeline.encoder.Encoder`` for ``Mode.HQ_ConstQ`` and
``Mode.HQ_CBR``, covering the picture loop of the reference encoder
(src/EncodeStream/EncodeStream.cpp:452-770):

    upload (the samples at their read width into a pinned staging slot,
       one non-blocking H2D; ``upload_picture``)
    -> bands.forward_lanes: wavelet_pad, forward DWT in the band layout
       and the lanes in serialisation order (one launch a level of
       csrc/band_lift.cu, reading the int16 samples and storing the
       subbands straight into the lanes)
    -> HQ CBR only: cbr_quant_indices (the rate control, one launch; the
       q indices stay on the device)
    -> quant_pack_hq_queued (quant at each lane's adjusted index, fused
       into the pack's one launch), then a non-blocking D2H of its status
       (flags, payload size) into pinned memory behind a CUDA event
    -> the handle: one blocking wait (the event), the flags checked, then
       one D2H of exactly the [totals | payload] bytes used, on a side
       stream so it does not wait for a picture dispatched since

``Encoder.encode_picture_async`` queues everything up to the handle
without synchronising, so the caller can read the next picture while the
card works (the encode CLI keeps one picture in flight);
``encode_picture`` is the same encode resolved at once. The stages are
separate functions so a profiler can time each.
``quantise`` is the quantiser on its own, for the tests. The forward
transform is the JAX package's band route (``Encoder._analyse_impl``:
forward_bands, bands_to_lanes); the TRANSFORM tap's planes are the lanes
in transform layout (``layout.lanes_to_plane``), as the JAX package builds
them with ``bands_to_inplace``. The in-place route (``analyse``:
``forward_planes``, one csrc/lift_level.cu launch a level, then
``planes_to_lanes``) stays as the band route's yardstick.
``Encoder.decode_inprocess`` serves the DECODED/PSNR taps through the
decoder's ``dequantise_planes`` and ``inverse_planes``, as the JAX
package's in-process decode does.

LD pictures are encoded by ``pipeline.ld.LDEncoder``, which shares the
upload, the forward transform and the lane layout with this module.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch

from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.config import EncoderConfig, Mode, PictureGeometry
from vc2tpu_torch.core.picture import Picture
from vc2tpu_torch.pipeline.decoder import dequantise_planes, qm_lanes
from vc2tpu_torch.quant.quantiser import adjust_quant_index, quant
from vc2tpu_torch.rdo import cbr
from vc2tpu_torch.slices import layout
from vc2tpu_torch.slices.hq import SliceGeometry
from vc2tpu_torch.vlc import device_pack
from vc2tpu_torch.wavelet import bands, lifting, matrices

def _print_slice_suggestions(cfg: EncoderConfig, luma_h: int,
                             chroma_h: int) -> None:
    """Parameter hints on a slice-geometry failure, as the reference prints
    them (EncodeStream.cpp:383-399): nearby --hSlice/--vSlice values at the
    requested depth when a transform at that depth is possible, else the
    nearest workable --waveletDepth and matching slice sizes."""
    g = cfg.geometry
    d = cfg.wavelet_depth
    try:
        if (matrices.wavelet_transform_is_possible(d, g.luma_width,
                                                   g.chroma_width)
                and matrices.wavelet_transform_is_possible(d, luma_h,
                                                           chroma_h)):
            a = matrices.suggest_slice_size(d, g.luma_width, g.chroma_width,
                                            cfg.x_size)
            u = matrices.suggest_slice_size(d, luma_h, chroma_h, cfg.y_size)
            print(f"Consider setting --hSlice (-a) to {a} and --vSlice (-u) "
                  f"to {u}.", file=sys.stderr)
        else:
            sd = matrices.suggest_wavelet_depth(g.luma_width, luma_h,
                                                g.chroma_width, chroma_h, d)
            a = matrices.suggest_slice_size(sd, g.luma_width, g.chroma_width,
                                            cfg.x_size)
            u = matrices.suggest_slice_size(sd, luma_h, chroma_h, cfg.y_size)
            print(f"It is not possible to encode this input with a wavelet "
                  f"depth of {d}.", file=sys.stderr)
            print(f"Consider setting --waveletDepth (-d) to {sd} and "
                  f"--hSlice (-a) to {a} and --vSlice (-u) to {u}.",
                  file=sys.stderr)
    except ValueError:
        pass                      # no workable parameters exist to suggest


def slice_geometry(cfg: EncoderConfig) -> SliceGeometry:
    """The slice grid of one coded picture (a field when interlaced)."""
    g = cfg.geometry
    luma_h = g.luma_height // 2 if cfg.interlaced else g.luma_height
    chroma_h = g.chroma_height // 2 if cfg.interlaced else g.chroma_height
    y_slices = matrices.slice_size_is_valid(cfg.wavelet_depth, luma_h,
                                            chroma_h, cfg.y_size)
    x_slices = matrices.slice_size_is_valid(cfg.wavelet_depth, g.luma_width,
                                            g.chroma_width, cfg.x_size)
    if not y_slices or not x_slices:
        _print_slice_suggestions(cfg, luma_h, chroma_h)
        raise ValueError(
            "The given waveletDepth, hSlice, and vSlice parameters cannot "
            "encode this input. See above for suggested parameters.")
    pl = (matrices.padded_size(luma_h, cfg.wavelet_depth),
          matrices.padded_size(g.luma_width, cfg.wavelet_depth))
    pc = (matrices.padded_size(chroma_h, cfg.wavelet_depth),
          matrices.padded_size(g.chroma_width, cfg.wavelet_depth))
    return SliceGeometry(y_slices, x_slices, pl, pc,
                         (pl[0] // y_slices, pl[1] // x_slices),
                         (pc[0] // y_slices, pc[1] // x_slices))


@dataclasses.dataclass
class EncodedPicture:
    q_device: torch.Tensor           # int32 [N] q indices, on the device
    slices: tuple                    # (ySlices, xSlices)
    payload: bytes                   # the picture's slice payload
    slice_totals: np.ndarray         # int32 per-slice bytes, raster order
    transform: Picture | None = None  # in-place transform planes (device)
    quantised: Picture | None = None  # quantised planes, transform layout
    lanes: tuple | None = None        # quantised lanes (qy, qu, qv)

    @functools.cached_property
    def q_indices(self) -> np.ndarray:
        """int32 [ySlices, xSlices] on the host, copied from the device at
        the first read: only the outputs and statistics that show the q
        indices pay for the copy."""
        return self.q_device.cpu().numpy().reshape(self.slices)


class Staging:
    """A ring of pinned host buffers for the pictures' uploads to a card.
    A slot is filled again only after the CUDA event recorded behind its
    last H2D has completed, so a picture's samples never overwrite those
    of a picture still in flight."""

    def __init__(self, slots: int = 2):
        self.slots = [(None, None)] * slots     # (pinned buffer, event)
        self.turn = 0

    def take(self, n: int, dtype: torch.dtype) -> tuple:
        """(slot, a pinned buffer of ``n`` elements free to fill)."""
        k = self.turn
        self.turn = (k + 1) % len(self.slots)
        buf, event = self.slots[k]
        if event is not None and not event.query():
            event.synchronize()
        if buf is None or buf.dtype != dtype or buf.numel() < n:
            buf = torch.empty(n, dtype=dtype, pin_memory=True)
        self.slots[k] = (buf, None)
        return k, buf[:n]

    def sent(self, k: int, device: torch.device) -> None:
        """Record the event behind slot ``k``'s H2D, queued on
        ``device``'s current stream."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        self.slots[k] = (self.slots[k][0], event)


def upload_picture(picture: Picture, bytes_per_sample: int,
                   device: torch.device, staging: Staging | None = None):
    """The picture's three planes to the device in one copy at their read
    width (int16 for up to 2 bytes a sample, else int32); returns the
    planes at that width, views of the one uploaded buffer. To a card the
    samples go through a pinned slot of ``staging`` (a one-slot ring when
    None) and a non-blocking copy, so the host does not wait for the H2D;
    on the CPU nothing is pinned."""
    dt = torch.int16 if bytes_per_sample <= 2 else torch.int32
    planes = [np.asarray(p) for p in (picture.y, picture.c1, picture.c2)]
    n = sum(p.size for p in planes)
    device = torch.device(device)
    if device.type == "cuda":
        staging = staging or Staging(1)
        slot, host = staging.take(n, dt)
    else:
        host = torch.empty(n, dtype=dt)
    at, view = 0, host.numpy()
    for p in planes:
        np.copyto(view[at:at + p.size].reshape(p.shape), p, casting="unsafe")
        at += p.size
    flat = host.to(device, non_blocking=True)
    if device.type == "cuda":
        staging.sent(slot, flat.device)
    out, at = [], 0
    for p in planes:
        h, w = p.shape
        out.append(flat[at:at + h * w].reshape(h, w))
        at += h * w
    return out


def fetch_async(t: torch.Tensor):
    """A zero-argument function that returns ``t`` on the host: a card's
    tensor is copied into pinned memory without blocking, behind a CUDA
    event that the function waits on (the caller's one blocking wait)."""
    if t.device.type != "cuda":
        return lambda: t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))

    def wait() -> torch.Tensor:
        event.synchronize()
        return host
    return wait


def fetch_ready(t: torch.Tensor, stream=None) -> np.ndarray:
    """``t``, whose producers have completed, on the host as a NumPy
    array. On a card it is copied into pinned memory on ``stream``, a side
    stream, so the copy does not wait behind the work queued on the
    tensor's stream since (the next picture's, in the encode pipeline)."""
    if stream is None:
        return t.cpu().numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
    stream.synchronize()
    return host.numpy()


def analyse(planes, kernel, depth: int) -> list:
    """Pad each plane (int16 or int32) to a multiple of 2**depth and take
    its forward DWT, in-place transform layout, int32."""
    padded = [lifting.wavelet_pad(p, depth).contiguous() for p in planes]
    return lifting.forward_planes(padded, kernel, depth)


def planes_to_lanes(planes, geo: SliceGeometry, depth: int) -> list:
    return [layout.plane_to_lanes(p, geo.y_slices, geo.x_slices, depth)
            for p in planes]


def lanes_to_planes(lanes, geo: SliceGeometry, depth: int) -> list:
    """(y, u, v) lanes in transform layout: the tap outputs' planes."""
    return [layout.lanes_to_plane(
        t, geo.y_slices, geo.x_slices,
        *(geo.luma_slice if c == 0 else geo.chroma_slice), depth)
        for c, t in enumerate(lanes)]


def quantise(lanes, q_idx: torch.Tensor, qmatrix: np.ndarray, depth: int,
             geo: SliceGeometry) -> list:
    """``quant`` of each component's lanes at each lane's adjusted index
    max(qIndex - qMatrix[band], 0)."""
    key = tuple(int(v) for v in qmatrix)
    out = []
    for comp, lanes_c in enumerate(lanes):
        sh, sw = geo.luma_slice if comp == 0 else geo.chroma_slice
        qm = qm_lanes(key, sh, sw, depth, lanes_c.device)
        aq = adjust_quant_index(q_idx.to(torch.int64)[:, None], qm[None, :])
        out.append(quant(lanes_c, aq))
    return out


class Encoder:
    """HQ (ConstQ or CBR) picture encoder on ``device`` (default: the
    card)."""

    def __init__(self, cfg: EncoderConfig, device=None):
        cfg.validate()
        if cfg.mode == Mode.LD:
            raise ValueError("Encoder encodes HQ pictures; LD pictures are "
                             "encoded by pipeline.ld.LDEncoder")
        self.device = devices.resolve(device)
        self.cfg = cfg
        self.geo = slice_geometry(cfg)
        self.qmatrix = matrices.quant_matrix(cfg.kernel, cfg.wavelet_depth)
        key = tuple(int(v) for v in self.qmatrix)
        self.qm = tuple(
            qm_lanes(key, *sl, cfg.wavelet_depth, self.device).to(torch.int32)
            for sl in (self.geo.luma_slice, self.geo.chroma_slice))
        self.budgets = None       # HQ CBR: int32 [N] slice bytes, on device
        if cfg.mode == Mode.HQ_CBR:
            # a field is half the frame's bytes (EncodeStream.cpp:208-215)
            self.picture_bytes = (cfg.compressed_bytes // 2 if cfg.interlaced
                                  else cfg.compressed_bytes)
            budgets = layout.slice_bytes_map(
                self.geo.y_slices, self.geo.x_slices, self.picture_bytes,
                cfg.slice_scalar)
            self.budgets = torch.from_numpy(budgets.ravel().copy()).to(
                self.device)
        self.staging = Staging()
        # the handles' copies of the payload, beside the next picture's work
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    def q_indices(self) -> torch.Tensor:
        return torch.full((self.geo.n_slices,), self.cfg.q_index,
                          dtype=torch.int32, device=self.device)

    def _analyse(self, picture: Picture) -> tuple:
        """Queue the upload, the forward lift and (CBR) the search: the
        transform lanes, the q indices and the pack's scratch (None for
        ConstQ)."""
        cfg, geo = self.cfg, self.geo
        planes = upload_picture(picture, cfg.bytes_per_sample, self.device,
                                self.staging)
        tlanes = bands.forward_lanes(planes, cfg.kernel, cfg.wavelet_depth,
                                     geo)
        if self.budgets is None:
            return tlanes, self.q_indices(), None
        # the search reports an index above 119 in the pack's flags word
        ly, lc = tlanes[0].shape[1], tlanes[1].shape[1]
        scratch = device_pack.pack_scratch(geo.n_slices, ly, lc, self.device)
        q_idx = cbr.cbr_quant_indices(*tlanes, *self.qm, self.budgets,
                                      cfg.slice_scalar, flags=scratch[1:2])
        return tlanes, q_idx, scratch

    def encode_picture_async(self, picture: Picture):
        """Queue the encode of one picture (a frame, or a field when
        interlaced) and return a zero-argument handle that returns its
        ``EncodedPicture``. The dispatch does not synchronise: the upload,
        the lift, the search, the pack and the read of the pack's status
        are queued on the card. The handle makes the picture's one
        blocking wait, raises the reference's error for the pack's flags,
        and copies exactly the [totals | payload] bytes used (on a side
        stream, beside any picture dispatched since); it holds the
        picture's device buffers until it has run."""
        cfg, geo = self.cfg, self.geo
        tlanes, q_idx, scratch = self._analyse(picture)
        buf, status, _ = device_pack.quant_pack_hq_queued(
            *tlanes, q_idx, *self.qm, cfg.slice_prefix, cfg.slice_scalar,
            slice_sizes=self.budgets, scratch=scratch)
        status = fetch_async(status)
        n = geo.n_slices

        def result() -> EncodedPicture:
            flags, total = status().tolist()
            device_pack.check_flags(flags)
            totals, payload = device_pack.split_result(
                fetch_ready(buf[:4 * n + total], self.copy_stream), n)
            return EncodedPicture(
                q_device=q_idx, slices=(geo.y_slices, geo.x_slices),
                payload=payload.tobytes(), slice_totals=totals.copy())
        return result

    def encode_picture(self, picture: Picture,
                       keep_planes: bool = False) -> EncodedPicture:
        """Encode one picture (a frame, or a field when interlaced):
        ``encode_picture_async(picture)()``. With ``keep_planes`` the
        result also holds the transform, the quantised planes and lanes on
        the device, for the tap outputs."""
        if not keep_planes:
            return self.encode_picture_async(picture)()
        cfg, geo, d = self.cfg, self.geo, self.cfg.wavelet_depth
        tlanes, q_idx, scratch = self._analyse(picture)
        buf, flags, lanes = device_pack.quant_pack_hq(
            *tlanes, q_idx, *self.qm, cfg.slice_prefix, cfg.slice_scalar,
            slice_sizes=self.budgets, keep_lanes=True, scratch=scratch)
        device_pack.check_flags(flags)
        totals, payload = device_pack.split_result(buf.cpu().numpy(),
                                                   geo.n_slices)
        return EncodedPicture(
            q_device=q_idx, slices=(geo.y_slices, geo.x_slices),
            payload=payload.tobytes(), slice_totals=totals,
            transform=Picture(*lanes_to_planes(tlanes, geo, d),
                              picture.chroma_format),
            quantised=Picture(*lanes_to_planes(lanes, geo, d),
                              picture.chroma_format),
            lanes=tuple(lanes))

    def decode_inprocess(self, enc: EncodedPicture,
                         geometry: PictureGeometry) -> Picture:
        """Inverse-quantise and inverse-transform the quantised lanes of a
        ``keep_planes`` encode, as the encoder's DECODED/PSNR taps do
        (EncodeStream.cpp:649-664); returns int32 NumPy planes cropped to
        ``geometry``."""
        cfg, d = self.cfg, self.cfg.wavelet_depth
        planes = dequantise_planes(enc.lanes, enc.q_device, self.qmatrix, d,
                                   self.geo)
        y, c1, c2 = lifting.inverse_planes(planes, cfg.kernel, d)
        g = geometry
        return Picture(
            y[:g.luma_height, :g.luma_width].cpu().numpy(),
            c1[:g.chroma_height, :g.chroma_width].cpu().numpy(),
            c2[:g.chroma_height, :g.chroma_width].cpu().numpy(),
            cfg.chroma_format)
