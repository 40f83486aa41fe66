"""DecodeStream-compatible CLI: VC-2 stream -> planar file, on the card.

Data-unit dispatch loop mirroring the reference decoder
(src/DecodeStream/DecodeStream.cpp:205-981): resync, sequence-header state,
HQ and LD pictures and fragments (reassembled into pictures), aux/padding
skip, interlaced field pairing and signal clip. Each picture decodes on
the device (``pipeline.decoder.synthesise_payload_to_words``, or
``synthesise_ld_payload_to_words`` after the host's LD header walk, the
LL band's DC prediction on the device) for the
DECODED output; the tap outputs write, one picture at a time and with no
field pairing, the q indices (INDICES), the unpacked lanes in transform
layout (QUANTISED; for LD the LL residuals as coded) or the dequantised
transform planes (TRANSFORM; for LD with the DC prediction), as int32
words.

With ``--mesh DxS`` (``Decoder(mesh=...)``) the DECODED output of each
picture decodes over the ``space`` bands of the mesh's first row
(``pipeline.sharded.ShardedDecoder``: the band form of the inverse DWT,
one ``band_inverse`` launch a level, each band keeping its own rows); the
host scans stay whole-picture. An HQ picture's bands each unpack their
block's slices, their own slice rows and a margin of their neighbours', in
one launch. An LD picture unpacks on the mesh's first device, its LL grids
computed there from the lanes (``quant.ld_dc``), and each band takes its
block's rows of the lanes and the grids. Where a picture's slice rows do
not divide over the bands it takes the single-device route on the mesh's
first device, and says so once, as the JAX package does; an LD picture
then still takes the in-place halo inverse lift
(``shard.halo.sharded_inverse_planes``) where its padded rows divide.
``ld_card_dc`` counts the LD pictures whose LL grids the decode device
computed: every one.
The tap outputs always take the single-device route.

On one card, a progressive picture's DECODED output is one replay of a
CUDA graph once its key has repeated (``pipeline.replay``: the route,
geometry, coding parameters and the payload's exact length): the first
picture of a key decodes eagerly, the second is captured and replayed,
and the later ones replay, each after the upload of its payload and
slice fields into the graph's inputs. ``graph_captures`` and
``graph_replays`` count them. The mesh route, the taps, interlaced
fields and the CPU always decode eagerly.

The DECODED output leaves the card through a ring of pinned host slots:
when a picture's bytes are queued in the output FIFO their D2H starts at
once, on a copy stream of the decoder's own; when the FIFO hands the
picture on, the host waits for that copy's event (long complete, as a
rule) and copies the slot once into a fresh buffer, which the sink gets
as a ``memoryview``, so the slot is free for the next picture. On the CPU
the sink gets a view of the decoded bytes themselves.

Under a torch profiler the picture decode is traced (``core.trace``): the
host scan (``dec.scan``), the device work's issue (``dec.issue``, around
the stages of ``pipeline.decoder``, or around the upload and a graph's
``dec.replay``), an output's wait in the FIFO
(``dec.fifo``), the wait for its copy back (``dec.copy_back``) and its
copy out of the slot (``dec.to_bytes``), each with the picture number.

An LD picture's bytes come from its preamble's slice_bytes fraction with
no second halving when interlaced: the JAX package's deliberate deviation
from the reference decoder (``vc2tpu/cli/decode_stream.py``,
``tests/test_golden.py::test_ld_interlaced_reference_defect``).

Errors: a corrupt or short stream raises ValueError, which the stream loop
answers by growing its window and then skipping the picture or fragment;
a header that would give no slices or divide by zero is such an error.
Unlike the JAX package, whose fragment path turns any exception into a
skipped picture, a kernel or CUDA error propagates here, for fragments as
for pictures, and the CLI exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import sys

import numpy as np
import torch

from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core import trace
from vc2tpu_torch.core.config import DecOutput, PictureGeometry, chroma_dims
from vc2tpu_torch.core.picture import Picture
from vc2tpu_torch.core.planario import SampleFormat, write_picture
from vc2tpu_torch.pipeline import replay
from vc2tpu_torch.pipeline.decoder import (dequantise_ld_planes,
                                           dequantise_planes, format_planes,
                                           hq_field_rows, hq_words,
                                           ld_field_rows, ld_words,
                                           synthesise_ld_payload_to_words,
                                           synthesise_payload_to_words,
                                           unpack_ld_payload, unpack_payload)
from vc2tpu_torch.pipeline.sharded import ShardedDecoder
from vc2tpu_torch.shard import halo
from vc2tpu_torch.shard.mesh import from_spec
from vc2tpu_torch.slices import layout
from vc2tpu_torch.slices.hq import SliceGeometry, scan_hq_slice_offsets
# ld_scan is not called here: the benchmark's decode.host_scan_ms wraps
# this module's name until that metric is retired
from vc2tpu_torch.slices.ld import LDScan, ld_fields, ld_scan  # noqa: F401
from vc2tpu_torch.stream.dataunit import DataUnitType, StreamReader
from vc2tpu_torch.wavelet import lifting, matrices


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vc2tpu-torch-decode",
        description="Decodes a VC-2 stream to an uncompressed planar file "
                    "on a CUDA device")
    p.add_argument("inFile")
    p.add_argument("outFile")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-o", "--output", default="Decoded",
                   choices=[o.value for o in DecOutput])
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default: cuda)")
    p.add_argument("--mesh", metavar="DxS", default=None,
                   help="decode on a DxS device mesh (row bands over the S "
                        "axis): the band form of the inverse DWT over each "
                        "band's block of slices; bit-exact with one device")
    return p


@dataclasses.dataclass
class LocatedPicture:
    """One picture located by the host: everything the device decode
    needs. HQ: the chain scan's q indices and component byte lengths
    (``synthesise_payload_to_words`` arguments); LD: the header walk
    (``ld``, for ``synthesise_ld_payload_to_words``)."""

    picnum: int
    pre: object
    geo: SliceGeometry
    pic_h: int
    payload: np.ndarray
    start: int
    q_idx: np.ndarray
    cbytes: np.ndarray | None = None
    ld: LDScan | None = None
    dstart: np.ndarray | None = None


@dataclasses.dataclass
class _FragState:
    """Per-picture fragment reassembly (reference FragmentedPictureData,
    DecodeStream.cpp:62-101)."""

    preamble: object
    payload_parts: dict            # first slice index -> bytes
    slices_decoded: int = 0


class _FragmentDecodeError(ValueError):
    """The fragment unit was complete but the assembled picture is corrupt:
    growing the read window cannot fix that, so the stream loop skips the
    picture instead of retrying."""


class Decoder:
    """Stateful stream decoder usable as a library (the CLI drives it)."""

    def __init__(self, output: DecOutput = DecOutput.DECODED, verbose=False,
                 sink=None, device=None, mesh=None):
        # mesh: "DxS" or a Mesh (shard.mesh.from_spec), built here so a
        # misconfigured mesh fails before any picture
        if mesh is not None:
            mesh = from_spec(mesh, device)
        self.mesh = mesh
        self._sdec_cache: dict = {}
        self._mesh_inert_logged = False
        self.device = (mesh.first if mesh is not None
                       else devices.resolve(device))
        self.output = output
        self.verbose = verbose
        self.sink = sink
        self.hdr = None
        self._major_version = 0
        self.pic = 0
        self.frame = 0
        self.frags: dict[int, _FragState] = {}
        self.frames_out = 0
        # output bytes in flight: (pinned slot, the CUDA event behind its
        # D2H, picture number, trace.stamp()); on the CPU (words, None, ...)
        self._pending: list[tuple] = []
        self._depth = 3               # pictures in flight before blocking
        self._slots: list[torch.Tensor] = []    # pinned slots free to fill
        self._copy_streams: dict = {}           # device -> D2H stream
        # the copy back's counts: pictures through the ring, pinned slots
        # allocated, and copy backs not yet complete when the FIFO took them
        self.copy_back_ring = 0
        self.copy_back_slots = 0
        self.copy_back_waited = 0
        # LD pictures whose LL grids the decode device computed from the
        # lanes (quant.ld_dc)
        self.ld_card_dc = 0
        # the single-device picture decode's graphs (pipeline.replay)
        self._graphs = replay.PictureGraphs()
        self._first_words = None      # formatted first field (interlace)
        self._first_picnum = None     # picture number of the buffered field
        self._field_parity = None     # picnum parity of FIRST fields
        self._cur_picnum = 0          # picture number being decoded

    def log(self, msg):
        if self.verbose:
            print(msg, file=sys.stderr)

    # --- pipelined output: a frame's D2H starts when it is queued, and the
    # host takes it only once later frames are queued on the device; byte
    # order is kept by the FIFO ---

    def _copy_back_async(self, words: torch.Tensor) -> tuple:
        """Start the copy of one output's bytes to the host. On a card, a
        DMA into a free pinned slot of ``words``' size (a new slot where
        none of that size is free: with the FIFO's ``_depth`` outputs at
        most, the ring never holds more slots), on the decoder's copy
        stream of ``words.device`` behind the work queued on its current
        stream; returns (slot, the event recorded behind the copy). On the
        CPU, (``words``, None)."""
        if words.device.type != "cuda":
            return words, None
        self._slots = [s for s in self._slots
                       if s.shape == words.shape and s.dtype == words.dtype]
        if self._slots:
            slot = self._slots.pop()
        else:
            slot = torch.empty(words.shape, dtype=words.dtype,
                               pin_memory=True)
            self.copy_back_slots += 1
        dev = words.device
        stream = self._copy_streams.get(dev)
        if stream is None:
            stream = self._copy_streams[dev] = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            slot.copy_(words, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        words.record_stream(stream)
        self.copy_back_ring += 1
        return slot, done

    def _flush(self, keep: int = 0):
        while len(self._pending) > keep:
            src, done, picnum, queued = self._pending.pop(0)
            trace.wait("dec.fifo", picnum, queued)
            with trace.span("dec.copy_back", picnum):
                if done is not None and not done.query():
                    self.copy_back_waited += 1
                    done.synchronize()
            with trace.span("dec.to_bytes", picnum):
                if done is None:
                    out = src.contiguous()
                else:
                    # the sink may keep what it gets: never hand it a slot
                    out = torch.empty(src.shape, dtype=src.dtype)
                    out.copy_(src)
                    self._slots.append(src)
                data = memoryview(out.numpy())
            self.sink.write(data)
            self.frames_out += 1

    @property
    def graph_captures(self) -> int:
        """Picture decodes captured in a CUDA graph."""
        return self._graphs.captures

    @property
    def graph_replays(self) -> int:
        """Pictures decoded by a replay of a captured graph."""
        return self._graphs.replays

    def _emit_words(self, words: torch.Tensor):
        """``words`` are the output bytes of one progressive frame or one
        field, on the device. Returns the event behind the copy back that
        reads them (None on the CPU, or for a first field, which is held
        to pair with the second)."""
        hdr = self.hdr
        if hdr.interlace:
            # Field pairing is by picture number, not arrival order: losing
            # one field (corrupt or missing) must not pair every later frame
            # from mismatched fields. First fields carry the parity of the
            # first field seen in the stream; a buffered first field is only
            # paired with picture number first+1 (mod 2^32).
            picnum = self._cur_picnum
            if (self.pic == 1
                    and picnum != ((self._first_picnum + 1) & 0xFFFFFFFF)):
                self.log(f"Dropping stale first field {self._first_picnum} "
                         f"(next decoded picture is {picnum})")
                self.pic = 0
                self._first_words = None
            if self.pic == 0:
                if self._field_parity is None:
                    self._field_parity = picnum & 1
                if (picnum & 1) != self._field_parity:
                    self.log(f"Dropping second field {picnum} whose first "
                             "field was not decoded")
                    return None
                self._first_words = words
                self._first_picnum = picnum
                self.pic = 1
                return None
            self.pic = 0
            first, second = self._first_words, words
            self._first_words = None
            top, bottom = ((first, second) if hdr.top_field_first
                           else (second, first))
            # interleave field rows as opaque wire elements, on the device
            elem = 1 if hdr.bitdepth == 8 else 2
            g = PictureGeometry.of(hdr.height // 2, hdr.width,
                                   hdr.chroma_format)
            parts = []
            off = 0
            for h, w in ((g.luma_height, g.luma_width),
                         (g.chroma_height, g.chroma_width),
                         (g.chroma_height, g.chroma_width)):
                n = h * w * elem
                t = top[off:off + n].reshape(h, w * elem)
                b = bottom[off:off + n].reshape(h, w * elem)
                parts.append(torch.stack([t, b], dim=1).reshape(-1))
                off += n
            words = torch.cat(parts)
        self._flush(keep=self._depth - 1)
        slot, done = self._copy_back_async(words)
        self._pending.append((slot, done, self._cur_picnum, trace.stamp()))
        self.frame += 1
        return done

    # --- picture decode ---

    def locate_picture(self, window, hq: bool):
        """Parse the picture data unit at the head of ``window`` (13-byte
        parse_info included) on the host: picture number, preamble and the
        slice chain. Returns (consumed bytes, LocatedPicture or None). A
        window too short for the picture raises ValueError, which the stream
        loop answers by growing the window."""
        rd = StreamReader(bytes(window))
        rd.major_version = self._major_version
        rd.r.seek(13)
        picnum = rd.read_picture_number()
        pre = rd.read_preamble(hq)
        if self.hdr is None:
            self.log("Cannot decode frame, no previous sequence header!")
            return rd.r.byte_pos, None
        return self._locate(picnum, pre, rd.data, rd.r.byte_pos, hq)

    def _locate(self, picnum: int, pre, data: bytes, start: int, hq: bool,
                whole: bool = True):
        """(end of the slices, LocatedPicture) of a picture whose slices
        begin at byte ``start`` of ``data``. ValueError when they run past
        the end of ``data`` (an LD picture is checked only when ``whole``:
        an assembled fragmented one reads 1-bits past its end, as the JAX
        package's does), or when the header's geometry is corrupt."""
        hdr = self.hdr
        depth = pre.depth
        pic_h = hdr.height // 2 if hdr.interlace else hdr.height
        padded_h = matrices.padded_size(pic_h, depth)
        padded_w = matrices.padded_size(hdr.width, depth)
        pch, pcw = chroma_dims(padded_h, padded_w, hdr.chroma_format)
        ys, xs = pre.slices_y, pre.slices_x
        geo = SliceGeometry(ys, xs, (padded_h, padded_w), (pch, pcw),
                            (padded_h // ys, padded_w // xs),
                            (pch // ys, pcw // xs))
        if self.mesh is not None and self.output == DecOutput.DECODED:
            self._check_mesh(pre, geo, hq)
        if hq:
            with trace.span("dec.scan", picnum):
                q_idx, dstart, cbytes, end = scan_hq_slice_offsets(
                    data, geo.n_slices, pre.slice_prefix,
                    pre.slice_size_scalar, start)
            # the data up to the slice chain's end: all the device needs
            payload = np.frombuffer(data, dtype=np.uint8, count=end)
            return end, LocatedPicture(picnum, pre, geo, pic_h, payload,
                                       start, q_idx, cbytes, dstart=dstart)
        ts = 1 << depth
        if any(d % ts for d in (*geo.luma_slice, *geo.chroma_slice)):
            raise ValueError("LD slices do not hold whole LL blocks")
        # this picture's bytes, with no second halving when interlaced
        picture_bytes = (pre.slice_bytes_numerator * geo.n_slices
                         // pre.slice_bytes_denominator)
        sizes = layout.slice_bytes_map(ys, xs, picture_bytes, 1).ravel()
        end = start + int(sizes.sum())
        if whole and end > len(data):
            raise ValueError("LD slice payload runs past the window")
        with trace.span("dec.scan", picnum):
            scan = ld_fields(data, sizes, geo, depth, start)
        payload = np.frombuffer(data, dtype=np.uint8,
                                count=min(end, len(data)))
        return end, LocatedPicture(picnum, pre, geo, pic_h, payload, start,
                                   scan.q, ld=scan)

    def _decode_picture(self, job: LocatedPicture):
        """Device decode of a located picture into the output; errors
        propagate."""
        hdr = self.hdr
        pre = job.pre
        qmatrix = matrices.quant_matrix(pre.wavelet_kernel, pre.depth)
        if self.output != DecOutput.DECODED:
            if self.mesh is not None and self.output == DecOutput.TRANSFORM:
                self._say_once("--mesh: no sharded path for output mode "
                               f"{self.output.value}; decoding single-chip")
            self._write_tap(job, qmatrix)
            return
        out_geom = PictureGeometry.of(job.pic_h, hdr.width, hdr.chroma_format)
        with trace.span("dec.issue", job.picnum):
            planes = None if self.mesh is None else self._mesh_planes(
                job, qmatrix)
            if planes is not None:
                words = format_planes(planes, out_geom, hdr.bitdepth)
            else:
                words = self._single_device(job, qmatrix, out_geom)
        self._cur_picnum = job.picnum
        self._graphs.read(words, self._emit_words(words))

    def _single_device(self, job: LocatedPicture, qmatrix,
                       out_geom: PictureGeometry) -> torch.Tensor:
        """A located picture's output bytes on the decode device: one
        replay of a CUDA graph where the picture may replay
        (``replay.eligible``) and its key has repeated, else the library's
        decode, ``synthesise_payload_to_words`` or
        ``synthesise_ld_payload_to_words``."""
        hdr, pre, ld = self.hdr, job.pre, job.ld
        args = (qmatrix, pre.wavelet_kernel, pre.depth, job.geo, out_geom,
                hdr.bitdepth)
        if ld is not None:
            self.ld_card_dc += 1
        if not replay.eligible(self.device, self.mesh, self.output,
                               hdr.interlace):
            if ld is not None:
                return synthesise_ld_payload_to_words(
                    job.payload, ld, *args, device=self.device)
            return synthesise_payload_to_words(
                job.payload, job.q_idx, job.cbytes, *args, pre.slice_prefix,
                start=job.start, device=self.device)
        if ld is not None:
            words, fields = ld_words, ld_field_rows(ld)
        else:
            words, fields = hq_words, hq_field_rows(job.q_idx, job.cbytes)
            args += (pre.slice_prefix, job.start)
        key = (ld is None, self.device, job.geo, pre.depth,
               int(pre.wavelet_kernel), tuple(int(v) for v in qmatrix),
               hdr.bitdepth, out_geom, pre.slice_prefix, job.start,
               job.payload.size)
        return self._graphs.run(key, words, args, job.payload, fields,
                                self.device)

    # --- the mesh route (--mesh) ---

    def _say_once(self, msg: str):
        if not self._mesh_inert_logged:
            self._mesh_inert_logged = True
            print(msg, file=sys.stderr)

    def _sharded_decoder(self, pre, geo):
        """The ShardedDecoder of this picture geometry (cached), or None
        when its slice rows do not divide over the mesh's ``space`` axis
        (the single-device route, said once a geometry)."""
        key = (pre.wavelet_kernel, pre.depth, geo)
        if key not in self._sdec_cache:
            space = self.mesh.shape["space"]
            sdec = None
            if geo.y_slices % space == 0:
                sdec = ShardedDecoder(pre.wavelet_kernel, pre.depth, geo,
                                      self.mesh)
            else:
                print(f"mesh decode: {geo.y_slices} slice rows do not divide "
                      f"over {space} shards; using the single-chip route",
                      file=sys.stderr)
            self._sdec_cache[key] = sdec
        return self._sdec_cache[key]

    def sharded_decoders(self) -> list:
        """The ShardedDecoders the mesh route has used, one a picture
        geometry, in first use."""
        return [s for s in self._sdec_cache.values() if s is not None]

    def _indivisible(self, geo, depth: int) -> int:
        """The rows of the first padded plane that does not cut into
        bands of whole ``2**depth`` rows over the mesh, else 0."""
        n, ts = self.mesh.shape["space"], 1 << depth
        return next((rows for rows in (geo.padded_luma[0],
                                       geo.padded_chroma[0])
                     if rows % n or (rows // n) % ts), 0)

    def _check_mesh(self, pre, geo, hq: bool):
        """Raise, on the host and before any device work, the ValueError
        the mesh route would meet (bands thinner than the JAX package's
        halo), so the stream loop skips the picture as the JAX package's
        decoder does."""
        if self._sharded_decoder(pre, geo) is None and (
                hq or self._indivisible(geo, pre.depth)):
            return                  # the single-device route
        for rows in (geo.padded_luma[0], geo.padded_chroma[0]):
            halo.check_rows(rows, self.mesh.shape["space"],
                            pre.wavelet_kernel, pre.depth)

    def _mesh_planes(self, job: LocatedPicture, qmatrix):
        """A located picture's synthesised padded planes over the mesh, on
        its first device; None where the picture takes the single-device
        route."""
        pre, geo = job.pre, job.geo
        sdec = self._sharded_decoder(pre, geo)
        if job.ld is None:
            return None if sdec is None else sdec.decode_payload_device(
                job.payload, job.q_idx, job.dstart, job.cbytes)
        # an LD picture unpacks on one device, its LL grids from the lanes
        lanes, q_idx, grids = self._unpack_ld(job, qmatrix)
        if sdec is not None:
            return sdec.synthesise(q_idx, *lanes, grids=grids)
        # slice rows that do not divide: the halo inverse where the padded
        # planes divide
        planes = dequantise_ld_planes(lanes, q_idx, grids, qmatrix,
                                      pre.depth, geo)
        rows = self._indivisible(geo, pre.depth)
        if rows:
            self._say_once(f"--mesh: LD plane of {rows} rows does not "
                           f"divide over {self.mesh.shape['space']} shards "
                           f"in units of {1 << pre.depth}; decoding "
                           "single-chip")
            return lifting.inverse_planes(planes, pre.wavelet_kernel,
                                          pre.depth)
        return halo.sharded_inverse_planes(planes, self.mesh,
                                           pre.wavelet_kernel, pre.depth)

    def _unpack_ld(self, job: LocatedPicture, qmatrix):
        """``unpack_ld_payload`` of a located LD picture on the decode
        device: its lanes, q indices and LL grids."""
        self.ld_card_dc += 1
        return unpack_ld_payload(job.payload, job.ld, job.geo, qmatrix,
                                 job.pre.depth, device=self.device)

    def _write_tap(self, job: LocatedPicture, qmatrix):
        """One picture's INDICES, QUANTISED or TRANSFORM output
        (DecodeStream.cpp's taps; the JAX package's ``_finish_picture``):
        the q indices as bytes, or int32 words of the lanes in transform
        layout, raw or dequantised (uncropped; an LD picture's LL band
        with its DC prediction)."""
        if self.output == DecOutput.INDICES:
            self.sink.write(np.asarray(job.q_idx).astype(np.uint8).tobytes())
            return
        pre, geo = job.pre, job.geo
        if job.ld is not None:
            lanes, q_idx, grids = self._unpack_ld(job, qmatrix)
        else:
            lanes, q_idx = unpack_payload(job.payload, job.q_idx, job.cbytes,
                                          geo, pre.slice_prefix,
                                          start=job.start, device=self.device)
        if self.output == DecOutput.TRANSFORM and job.ld is not None:
            planes = dequantise_ld_planes(lanes, q_idx, grids, qmatrix,
                                          pre.depth, geo)
        elif self.output == DecOutput.TRANSFORM:
            planes = dequantise_planes(lanes, q_idx, qmatrix, pre.depth, geo)
        else:
            planes = [layout.lanes_to_plane(
                lanes_c, geo.y_slices, geo.x_slices,
                *(geo.luma_slice if c == 0 else geo.chroma_slice), pre.depth)
                for c, lanes_c in enumerate(lanes)]
        write_picture(self.sink, Picture(*planes, self.hdr.chroma_format),
                      SampleFormat(word_width=4, offset=False))

    def _handle_fragment(self, rd: StreamReader, hq: bool):
        """The HQ or LD fragment data unit at the head of ``rd`` (its
        parse_info read). Returns (consumed bytes, LocatedPicture or None): the
        picture once its last slices arrive. ValueError when the window is
        too short; _FragmentDecodeError when the assembled picture is
        corrupt."""
        picnum = rd.read_picture_number()
        frag = rd.read_fragment_header()
        if frag.n_slices == 0:
            pre = rd.read_preamble(hq)
            if self.hdr is None:
                self.log("Cannot decode frame, no previous sequence header!")
                return rd.r.byte_pos, None
            self.frags[picnum] = _FragState(preamble=pre, payload_parts={})
            return rd.r.byte_pos, None
        body = rd.r.get_raw(frag.data_length)
        if len(body) < frag.data_length:
            raise ValueError("truncated fragment body")
        st = self.frags.get(picnum)
        if st is None:
            self.log("Cannot decode slices as no picture header yet read "
                     f"for picture number {picnum}")
            return rd.r.byte_pos, None
        first = (frag.slice_offset_y * st.preamble.slices_x
                 + frag.slice_offset_x)
        # idempotent under the stream loop's grow-and-retry (and under
        # duplicate fragments): a span already seen must not count twice
        if first not in st.payload_parts:
            st.slices_decoded += frag.n_slices
        st.payload_parts[first] = body
        if st.slices_decoded < st.preamble.slices_x * st.preamble.slices_y:
            return rd.r.byte_pos, None
        # complete: drop the reassembly state first, so a corrupt picture
        # leaves none behind and is not retried with a bigger window
        del self.frags[picnum]
        payload = b"".join(p for _, p in sorted(st.payload_parts.items()))
        try:
            _end, job = self._locate(picnum, st.preamble, payload, 0, hq,
                                     whole=False)
        except ValueError as exc:
            raise _FragmentDecodeError(exc) from exc
        return rd.r.byte_pos, job

    # --- data unit handlers ---

    def run(self, data: bytes) -> int:
        """Decode a complete in-memory stream (library entry)."""
        return self.run_stream(io.BytesIO(data))

    def run_stream(self, fp, chunk_bytes: int = 1 << 20) -> int:
        """Incremental decode from a binary file object: memory stays
        O(largest data unit) (a rolling window slides over the input),
        matching the reference's istream loop
        (src/DecodeStream/DecodeStream.cpp:205)."""
        window = bytearray()
        eof = False

        def fill(n=None) -> bool:
            """Grow the window to >= n bytes (or by one chunk). Returns
            False if EOF prevented reaching the target."""
            nonlocal eof
            while not eof and (n is None or len(window) < n):
                b = fp.read(chunk_bytes if n is None
                            else max(chunk_bytes, n - len(window)))
                if not b:
                    eof = True
                else:
                    window.extend(b)
                if n is None:
                    break
            return n is None or len(window) >= n

        def resync() -> bool:
            """Drop bytes until the window starts at a parse_info prefix."""
            while True:
                i = window.find(b"BBCD")
                if i >= 0:
                    del window[:i]
                    return True
                # keep a 3-byte tail (possible partial prefix)
                if len(window) > 3:
                    del window[:-3]
                if eof:
                    return False
                fill()

        def consume(n: int):
            del window[:n]

        def skip(n: int):
            """Discard n bytes of input WITHOUT buffering them (aux/padding
            bodies and corrupt-picture skips can be arbitrarily large)."""
            nonlocal eof
            have = min(n, len(window))
            consume(have)
            left = n - have
            while left > 0 and not eof:
                b = fp.read(min(chunk_bytes, left))
                if not b:
                    eof = True
                    break
                left -= len(b)

        first = True
        while True:
            fill(13)
            if len(window) < 13:
                if not eof:
                    continue
                self._flush()
                self.log("End of data stream reached successfully, exiting.")
                return 0
            rd = StreamReader(bytes(window[:13]))
            rd.major_version = self._major_version
            try:
                du_type, next_off, _prev = rd.read_data_unit()
            except ValueError as exc:
                if not first:
                    # corrupt parse_info: re-lock onto the next 'BBCD'
                    print(f"Bad parse info ({exc}); resynchronising",
                          file=sys.stderr)
                consume(1)
                if not resync():
                    self._flush()
                    return 0
                continue
            first = False
            self.log(f"Have read data unit of type: {du_type.value}")
            # pull the declared unit body into the window; cap the prefetch
            # so a corrupt next_parse_offset cannot force an unbounded buffer
            if 13 <= next_off < (1 << 30):
                fill(min(next_off, 64 << 20))
            if du_type == DataUnitType.SEQUENCE_HEADER:
                fill(min(max(next_off, 4096), 1 << 20))
                rd = StreamReader(bytes(window))
                rd.r.seek(13)
                try:
                    self.hdr = rd.read_sequence_header()
                    self._major_version = rd.major_version
                except ValueError as exc:
                    print(f"Bad sequence header ({exc}); resynchronising",
                          file=sys.stderr)
                    consume(1)
                    if not resync():
                        self._flush()
                        return 0
                    continue
                consume(rd.r.byte_pos)
            elif du_type == DataUnitType.END_OF_SEQUENCE:
                self.log(f"End of Sequence after {self.frame} frames")
                consume(13)
            elif du_type in (DataUnitType.AUXILIARY_DATA,
                             DataUnitType.PADDING_DATA):
                if next_off - 13 < 0:
                    raise ValueError("data length is less than zero.")
                skip(next_off)
            elif du_type in (DataUnitType.HQ_PICTURE, DataUnitType.LD_PICTURE):
                hq = du_type == DataUnitType.HQ_PICTURE
                end, job = None, None
                grow_cap = min(max(next_off, 0), 64 << 20) + (64 << 20)
                while True:
                    try:
                        end, job = self.locate_picture(window, hq)
                        break
                    except ValueError as exc:
                        # only a window too short for the slice chain (or a
                        # corrupt picture header) lands here: grow the
                        # window and retry, up to a 64 MB margin, before
                        # declaring the picture corrupt. Device errors are
                        # not caught: they are raised by _decode_picture,
                        # outside this loop.
                        before = len(window)
                        if not eof and before < grow_cap:
                            fill(min(before + 8 * chunk_bytes, grow_cap))
                        if len(window) > before:
                            continue
                        print(f"Failed to read {'HQ' if hq else 'LD'} "
                              f"compressed frame ({exc})", file=sys.stderr)
                        # drop any buffered first field: a lost second field
                        # must not pair later fields off-by-one
                        self.pic = 0
                        self._first_words = None
                        break
                if job is not None:
                    self._decode_picture(job)
                if end is not None:
                    consume(end)
                elif next_off >= 13:
                    skip(next_off)
                else:
                    consume(1)
                    if not resync():
                        self._flush()
                        return 0
            elif du_type in (DataUnitType.HQ_FRAGMENT,
                             DataUnitType.LD_FRAGMENT):
                fill(max(min(next_off, 64 << 20), 13 + 4 + 8))
                grow_cap = min(max(next_off, 0), 64 << 20) + (64 << 20)
                job = None
                while True:
                    # the window itself, not a copy a fragment: what the
                    # fragment keeps is the slice of its body, copied out
                    # before the window is consumed
                    rd = StreamReader(window)
                    rd.major_version = self._major_version
                    rd.r.seek(13)
                    try:
                        end, job = self._handle_fragment(
                            rd, du_type == DataUnitType.HQ_FRAGMENT)
                        consume(min(end, len(window)))
                        break
                    except _FragmentDecodeError as exc:
                        # a bigger window cannot help: skip, and drop any
                        # buffered first field (as a failed picture does)
                        print(f"Failed to decode fragmented picture ({exc})",
                              file=sys.stderr)
                        self.pic = 0
                        self._first_words = None
                        skip(next_off if next_off >= 13 else 13)
                        break
                    except ValueError as exc:
                        # a fragment body may run past a zero or lying
                        # next_parse_offset: grow the window and retry (as
                        # the picture path does) before skipping it
                        before = len(window)
                        if not eof and before < grow_cap:
                            fill(min(before + 8 * chunk_bytes, grow_cap))
                        if len(window) > before:
                            continue
                        print(f"Failed to read fragment ({exc})",
                              file=sys.stderr)
                        skip(next_off if next_off >= 13 else 13)
                        break
                if job is not None:
                    self._decode_picture(job)     # device errors propagate
            else:
                consume(13)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # incremental input: memory stays O(one data unit) regardless of stream
    # length (reference DecodeStream.cpp:205 istream loop)
    fp = sys.stdin.buffer if args.inFile == "-" else open(args.inFile, "rb")
    sink = sys.stdout.buffer if args.outFile == "-" else open(args.outFile, "wb")
    try:
        dec = Decoder(output=DecOutput(args.output), verbose=args.verbose,
                      sink=sink, device=args.device, mesh=args.mesh)
        rc = dec.run_stream(fp)
    except Exception as exc:
        print(f"Error: {exc}", file=sys.stderr)
        return 1
    finally:
        if args.outFile != "-":
            sink.close()
    return rc


if __name__ == "__main__":
    sys.exit(main())
