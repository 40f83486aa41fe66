"""LD picture encode on the device: planar samples -> slice payload.

Port of the device route of ``vc2tpu.pipeline.ld.LDEncoder``
(``_analyse_dev_impl``), the picture loop of the reference encoder's LD
mode (src/EncodeStream/EncodeStream.cpp:195-245 and 452-770):

    upload (the samples at their read width into a pinned staging slot,
       one non-blocking H2D; ``pipeline.encoder.upload_picture``)
    -> bands.forward_lanes (one launch a level of csrc/band_lift.cu: the
       forward DWT in the band layout, the subbands stored into the lanes)
    -> ld_rate_control (one launch of csrc/ld_rate.cu: the q indices and
       the LL lanes quantised with DC prediction stay on the device)
    -> quant_pack_ld (one launch of csrc/ld_pack.cu: the body lanes
       quantised at max(q - qm, 0) in its load, the LL lanes from the rate
       control, each slice at its fixed byte offset)
    -> one D2H of the [flags | payload] buffer, the picture's one
       synchronisation

The slices' byte budgets are the picture's bytes spread over the slices
(``layout.slice_bytes_map``; a field has half the frame's bytes).
``decode_inprocess`` serves the DECODED/PSNR outputs: the LL band's
DC-prediction inverse on the host (``slices.ld.dequantise_ll``), then the
decoder's ``dequantise_ld_planes`` and ``inverse_planes``, as the JAX
package's ``ld_dequantise_picture`` does.

With a ``mesh`` the analysis DWT runs over the mesh's row bands (the
halo forward lift of ``shard.halo``, one csrc/lift_level.cu launch a
level a device, then ``planes_to_lanes``), as the JAX package's
``--mesh`` route does; where the padded rows do not divide into bands of
whole ``2**depth`` rows it analyses on one device and says so once. The
rate control's wavefront couples every slice, so it and the pack run
once a picture on the mesh's first device.

The JAX package's host and auto routes and its int16 fetch are not
ported: they answered the TPU's link.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.config import EncoderConfig, Mode, PictureGeometry
from vc2tpu_torch.core.picture import Picture
from vc2tpu_torch.pipeline.decoder import dequantise_ld_planes
from vc2tpu_torch.pipeline.encoder import (EncodedPicture, Staging,
                                           lanes_to_planes, planes_to_lanes,
                                           slice_geometry, upload_picture)
from vc2tpu_torch.pipeline.sharded import upload_blocks
from vc2tpu_torch.rdo import ld as rdo_ld
from vc2tpu_torch.shard import halo
from vc2tpu_torch.shard.mesh import from_spec
from vc2tpu_torch.slices import layout
from vc2tpu_torch.slices import ld as slices_ld
from vc2tpu_torch.vlc import device_pack
from vc2tpu_torch.wavelet import bands, lifting, matrices


class LDEncoder:
    """LD picture encoder on ``device`` (default: the card), or with its
    analysis over ``mesh`` (a ``shard.mesh.Mesh``, or a ``"DxS"`` spec for
    ``shard.mesh.from_spec``), the rest on the mesh's first device."""

    def __init__(self, cfg: EncoderConfig, device=None, mesh=None):
        cfg.validate()
        if cfg.mode != Mode.LD:
            raise ValueError(f"LDEncoder encodes Mode.LD, not {cfg.mode.value}"
                             "; use pipeline.encoder.Encoder")
        if mesh is not None:
            mesh = from_spec(mesh, device)
        self.mesh = mesh
        self._mesh_inert_logged = False
        self.device = dev = (mesh.first if mesh is not None
                             else devices.resolve(device))
        self.cfg = cfg
        self.geo = geo = slice_geometry(cfg)
        d = cfg.wavelet_depth
        ts = 1 << d
        self.qmatrix = matrices.quant_matrix(cfg.kernel, d)
        self.qm_block_y = slices_ld.qm_block(*geo.luma_slice, d, self.qmatrix)
        self.qm_block_c = slices_ld.qm_block(*geo.chroma_slice, d,
                                             self.qmatrix)
        self.band_sizes_y, self.band_sizes_c = (
            bands.band_sizes(*sl, d) for sl in (geo.luma_slice,
                                                geo.chroma_slice))
        self.ll_y = (geo.luma_slice[0] // ts, geo.luma_slice[1] // ts)
        self.ll_c = (geo.chroma_slice[0] // ts, geo.chroma_slice[1] // ts)
        # a field is half the frame's bytes (vc2tpu/pipeline/ld.py:61-64)
        self.picture_bytes = (cfg.compressed_bytes // 2 if cfg.interlaced
                              else cfg.compressed_bytes)
        self.slice_budgets = layout.slice_bytes_map(
            geo.y_slices, geo.x_slices, self.picture_bytes, 1)
        budgets = self.slice_budgets.ravel().astype(np.int64)
        self.avail = rdo_ld.avail_bits(budgets)
        self.len_bits = slices_ld.len_bits_of(budgets)
        self.payload_bytes = int(budgets.sum())
        # the constants, on the device once
        self.qm = tuple(torch.as_tensor(rdo_ld.lane_qm(self.qmatrix, bs),
                                        device=dev)
                        for bs in (self.band_sizes_y, self.band_sizes_c))
        self.sizes = torch.as_tensor(budgets.astype(np.int32), device=dev)
        self.starts = torch.as_tensor(np.cumsum(budgets) - budgets,
                                      device=dev)
        self.avail_device = torch.as_tensor(self.avail, device=dev)
        self.staging = Staging()

    def analyse(self, picture: Picture) -> list:
        """The picture's transform lanes (y, u, v) on the device: over the
        mesh's row bands where they divide, else ``bands.forward_lanes``
        on the one device."""
        cfg, d = self.cfg, self.cfg.wavelet_depth
        if self.mesh is not None:
            planes = self._analyse_mesh(picture)
            if planes is not None:
                return planes_to_lanes(planes, self.geo, d)
        planes = upload_picture(picture, cfg.bytes_per_sample, self.device,
                                self.staging)
        return bands.forward_lanes(planes, cfg.kernel, d, self.geo)

    def _analyse_mesh(self, picture: Picture):
        """The halo forward lift over the ``space`` bands of the mesh's
        first row, gathered on its first device; None (said once on stderr,
        as the JAX package says it) when a padded plane's rows do not
        divide into bands of whole ``2**depth`` rows."""
        cfg, geo, d = self.cfg, self.geo, self.cfg.wavelet_depth
        n = self.mesh.shape["space"]
        ts = 1 << d
        pads = (geo.padded_luma, geo.padded_chroma, geo.padded_chroma)
        for rows, _w in pads:
            if rows % n or (rows // n) % ts:
                if not self._mesh_inert_logged:
                    self._mesh_inert_logged = True
                    print(f"--mesh: LD plane of {rows} rows does not divide "
                          f"over {n} shards in units of {ts}; analysing "
                          "single-chip", file=sys.stderr)
                return None
        for rows, _w in pads:
            halo.check_rows(rows, n, cfg.kernel, d)
        geos = [halo.band_rows(rows, n, halo.margin(cfg.kernel, d))
                for rows, _w in pads]
        blocks = upload_blocks(picture, cfg.bytes_per_sample,
                               self.mesh.row(0), geos, pads)
        bands = halo.forward_blocks(blocks, geos, cfg.kernel, d)
        return [torch.cat([t.to(self.device) for t in b]) for b in bands]

    def rate_control(self, tlanes):
        """The q indices and LL lanes of a picture's transform lanes, on the
        device (one launch, not synchronised)."""
        geo = self.geo
        return rdo_ld.ld_rate_control(
            *tlanes, self.qmatrix, self.band_sizes_y, self.band_sizes_c,
            self.avail_device, (geo.y_slices, geo.x_slices), self.ll_y,
            self.ll_c)

    def pack(self, tlanes, q_idx, ll, keep_lanes: bool = False):
        """The [flags | payload] buffer of a picture (one launch, not
        synchronised), and its quantised lanes when ``keep_lanes``."""
        return device_pack.quant_pack_ld(
            *tlanes, ll, q_idx, *self.qm, self.sizes, self.starts,
            self.payload_bytes, keep_lanes=keep_lanes)

    def encode_picture(self, picture: Picture,
                       keep_planes: bool = False) -> EncodedPicture:
        """Encode one picture (a frame, or a field when interlaced). With
        ``keep_planes`` the result also holds the transform, the quantised
        planes and lanes on the device, for the tap outputs."""
        geo, d = self.geo, self.cfg.wavelet_depth
        tlanes = self.analyse(picture)
        q_idx, *ll = self.rate_control(tlanes)
        buf, lanes = self.pack(tlanes, q_idx, ll, keep_planes)
        flags, payload = device_pack.ld_result(buf.cpu().numpy())
        if flags & device_pack.FLAG_LD_FIT:
            raise ValueError(
                "SliceIO, LD mode: Too many bytes for the U and V slices")
        out = EncodedPicture(
            q_device=q_idx, slices=(geo.y_slices, geo.x_slices),
            payload=payload.tobytes(), slice_totals=self.slice_budgets.ravel())
        if keep_planes:
            out.transform = Picture(*lanes_to_planes(tlanes, geo, d),
                                    picture.chroma_format)
            out.quantised = Picture(*lanes_to_planes(lanes, geo, d),
                                    picture.chroma_format)
            out.lanes = tuple(lanes)
        return out

    def decode_inprocess(self, enc: EncodedPicture,
                         geometry: PictureGeometry) -> Picture:
        """Inverse-quantise and inverse-transform a ``keep_planes`` encode,
        as the encoder's DECODED/PSNR outputs do (EncodeStream.cpp:
        649-664): the LL band of each quantised plane (its ``[::2^depth,
        ::2^depth]`` sub-lattice) through the DC-prediction inverse on the
        host (native; its Python twin for a CPU encoder), the rest as the
        decoder dequantises. Returns int32 NumPy planes cropped to
        ``geometry``."""
        cfg, geo, d = self.cfg, self.geo, self.cfg.wavelet_depth
        ts = 1 << d
        q = enc.q_indices.ravel()
        inverse = (slices_ld.dequantise_ll_plain
                   if self.device.type == "cpu" else slices_ld.dequantise_ll)
        grids = []
        for plane, sl, qm_blk in zip(
                (enc.quantised.y, enc.quantised.c1, enc.quantised.c2),
                (geo.luma_slice, geo.chroma_slice, geo.chroma_slice),
                (self.qm_block_y, self.qm_block_c, self.qm_block_c)):
            codes = plane[::ts, ::ts].cpu().numpy()
            grids.append(torch.as_tensor(
                inverse(codes, geo.y_slices, geo.x_slices, ts, *sl, qm_blk, q),
                device=self.device))
        planes = dequantise_ld_planes(enc.lanes, enc.q_device, grids,
                                      self.qmatrix, d, geo)
        y, c1, c2 = lifting.inverse_planes(planes, cfg.kernel, d)
        g = geometry
        return Picture(
            y[:g.luma_height, :g.luma_width].cpu().numpy(),
            c1[:g.chroma_height, :g.chroma_width].cpu().numpy(),
            c2[:g.chroma_height, :g.chroma_width].cpu().numpy(),
            cfg.chroma_format)
