"""Multi-device HQ encode and decode over a (data, space) mesh, to and from
stream bytes.

Port of ``vc2tpu.pipeline.sharded``. Frames go over the ``data`` axis,
row bands of each picture over ``space``; a band is a run of whole slice
rows, so everything after the DWT is local to the band. The DWT is the
band (Mallat) form of ``shard.halo`` (``forward_bands_local``,
``inverse_bands_local``): a band transforms a *block*, its own slice rows
and a margin of whole slice rows of its neighbours (``halo.band_blocks``),
whose rows past the margin are exact, so no row travels between bands:

    encode, a band:  upload of the block's rows of the host picture, at
                     their read width (one copy)
                     -> forward_bands_local: band_forward, one launch a
                        level (the three components in each), straight
                        into the block's lanes; the band keeps its own
                        slices' lanes
                     -> HQ CBR: cbr_quant_indices at the band's share of
                        the slice budgets (one hq_cbr launch)
                     -> quant_pack_hq (one hq_pack launch, its own
                        scratch and flags)
    decode, a band:  HQ: upload of the span of the payload that its
                     block's slices cover (the host chain scan runs once
                     over the picture) -> unpack_hq (one hq_unpack
                     launch); LD: its block's rows of the lanes and of the
                     LL grids, which one ld_unpack and one ld_dc launch
                     made on the first device
                     -> inverse_bands_local: band_inverse, one launch a
                        level, dequantising in its load; the band keeps
                        its own rows -> gathered on the mesh's first device

Bands on one device share its stream; each device is synchronised once a
batch to read every pack's flags and size, and its spans come back in
one copy. In a process of a multi-process mesh (``shard.multihost``) the
encoder works only the positions that process holds; every process has
its rows' whole pictures, so a row split over processes needs no rows of
another. A band's slices are contiguous in raster order, so its payload
is a contiguous span of the picture's: the host concatenates the spans
into ``EncodedPicture``s equal to ``Encoder.encode_picture``'s, or frames
each span as fragments as it lands (``encode_batch_to_fragments``),
byte-identical to ``write_picture`` over the whole payload.

The JAX package's ``w32``/``cap`` buckets, their retry and its host
fallback are not carried over: each pack's buffer holds
``device_pack.payload_capacity`` bytes, as on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from vc2tpu_torch.core.config import EncoderConfig, Mode
from vc2tpu_torch.pipeline.decoder import qm_lanes
from vc2tpu_torch.pipeline.encoder import EncodedPicture, slice_geometry
from vc2tpu_torch.rdo import cbr
from vc2tpu_torch.shard import halo
from vc2tpu_torch.slices import layout
from vc2tpu_torch.slices.hq import SliceGeometry, scan_hq_slice_offsets
from vc2tpu_torch.vlc import device_pack, device_unpack
from vc2tpu_torch.wavelet import matrices


def _pad_block(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Edge replication of a block to (rows, cols), as ``wavelet_pad``."""
    h, w = x.shape
    if (h, w) == (rows, cols):
        return x.contiguous()
    r = torch.arange(rows, device=x.device).clamp(max=h - 1)
    c = torch.arange(cols, device=x.device).clamp(max=w - 1)
    return x.index_select(0, r).index_select(1, c)


def upload_rows(picture, bytes_per_sample: int, devs, geos,
                mine=None) -> list:
    """Each band's rows [a, b) of the picture's three planes (``geos[c][i]``
    = (a, r0, r1, b), clipped to the plane), its three planes in one copy
    to ``devs[i]`` at their read width (int16 for up to 2 bytes a sample).
    Returns ``[c][i]`` 2-D views of that copy; None for a band that
    ``mine[i]`` says another process holds."""
    dt = np.int16 if bytes_per_sample <= 2 else np.int32
    planes = (picture.y, picture.c1, picture.c2)
    out = [[], [], []]
    for i, dev in enumerate(devs):
        if mine is not None and not mine[i]:
            for c in range(3):
                out[c].append(None)
            continue
        parts, shapes = [], []
        for c, p in enumerate(planes):
            a, _r0, _r1, b = geos[c][i]
            rows = np.asarray(p[a:min(b, p.shape[0])])
            parts.append(rows.astype(dt).ravel())
            shapes.append(rows.shape)
        flat = torch.from_numpy(np.concatenate(parts)).to(dev)
        at = 0
        for c, (h, w) in enumerate(shapes):
            out[c].append(flat[at:at + h * w].reshape(h, w))
            at += h * w
    return out


def upload_blocks(picture, bytes_per_sample: int, devs, geos, padded,
                  mine=None) -> list:
    """``upload_rows``, each block then widened to int32 and padded by
    edge replication to rows [a, b) of the padded planes (``padded[c]``,
    their (h, w)): the in-place halo lift's input."""
    rows = upload_rows(picture, bytes_per_sample, devs, geos, mine)
    return [[None if x is None else
             _pad_block(x.to(torch.int32), g[3] - g[0], padded[c][1])
             for x, g in zip(rows[c], geos[c])] for c in range(3)]


class ShardedEncoder:
    """HQ (ConstQ or CBR) encoder over ``mesh``: a batch of pictures (its
    length a multiple of the ``data`` extent, the frames of data row d the
    d-th block) to ``EncodedPicture``s identical to
    ``Encoder.encode_picture``'s. ``y_slices`` must divide by the ``space``
    extent. With a ``rank`` the encoder works the positions that
    ``mesh.owners`` gives that process (``shard.multihost`` drives this):
    a band's block comes from the host picture, so a row split over
    processes exchanges nothing; without one it works every position."""

    def __init__(self, cfg: EncoderConfig, mesh, rank: int | None = None):
        cfg.validate()
        if cfg.mode == Mode.LD:
            raise ValueError("ShardedEncoder encodes HQ pictures; LD pictures "
                             "are encoded by pipeline.ld.LDEncoder(mesh=...)")
        self.cfg = cfg
        self.mesh = mesh
        self.data = mesh.shape["data"]
        self.space = mesh.shape["space"]
        self.geo = geo = slice_geometry(cfg)
        if geo.y_slices % self.space:
            raise ValueError("y_slices must divide by the space mesh extent")
        d = cfg.wavelet_depth
        self.n_loc = geo.n_slices // self.space
        self.qmatrix = matrices.quant_matrix(cfg.kernel, d)
        key = tuple(int(v) for v in self.qmatrix)
        self._qm = {dev: tuple(qm_lanes(key, *sl, d, dev).to(torch.int32)
                               for sl in (geo.luma_slice, geo.chroma_slice))
                    for dev in mesh.distinct()}
        self.padded = (geo.padded_luma, geo.padded_chroma, geo.padded_chroma)
        # each band's block of slice rows, in each component's rows
        self.geos = [[tuple(r * sh for r in blk) for blk in halo.band_blocks(
            geo, self.space, cfg.kernel, d)] for sh in (
            geo.luma_slice[0], geo.chroma_slice[0], geo.chroma_slice[0])]
        self.mine = [[rank is None or o == rank for o in row]
                     for row in mesh.owners]
        self.slice_budgets = None
        self._budgets = {}
        if cfg.mode == Mode.HQ_CBR:
            # a field is half the frame's bytes (EncodeStream.cpp:208-215)
            picture_bytes = (cfg.compressed_bytes // 2 if cfg.interlaced
                             else cfg.compressed_bytes)
            self.slice_budgets = layout.slice_bytes_map(
                geo.y_slices, geo.x_slices, picture_bytes, cfg.slice_scalar)
            flat = self.slice_budgets.ravel()
            n = self.n_loc
            for row in mesh.devices:
                for s, dev in enumerate(row):
                    self._budgets[dev, s] = torch.from_numpy(
                        flat[s * n:(s + 1) * n].copy()).to(dev)
        self.balance = []         # per picture: each band's payload bytes

    def _launch(self, pictures) -> list:
        """Queue the device work of a batch: ``jobs[b][s]`` = (q indices,
        pack buffer, pack status) of picture b's band s, not synchronised;
        None for a band of another process."""
        cfg, geo, d = self.cfg, self.geo, self.cfg.wavelet_depth
        if len(pictures) % self.data:
            raise ValueError(f"a batch of {len(pictures)} pictures does not "
                             f"divide over the data extent {self.data}")
        per = len(pictures) // self.data
        for h, _w in self.padded:
            halo.check_rows(h, self.space, cfg.kernel, d)
        n = self.n_loc
        jobs = []
        for b, pic in enumerate(pictures):
            devs, mine = self.mesh.row(b // per), self.mine[b // per]
            rows = upload_rows(pic, cfg.bytes_per_sample, devs, self.geos,
                               mine)
            row = []
            for s, dev in enumerate(devs):
                if not mine[s]:
                    row.append(None)
                    continue
                lanes = halo.forward_bands_local(
                    [rows[c][s] for c in range(3)], cfg.kernel, d, geo, s,
                    self.space)
                qm_y, qm_c = self._qm[dev]
                budgets = self._budgets.get((dev, s))
                scratch = None
                if budgets is None:
                    q = torch.full((n,), cfg.q_index, dtype=torch.int32,
                                   device=dev)
                else:
                    # the search reports an index above 119 in the pack's
                    # flags word
                    scratch = device_pack.pack_scratch(
                        n, lanes[0].shape[1], lanes[1].shape[1], dev)
                    q = cbr.cbr_quant_indices(*lanes, qm_y, qm_c, budgets,
                                              cfg.slice_scalar,
                                              flags=scratch[1:2])
                buf, status, _ = device_pack.quant_pack_hq_queued(
                    *lanes, q, qm_y, qm_c, cfg.slice_prefix,
                    cfg.slice_scalar, slice_sizes=budgets, scratch=scratch)
                row.append((q, buf, status))
            jobs.append(row)
        return jobs

    def _statuses(self, jobs, check: bool = True) -> dict:
        """(flags, payload size) of every band of this process, read with
        one synchronisation a device; with ``check``, raises the
        reference's error for the first band (in picture, then band order)
        with a flag set."""
        by_dev: dict = {}
        for b, row in enumerate(jobs):
            for s, job in enumerate(row):
                if job is not None:
                    by_dev.setdefault(job[2].device, []).append((b, s))
        out = {}
        for keys in by_dev.values():
            vals = torch.stack([jobs[b][s][2] for b, s in keys]).tolist()
            out.update(zip(keys, vals))
        if check:
            for key in sorted(out):
                device_pack.check_flags(out[key][0])
        self.balance = [[out[b, s][1] for s in range(len(row))
                         if (b, s) in out] for b, row in enumerate(jobs)]
        return out

    def _q_indices(self, row) -> torch.Tensor:
        first = row[0][0].device
        return torch.cat([q.to(first) for q, _b, _s in row])

    def encode_batch(self, pictures) -> list:
        """Encode a batch of Pictures (frames, or fields when interlaced).
        Returns ``EncodedPicture``s (q indices, payload, slice totals)
        identical to ``Encoder.encode_picture``'s."""
        jobs = self._launch(pictures)
        status = self._statuses(jobs)
        n = self.n_loc
        by_dev: dict = {}
        for key, (_flags, size) in status.items():
            b, s = key
            buf = jobs[b][s][1]
            by_dev.setdefault(buf.device, []).append((key, buf[:4 * n + size]))
        spans = {}
        for parts in by_dev.values():          # one copy a device
            host = torch.cat([p for _k, p in parts]).cpu().numpy()
            at = 0
            for key, p in parts:
                spans[key] = host[at:at + p.numel()]
                at += p.numel()
        out = []
        for b, row in enumerate(jobs):
            totals, payloads = [], []
            for s in range(len(row)):
                t, p = device_pack.split_result(spans[b, s], n)
                totals.append(t)
                payloads.append(p.tobytes())
            out.append(EncodedPicture(
                q_device=self._q_indices(row),
                slices=(self.geo.y_slices, self.geo.x_slices),
                payload=b"".join(payloads),
                slice_totals=np.concatenate(totals)))
        return out

    def encode_batch_to_fragments(self, pictures, writer, picture_numbers,
                                  preamble) -> list:
        """Encode a batch and write each of ``picture_numbers``' pictures
        (the batch's first ones; the rest are padding) as fragment data
        units through ``writer``, feeding each band's span to the picture's
        ``FragmentWriter`` as its copy lands. Every band's flags are read
        first, so an error comes before any byte is written. Byte-identical
        to ``write_picture`` over the whole payload (reference
        DataUnit.cpp:267-342). Returns each picture's q indices (ySlices,
        xSlices)."""
        jobs = self._launch(pictures)
        status = self._statuses(jobs)
        n = self.n_loc
        q_out = []
        for b, picnum in enumerate(picture_numbers):
            fw = writer.begin_fragments(picnum, preamble, hq=True)
            for s, (_q, buf, _st) in enumerate(jobs[b]):
                span = buf[:4 * n + status[b, s][1]].cpu().numpy()
                fw.feed(*device_pack.split_result(span, n))
            fw.close()
            q_out.append(self._q_indices(jobs[b]).cpu().numpy().reshape(
                self.geo.y_slices, self.geo.x_slices))
        return q_out


class ShardedDecoder:
    """Decode of one picture's slice payload over the ``space`` axis of
    ``mesh`` (its first data row), to padded int32 planes on the mesh's
    first device, equal to the single-device decode's. HQ: the host finds
    the slices (the chain scan, once a picture, serial as in the JAX
    package); each band unpacks the slices of its block
    (``halo.band_blocks``: its own slice rows and a margin of its
    neighbours') from its span of the payload on its device
    (``decode_payload_device``). LD: the picture unpacks on one device,
    with its LL grids (``pipeline.decoder.unpack_ld_payload``), and each
    band takes its block's rows of the lanes and the grids
    (``synthesise``). Then ``halo.inverse_bands_local`` keeps each band's
    own rows.

    Both ``decode_payload`` and ``decode_payload_device`` take the device
    unpack: the JAX package's host-unpack route serves only its
    ``block_bytes_estimate`` fallback, which is not ported."""

    def __init__(self, kernel, depth: int, geo: SliceGeometry, mesh):
        self.kernel = kernel
        self.depth = depth
        self.geo = geo
        self.mesh = mesh
        self.space = space = mesh.shape["space"]
        if geo.y_slices % space:
            raise ValueError("y_slices must divide by the space mesh extent")
        self.devs = mesh.row(0)
        self.n_loc = geo.n_slices // space
        self.blocks = halo.band_blocks(geo, space, kernel, depth)
        self.qmatrix = matrices.quant_matrix(kernel, depth)
        self.ly = geo.luma_slice[0] * geo.luma_slice[1]
        self.lc = geo.chroma_slice[0] * geo.chroma_slice[1]
        self.spans = []           # the last HQ picture's payload bytes a band

    def _check(self) -> None:
        """The JAX package's ValueErrors for bands this transform cannot
        take, before any device work."""
        for rows, _w in (self.geo.padded_luma, self.geo.padded_chroma):
            halo.check_rows(rows, self.space, self.kernel, self.depth)

    def _block_slices(self, s: int) -> slice:
        a, _r0, _r1, b = self.blocks[s]
        xs = self.geo.x_slices
        return slice(a * xs, b * xs)

    def _synthesise(self, s: int, lanes, q_idx, ll=None) -> list:
        """Band s's own rows of the three padded planes from its block's
        lanes and q indices (LD: its block's rows of the LL grids)."""
        return halo.inverse_bands_local(lanes, q_idx, self.qmatrix,
                                        self.kernel, self.depth, self.geo,
                                        s, self.space, ll)

    def _gather(self, bands) -> tuple:
        """bands[s] = band s's rows of the three planes -> the planes,
        whole on the first device."""
        first = self.devs[0]
        return tuple(torch.cat([b[c].to(first) for b in bands])
                     for c in range(3))

    def synthesise(self, q_idx, ly, lu, lv, grids=None) -> tuple:
        """Entropy-decoded lanes (q [N], lanes [N, L], host or device) ->
        (y, c1, c2) padded planes: each band's block of the lanes on its
        device, dequantised and inverse-transformed there. LD: ``grids``
        are the three LL grids with their DC prediction (int32, host or
        device), each band taking its block's rows of them."""
        self._check()
        q_all = torch.as_tensor(q_idx).ravel()
        ts = 1 << self.depth
        bands = []
        for s, dev in enumerate(self.devs):
            sl = self._block_slices(s)
            lanes = [torch.as_tensor(x[sl]).to(dev, torch.int32).contiguous()
                     for x in (ly, lu, lv)]
            q = q_all[sl].to(dev, torch.int32)
            ll = None
            if grids is not None:
                a, _r0, _r1, b = self.blocks[s]
                ll = [torch.as_tensor(g[a * sh // ts:b * sh // ts]).to(
                    dev, torch.int32).contiguous()
                    for g, sh in zip(grids, (self.geo.luma_slice[0],
                                             self.geo.chroma_slice[0],
                                             self.geo.chroma_slice[0]))]
            bands.append(self._synthesise(s, lanes, q, ll))
        return self._gather(bands)

    def decode_payload(self, payload, prefix: int, scalar: int,
                       start: int = 0) -> tuple:
        """One picture's slice payload (slices from byte ``start``) ->
        (y, c1, c2) padded planes: the chain scan, then
        ``decode_payload_device``."""
        q, dstart, cbytes, _end = scan_hq_slice_offsets(
            payload, self.geo.n_slices, prefix, scalar, start)
        return self.decode_payload_device(payload, q, dstart, cbytes)

    def decode_payload_device(self, payload, q_idx, dstart, cbytes,
                              prefix: int | None = None,
                              scalar: int | None = None,
                              start: int = 0) -> tuple:
        """One picture's slice payload and its chain scan (q [N], the
        components' byte offsets and lengths [3, N]) -> (y, c1, c2) padded
        planes. Band s uploads the bytes its block's slices' regions span
        and unpacks them in one launch. ``prefix``, ``scalar`` and ``start``
        are taken for the JAX signature; the offsets already hold them."""
        self._check()
        data = np.frombuffer(payload, np.uint8)
        dstart = np.asarray(dstart, np.int64)
        cbytes = np.asarray(cbytes, np.int64)
        q_idx = np.asarray(q_idx).ravel()
        bands, self.spans = [], []
        for s, dev in enumerate(self.devs):
            sl = self._block_slices(s)
            lo = int(dstart[0, sl.start])
            hi = int((dstart[:, sl] + cbytes[:, sl]).max(initial=lo))
            hi = min(max(hi, lo), data.size)
            fields = np.concatenate([q_idx[None, sl], dstart[:, sl] - lo,
                                     cbytes[:, sl]]).astype(np.int32)
            pay = torch.from_numpy(data[lo:hi].copy()).to(dev)
            f = torch.from_numpy(fields).to(dev)
            lanes = device_unpack.unpack_hq(pay, f[1:4], f[4:7], self.ly,
                                            self.lc)
            bands.append(self._synthesise(s, lanes, f[0]))
            self.spans.append(hi - lo)
        return self._gather(bands)
