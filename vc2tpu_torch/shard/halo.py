"""Halo-exchange lifting DWT for row-band-sharded pictures.

Port of ``vc2tpu.shard.halo``. A picture's rows are cut into ``n`` row
bands (the ``space`` axis of a mesh), each a multiple of ``2**depth`` rows
on its device; the transform, in the in-place layout, equals the
unsharded ``lifting.forward_plane`` / ``inverse_plane`` exactly (ints,
integer ``==``).

The JAX package exchanges halo rows before every vertical lifting step
(``ppermute``, a parity's ``halo_width`` rows). The port's lift kernel
runs all the steps of a level in one launch (``lifting.lift_levels``), so
rows are exchanged once a level instead:

* a band's block holds its own rows and a margin of ``lifting.halo(kernel)
  * s`` rows on each side at level stride ``s`` (the level's
  contamination reach in its sub-lattice rows, ``lifting.true_reach`` of
  both ladders, times ``s``), clipped to the picture; the edge bands take
  nothing past the picture's edge, where the kernel's own clamp is the
  picture's;
* the margin rows are copied from whichever bands hold them, more than one
  band away when bands are thinner than the margin (a device copy on one
  card, a peer copy between cards; between processes, where a row of the
  mesh spans them, point-to-point over ``torch.distributed``, every send
  and receive of a level posted together and then waited on);
* one ``lift_levels`` call a level on each device lifts every block of
  every plane that device holds (one kernel launch), and a band keeps its
  block's interior: the rows past the margin are exact, since nothing from
  beyond the block reaches them;
* the forward writes each coarser level back into the band's sub-lattice
  (as ``lifting.forward_planes`` does); the inverse passes each level's
  compact result to the next finer one as its overlay, whose margins are
  refreshed from the neighbours' results the same way.

Blocks keep heights that are multiples of ``2 * s`` because the margins
are (``halo`` is even and bands are multiples of ``2**depth``). The port
raises the JAX package's errors where it raises them: a band that is not
a multiple of ``2**depth`` rows, and a band whose deepest parity plane has
fewer rows than the JAX ``halo_width``. Thinner bands than that are within
the port's reach but are refused all the same.

The band (Mallat) form, ``forward_bands_local`` and
``inverse_bands_local`` (the JAX package's names), is what the mesh's HQ
encode and decode and its divisible LD decode run (``pipeline.sharded``).
A band works a *block* of whole slice rows: its own and ``band_margin``
more on each side, clipped to the picture, and runs the single-device
band route (``wavelet.bands``: one csrc/band_lift.cu launch a level, its
three components together) over the block's slice geometry. The rows
past the margin are exact without any exchange between levels (the
bound is derived at ``band_margin``), so a band keeps its own slice rows
and nothing travels between bands: the decode's bands unpack their
block's slices from the picture's payload, and the encode's bands upload
their block's rows from the host picture. The in-place functions above
stay for what the JAX package runs in its in-place form:
``LDEncoder(mesh=)``, the LD decode whose slice rows do not divide over
the mesh, and ``sharded_forward_plane(s)`` / ``sharded_inverse_plane(s)``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from vc2tpu_torch.core.config import WaveletKernel
from vc2tpu_torch.slices.hq import SliceGeometry
from vc2tpu_torch.wavelet import bands, lifting


def halo_width(kernel: WaveletKernel) -> int:
    """Max |tap offset| of the kernel's lifting steps, in sub-lattice rows:
    LeGall/Daub97 1, DD97/DD137 2, Fidelity 4, Haar 0 (the JAX package's
    per-step halo, whose rule for the thinnest band the port keeps)."""
    return max((abs(off) for (_, _, taps, _, _) in lifting._STEPS[kernel]
                for (off, _) in taps), default=0)


def check_rows(rows: int, n: int, kernel: WaveletKernel, depth: int) -> None:
    """Raise the JAX package's ValueError for a plane of ``rows`` rows that
    cannot be cut into ``n`` bands for this transform."""
    if rows % n or (rows // n) % (1 << depth):
        raise ValueError("row shards must be multiples of 2**depth")
    if (depth and lifting._STEPS[kernel]
            and (rows // n) >> depth < halo_width(kernel)):
        raise ValueError("row shard too small for this kernel's halo")


def margin(kernel: WaveletKernel, depth: int) -> int:
    """Rows a band's block holds beyond its own on each side: the coarsest
    level's halo."""
    return lifting.halo(kernel) << (depth - 1) if depth else 0


def band_rows(rows: int, n: int, extra: int) -> list:
    """(a, r0, r1, b) of each of ``n`` bands of ``rows`` rows: the band owns
    rows [r0, r1) and its block holds [a, b), ``extra`` more on each side
    clipped to the plane."""
    h = rows // n
    return [(max(0, i * h - extra), i * h, (i + 1) * h,
             min(rows, (i + 1) * h + extra)) for i in range(n)]


class _Exchange:
    """The margin-row copies of one lifting call. Between two bands of
    this process a copy is made at once (a device copy on one card, a peer
    copy between cards). With a band of another process (``owners[p][j]``,
    the process of plane p's band j, not this one) the rows go over
    ``torch.distributed`` point-to-point: ``run`` posts every send and
    receive of a level together and then waits on all of them, so no order
    of the peers' sends can deadlock. Gloo carries CPU tensors: a card's
    rows are staged through pinned host buffers. The k-th message from one
    process to another carries tag k in both processes, since both
    enumerate the shared planes' copies in the same order."""

    def __init__(self, owners=None):
        self.owners = owners
        self.rank = dist.get_rank() if owners and any(owners) else None
        self.tags: dict = {}
        self.sends, self.recvs = [], []

    def mine(self, p: int, i: int) -> bool:
        """Whether this process holds band i of plane p."""
        o = self.owners[p] if self.owners else None
        return o is None or o[i] == self.rank

    def fill(self, bufs, geo, p: int, i: int, lo: int, hi: int) -> None:
        """Copy rows [lo, hi) of plane p into band i's block from the bands
        that own them (``bufs[j]`` is None for a band of another
        process)."""
        a = geo[i][0]
        for j, (aj, r0, r1, _b) in enumerate(geo):
            x0, x1 = max(lo, r0), min(hi, r1)
            if j == i or x0 >= x1:
                continue
            here, there = self.mine(p, i), self.mine(p, j)
            if here and there:
                bufs[i][x0 - a:x1 - a].copy_(bufs[j][x0 - aj:x1 - aj],
                                             non_blocking=True)
            elif here:
                self._recv(self.owners[p][j], bufs[i][x0 - a:x1 - a])
            elif there:
                self._send(self.owners[p][i], bufs[j][x0 - aj:x1 - aj])

    def _tag(self, peer: int, way: str) -> int:
        k = self.tags.get((peer, way), 0)
        self.tags[peer, way] = k + 1
        return k

    def _host(self, rows: torch.Tensor) -> torch.Tensor:
        return torch.empty(rows.shape, dtype=rows.dtype,
                           pin_memory=rows.device.type == "cuda")

    def _send(self, peer: int, rows: torch.Tensor) -> None:
        host = self._host(rows)
        host.copy_(rows, non_blocking=True)
        self.sends.append((peer, self._tag(peer, "send"), host, rows.device))

    def _recv(self, peer: int, rows: torch.Tensor) -> None:
        self.recvs.append((peer, self._tag(peer, "recv"), self._host(rows),
                           rows))

    def run(self) -> None:
        """Send and receive the level's rows across processes, then copy
        the received rows into their blocks."""
        if not self.sends and not self.recvs:
            return
        for dev in {d for *_x, d in self.sends if d.type == "cuda"}:
            torch.cuda.current_stream(dev).synchronize()   # the staged rows
        works = ([dist.isend(h, peer, tag=tag)
                  for peer, tag, h, _d in self.sends]
                 + [dist.irecv(h, peer, tag=tag)
                    for peer, tag, h, _r in self.recvs])
        for w in works:
            w.wait()
        for _peer, _tag, h, rows in self.recvs:
            rows.copy_(h, non_blocking=True)
        self.sends, self.recvs = [], []


def _refresh(xch, bufs, geo, p: int, i: int, reach: int, scale: int = 1,
             blocks=None) -> None:
    """Refresh the rows of plane p's band i's block within ``reach`` plane
    rows of the band, from the bands that own them. For a compact level of
    stride ``scale``, ``blocks`` gives each block's first row and the
    band's rows in that level's rows."""
    _a, r0, r1, _b = geo[i]
    rows = geo[-1][2]
    g = geo if blocks is None else blocks
    xch.fill(bufs, g, p, i, max(0, r0 - reach) // scale, r0 // scale)
    xch.fill(bufs, g, p, i, r1 // scale, min(rows, r1 + reach) // scale)


def _lift_by_device(blocks, kernel, invert: bool, stride: int,
                    overlays=None) -> list:
    """``lifting.lift_levels`` of every block (None for a band of another
    process), one call (one launch) for the blocks of each device; results
    in the blocks' order."""
    overlays = overlays or [None] * len(blocks)
    groups: dict = {}
    for k, x in enumerate(blocks):
        if x is not None:
            groups.setdefault(x.device, []).append(k)
    out = [None] * len(blocks)
    for idx in groups.values():
        res = lifting.lift_levels([blocks[k] for k in idx], kernel, invert,
                                  stride, [overlays[k] for k in idx])
        for k, r in zip(idx, res):
            out[k] = r
    return out


def _geometry(planes, kernel, depth: int) -> list:
    return [band_rows(len(bands) * next(t.shape[0] for t in bands
                                        if t is not None),
                      len(bands), margin(kernel, depth)) for bands in planes]


def _extend(xch, planes, geos) -> list:
    """The blocks of the planes' bands: each band's rows with its margins
    copied from the bands that own them (int32, contiguous, on the band's
    device; None for a band of another process)."""
    blocks = []
    for bands, geo in zip(planes, geos):
        row = []
        for x, (a, r0, r1, b) in zip(bands, geo):
            blk = None
            if x is not None:
                blk = torch.empty((b - a, x.shape[1]), dtype=torch.int32,
                                  device=x.device)
                blk[r0 - a:r1 - a].copy_(x)
            row.append(blk)
        blocks.append(row)
    for p, geo in enumerate(geos):
        for i, (a, r0, r1, b) in enumerate(geo):
            xch.fill(blocks[p], geo, p, i, a, r0)
            xch.fill(blocks[p], geo, p, i, r1, b)
    xch.run()
    return blocks


def forward_blocks(blocks, geos, kernel: WaveletKernel, depth: int) -> list:
    """Forward DWT of row-band-sharded planes given as blocks:
    ``blocks[p][i]`` holds rows [a, b) of plane p's band i (``geos[p][i]``
    = (a, r0, r1, b) from ``band_rows(rows, n, margin(kernel, depth))``),
    int32 and contiguous on the band's device. Returns ``out[p][i]``, the
    band's rows [r0, r1) of the transform (views of new blocks). One
    ``lift_levels`` call a level a device."""
    return _forward(_Exchange(), blocks, geos, kernel, depth)


def _forward(xch, blocks, geos, kernel, depth: int) -> list:
    hr = lifting.halo(kernel)
    bufs = [list(p) for p in blocks]
    jobs = [(p, i) for p in range(len(bufs)) for i in range(len(bufs[p]))]
    for level in range(depth):
        s = 1 << level
        if level:
            for p, i in jobs:
                _refresh(xch, bufs[p], geos[p], p, i, hr * s)
            xch.run()
        views = []
        for p, i in jobs:
            a, r0, r1, b = geos[p][i]
            x = bufs[p][i]
            lo, hi = max(a, r0 - hr * s), min(b, r1 + hr * s)
            views.append(x if x is None or not level else x[lo - a:hi - a])
        outs = _lift_by_device(views, kernel, False, s)
        for (p, i), out in zip(jobs, outs):
            a, r0, r1, b = geos[p][i]
            if out is None:
                continue
            if not level:
                bufs[p][i] = out          # the whole block, margins stale
                continue
            lo = max(a, r0 - hr * s)
            bufs[p][i][r0 - a:r1 - a][::s, ::s] = \
                out[(r0 - lo) // s:(r1 - lo) // s]
    return [[None if x is None else x[g[1] - g[0]:g[2] - g[0]]
             for x, g in zip(bufs[p], geos[p])] for p in range(len(bufs))]


def forward_bands(planes, kernel: WaveletKernel, depth: int,
                  owners=None) -> list:
    """Forward DWT of row-band-sharded planes: ``planes[p][i]`` is band i
    of plane p, its own rows on its device (every band of a plane the same
    height, a multiple of ``2**depth``). Returns the bands of the
    transform, in the same shape. ``owners[p]``, where given and not
    None, is the process of each band of plane p: a band of another
    process is None in ``planes`` and in the result, and its rows travel
    over ``torch.distributed``. These bands are a mesh's bands of rows, in-place layout; the subbands
    of the Mallat form are ``wavelet.lifting.forward_bands``'s."""
    planes = [[None if t is None else t.to(torch.int32) for t in bands]
              for bands in planes]
    if not depth:
        return [[None if t is None else t.contiguous() for t in bands]
                for bands in planes]
    xch = _Exchange(owners)
    geos = _geometry(planes, kernel, depth)
    return _forward(xch, _extend(xch, planes, geos), geos, kernel, depth)


def inverse_bands(planes, kernel: WaveletKernel, depth: int,
                  owners=None) -> list:
    """Inverse DWT of row-band-sharded transform planes (as
    ``forward_bands``'s result): one ``lift_levels`` call a level a device,
    coarsest first, each level's compact result the overlay of the next
    after its margins are refreshed from the neighbours'. ``owners`` as
    ``forward_bands``'s. Row bands, as ``forward_bands``; the Mallat
    form's subbands go through ``wavelet.lifting.inverse_bands``."""
    planes = [[None if t is None else t.to(torch.int32) for t in bands]
              for bands in planes]
    if not depth:
        return [[None if t is None else t.contiguous() for t in bands]
                for bands in planes]
    hr = lifting.halo(kernel)
    xch = _Exchange(owners)
    geos = _geometry(planes, kernel, depth)
    tbufs = _extend(xch, planes, geos)
    jobs = [(p, i) for p in range(len(planes)) for i in range(len(planes[p]))]
    coarse = None       # coarse[p][i]: (compact result, its first row)
    for level in range(depth - 1, -1, -1):
        s = 1 << level
        if coarse is not None:
            sc = 2 * s                # the coarser level's stride
            for p, i in jobs:
                blocks = [(c0, g[1] // sc, g[2] // sc, None)
                          for (_t, c0), g in zip(coarse[p], geos[p])]
                _refresh(xch, [t for t, _ in coarse[p]], geos[p], p, i,
                         hr * s, sc, blocks)
            xch.run()
        views, overlays, firsts = [], [], []
        for p, i in jobs:
            a, r0, r1, b = geos[p][i]
            lo, hi = max(a, r0 - hr * s), min(b, r1 + hr * s)
            x = tbufs[p][i]
            views.append(None if x is None else x[lo - a:hi - a])
            firsts.append(lo // s)
            if coarse is not None:
                c, c0 = coarse[p][i]
                overlays.append(None if c is None else
                                c[lo // (2 * s) - c0:hi // (2 * s) - c0])
        outs = _lift_by_device(views, kernel, True, s, overlays or None)
        it = iter(zip(outs, firsts))
        coarse = [[next(it) for _ in planes[p]] for p in range(len(planes))]
    return [[None if t is None else t[g[1] - c0:g[2] - c0]
             for (t, c0), g in zip(coarse[p], geos[p])]
            for p in range(len(planes))]


# --- the band (Mallat) form: a band's block of slice rows ---------------------

def band_margin(kernel: WaveletKernel, depth: int, geo) -> int:
    """Slice rows a band's block holds beyond its own on each side: the
    band form's reach ``lifting.halo(kernel) * (2**depth - 1)`` rows,
    rounded up to whole slice rows of each component, the largest.

    The bound. Within a block the band kernels clamp their taps at the
    block's edges; where that edge is not the picture's, a clamped tap
    reads a wrong row. A block's edges lie on slice rows, multiples of
    ``2**depth`` rows, so at every level the edge falls between whole
    parity pairs, where ``lifting.halo`` (even) bounds how far one
    ladder carries wrong values. Inverse: the coarsest level's rows within
    ``halo`` of the edge go wrong (in that level's rows, ``2**(depth-1)``
    plane rows each); a finer level doubles the wrong rows of the coarser
    LL it interleaves and adds ``halo``: 3, 7, ... ``2**depth - 1`` halos,
    which is ``halo * (2**depth - 1)`` plane rows. Forward: the wrong LL
    rows ``b`` of a level feed the next, whose ladder spreads them to
    ``b + halo`` rows, one more when ``b`` is odd; the subband rows they
    touch cover at most ``halo * (2**depth - 1) + 2**depth - 2`` plane
    rows, in whole blocks of ``2**depth``, hence within that reach rounded
    up to ``2**depth`` rows. Slice heights are multiples of ``2**depth``,
    so whole slice rows of the reach cover both."""
    reach = lifting.halo(kernel) * ((1 << depth) - 1)
    return max(-(-reach // sh) for sh in (geo.luma_slice[0],
                                          geo.chroma_slice[0]))


def band_blocks(geo, n: int, kernel: WaveletKernel, depth: int) -> list:
    """(a, r0, r1, b) in slice rows of each of ``n`` bands of the slice
    geometry ``geo``: the band owns slice rows [r0, r1) and its block holds
    [a, b), ``band_margin`` more on each side clipped to the picture."""
    return band_rows(geo.y_slices, n, band_margin(kernel, depth, geo))


def block_geometry(geo, a: int, b: int) -> SliceGeometry:
    """The slice geometry of slice rows [a, b) of ``geo``."""
    ys = b - a
    (lh, _lw), (ch, _cw) = geo.luma_slice, geo.chroma_slice
    return SliceGeometry(ys, geo.x_slices, (ys * lh, geo.padded_luma[1]),
                         (ys * ch, geo.padded_chroma[1]), geo.luma_slice,
                         geo.chroma_slice)


def forward_bands_local(planes, kernel: WaveletKernel, depth: int, geo,
                        band: int, n: int) -> list:
    """The forward DWT of band ``band`` of ``n`` of a picture of slice
    geometry ``geo``, into its lanes. ``planes`` is the band's block of
    the three planes (rows [a * sh, b * sh) of each, ``band_blocks``),
    int16 or int32 with contiguous rows on the band's device; the block
    that ends the picture may stop at the picture's last row, and every
    block at its width: the kernel's clamped reads pad them, as
    ``wavelet_pad`` pads the picture. Returns the band's own slice rows of
    the (y, u, v) lanes, int32 [ys_local * xs, L] (views of the block's
    lanes): ``bands_to_lanes`` of the JAX package's ``forward_bands_local``.
    One ``band_forward`` launch a level (``bands.forward_lanes``); at depth
    0 the lanes are the samples (``forward_lanes_plain``)."""
    a, r0, r1, b = band_blocks(geo, n, kernel, depth)[band]
    bgeo = block_geometry(geo, a, b)
    lanes = (bands.forward_lanes if depth else bands.forward_lanes_plain)(
        planes, kernel, depth, bgeo)
    xs = geo.x_slices
    return [t[(r0 - a) * xs:(r1 - a) * xs] for t in lanes]


def inverse_bands_local(lanes, q_idx: torch.Tensor, qmatrix,
                        kernel: WaveletKernel, depth: int, geo, band: int,
                        n: int, ll=None) -> list:
    """The dequantise and inverse DWT of band ``band`` of ``n`` of a
    picture of slice geometry ``geo``: ``lanes`` the (y, u, v) int32
    lanes of the band's block's slices (``band_blocks``), ``q_idx`` their
    q indices, ``ll`` (LD) the block's rows of the three LL grids, band 0.
    Returns the band's own rows of the three padded int32 planes (views):
    the JAX package's ``inverse_bands_local`` after ``scale_banded`` and
    ``lanes_to_bands``. One ``band_inverse`` launch a level
    (``bands.inverse_lanes``); at depth 0 the dequantised lanes (LD: the
    grids) are the planes (``inverse_lanes_plain``)."""
    a, r0, r1, b = band_blocks(geo, n, kernel, depth)[band]
    bgeo = block_geometry(geo, a, b)
    planes = (bands.inverse_lanes if depth else bands.inverse_lanes_plain)(
        lanes, q_idx, qmatrix, bgeo, kernel, depth, ll)
    return [p[(r0 - a) * sh:(r1 - a) * sh]
            for p, sh in zip(planes, (geo.luma_slice[0], geo.chroma_slice[0],
                                      geo.chroma_slice[0]))]


def _axis_devices(mesh, axis_name: str) -> list:
    if axis_name == "space":
        return mesh.row(0)
    if axis_name == "data":
        return [row[0] for row in mesh.devices]
    raise ValueError(f"no mesh axis {axis_name!r}")


def _sharded(planes, mesh, kernel, depth: int, axis_name: str,
             inverse: bool) -> list:
    """The forward or inverse of whole planes, each (..., H, W), cut into
    row bands over the mesh's ``axis_name`` axis: one ``lift_levels`` call
    a level a device for all of them. Returned whole on the axis's first
    device."""
    devs = _axis_devices(mesh, axis_name)
    n = len(devs)
    shapes, bands = [], []
    for plane in planes:
        x = plane if isinstance(plane, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(plane))
        x = x.to(torch.int32)
        rows, width = x.shape[-2], x.shape[-1]
        check_rows(rows, n, kernel, depth)
        h = rows // n
        frames = x.reshape(-1, rows, width)
        shapes.append((x.shape, len(frames)))
        bands += [[f[i * h:(i + 1) * h].to(devs[i]) for i in range(n)]
                  for f in frames]
    out = iter((inverse_bands if inverse else forward_bands)(bands, kernel,
                                                           depth))
    first = devs[0]
    return [torch.stack([torch.cat([t.to(first) for t in next(out)])
                         for _ in range(count)]).reshape(shape)
            for shape, count in shapes]


def sharded_forward_planes(planes, mesh, kernel: WaveletKernel, depth: int,
                           axis_name: str = "space") -> list:
    """Forward DWT of (already padded) planes, each (..., H, W), cut into
    row bands over the mesh's ``axis_name`` axis (its first row or column
    of devices), one ``lift_levels`` call a level a device for all of them.
    Values and layout equal the unsharded ``lifting.forward_plane``'s;
    returned whole on the axis's first device."""
    return _sharded(planes, mesh, kernel, depth, axis_name, False)


def sharded_inverse_planes(transforms, mesh, kernel: WaveletKernel,
                           depth: int, axis_name: str = "space") -> list:
    """Inverse of ``sharded_forward_planes`` (``lifting.inverse_plane``
    over row bands)."""
    return _sharded(transforms, mesh, kernel, depth, axis_name, True)


def sharded_forward_plane(plane, mesh, kernel: WaveletKernel, depth: int,
                          axis_name: str = "space") -> torch.Tensor:
    """``sharded_forward_planes`` of one plane (the JAX package's
    signature)."""
    return _sharded([plane], mesh, kernel, depth, axis_name, False)[0]


def sharded_inverse_plane(transform, mesh, kernel: WaveletKernel,
                          depth: int, axis_name: str = "space"):
    """``sharded_inverse_planes`` of one plane."""
    return _sharded([transform], mesh, kernel, depth, axis_name, True)[0]
