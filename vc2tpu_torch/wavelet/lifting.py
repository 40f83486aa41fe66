"""Integer lifting wavelet transforms: the in-place interleaved layout and
the Mallat (band) form.

Port of ``vc2tpu.wavelet.lifting`` and of its Pallas kernel
``vc2tpu.wavelet.pallas_lift.lift_level``. The band form's functions
(``forward_bands``, ``inverse_bands``, ``bands_to_lanes``, ...) are plain
PyTorch here; the kernels that run them on the card are wrapped in
``wavelet.bands``. The in-place route follows. One transform level of
one or more planes is ``lift_levels``: a CUDA kernel
(``csrc/lift_level.cu``, one launch for all the planes) for CUDA tensors,
the plain PyTorch version ``lift_level_plain`` for CPU tensors;
``lift_level`` is its one-plane case. The reference's loops are at
src/Library/src/WaveletTransform.cpp:478-1265.

* every lifting pass updates one parity from clamped-shifted views of the
  other parity; source indices clamp to [0, n-1] in even/odd index space,
  which reproduces the reference's clamped taps (WaveletTransform.cpp:
  495-498, 936-943);
* a level at stride ``s`` lifts the ``x[::s, ::s]`` sub-lattice. On the
  card the kernel reads it in place and writes a compact plane; the inverse
  passes each level's compact result to the next finer level as an
  overlay of that level's (even, even) samples, so no sub-lattice is copied
  or scattered. On the CPU the sub-lattice is copied;
* arithmetic is int32 with wrap-around and arithmetic shifts, as in C. The
  plain version forms it in int64 and wraps explicitly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vc2tpu_torch.core import build
from vc2tpu_torch.core import capture
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.config import WaveletKernel
from vc2tpu_torch.core.intmath import wrap32
from vc2tpu_torch.wavelet.matrices import TRANSFORM_SHIFT, padded_size

# Lifting step: (target_parity, sign, ((offset, coeff), ...), add, shift_bits)
# target 'o': o[i] (sign)= (sum coeff*e[i+off] + add) >> shift
# target 'e': e[i] (sign)= (sum coeff*o[i+off] + add) >> shift
_STEPS = {
    WaveletKernel.LeGall: (
        ("o", -1, ((0, 1), (1, 1)), 1, 1),
        ("e", +1, ((-1, 1), (0, 1)), 2, 2),
    ),
    WaveletKernel.DD97: (
        ("o", -1, ((-1, -1), (0, 9), (1, 9), (2, -1)), 8, 4),
        ("e", +1, ((-1, 1), (0, 1)), 2, 2),
    ),
    WaveletKernel.DD137: (
        ("o", -1, ((-1, -1), (0, 9), (1, 9), (2, -1)), 8, 4),
        ("e", +1, ((-2, -1), (-1, 9), (0, 9), (1, -1)), 16, 5),
    ),
    WaveletKernel.Haar0: (
        ("o", -1, ((0, 1),), 0, 0),
        ("e", +1, ((0, 1),), 1, 1),
    ),
    WaveletKernel.Fidelity: (
        ("e", +1, ((-4, -8), (-3, 21), (-2, -46), (-1, 161),
                   (0, 161), (1, -46), (2, 21), (3, -8)), 128, 8),
        ("o", -1, ((-3, -2), (-2, 10), (-1, -25), (0, 81),
                   (1, 81), (2, -25), (3, 10), (4, -2)), 128, 8),
    ),
    WaveletKernel.Daub97: (
        ("o", -1, ((0, 6497), (1, 6497)), 2048, 12),
        ("e", -1, ((-1, 217), (0, 217)), 2048, 12),
        ("o", +1, ((0, 3616), (1, 3616)), 2048, 12),
        ("e", +1, ((-1, 1817), (0, 1817)), 2048, 12),
    ),
    WaveletKernel.NullKernel: (),
}
_STEPS[WaveletKernel.Haar1] = _STEPS[WaveletKernel.Haar0]


def ladder(kernel: WaveletKernel, invert: bool):
    """The step list one level runs: the inverse is the reversed list with
    flipped signs, exactly how the reference's inverse loops are arranged."""
    steps = _STEPS[kernel]
    if invert:
        steps = tuple((t, -s, taps, add, sh)
                      for (t, s, taps, add, sh) in reversed(steps))
    return steps


# --- plain PyTorch version ---------------------------------------------------

def _apply_steps(e, o, steps, dim: int):
    """One predict/update ladder along ``dim`` on int64 parity planes that
    hold int32 values; tap indices clamp to [0, n-1] (edge replication)."""
    for target, sign, taps, add, sh in steps:
        src = e if target == "o" else o
        n = src.shape[dim]
        idx = torch.arange(n, device=src.device)
        acc = None
        for off, coeff in taps:
            term = coeff * src.index_select(dim, (idx + off).clamp(0, n - 1))
            acc = term if acc is None else acc + term
        delta = wrap32(acc + add) >> sh if sh else wrap32(acc)
        if target == "o":
            o = wrap32(o + sign * delta)
        else:
            e = wrap32(e + sign * delta)
    return e, o


def _split(v, dim: int):
    if dim == 0:
        return v[0::2], v[1::2]
    return v[:, 0::2], v[:, 1::2]


def _interleave(e, o, dim: int):
    shape = list(e.shape)
    shape[dim] *= 2
    return torch.stack([e, o], dim=dim + 1).reshape(shape)


def lift_level_plain(x: torch.Tensor, kernel: WaveletKernel,
                     invert: bool = False) -> torch.Tensor:
    """One in-place transform level of an int32 (h, w) plane, h and w even.
    Forward: accuracy shift, horizontal then vertical ladder; inverse:
    vertical, horizontal, then the rounded unshift (reference
    WaveletTransform.cpp:595-698 for the LeGall instance)."""
    steps = ladder(kernel, invert)
    shift = TRANSFORM_SHIFT[kernel]
    v = x.to(torch.int64)
    if not invert:
        if shift:
            v = wrap32(v << shift)
        v = _interleave(*_apply_steps(*_split(v, 1), steps, 1), 1)
        v = _interleave(*_apply_steps(*_split(v, 0), steps, 0), 0)
    else:
        v = _interleave(*_apply_steps(*_split(v, 0), steps, 0), 0)
        v = _interleave(*_apply_steps(*_split(v, 1), steps, 1), 1)
        if shift:
            v = wrap32(v + (1 << (shift - 1))) >> shift
    return v.to(torch.int32)


def level_input(plane: torch.Tensor, stride: int = 1,
                overlay: torch.Tensor | None = None) -> torch.Tensor:
    """The plane one level lifts: ``plane[::stride, ::stride]``, with its
    (even, even) samples taken from ``overlay`` (the coarser level's
    compact result) when one is given. A contiguous copy."""
    x = plane[::stride, ::stride]
    if overlay is not None:
        x = x.clone()
        x[::2, ::2] = overlay
    return x.contiguous()


def lift_levels_plain(planes, kernel: WaveletKernel, invert: bool = False,
                      stride: int = 1, overlays=None) -> list:
    """Plain version of ``lift_levels``, on any device."""
    overlays = overlays or [None] * len(planes)
    return [lift_level_plain(level_input(p, stride, o), kernel, invert)
            for p, o in zip(planes, overlays)]


# --- the CUDA kernel ----------------------------------------------------------

def true_reach(steps) -> int:
    """Exact interleaved contamination reach of one ladder (a port of
    ``pallas_lift._true_reach``): how deep values from beyond a tile's
    edge propagate into the tile through the lifting dependency chain, both
    boundary directions."""
    N = 64

    def sim(sign):
        bad = {r: (r < 0) for r in range(-N, N)}

        def get(r):
            return bad[r] if -N <= r < N else (r < 0)

        for (t, _s, taps, _a, _sh) in steps:
            pt = 1 if t == "o" else 0
            ps = 1 - pt
            new = dict(bad)
            for r in range(-N, N):
                if (r & 1) != pt:
                    continue
                if any(get(r + sign * (2 * o + ps - pt)) for o, _ in taps):
                    new[r] = True
            bad = new
        return max([r + 1 for r in range(N) if bad[r]] + [0])

    return max(sim(1), sim(-1))


@functools.lru_cache(maxsize=None)
def halo(kernel: WaveletKernel) -> int:
    """Halo, in interleaved samples on every side of a kernel tile: the
    larger contamination reach of the forward and inverse ladders, rounded
    up to even so tile regions keep their parity."""
    reach = max(true_reach(ladder(kernel, False)),
                true_reach(ladder(kernel, True)))
    return reach + (reach & 1)


def col_halo(h: int) -> int:
    """The column halo: ``h`` rounded up to a multiple of 4, so a region's
    first column is 16-byte aligned wherever its tile's is."""
    return (h + 3) & ~3


# Regions (rows, columns of samples a CTA holds), largest first. A region
# is 2^k (at least 64) columns wide: the kernel maps threads to it with
# shifts, and each of its parity planes fills a warp's 32 lanes along a
# row. A launch takes the largest region whose tiles still give every SM
# of the card CTAS_PER_SM CTAs.
REGIONS = ((64, 256), (64, 128), (32, 128), (32, 64))
CTAS_PER_SM = 3
MAX_PLANES = 48               # planes a launch takes (csrc/lift_level.cu)
SMEM_LIMIT = 232448            # bytes of shared memory a CTA may opt into


def tiles(hr: int) -> list:
    """The output tiles (rows, columns) for halo ``hr``, largest first: each
    region less its halos, leaving out a region whose halos would take more
    than half of it."""
    hc = col_halo(hr)
    return [(rh - 2 * hr, rw - 2 * hc) for rh, rw in REGIONS
            if 4 * hr <= rh and 4 * hc <= rw]


def tile_shape(sizes, hr: int, min_ctas: int) -> tuple:
    """The output tile of one launch over planes of the given (h, w) sizes
    with halo ``hr``: the largest that gives ``min_ctas`` tiles."""
    options = tiles(hr)
    for th, tw in options:
        if sum(-(-h // th) * -(-w // tw) for h, w in sizes) >= min_ctas:
            return th, tw
    return options[-1]


def tile_region(ty0: int, tx0: int, th: int, tw: int, h: int, w: int,
                hr: int) -> tuple:
    """(r0, r1, c0, c1): the samples the CTA of the tile at (ty0, tx0)
    loads, the tile plus ``hr`` rows and ``col_halo(hr)`` columns on every
    side, clipped to the (h, w) plane."""
    hc = col_halo(hr)
    return (max(0, ty0 - hr), min(h, ty0 + th + hr),
            max(0, tx0 - hc), min(w, tx0 + tw + hc))


def smem_bytes(th: int, tw: int, hr: int) -> int:
    """Shared memory of one CTA: the largest region, as four parity
    planes of (rows / 2) x (columns / 2) words."""
    return 4 * (th + 2 * hr) * (tw + 2 * col_halo(hr))


def ladder_header() -> str:
    """``lift_ladders.h`` for csrc/lift_level.cu: every wavelet's forward
    and inverse ladder as compile-time types, generated from ``_STEPS``
    (via ``ladder``) and ``TRANSFORM_SHIFT``, and the switch that picks
    one by (wavelet, direction)."""
    lines = ["// Generated from vc2tpu_torch.wavelet.lifting._STEPS and",
             "// matrices.TRANSFORM_SHIFT by lifting.ladder_header().",
             "// Ladder<invert, transform shift, Step...>;",
             "// Step<target parity, sign, add, shift, offset, coeff, ...>.",
             "#pragma once", ""]
    cases = []
    for kernel in WaveletKernel:
        for invert in (False, True):
            steps = []
            for target, sign, taps, add, sh in ladder(kernel, invert):
                args = [1 if target == "o" else 0, sign, add, sh]
                args += [v for tap in taps for v in tap]
                steps.append("Step<" + ", ".join(map(str, args)) + ">")
            name = f"lift_{kernel.name}_{'inv' if invert else 'fwd'}"
            head = [str(int(invert)), str(TRANSFORM_SHIFT[kernel])]
            lines.append(f"using {name} = Ladder<"
                         + ", ".join(head + steps) + ">;")
            cases.append(f"    case {2 * int(kernel) + int(invert)}: "
                         f"return f({name}{{}});")
    lines += ["", "template <class F>",
              "int with_ladder(int kernel, int invert, F&& f) {",
              "  switch (2 * kernel + invert) {", *cases,
              "    default: return (int)cudaErrorInvalidValue;", "  }", "}",
              ""]
    return "\n".join(lines)


def kernel_source() -> build.Source:
    return build.Source("lift_level", (("lift_ladders.h", ladder_header()),))


class _LiftPlane(ctypes.Structure):
    """Mirror of ``struct LiftPlane`` in csrc/lift_level.cu."""

    _fields_ = [
        ("src", ctypes.c_void_p),
        ("overlay", ctypes.c_void_p),
        ("dst", ctypes.c_void_p),
        ("src_ld", ctypes.c_longlong),
        ("src_step", ctypes.c_int),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("tiles_x", ctypes.c_int),
        ("tile0", ctypes.c_int),
    ]


class _LiftTable(ctypes.Structure):
    """Mirror of ``struct LiftTable<MAX_PLANES>`` in csrc/lift_level.cu."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("n_tiles", ctypes.c_int),
        ("th", ctypes.c_int),
        ("tw", ctypes.c_int),
        ("halo", ctypes.c_int),
        ("p", _LiftPlane * MAX_PLANES),
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load(kernel_source())
    lib.lift_level_launch.argtypes = [
        ctypes.POINTER(_LiftTable), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.lift_level_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def _plan(shapes: tuple, stride: int, kernel: int, sms: int) -> tuple:
    """(plane table with its pointers 0, as bytes; the level's (h, w)
    sizes) of one launch over planes of the given (H, W) shapes at
    ``stride`` on a card of ``sms`` SMs. Raises ValueError where the kernel
    cannot take them. Cached: the decoder asks for the same few plans every
    picture."""
    if not 1 <= len(shapes) <= MAX_PLANES:
        raise ValueError(f"lift_levels: 1 to {MAX_PLANES} planes, "
                         f"got {len(shapes)}")
    if stride < 1 or stride & (stride - 1):
        raise ValueError(f"lift_levels: stride {stride} is not a power of 2")
    for shape in shapes:
        if len(shape) != 2 or shape[0] < 2 * stride or shape[1] < 2 * stride \
                or shape[0] % (2 * stride) or shape[1] % (2 * stride):
            raise ValueError(f"lift_levels: plane {tuple(shape)} at stride "
                             f"{stride} is not 2-D and even-sized")
    sizes = tuple((H // stride, W // stride) for H, W in shapes)
    kernel = WaveletKernel(kernel)
    hr = halo(kernel)
    th, tw = tile_shape(sizes, hr, CTAS_PER_SM * sms)
    if smem_bytes(th, tw, hr) > SMEM_LIMIT:
        raise ValueError(f"lift_levels: {kernel.name} tiles exceed shared "
                         "memory")
    table = _LiftTable(n=len(shapes), th=th, tw=tw, halo=hr)
    tile0 = 0
    for i, ((H, W), (h, w)) in enumerate(zip(shapes, sizes)):
        tiles_x = -(-w // tw)
        table.p[i] = _LiftPlane(src_ld=stride * W, src_step=stride, h=h, w=w,
                                tiles_x=tiles_x, tile0=tile0)
        tile0 += tiles_x * -(-h // th)
    table.n_tiles = tile0
    return bytes(table), sizes


@capture.counted
def lift_levels(planes, kernel: WaveletKernel, invert: bool = False,
                stride: int = 1, overlays=None) -> list:
    """One 2-D lifting level of each plane's ``plane[::stride, ::stride]``
    sub-lattice (planes: contiguous int32 (H, W), H and W multiples of
    2 * stride), with the (even, even) samples of that sub-lattice taken
    from ``overlays[i]`` where it is not None. Returns compact
    (H / stride, W / stride) planes.

    CUDA planes go through csrc/lift_level.cu, all in one launch (one a
    ``MAX_PLANES`` of them), reading the sub-lattice and the overlay in
    place; CPU planes through ``lift_level`` (its plain route) on a copied
    sub-lattice."""
    overlays = overlays or [None] * len(planes)
    dev = planes[0].device if len(planes) else None
    if dev is not None and dev.type == "cpu":
        return [lift_level(level_input(p, stride, o), kernel, invert)
                for p, o in zip(planes, overlays)]
    if dev is None or dev.type != "cuda":
        raise ValueError(f"lift_levels: unsupported device {dev}")
    if len(planes) > MAX_PLANES:
        return [out for i in range(0, len(planes), MAX_PLANES)
                for out in lift_levels(planes[i:i + MAX_PLANES], kernel,
                                       invert, stride,
                                       overlays[i:i + MAX_PLANES])]
    index, kernel = dev.index, int(kernel)
    template, sizes = _plan(tuple([p.shape for p in planes]), stride, kernel,
                            _sm_count(index))
    table = _LiftTable.from_buffer_copy(template)
    outs = []
    for entry, p, o, (h, w) in zip(table.p, planes, overlays, sizes):
        if p.get_device() != index or p.dtype != torch.int32 or \
                not p.is_contiguous():
            raise ValueError("lift_levels: needs contiguous int32 planes on "
                             f"one device, got {p.dtype} on {p.device}")
        if o is not None:
            if o.get_device() != index or o.dtype != torch.int32 or \
                    not o.is_contiguous() or o.shape != (h // 2, w // 2):
                raise ValueError("lift_levels: the overlay must be a "
                                 "contiguous int32 plane of the level's "
                                 "(even, even) samples")
            entry.overlay = o.data_ptr()
        out = torch.empty((h, w), dtype=torch.int32, device=dev)
        entry.src, entry.dst = p.data_ptr(), out.data_ptr()
        outs.append(out)
    with devices.guard(planes[0]):
        rc = _lib().lift_level_launch(
            ctypes.byref(table), kernel, int(invert),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"lift_level kernel launch failed: CUDA error {rc}")
    lift_levels.launches += 1
    return outs


def lift_level(x: torch.Tensor, kernel: WaveletKernel,
               invert: bool = False) -> torch.Tensor:
    """One 2-D lifting level of a contiguous int32 (h, w) plane (h, w even):
    the one-plane case of ``lift_levels``. A CUDA tensor goes through the
    kernel of csrc/lift_level.cu; a CPU tensor through lift_level_plain."""
    if x.device.type == "cpu":
        return lift_level_plain(x, kernel, invert)
    return lift_levels([x], kernel, invert)[0]


# --- whole-plane transforms ---------------------------------------------------

def wavelet_pad(plane: torch.Tensor, depth: int) -> torch.Tensor:
    """Edge-replication pad to multiples of 2**depth
    (reference WaveletTransform.cpp:79-94)."""
    h, w = plane.shape[-2], plane.shape[-1]
    ph, pw = padded_size(h, depth), padded_size(w, depth)
    if (ph, pw) == (h, w):
        return plane
    rows = torch.arange(ph, device=plane.device).clamp(max=h - 1)
    cols = torch.arange(pw, device=plane.device).clamp(max=w - 1)
    return plane.index_select(-2, rows).index_select(-1, cols)


def forward_planes(planes, kernel: WaveletKernel, depth: int) -> list:
    """Forward DWT of several already-padded planes at once, in-place
    transform layout (reference WaveletTransform.cpp:262-281): one
    ``lift_levels`` call a level for all the planes, finest first, level
    ``l`` reading the previous level's ``x[::2**l, ::2**l]`` sub-lattice in
    place. On the card that is one kernel launch a level; each coarser
    level's compact result goes back into its sub-lattice by a strided
    copy. Returns contiguous int32 planes (new ones when depth > 0)."""
    xs = [p if p.dtype == torch.int32 and p.is_contiguous()
          else p.to(torch.int32).contiguous() for p in planes]
    for level in range(depth):
        s = 1 << level
        outs = lift_levels(xs, kernel, stride=s)
        if s == 1:
            xs = outs
        else:
            for x, o in zip(xs, outs):
                x[::s, ::s] = o
    return xs


def forward_plane(plane: torch.Tensor, kernel: WaveletKernel,
                  depth: int) -> torch.Tensor:
    """Forward DWT of one plane (``forward_planes`` of one)."""
    return forward_planes([plane], kernel, depth)[0]


def inverse_planes(transforms, kernel: WaveletKernel, depth: int) -> list:
    """Inverse DWT of several planes at once, counterpart of reference
    WaveletTransform.cpp:321-342: one ``lift_levels`` call a level, coarsest
    first, each level's compact result the overlay of the next. On the card
    that is one kernel launch a level for all the planes. Caller crops
    padding; the inputs are not modified."""
    xs = [t if t.dtype == torch.int32 and t.is_contiguous()
          else t.to(torch.int32).contiguous() for t in transforms]
    if depth == 0:
        return xs
    coarse = None
    for level in range(depth - 1, -1, -1):
        coarse = lift_levels(xs, kernel, True, stride=1 << level,
                             overlays=coarse)
    return coarse


def inverse_plane(transform: torch.Tensor, kernel: WaveletKernel,
                  depth: int) -> torch.Tensor:
    """Inverse DWT of one plane (``inverse_planes`` of one)."""
    return inverse_planes([transform], kernel, depth)[0]


def coefficient_bound(kernel: WaveletKernel, depth: int,
                      input_max: int) -> int:
    """Safe upper bound on |coefficient| after the forward transform,
    propagated step by step through the lifting ladder (both axes, all
    levels, the accuracy shift included)."""
    steps = _STEPS[kernel]
    shift = TRANSFORM_SHIFT[kernel]
    m = int(input_max)
    for _ in range(depth):
        m <<= shift
        for _axis in range(2):
            bounds = {"e": m, "o": m}
            for target, _sign, taps, add, sh in steps:
                src = "e" if target == "o" else "o"
                acc = sum(abs(c) for _off, c in taps) * bounds[src] + add
                bounds[target] = bounds[target] + (acc >> sh if sh else acc)
            m = max(bounds.values())
    return m


def forward_picture(picture, kernel: WaveletKernel, depth: int):
    """Pad and forward-transform all three planes, in-place layout
    (reference WaveletTransform.cpp:1267-1279)."""
    from vc2tpu_torch.core.picture import Picture

    planes = forward_planes([wavelet_pad(p, depth) for p in
                             (picture.y, picture.c1, picture.c2)],
                            kernel, depth)
    return Picture(*planes, picture.chroma_format)


def inverse_picture(transform, kernel: WaveletKernel, depth: int, geometry):
    """Inverse-transform all planes and crop them to ``geometry``
    (reference WaveletTransform.cpp:1281-1292)."""
    from vc2tpu_torch.core.picture import Picture

    y, c1, c2 = inverse_planes([transform.y, transform.c1, transform.c2],
                               kernel, depth)
    g = geometry
    return Picture(y[:g.luma_height, :g.luma_width],
                   c1[:g.chroma_height, :g.chroma_width],
                   c2[:g.chroma_height, :g.chroma_width],
                   transform.chroma_format)


# --- the Mallat (band) form --------------------------------------------------
# The slices' lanes are subband-major (slices/layout.lane_order), so the
# band route keeps each subband a contiguous 2-D array: no sub-lattice is
# read or written. Bands are ordered as lane_order and the quant matrix
# index them: [LL, then per level coarsest -> finest HL, LH, HH]. These
# are the subbands of one plane; ``shard.halo.forward_bands`` /
# ``inverse_bands`` lift a mesh's bands of rows, which are another thing.
# The kernels of this route (csrc/band_lift.cu) are wrapped in
# ``wavelet.bands``; these are their plain building blocks.

def forward_bands(plane: torch.Tensor, kernel: WaveletKernel,
                  depth: int) -> list:
    """Forward DWT of an already-padded (h, w) plane as a list of int32
    subband arrays: per level the accuracy shift, the horizontal ladder,
    then the vertical ladder on each half."""
    steps = ladder(kernel, False)
    shift = TRANSFORM_SHIFT[kernel]
    x = plane.to(torch.int64)
    fine_to_coarse = []
    for _ in range(depth):
        if shift:
            x = wrap32(x << shift)
        he, ho = _apply_steps(*_split(x, 1), steps, 1)
        ll, lh = _apply_steps(*_split(he, 0), steps, 0)
        hl, hh = _apply_steps(*_split(ho, 0), steps, 0)
        fine_to_coarse.append((hl, lh, hh))
        x = ll
    bands = [x]
    for level in reversed(fine_to_coarse):
        bands.extend(level)
    return [b.to(torch.int32) for b in bands]


def inverse_bands(bands, kernel: WaveletKernel, depth: int) -> torch.Tensor:
    """Inverse DWT from subband arrays back to the (padded) plane, int32:
    per level, coarsest first, the vertical ladder on (LL, LH) and on (HL,
    HH), the horizontal ladder, then the rounded unshift."""
    steps = ladder(kernel, True)
    shift = TRANSFORM_SHIFT[kernel]
    x = bands[0].to(torch.int64)
    for level in range(depth):
        hl, lh, hh = (b.to(torch.int64)
                      for b in bands[1 + 3 * level:4 + 3 * level])
        he = _interleave(*_apply_steps(x, lh, steps, 0), 0)
        ho = _interleave(*_apply_steps(hl, hh, steps, 0), 0)
        x = _interleave(*_apply_steps(he, ho, steps, 1), 1)
        if shift:
            x = wrap32(x + (1 << (shift - 1))) >> shift
    return x.to(torch.int32)


def band_dims(padded_h: int, padded_w: int, depth: int) -> list:
    """(h, w) of each band in ``forward_bands`` order."""
    dims = [(padded_h >> depth, padded_w >> depth)]
    for level in range(1, depth + 1):
        s = 1 << (depth + 1 - level)
        dims.extend([(padded_h // s, padded_w // s)] * 3)
    return dims


def bands_to_inplace(bands, depth: int) -> torch.Tensor:
    """The reference's interleaved in-place layout of subband arrays
    (split_into_subbands' inverse, WaveletTransform.cpp:428-476)."""
    x = bands[0]
    for level in range(depth):
        hl, lh, hh = bands[1 + 3 * level:4 + 3 * level]
        x = _interleave(_interleave(x, hl, 1), _interleave(lh, hh, 1), 0)
    return x


def inplace_to_bands(x: torch.Tensor, depth: int) -> list:
    """The subband arrays of an interleaved in-place plane."""
    fine_to_coarse = []
    for _ in range(depth):
        even, odd = _split(x, 0)
        ll, hl = _split(even, 1)
        lh, hh = _split(odd, 1)
        fine_to_coarse.append((hl, lh, hh))
        x = ll
    bands = [x]
    for level in reversed(fine_to_coarse):
        bands.extend(level)
    return bands


def bands_to_lanes(bands, y_slices: int, x_slices: int) -> torch.Tensor:
    """Subband arrays -> (nSlices, L) lanes in serialisation order
    (band-major, raster within each band's slice sub-block): a reshape and
    a permute a band."""
    parts = []
    for b in bands:
        h, w = b.shape
        sh, sw = h // y_slices, w // x_slices
        t = b.reshape(y_slices, sh, x_slices, sw).permute(0, 2, 1, 3)
        parts.append(t.reshape(y_slices * x_slices, sh * sw))
    return torch.cat(parts, dim=1)


def lanes_to_bands(lanes: torch.Tensor, y_slices: int, x_slices: int,
                   dims) -> list:
    """Inverse of ``bands_to_lanes``; ``dims`` from ``band_dims``."""
    bands, pos = [], 0
    for h, w in dims:
        sh, sw = h // y_slices, w // x_slices
        t = lanes[:, pos:pos + sh * sw].reshape(y_slices, x_slices, sh, sw)
        bands.append(t.permute(0, 2, 1, 3).reshape(h, w))
        pos += sh * sw
    return bands
