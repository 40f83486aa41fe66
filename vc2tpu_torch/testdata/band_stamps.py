"""Where the time of the band kernels goes (csrc/band_lift.cu), from
%%globaltimer stamps in an instrumented copy of the source.

    python vc2tpu_torch/testdata/band_stamps.py [ROOT]

ROOT (default: this checkout) is copied to a temporary directory, its
``band_lift.cu`` gets a stamp at the start of each CTA and of each phase
of its first tile, and the copy's kernels are built as usual and run on
one 1080p ConstQ picture: each inverse level on the fixture's unpacked
lanes, each forward level on the samples that the inverse returns (int16,
as uploaded). The script prints, for each level, the tiles, the grid and
the CTAs an SM holds, when CTAs start and end, and each phase's time
(median, 90th percentile, longest over the CTAs; then luma's and
chroma's tiles apart): the inverse's copies issued (lanes, LL, q indices
and tables), the wait for them, the dequantisation, the ladders, the
store and any later tiles; the forward's input load, ladders, lane store
and later tiles. Needs a CUDA card; the stamps cost a few stores a CTA.
Written for this design's source: the kernels' first form (commit
0f2d15a) has other lines and is not recognised.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

INVERSE_PHASES = ((0, 1, "entry"), (1, 2, "copies issued"),
                  (2, 3, "copy wait"), (3, 4, "dequant"), (4, 6, "ladders"),
                  (6, 7, "store"), (7, 8, "later tiles"))
FORWARD_PHASES = ((0, 1, "entry"), (1, 4, "load input"), (4, 6, "ladders"),
                  (6, 7, "store lanes"), (7, 8, "later tiles"))


# (line of the source, its stamped form), applied in order
PATCHES = [
    ("__device__ const int32_t QUANT_FACTORS[N_Q] = {VC2_QUANT_FACTORS};",
     """__device__ unsigned long long g_stamp[16 * 65536];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %smid;" : "=r"(r));
  return r;
}
#define STAMP(k) \
  if (threadIdx.x == 0 && tile == (int)blockIdx.x) \
    g_stamp[16 * blockIdx.x + (k)] = gtime();
#define END_STAMPS \
  if (threadIdx.x == 0) { \
    g_stamp[16 * blockIdx.x + 8] = gtime(); \
    g_stamp[16 * blockIdx.x + 9] = smid(); \
  }
__device__ const int32_t QUANT_FACTORS[N_Q] = {VC2_QUANT_FACTORS};"""),
    # inverse
    ("    const Tile T = tile_at(t, tile, sm.planes, true);",
     "    STAMP(1)\n    const Tile T = tile_at(t, tile, sm.planes, true);"),
    ("    copy_wait();\n    __syncthreads();\n"
     "    dequant_planes(P, g, P.ll ? 1 : 0, sm.sq, sm);\n"
     "    __syncthreads();\n\n    cols<S...>(g);\n    rows<S...>(g);\n",
     "    STAMP(2)\n    copy_wait();\n    __syncthreads();\n    STAMP(3)\n"
     "    dequant_planes(P, g, P.ll ? 1 : 0, sm.sq, sm);\n"
     "    __syncthreads();\n    STAMP(4)\n\n    cols<S...>(g);\n"
     "    rows<S...>(g);\n    STAMP(6)\n"),
    ("    __syncthreads();  // the planes and tables are the next tile's\n"
     "  }\n}",
     "    __syncthreads();  // the planes and tables are the next tile's\n"
     "    STAMP(7)\n  }\n  END_STAMPS\n}"),
    # forward
    ("    const Tile T = tile_at(t, tile, sm.planes, false);",
     "    STAMP(1)\n    const Tile T = tile_at(t, tile, sm.planes, false);"),
    ("      load_input<int32_t, TSHIFT>(P, g, T.r0, T.c0);\n"
     "    __syncthreads();\n\n    rows<S...>(g);\n    cols<S...>(g);\n",
     "      load_input<int32_t, TSHIFT>(P, g, T.r0, T.c0);\n"
     "    __syncthreads();\n    STAMP(4)\n\n    rows<S...>(g);\n"
     "    cols<S...>(g);\n    STAMP(6)\n"),
    ("    __syncthreads();  // the planes are the next tile's\n  }\n}",
     "    __syncthreads();  // the planes are the next tile's\n"
     "    STAMP(7)\n  }\n  END_STAMPS\n}"),
    # the CTA's start, and the launch's grid
    ("band_level_kernel(const __grid_constant__ BandTable t) {\n",
     "band_level_kernel(const __grid_constant__ BandTable t) {\n"
     "  if (threadIdx.x == 0) g_stamp[16 * blockIdx.x] = gtime();\n"),
    ("template <class L>\nint launch(const BandTable& t, cudaStream_t stream) {",
     "int g_grid[2];\ntemplate <class L>\n"
     "int launch(const BandTable& t, cudaStream_t stream) {"),
    ("  const int grid = min(t.n_tiles, max(per_sm, 1) * sms);\n",
     "  const int grid = min(t.n_tiles, max(per_sm, 1) * sms);\n"
     "  g_grid[0] = grid, g_grid[1] = per_sm;\n"),
]

DEBUG = r"""
extern "C" int band_debug(unsigned long long* out, int n, int* grid) {
  grid[0] = g_grid[0], grid[1] = g_grid[1];
  return (int)cudaMemcpyFromSymbol(out, g_stamp,
                                   sizeof(unsigned long long) * 16 * n);
}
"""


def stamped(s: str) -> str:
    """band_lift.cu with the stamps inserted."""
    for old, new in PATCHES:
        if old not in s:
            raise ValueError("band_stamps: the source has no line "
                             + old.strip().splitlines()[0])
        s = s.replace(old, new, 1)
    return s + DEBUG


def report(lib, name: str, n: int, phases, luma_tiles: int) -> None:
    import numpy as np

    st = np.zeros(16 * n, np.uint64)
    grid = np.zeros(2, np.int32)
    lib.band_debug(st.ctypes.data, n, grid.ctypes.data)
    g = int(grid[0])
    st = st.reshape(-1, 16)[:g].astype(np.int64)
    rel = (st[:, :9] - st[:, 0].min()) / 1e3
    sm = st[:, 9]
    print(f"{name}: {n} tiles, grid {g} ({grid[1]} CTAs an SM), "
          f"{np.bincount(sm).max()} CTAs at most on one of "
          f"{len(set(sm.tolist()))} SMs; CTAs start by "
          f"{rel[:, 0].max():.2f} us, end {rel[:, 8].min():.2f} - "
          f"{np.median(rel[:, 8]):.2f} (median) - {rel[:, 8].max():.2f} us")
    for a, b, label in phases:
        d = rel[:, b] - rel[:, a]
        y, c = d[:luma_tiles], d[luma_tiles:]
        print(f"  {label:14s} median {np.median(d):6.2f}, p90 "
              f"{np.percentile(d, 90):6.2f}, max {d.max():6.2f} us; luma "
              f"{np.median(y):6.2f} / {y.max():6.2f}, chroma "
              f"{np.median(c):6.2f} / {c.max():6.2f} us")


def measure(copy: str) -> None:
    """In this process: the stamped copy's levels on the 1080p picture."""
    sys.path.insert(0, copy)
    import torch

    import chip_smoke as cs
    from vc2tpu_torch.pipeline import decoder as pipe
    from vc2tpu_torch.vlc import device_unpack as du
    from vc2tpu_torch.wavelet import bands, lifting, matrices

    dev = torch.device("cuda")
    stream_ = torch.cuda.current_stream().cuda_stream
    with open(os.path.join(cs.TESTDATA, "fixtures_1080p.json")) as f:
        fixture = json.load(f)["streams"]["constq_1080p"]
    with open(os.path.join(cs.TESTDATA, fixture["stream"]), "rb") as f:
        job = cs.pictures_of(f.read(), dev)[0][2]
    pre, geo = job.pre, job.geo
    pay, fields = pipe.upload(job.payload, job.q_idx, job.cbytes, dev)
    clen = fields[1:].contiguous()
    dstart = du.hq_component_offsets(clen, pre.slice_prefix, job.start)
    lanes = du.unpack_hq(pay, dstart, clen,
                         geo.luma_slice[0] * geo.luma_slice[1],
                         geo.chroma_slice[0] * geo.chroma_slice[1])
    q, kernel, depth = fields[0], pre.wavelet_kernel, pre.depth
    qm = tuple(int(v) for v in matrices.quant_matrix(kernel, depth))
    sms = lifting._sm_count(dev.index)
    lib = bands._lib()
    lib.band_debug.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p]

    def run(fn, table):
        for _ in range(3):  # the last run's stamps, after a warm-up
            torch.cuda._sleep(2000000)
            cs.check(fn(ctypes.byref(table), int(kernel), stream_) == 0,
                     "band_stamps: launch failed")
            torch.cuda.synchronize()

    coarse = None
    for level, ((template, dims), maps) in enumerate(zip(
            bands._plan(geo, qm, int(kernel), depth, sms, True),
            bands._map_tensors(geo, depth, True, dev))):
        table = bands._BandTable.from_buffer_copy(template)
        table.q = q.data_ptr()
        outs = [torch.empty(hw, dtype=torch.int32, device=dev)
                for hw in dims]
        for i in range(3):
            e = table.p[i]
            e.lanes, e.dst = lanes[i].data_ptr(), outs[i].data_ptr()
            e.map = maps[i].data_ptr()
            if coarse is not None:
                e.ll = coarse[i].data_ptr()
        run(lib.band_inverse_launch, table)
        report(lib, f"inverse level {level + 1} of {depth}", table.n_tiles,
               INVERSE_PHASES, table.p[1].tile0)
        coarse = outs
    want = bands.inverse_lanes_plain(lanes, q, qm, geo, kernel, depth)
    cs.check(all(torch.equal(a, b) for a, b in zip(coarse, want)),
             "band_stamps: the stamped inverse differs from its plain "
             "version")
    src = [c.to(torch.int16) for c in coarse]
    flanes = [torch.empty_like(t) for t in lanes]
    for level, ((template, dims), maps) in enumerate(zip(
            reversed(bands._plan(geo, (0,) * (3 * depth + 1), int(kernel),
                                 depth, sms, True)),
            reversed(bands._map_tensors(geo, depth, True, dev)))):
        table = bands._BandTable.from_buffer_copy(template)
        outs = []
        for i, (h, w) in enumerate(dims):
            e = table.p[i]
            e.lanes, e.map = flanes[i].data_ptr(), maps[i].data_ptr()
            x = src[i]
            e.src, e.src_ld = x.data_ptr(), x.stride(0)
            e.src_h, e.src_w = x.shape
            e.src_bytes = x.element_size()
            if level + 1 < depth:
                outs.append(torch.empty((h // 2, w // 2), dtype=torch.int32,
                                        device=dev))
                e.dst = outs[-1].data_ptr()
        run(lib.band_forward_launch, table)
        report(lib, f"forward level {depth - level} of {depth}",
               table.n_tiles, FORWARD_PHASES, table.p[1].tile0)
        src = outs


def main(argv) -> int:
    if argv and argv[0] == "--measure":
        measure(argv[1])
        return 0
    root = os.path.abspath(argv[0] if argv else ROOT)
    with tempfile.TemporaryDirectory() as work:
        shutil.copy(os.path.join(root, "chip_smoke.py"), work)
        shutil.copytree(os.path.join(root, "vc2tpu_torch"),
                        os.path.join(work, "vc2tpu_torch"),
                        ignore=shutil.ignore_patterns("_build",
                                                      "__pycache__"))
        path = os.path.join(work, "vc2tpu_torch", "csrc", "band_lift.cu")
        with open(path) as f:
            text = stamped(f.read())
        with open(path, "w") as f:
            f.write(text)
        return subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--measure", work], cwd=work).returncode


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
