"""Where the time of the LD pack and LD unpack kernels goes, from clock64()
stamps in instrumented copies of their sources.

    python vc2tpu_torch/testdata/ld_stamps.py ROOT

ROOT is a checkout whose ``vc2tpu_torch/csrc/ld_pack.cu`` and
``ld_unpack.cu`` are to be measured: this tree, or commit 7f60d0a (the
kernels before the current designs) unpacked with ``git archive``. The
script recognises either design by the lines it stamps, inserts the
stamps, builds both copies with ``nvcc -Xptxas -v`` (printing registers
and spills), runs each a few times on the 1080p LD picture (the pack on
its transform lanes and the rate control's LL lanes, the unpack on
``ld_1080p.vc2``'s payload), checks the outputs against the kernels' plain
versions and prints, for each phase of each kernel, the cycles a warp
spends in it (the longest thread of the warp), each kernel's span on the
card's global timer, its CTAs' lifetimes and the CTAs an SM can hold.
The phases of 7f60d0a's kernels: the pack's sizing pass, write pass and
zero fill (one thread a slice), the unpack's window staging, region walk,
wait at the barrier and tile write (one thread a region). Those of the
current designs: the pack's load and sizing, group scan and window write
(a group of threads a slice), the unpack's staging, decode, wait and
write. Needs a CUDA card; the stamps cost a few stores a thread.
"""

from __future__ import annotations

import ctypes
import io
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

STAMP_DEFS = r"""
__device__ long long* g_stamps;
__device__ __forceinline__ long long gtimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
"""

SET_STAMPS = r"""
extern "C" int set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));
}

"""


def occupancy(kernel: str, dynamic: bool) -> str:
    set_smem = (f"  cudaFuncSetAttribute({kernel}, "
                "cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
                if dynamic else "")
    return ('extern "C" int occupancy(int threads, int smem) {\n' + set_smem
            + "  int b = 0;\n"
            f"  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, {kernel}, "
            f"threads, {'smem' if dynamic else '0'});\n  return b;\n}}\n\n")


# Each design: (anchor, text inserted before it) pairs, every anchor found
# exactly once, and the phases as (name, first stamp, last stamp). Stamp
# columns 0-4 are clock64() values, 5 and 6 the global timer at the
# thread's start and end, 7 the CTA.
END_PACK = ("  o[5] = g0; o[6] = gtimer(); o[7] = blockIdx.x;\n")
DESIGNS = {
    "ld_pack": [
        ("7f60d0a: one thread a slice", [
            ("__global__ void __launch_bounds__(THREADS) ld_pack(PackArgs a)"
             " {", STAMP_DEFS),
            ("  // size: the luma and the interleaved U/V codes' bits",
             "  const long long t0 = clock64(), g0 = gtimer();\n"),
            ("  const long long uv_bits = total - 7 - len_bits - y_used;",
             "  const long long t1 = clock64();\n"),
            ("  uint8_t* at = a.out + 4 + a.starts[s];",
             "  const long long t2 = clock64();\n"),
            ("}\n\n}  // namespace",
             "  long long* o = g_stamps + 8 * s;\n"
             "  o[0] = t0; o[1] = t1; o[2] = t2; o[3] = clock64();\n"
             + END_PACK),
            ('extern "C" int ld_pack_launch(',
             SET_STAMPS + occupancy("ld_pack", False)),
        ], [("sizing pass", 0, 1), ("write pass", 1, 2), ("zero fill", 2, 3),
            ("whole thread", 0, 3)]),
        ("a group of threads a slice", [
            ("__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) "
             "ld_pack(PackArgs a) {", STAMP_DEFS),
            ("  // thread t: luma lanes [lo, hi)",
             "  const long long t0 = clock64(), g0 = gtimer();\n"),
            ("  // the group: the bits before each chunk",
             "  const long long t1 = clock64();\n"),
            ("  // write, one 16-byte aligned window",
             "  const long long t2 = clock64();\n"),
            ("}\n\n}  // namespace",
             "  long long* o = g_stamps + 8 * ((long long)blockIdx.x * THREADS"
             " + tid);\n"
             "  o[0] = t0; o[1] = t1; o[2] = t2; o[3] = clock64();\n"
             + END_PACK),
            ('extern "C" int ld_pack_launch(',
             SET_STAMPS + occupancy("ld_pack", False)),
        ], [("load, quantise and size", 0, 1), ("group scan and flag", 1, 2),
            ("window write", 2, 3), ("whole thread", 0, 3)]),
    ],
    "ld_unpack": [
        (design, [
            ("__global__ void __launch_bounds__(" + bounds + ")\n"
             "ld_unpack_kernel", STAMP_DEFS),
            ("  extern __shared__ __align__(16) uint32_t smem[];",
             "  const long long t0 = clock64(), g0 = gtimer();\n"),
            ("  if (staged_flags != nullptr && t == 0) staged_flags[blockIdx.x]",
             "  const long long t1 = clock64();\n"),
            ("  if (!stage) return;\n  __syncthreads();\n",
             "  const long long t2 = clock64();\n"),
            ("\n  const int rows = min(s, n - s0);",
             "  const long long t3 = clock64();\n"),
            ("}\n\n}  // namespace",
             "  long long* o = g_stamps + 8 * ((long long)blockIdx.x *"
             " blockDim.x + t);\n"
             "  o[0] = t0; o[1] = t1; o[2] = t2; o[3] = t3; o[4] = clock64();"
             "\n  o[5] = g0; o[6] = gtimer(); o[7] = valid ? blockIdx.x : -1;"
             "\n"),
            ('extern "C" int ld_unpack_launch(',
             SET_STAMPS + occupancy("ld_unpack_kernel", True)),
        ], [("staging (tile zeroed, window staged)", 0, 1),
            (phase, 1, 2), ("wait at the barrier", 2, 3),
            ("tile write", 3, 4), ("whole thread", 0, 4)])
        for design, bounds, phase in (
            ("7f60d0a: one thread a region, decode_region", "2 * MAX_SLICES",
             "region walk"),
            ("one thread a region, a code or a zero run a step", "MAX_THREADS",
             "region decode"))
    ],
}


def stamped(text: str, name: str):
    """(design, source with stamps, phases) of the first design of kernel
    ``name`` whose anchors the source holds, each once."""
    for design, patches, phases in DESIGNS[name]:
        if all(text.count(anchor) == 1 for anchor, _ in patches):
            for anchor, insert in patches:
                text = text.replace(anchor, insert + anchor)
            return design, text, phases
    raise RuntimeError(f"{name}: the source matches no known design")


def build(root: str, name: str, headers, work: str):
    """Build the stamped copy of csrc/<name>.cu of ``root``; returns (the
    library, its design, its phases)."""
    from vc2tpu_torch.core import build as b

    csrc = os.path.join(root, "vc2tpu_torch", "csrc")
    with open(os.path.join(csrc, f"{name}.cu")) as f:
        design, src, phases = stamped(f.read(), name)
    path = os.path.join(work, f"{name}_stamped.cu")
    with open(path, "w") as f:
        f.write(src)
    for fname, text in headers:
        with open(os.path.join(work, fname), "w") as f:
            f.write(text)
    lib = os.path.join(work, f"lib{name}_stamped.so")
    out = subprocess.run([b.nvcc_path(), *b.NVCC_FLAGS, "-Xptxas", "-v",
                          "-I", csrc, "-I", work, "-o", lib, path],
                         capture_output=True, text=True)
    print(f"{name} ({design}), nvcc -Xptxas -v:")
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    lib = ctypes.CDLL(lib)
    lib.set_stamps.argtypes = [ctypes.c_void_p]
    lib.occupancy.argtypes = [ctypes.c_int, ctypes.c_int]
    return lib, design, phases


def quantiles(x) -> str:
    x = np.asarray(x, np.float64)
    return (f"median {np.median(x):.0f}, p90 {np.percentile(x, 90):.0f}, "
            f"max {x.max():.0f}")


def report(name: str, st: np.ndarray, phases, mhz: float):
    """Print each phase's cycles a warp (its longest thread; stamps [threads
    in launch order, 8], rows of threads that did not stamp are 0), the
    span on the global timer and the CTAs' lifetimes."""
    live = st[:, 5] > 0
    print(f"{name} span on the global timer: "
          f"{(st[live, 6].max() - st[live, 5].min()) / 1e3:.2f} us")
    pad = -len(st) % 32
    warps = np.concatenate([st, np.zeros((pad, 8), st.dtype)]).reshape(
        -1, 32, 8)
    alive = (warps[:, :, 5] > 0)
    for label, a, b in phases:
        d = np.where(alive, warps[:, :, b] - warps[:, :, a], 0).max(1)
        d = d[alive.any(1)]
        print(f"{name} {label}: cycles a warp {quantiles(d)} "
              f"({np.median(d) / mhz:.2f} us median at {mhz:.0f} MHz)")
    ctas = st[live, 7]
    life = [st[live][ctas == c] for c in np.unique(ctas)]
    print(f"{name} CTA lifetime on the global timer: ns "
          f"{quantiles([c[:, 6].max() - c[:, 5].min() for c in life])}")


def main(argv) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    root = os.path.abspath(argv[0])
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import make_1080p
    from vc2tpu_torch.core.config import ColourFormat, PictureGeometry
    from vc2tpu_torch.core.planario import PlanarReader, SampleFormat
    from vc2tpu_torch.vlc import device_pack as dp
    from vc2tpu_torch.vlc import device_unpack as du

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = cs.max_sm_hz() / 1e6
    print(f"card: {cs.card_line()}; {sms} SMs; max SM clock {mhz:.0f} MHz; "
          f"kernels of {root}")
    work = tempfile.mkdtemp()
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    # the LD pack on the 1080p picture
    lib, design, phases = build(root, "ld_pack",
                                dp.ld_kernel_source().headers, work)
    src = os.path.join(work, "hd.16p2")
    make_1080p.make_input(src)
    with open(src, "rb") as f:
        picture = PlanarReader(io.BytesIO(f.read()),
                               PictureGeometry.of(1080, 1920,
                                                  ColourFormat.CF422),
                               SampleFormat(word_width=2, bit_depth=10)
                               ).read_frame()
    enc, tlanes = cs.ld_fixture_lanes(dev, picture)
    q, *ll = enc.rate_control(tlanes)
    y, u, v = tlanes
    n = q.numel()
    old = design.startswith("7f60d0a")
    group = 1 if old else dp.ld_group_size(y.shape[1], u.shape[1])
    threads = dp.LD_THREADS
    ctas = -(-n * group // threads)
    stamps = torch.zeros((ctas * threads, 8), dtype=torch.int64, device=dev)
    rc = lib.set_stamps(stamps.data_ptr())
    args = [y.data_ptr(), u.data_ptr(), v.data_ptr(), y.shape[1],
            u.shape[1], ll[0].data_ptr(), ll[1].data_ptr(), ll[2].data_ptr(),
            ll[0].shape[1], ll[1].shape[1], enc.qm[0].data_ptr(),
            enc.qm[1].data_ptr(), None, None, None, q.data_ptr(),
            enc.sizes.data_ptr(), enc.starts.data_ptr(), n]
    lib.ld_pack_launch.argtypes = ([p, p, p, i, i, p, p, p, i, i]
                                   + [p] * 8 + [i] + ([] if old else [i])
                                   + [p, p])
    out = torch.empty(4 + enc.payload_bytes, dtype=torch.uint8, device=dev)
    for _ in range(3):       # the last launch's stamps are kept
        out[:4].zero_()
        rc |= lib.ld_pack_launch(*args, *([] if old else [group]),
                                 out.data_ptr(), stream)
    torch.cuda.synchronize()
    want, _ = dp.quant_pack_ld_plain(*tlanes, ll, q, *enc.qm, enc.sizes)
    if rc or not torch.equal(out, want):
        raise RuntimeError("the stamped ld_pack differs from its plain "
                           "version")
    blocks = lib.occupancy(threads, 0)
    print(f"ld_pack: {n} slices, {group} threads a slice, {threads} a CTA, "
          f"{ctas} CTAs; {blocks} CTAs an SM resident at most "
          f"({blocks * threads // 32} warps); this grid: {ctas / sms:.2f} "
          f"CTAs an SM")
    report("ld_pack", stamps.cpu().numpy(), phases, mhz)

    # the LD unpack on ld_1080p.vc2
    lib, design, phases = build(root, "ld_unpack", (), work)
    with open(os.path.join(HERE, "ld_1080p.vc2"), "rb") as f:
        job = cs.ld_picture_of(f.read(), dev)[2]
    geo = job.geo
    ly = geo.luma_slice[0] * geo.luma_slice[1]
    lc = geo.chroma_slice[0] * geo.chroma_slice[1]
    pay = torch.as_tensor(np.array(job.payload), device=dev)
    fields = torch.as_tensor(job.ld.fields, device=dev)
    n = fields.shape[1]
    # 7f60d0a's plan: 32 slices a CTA and an 8 KB window
    s, win = (32, 8192) if design.startswith("7f60d0a") else (
        du.ld_unpack_plan(ly, lc)[0], du.LD_WINDOW_BYTES)
    ctas, threads = -(-n // s), (2 * s + 31) & ~31
    smem = win + 4 * s * ((ly | 1) + ((2 * lc) | 1))
    stamps = torch.zeros((ctas * threads, 8), dtype=torch.int64, device=dev)
    rc = lib.set_stamps(stamps.data_ptr())
    lib.ld_unpack_launch.argtypes = [p, ctypes.c_longlong, p, i, i, i, p, p,
                                     p, i, i, i, p, p]
    outs = [torch.empty((n, k), dtype=torch.int32, device=dev)
            for k in (ly, lc, lc)]
    for _ in range(3):
        rc |= lib.ld_unpack_launch(
            pay.data_ptr(), pay.numel(), fields.data_ptr(), n, ly, lc,
            *(o.data_ptr() for o in outs), s, win, 1, None, stream)
    torch.cuda.synchronize()
    want = du.unpack_ld_plain(pay, fields, ly, lc)
    if rc or not all(torch.equal(a, b) for a, b in zip(outs, want)):
        raise RuntimeError("the stamped ld_unpack differs from its plain "
                           "version")
    blocks = lib.occupancy(threads, smem)
    print(f"ld_unpack: {n} slices, {s} slices = {threads} threads a CTA, "
          f"{ctas} CTAs, {smem} bytes of shared memory a CTA; {blocks} CTAs "
          f"an SM resident at most ({blocks * threads // 32} warps); this "
          f"grid: {ctas / sms:.2f} CTAs an SM")
    st = stamps.cpu().numpy()
    st[st[:, 7] < 0] = 0          # threads past the last slice
    report("ld_unpack", st, phases, mhz)
    walk = phases[1]
    per_bit = ((st[:, walk[2]] - st[:, walk[1]])[st[:, 5] > 0].sum()
               / max(int(fields[2:].clamp(min=0).sum()), 1))
    print(f"ld_unpack {walk[0]}: {per_bit:.2f} cycles a region bit")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
