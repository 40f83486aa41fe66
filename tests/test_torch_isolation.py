"""The port stands alone: it imports neither jax nor vc2tpu, its entry
points run on the card unless asked for the CPU, its kernels build only
from source with nvcc (the chain scan and the LD scan with the host C++
compiler) into libraries keyed by their sources and the headers they
include, a CUDA tensor never takes a wrapper's plain route, and a kernel
error in a fragmented picture propagates."""

import ast
import dataclasses
import io
import os
import subprocess
import sys

import pytest
import torch

from vc2tpu_torch.cli import decode_frame, decode_stream, encode_stream
from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core import build
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.core.config import (ColourFormat, EncoderConfig, Mode,
                                      WaveletKernel)
from vc2tpu_torch.pipeline.encoder import Encoder
from vc2tpu_torch.pipeline.ld import LDEncoder
from vc2tpu_torch.quant import ld_dc
from vc2tpu_torch.rdo import cbr
from vc2tpu_torch.rdo import ld as rdo_ld
from vc2tpu_torch.slices import hq, ld
from vc2tpu_torch.vlc import device_pack, device_unpack
from vc2tpu_torch.wavelet import bands, lifting

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(os.path.join(ROOT, "vc2tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "vc2tpu")


def test_no_file_imports_jax_or_vc2tpu():
    bad = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def _imports_clean(modules: str):
    code = (f"import sys, {modules}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vc2tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_import_loads_no_jax_or_vc2tpu():
    _imports_clean("vc2tpu_torch, vc2tpu_torch.cli.decode_stream, "
                   "vc2tpu_torch.pipeline.decoder")


def test_encode_imports_load_no_jax_or_vc2tpu():
    _imports_clean("vc2tpu_torch.cli.encode_stream, "
                   "vc2tpu_torch.pipeline.encoder")


def test_rate_control_imports_load_no_jax_or_vc2tpu():
    _imports_clean("vc2tpu_torch.rdo, vc2tpu_torch.rdo.cbr")


def test_ld_and_decode_frame_imports_load_no_jax_or_vc2tpu():
    _imports_clean("vc2tpu_torch.slices.ld, vc2tpu_torch.cli.decode_frame")


def test_ld_encode_imports_load_no_jax_or_vc2tpu():
    _imports_clean("vc2tpu_torch.pipeline.ld, vc2tpu_torch.rdo.ld")


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        devices.resolve(None)
    assert devices.resolve("cpu") == torch.device("cpu")
    golden = os.path.join(ROOT, "tests", "golden", "constq_legall_d2.vc2")
    assert decode_stream.main([golden, os.devnull]) != 0
    packaged = os.path.join(ROOT, "tests", "golden",
                            "constq_legall_d2.packaged.raw")
    assert decode_frame.main(
        ["-x", "64", "-y", "32", "-f", "4:2:2", "-l", "10", "-k", "LeGall",
         "-d", "2", "-u", "1", "-a", "2", packaged, os.devnull]) != 0


def _config():
    return EncoderConfig(height=32, width=64,
                         chroma_format=ColourFormat.CF422,
                         kernel=WaveletKernel.LeGall, wavelet_depth=2,
                         y_size=1, x_size=2, luma_depth=10, chroma_depth=10,
                         q_index=20)


def test_encoder_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(_config())
    assert Encoder(_config(), device="cpu").device == torch.device("cpu")
    cbr_cfg = dataclasses.replace(_config(), mode=Mode.HQ_CBR, q_index=0,
                                  compressed_bytes=2048)
    with pytest.raises(RuntimeError, match="CUDA"):
        Encoder(cbr_cfg)
    src = os.path.join(ROOT, "tests", "golden", "tiny422.16p2")
    argv = ["-x", "64", "-y", "32", "-f", "4:2:2", "-l", "10", "-k",
            "LeGall", "-d", "2", "-u", "1", "-a", "2", src, os.devnull]
    assert encode_stream.main(["-m", "HQ_ConstQ", "-q", "20"] + argv) != 0
    assert encode_stream.main(["-m", "HQ_CBR", "-s", "2048"] + argv) != 0
    assert encode_stream.main(["-m", "LD", "-s", "2048"] + argv) != 0


def test_ld_encoder_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(_config(), mode=Mode.LD, q_index=0,
                              compressed_bytes=2048)
    with pytest.raises(RuntimeError, match="CUDA"):
        LDEncoder(cfg)
    assert LDEncoder(cfg, device="cpu").device == torch.device("cpu")


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to follow a wrapper's
    route on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda")


class _KernelReached(Exception):
    pass


def test_cuda_payload_never_takes_the_plain_ld_unpack(monkeypatch):
    """A CUDA payload reaching ``unpack_ld`` without a card raises (the
    kernel's outputs cannot be allocated, nor the kernel built); it never
    runs the plain version."""
    called = []
    monkeypatch.setattr(device_unpack, "unpack_ld_plain",
                        lambda *a: called.append(a))
    monkeypatch.setattr(device_unpack, "unpack_signed_streams",
                        lambda *a, **k: called.append(a))
    payload = torch.zeros(64, dtype=torch.uint8).as_subclass(_OnCuda)
    fields = torch.zeros((4, 3), dtype=torch.int32).as_subclass(_OnCuda)
    with pytest.raises(Exception):
        device_unpack.unpack_ld(payload, fields, 16, 8)
    assert not called


@pytest.mark.parametrize("entry", ["pack_hq", "quant_pack_hq",
                                   "cbr_quant_indices", "ld_rate_control",
                                   "quant_pack_ld", "quant_pack_ld_unkept"])
def test_cuda_lanes_never_take_the_plain_route(entry, monkeypatch):
    def plain(*_a, **_k):
        raise AssertionError(f"{entry} took the plain route for CUDA lanes")

    def kernel(*_a, **_k):
        raise _KernelReached

    monkeypatch.setattr(device_pack, "pack_hq_plain", plain)
    monkeypatch.setattr(device_pack, "quant_pack_hq_plain", plain)
    monkeypatch.setattr(device_pack, "launch_pack", kernel)
    monkeypatch.setattr(cbr, "cbr_quant_indices_plain", plain)
    monkeypatch.setattr(cbr, "bisect_plain", plain)
    monkeypatch.setattr(cbr, "launch_search", kernel)
    monkeypatch.setattr(rdo_ld, "ld_rate_control_plain", plain)
    monkeypatch.setattr(rdo_ld, "launch_rate", kernel)
    monkeypatch.setattr(device_pack, "pack_ld_plain", plain)
    monkeypatch.setattr(device_pack, "quant_pack_ld_plain", plain)
    monkeypatch.setattr(device_pack, "launch_ld_pack", kernel)
    lanes = [torch.zeros(shape, dtype=torch.int32).as_subclass(_OnCuda)
             for shape in ((4, 8), (4, 4), (4, 4), (4,))]
    qm = [torch.zeros(n, dtype=torch.int32).as_subclass(_OnCuda)
          for n in (8, 4)]
    assert lanes[0].device.type == "cuda"
    with pytest.raises(_KernelReached):
        if entry == "pack_hq":
            device_pack.pack_hq(*lanes, 0, 1)
        elif entry == "quant_pack_hq":
            device_pack.quant_pack_hq(*lanes, *qm, 0, 1, keep_lanes=True)
        elif entry == "cbr_quant_indices":
            cbr.cbr_quant_indices(*lanes[:3], *qm, lanes[3], 1)
        elif entry == "ld_rate_control":
            # 2 x 2 slices; a luma slice of one LL lane and 7 of one band
            rdo_ld.ld_rate_control(*lanes[:3], (0, 1), (1, 7), (1, 3),
                                   lanes[3], (2, 2), (1, 1), (1, 1))
        else:
            ll = [x[:, :1].contiguous() for x in lanes[:3]]
            device_pack.quant_pack_ld(*lanes[:3], ll, lanes[3], *qm,
                                      lanes[3],
                                      keep_lanes=entry == "quant_pack_ld")


def _boom(*_a, **_k):
    raise RuntimeError("kernel launch failed")


# the decode's lift is the band route's kernel (bands.inverse_lanes)
@pytest.mark.parametrize("module,name", [(bands, "inverse_lanes"),
                                         (device_unpack, "unpack_hq")],
                         ids=["lift_level", "unpack_hq"])
def test_kernel_error_propagates_from_fragments(module, name, monkeypatch,
                                                tmp_path):
    """A kernel failure in a fragmented picture's decode is not skipped as
    a corrupt picture (the JAX package skips any exception there): it
    propagates, and the CLI exits non-zero."""
    golden = os.path.join(ROOT, "tests", "golden", "cbr_fragmented.vc2")
    with open(golden, "rb") as f:
        data = f.read()
    monkeypatch.setattr(module, name, _boom)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        Decoder(sink=io.BytesIO(), device="cpu").run(data)
    assert decode_stream.main([golden, str(tmp_path / "out.16p2"),
                               "--device", "cpu"]) != 0


def test_build_needs_a_host_compiler(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="C\\+\\+"):
        build.cxx_path()


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


def test_libraries_are_keyed_by_their_shared_header(monkeypatch, tmp_path):
    """An edit of the decode core that both unpack kernels include changes
    both libraries' names, so a stale library is never loaded."""
    srcs = [device_unpack.kernel_source(), device_unpack.ld_kernel_source()]
    before = [build.library_path(s) for s in srcs]
    for s in srcs:
        assert os.path.join(build.CSRC, "golomb_decode.cuh") in \
            build.included_headers(s.path)
    for name in ("hq_unpack.cu", "ld_unpack.cu", "golomb_decode.cuh"):
        with open(os.path.join(build.CSRC, name)) as f:
            (tmp_path / name).write_text(f.read())
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    assert [build.library_path(s) for s in srcs] == before
    header = tmp_path / "golomb_decode.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = [build.library_path(s) for s in srcs]
    assert all(a != b for a, b in zip(after, before))


def test_encode_libraries_are_keyed_by_their_shared_header():
    """The code writer and quotient of csrc/golomb_encode.cuh are included
    by the four kernels that write or size codes, so they are hashed into
    each library's name."""
    header = os.path.join(build.CSRC, "golomb_encode.cuh")
    for src in (device_pack.kernel_source(), device_pack.ld_kernel_source(),
                rdo_ld.kernel_source(), cbr.kernel_source()):
        assert header in build.included_headers(src.path), src.name


def test_dc_libraries_are_keyed_by_their_shared_header():
    """The DC prediction's arithmetic, csrc/dc_predict.cuh, is included by
    the host recurrence and the card's wavefront, so it is hashed into
    both libraries' names."""
    header = os.path.join(build.CSRC, "dc_predict.cuh")
    for src in (ld.scan_source(), ld_dc.kernel_source()):
        assert header in build.included_headers(src.path), src.name


@pytest.mark.parametrize("case", ["sources", "generated_header",
                                  "host_source", "cbr_header"])
def test_libraries_are_keyed_by_source_hash(case):
    if case == "sources":
        srcs = [lifting.kernel_source(), build.Source("hq_unpack")]
    elif case == "cbr_header":
        # the CBR search with a changed table in its generated header
        src = cbr.kernel_source()
        (fname, text), = src.headers
        assert src.path.endswith("hq_cbr.cu") and fname == "hq_cbr_params.h"
        changed = text.replace("#define VC2_CBR_MAX_Q 119",
                               "#define VC2_CBR_MAX_Q 118")
        assert changed != text
        srcs = [src, build.Source(src.name, ((fname, changed),))]
    elif case == "host_source":
        srcs = [hq.scan_source(), device_pack.kernel_source()]
        assert srcs[0].path.endswith("hq_scan.cpp")
        assert srcs[1].path.endswith("hq_pack.cu")
    else:
        # the same .cu with a changed generated ladder header
        src = lifting.kernel_source()
        (fname, text), = src.headers
        changed = text.replace("Step<1, -1, 1, 1, 0, 1, 1, 1>",
                               "Step<1, -1, 1, 1, 0, 1, 1, 2>")
        assert changed != text
        srcs = [src, build.Source(src.name, ((fname, changed),))]
    paths = {build.library_path(s) for s in srcs}
    assert len(paths) == 2
    for p in paths:
        assert os.path.dirname(p) == build.BUILD_DIR
        assert os.path.basename(p).split("-")[1].split(".")[0].isalnum()


def test_shard_imports_load_no_jax_or_vc2tpu():
    _imports_clean("vc2tpu_torch.shard.mesh, vc2tpu_torch.shard.halo, "
                   "vc2tpu_torch.shard.multihost, vc2tpu_torch.shard.dryrun, "
                   "vc2tpu_torch.pipeline.sharded")


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    """A mesh takes one distinct card a position unless told otherwise:
    without a card it raises, with too few it raises the JAX package's
    error; the CPU fills any number of positions, and an explicit list may
    repeat a card."""
    from vc2tpu_torch.shard.mesh import make_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="mesh 1x2 needs more than 1 "
                                         "devices"):
        make_mesh(1, 2)
    assert make_mesh().devices == [[torch.device("cuda", 0)]]
    cpu = make_mesh(2, 4, device="cpu")
    assert cpu.shape == {"data": 2, "space": 4}
    assert cpu.distinct() == [torch.device("cpu")]
    shared = make_mesh(1, 4, devices=["cuda:0"] * 4)
    assert shared.row(0) == [torch.device("cuda", 0)] * 4


def test_multihost_harness_needs_a_card(monkeypatch, tmp_path):
    """The two-process harness runs on the card unless told otherwise:
    without one, ``launch`` and its command raise before any process
    starts."""
    from vc2tpu_torch.shard import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multihost.subprocess, "Popen", None)
    out = str(tmp_path / "mh.vc2")
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.launch(out)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.main([out])
    assert not os.path.exists(out)


def test_mesh_spec_is_shape_or_mesh(monkeypatch):
    """``--mesh`` takes ``DxS`` only; a program passes a ``Mesh``, which
    may repeat a card, as itself."""
    from vc2tpu_torch.shard.mesh import from_spec, make_mesh

    assert from_spec("2x4", "cpu").shape == {"data": 2, "space": 4}
    shared = make_mesh(1, 3, devices=["cuda:0"] * 3)
    assert from_spec(shared, "cpu") is shared
    with pytest.raises(ValueError):
        from_spec("1x3=cuda:0")


def _launch_calls(tree):
    """(line, inside a ``with devices.guard(...)`` block) of every
    ``_lib().<name>_launch(`` and ``_ld_lib().<name>_launch(`` call."""
    out = []

    def guarded(node):
        return isinstance(node, ast.With) and any(
            isinstance(i.context_expr, ast.Call)
            and isinstance(i.context_expr.func, ast.Attribute)
            and i.context_expr.func.attr == "guard"
            and isinstance(i.context_expr.func.value, ast.Name)
            and i.context_expr.func.value.id == "devices"
            for i in node.items)

    def visit(node, inside):
        inside = inside or guarded(node)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr.endswith("_launch")
                and isinstance(node.func.value, ast.Call)
                and isinstance(node.func.value.func, ast.Name)
                and node.func.value.func.id in ("_lib", "_ld_lib")):
            out.append((node.lineno, inside))
        for child in ast.iter_child_nodes(node):
            visit(child, inside)

    visit(tree, False)
    return out


def test_every_kernel_launch_goes_to_its_tensors_card():
    """Every kernel launch of the port sits in ``with devices.guard(t):``,
    so the ``<<<>>>`` inside it goes to the card that holds its tensors,
    not to the calling thread's current card."""
    found, bad = 0, []
    for path in _port_files():
        if os.sep + "vc2tpu_torch" + os.sep not in path:
            continue
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for line, inside in _launch_calls(tree):
            found += 1
            if not inside:
                bad.append(f"{path}:{line}")
    assert not bad, bad
    # lift, band x2, hq/ld unpack, hq/ld pack, cbr, ld x2, ld dc
    assert found == 11


def test_guard_is_the_tensors_card():
    assert isinstance(devices.guard(torch.zeros(1)),
                      type(devices.guard(torch.ones(2))))
    with devices.guard(torch.zeros(1)):
        pass

    class _Card1(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 1)

    g = devices.guard(torch.zeros(1).as_subclass(_Card1))
    assert isinstance(g, torch.cuda.device) and g.idx == 1
