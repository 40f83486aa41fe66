"""The port's one-picture encode pipeline on the CPU: the encode CLI
(``--device cpu``) against ``vc2tpu.cli.encode_stream.main`` on the
multi-picture goldens (ConstQ, CBR with fragments, interlaced) and on a
seeded stream whose middle frame trips a pack flag (the exit code, the
error line and the bytes written before it); and
``Encoder.encode_picture_async`` handles, resolved in order, against
``encode_picture``."""

import contextlib
import io
import json
import os

import numpy as np
import pytest

from vc2tpu.cli import encode_stream as j_enc

from vc2tpu_torch.cli import encode_stream
from vc2tpu_torch.core.config import (ColourFormat, EncoderConfig, Mode,
                                      WaveletKernel)
from vc2tpu_torch.core.picture import Picture
from vc2tpu_torch.pipeline.encoder import Encoder

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    META = json.load(_f)
CASES = {c[0]: c for c in META["cases"]}


def _run(main, argv, out):
    """(exit code, stdout, output bytes)."""
    so = io.StringIO()
    with contextlib.redirect_stdout(so), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = main(argv)
    data = b""
    if os.path.exists(out):
        with open(out, "rb") as f:
            data = f.read()
    return rc, so.getvalue(), data


def _both(argv, src, tmp_path):
    """The JAX CLI's and the port's run of ``argv`` on ``src``."""
    jout, tout = str(tmp_path / "jax.vc2"), str(tmp_path / "port.vc2")
    want = _run(j_enc.main, argv + [src, jout], jout)
    got = _run(encode_stream.main, argv + ["--device", "cpu", src, tout],
               tout)
    return got, want


@pytest.mark.parametrize("case", ["constq_legall_d2", "cbr_fragmented",
                                  "constq_interlaced"])
def test_pipelined_goldens_match_vc2tpu(case, tmp_path):
    """Two frames of tiny422 (four pictures interlaced), through the
    pipelined loop: the bytes equal the golden and the JAX CLI's."""
    _c, inp, extra = CASES[case]
    m = META["inputs"][inp]
    assert m["frames"] == 2
    argv = ["-x", str(m["width"]), "-y", str(m["height"]), "-f", m["fmt"],
            "-l", str(m["depth"]), "-n", "2"] + list(extra)
    got, want = _both(argv, os.path.join(GOLDEN, f"{inp}.16p2"), tmp_path)
    assert got == want
    assert got[0] == 0
    with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
        assert got[2] == f.read()


def _flagged_input(path, seed=11):
    """Three 64x32 4:2:2 10-bit frames: flat, seeded noise, flat. At -q 0
    with slices of 32 x 8 luma samples only the noise overflows a slice
    component's length byte (the pack's FLAG_SCALAR)."""
    rng = np.random.default_rng(seed)
    frames = []
    for k in range(3):
        if k == 1:
            y = rng.integers(0, 1024, (32, 64))
            c = rng.integers(0, 1024, (2, 32, 32))
        else:
            y = np.full((32, 64), 512)
            c = np.full((2, 32, 32), 512)
        frames += [y.ravel(), c.ravel()]
    with open(path, "wb") as f:
        f.write(np.concatenate(frames).astype(">u2").tobytes())


@pytest.mark.parametrize("mode", [["-m", "HQ_ConstQ", "-q", "0"],
                                  ["-m", "HQ_CBR", "-s", "40000"]],
                         ids=["constq", "cbr"])
def test_an_error_mid_stream_matches_vc2tpu(mode, tmp_path, monkeypatch):
    """Frame 1 trips a flag: both CLIs exit 1 with the same error line,
    one picture later, with frame 0 written (and the same bytes). The JAX
    CLI runs its device route: its ConstQ auto route resolves its second
    picture at once to time the TPU's link against its host encoder, a
    probe the port does not have."""
    monkeypatch.setenv("VC2TPU_ENCODE_ROUTE", "device")
    src = str(tmp_path / "in.16p2")
    _flagged_input(src)
    argv = ["-x", "64", "-y", "32", "-f", "4:2:2", "-l", "10", "-n", "2",
            "-k", "LeGall", "-d", "2", "-u", "2", "-a", "8", "-S", "1"] + mode
    got, want = _both(argv, src, tmp_path)
    assert got == want
    assert got[0] == 1 and got[1].startswith("Error: ")
    assert got[2]                     # the sequence header and frame 0


def _pictures(cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    g = cfg.geometry
    return [Picture(rng.integers(-512, 512, (g.luma_height, g.luma_width)),
                    rng.integers(-512, 512, (g.chroma_height, g.chroma_width)),
                    rng.integers(-512, 512, (g.chroma_height, g.chroma_width)),
                    cfg.chroma_format) for _ in range(n)]


@pytest.mark.parametrize("mode", [Mode.HQ_ConstQ, Mode.HQ_CBR])
def test_async_handles_equal_encode_picture(mode):
    """Several distinct pictures dispatched before any handle is resolved,
    then resolved in order, equal ``encode_picture`` of each."""
    cfg = EncoderConfig(height=32, width=64, chroma_format=ColourFormat.CF422,
                        kernel=WaveletKernel.DD97, wavelet_depth=2, y_size=1,
                        x_size=2, mode=mode, luma_depth=10, chroma_depth=10,
                        q_index=12, compressed_bytes=3000)
    pics = _pictures(cfg, 4)
    enc = Encoder(cfg, device="cpu")
    handles = [enc.encode_picture_async(p) for p in pics]
    for h, p in zip(handles, pics):
        got, want = h(), enc.encode_picture(p)
        assert got.payload == want.payload
        assert np.array_equal(got.slice_totals, want.slice_totals)
        assert np.array_equal(got.q_indices, want.q_indices)
    assert len({h().payload for h in handles}) == len(pics)
