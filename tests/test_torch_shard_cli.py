"""``--mesh DxS`` on the port's two CLIs (``--device cpu``, the CPU mesh)
against vc2tpu's CLIs with ``--mesh`` on the 8 virtual CPU devices of
tests/conftest.py: the bytes, the exit code, the error and the stderr line
of each fallback; and every golden encoded and decoded over a mesh."""

import contextlib
import io
import json
import os

import pytest

from vc2tpu.cli import decode_stream as j_dec
from vc2tpu.cli import encode_stream as j_enc

from vc2tpu_torch.cli import decode_stream, encode_stream

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(GOLDEN, "meta.json")) as _f:
    META = json.load(_f)
CASES = {c[0]: c for c in META["cases"]}
# goldens whose bands are thinner than the JAX package's halo on a mesh
THIN = {"1x4": ("constq_dd97_d3", "constq_dd137_d2", "cbr_interlaced",
                "constq_extreme_fidelity")}


def _encode_argv(case):
    _c, inp, extra = CASES[case]
    m = META["inputs"][inp]
    return (["-x", str(m["width"]), "-y", str(m["height"]), "-f", m["fmt"],
             "-l", str(m["depth"]), "-n", "2"] + list(extra),
            os.path.join(GOLDEN, f"{inp}.16p2"))


def _run(main, argv, out):
    """(exit code, stdout, the mesh lines of stderr, output bytes)."""
    so, se = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
        rc = main(argv)
    lines = [ln for ln in se.getvalue().splitlines()
             if ln.startswith(("mesh decode:", "--mesh:", "Failed"))]
    data = b""
    if os.path.exists(out):
        with open(out, "rb") as f:
            data = f.read()
    return rc, so.getvalue(), lines, data


# (name, CLI, golden case, extra argv, mesh)
RUNS = [
    ("encode_cbr_fragmented", "encode", "cbr_fragmented", [], "1x8"),
    ("decode_cbr_fragmented", "decode", "cbr_fragmented", [], "1x8"),
    ("decode_ld_legall_d2", "decode", "ld_legall_d2", [], "1x8"),
    # the fallbacks: slice rows that do not divide, LD planes that do not
    # divide, an HQ encode that cannot shard, outputs with no mesh path
    ("decode_indivisible", "decode", "constq_legall_d2", [], "1x3"),
    ("decode_thin_bands", "decode", "constq_dd97_d3", [], "1x4"),
    ("decode_ld_indivisible", "decode", "ld_interlaced", [], "1x8"),
    ("encode_indivisible", "encode", "constq_legall_d2", [], "1x3"),
    ("encode_ld_indivisible", "encode", "ld_legall_d2", [], "1x3"),
    ("encode_packaged", "encode", "constq_legall_d2", ["-o", "Packaged"],
     "1x2"),
    ("decode_transform", "decode", "constq_legall_d2", ["-o", "Transform"],
     "1x2"),
]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """vc2tpu's CLIs on every run of RUNS."""
    d = tmp_path_factory.mktemp("jax_mesh")
    out = {}
    for name, cli, case, extra, mesh in RUNS:
        path = str(d / name)
        out[name] = _run(*_argv(cli, case, extra, mesh, path, jax=True),
                         path)
    return out


def _argv(cli, case, extra, mesh, path, jax=False):
    if cli == "encode":
        argv, src = _encode_argv(case)
        main = j_enc.main if jax else encode_stream.main
        argv = argv + extra + [src, path]
    else:
        main = j_dec.main if jax else decode_stream.main
        argv = extra + [os.path.join(GOLDEN, f"{case}.vc2"), path]
    argv += ["--mesh", mesh]
    if not jax:
        argv += ["--device", "cpu"]
    return main, argv


@pytest.mark.parametrize("name,cli,case,extra,mesh", RUNS,
                         ids=[r[0] for r in RUNS])
def test_mesh_cli_matches_vc2tpu(jax_runs, tmp_path, name, cli, case, extra,
                                 mesh):
    path = str(tmp_path / name)
    got = _run(*_argv(cli, case, extra, mesh, path), path)
    want = jax_runs[name]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    # every run writes bytes but the one whose pictures are all skipped
    assert bool(got[3]) == (want[0] == 0 and name != "decode_thin_bands")


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_goldens_over_a_mesh(case, mesh, tmp_path):
    """Every golden, encoded and decoded over the mesh, byte for byte, where
    its geometry shards (an HQ encode whose slice rows do not divide, or
    whose bands are thinner than the JAX package's halo, exits 1 with the
    JAX package's error, as its CLI does)."""
    argv, src = _encode_argv(case)
    out = str(tmp_path / "out.vc2")
    rc, stdout, _lines, data = _run(
        encode_stream.main, argv + ["--device", "cpu", "--mesh", mesh,
                                    src, out], out)
    with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
        ref = f.read()
    if rc:
        assert stdout in ("Error: y_slices must divide by the space mesh "
                          "extent\n",
                          "Error: row shard too small for this kernel's "
                          "halo\n"), stdout
    else:
        assert data == ref
    dec = str(tmp_path / "out.16p2")
    rc, stdout, _lines, data = _run(
        decode_stream.main, [os.path.join(GOLDEN, f"{case}.vc2"), dec,
                             "--device", "cpu", "--mesh", mesh], dec)
    with open(os.path.join(GOLDEN, f"{case}.dec.16p2"), "rb") as f:
        want = f.read()
    # a picture whose bands are too thin is skipped, as the JAX package's
    # decoder skips it
    assert rc == 0
    assert data == (b"" if case in THIN.get(mesh, ()) else want)
