"""The port stands alone: it imports neither jax nor vc2tpu, its entry
points run on the card unless asked for the CPU, and its kernels build only
from source with nvcc."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from vc2tpu_torch.cli import decode_stream
from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core import build
from vc2tpu_torch.core import device as devices
from vc2tpu_torch.wavelet import lifting

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


def test_import_loads_no_jax_or_vc2tpu():
    code = ("import sys, vc2tpu_torch, vc2tpu_torch.cli.decode_stream, "
            "vc2tpu_torch.pipeline.decoder\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'vc2tpu')]\n"
            "assert not bad, bad\n"
            "print('clean')")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_entry_points_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Decoder()
    with pytest.raises(RuntimeError, match="CUDA"):
        devices.resolve(None)
    assert devices.resolve("cpu") == torch.device("cpu")
    golden = os.path.join(ROOT, "tests", "golden", "constq_legall_d2.vc2")
    assert decode_stream.main([golden, os.devnull]) != 0


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


@pytest.mark.parametrize("case", ["sources", "generated_header"])
def test_libraries_are_keyed_by_source_hash(case):
    if case == "sources":
        srcs = [lifting.kernel_source(), build.Source("hq_unpack")]
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
