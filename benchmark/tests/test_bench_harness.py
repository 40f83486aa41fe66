"""The harness on the CPU: every cell kind driven through the port's CLI at
a test's size (``--device cpu``), the faults that have to make ``correct``
false, the control, the refusal without a card, the look-up of every part
by name, and the imports no module may make."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import measure
import run
from control import Control
from tiny import BENCH, ROOT, config, drive, traffic


@pytest.mark.parametrize("cell,direction,mode,loop", [
    ("hq1080.decode", "decode", "HQ_CBR", "closed"),
    ("hq1080.encode", "encode", "HQ_CBR", "closed"),
    ("ld1080.decode", "decode", "LD", "closed"),
    ("hq1080.decode.live", "decode", "HQ_CBR", "paced"),
])
def test_cell_runs_correct(cell, direction, mode, loop):
    rc, result, err = drive(cell, direction, mode, loop=loop)
    assert rc == 0, err
    assert result["correct"] and result["failed"] == 0
    assert result["attempted"] > traffic(f"{direction}_closed")["warmup"]
    assert result["checks"]["sampled"]["value"] > 0
    names = set(result["metrics"])
    assert "setup_s" in names and len(names) >= 2
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")


def test_traced_run_reads_its_metrics():
    rc, result, err = drive("hq1080.decode", "decode", trace=1)
    assert rc == 0, err
    assert result["correct"]
    assert result["metrics"]["decode.host_scan_ms"]["value"] > 0
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result
    # no device on the CPU: the kernels' metrics find nothing and are left
    # out, never reported as 0
    assert "band_inverse_roofline" not in result["metrics"]


def _alter_words(monkeypatch):
    from vc2tpu_torch.cli import decode_stream

    real = decode_stream.synthesise_payload_to_words

    def altered(*args, **kwargs):
        words = real(*args, **kwargs).clone()
        words[len(words) // 2] ^= 1
        return words
    monkeypatch.setattr(decode_stream, "synthesise_payload_to_words", altered)


def _short_picture(monkeypatch):
    from vc2tpu_torch.cli import decode_stream

    real = decode_stream.synthesise_payload_to_words

    def short(*args, **kwargs):
        return real(*args, **kwargs)[1:]
    monkeypatch.setattr(decode_stream, "synthesise_payload_to_words", short)


def _stale_picture(monkeypatch):
    from vc2tpu_torch.cli.decode_stream import Decoder

    real = Decoder._emit_words
    last = {}

    def stale(self, words):
        out = last.get("words", words)
        last["words"] = words
        return real(self, out)
    monkeypatch.setattr(Decoder, "_emit_words", stale)


def _half_left_out(monkeypatch):
    from vc2tpu_torch.cli.decode_stream import Decoder

    real = Decoder._decode_picture
    count = {"n": 0}

    def half(self, job):
        count["n"] += 1
        if count["n"] % 2:
            return real(self, job)
    monkeypatch.setattr(Decoder, "_decode_picture", half)


def _encoder_handle(monkeypatch, change):
    from vc2tpu_torch.pipeline.encoder import Encoder

    real = Encoder.encode_picture_async
    state = {}

    def patched(self, picture):
        handle = real(self, picture)

        def result():
            enc = handle()
            return change(enc, state)
        return result
    monkeypatch.setattr(Encoder, "encode_picture_async", patched)


def _alter_payload(monkeypatch):
    def change(enc, state):
        p = bytearray(enc.payload)
        p[len(p) // 2] ^= 1
        enc.payload = bytes(p)
        return enc
    _encoder_handle(monkeypatch, change)


def _short_payload(monkeypatch):
    def change(enc, state):
        enc.payload = enc.payload[:-1]
        return enc
    _encoder_handle(monkeypatch, change)


def _stale_payload(monkeypatch):
    def change(enc, state):
        out = state.get("enc", enc)
        state["enc"] = enc
        return out
    _encoder_handle(monkeypatch, change)


def _half_written(monkeypatch):
    from vc2tpu_torch.stream.dataunit import StreamWriter

    real = StreamWriter.write_picture
    count = {"n": 0}

    def half(self, *args, **kwargs):
        count["n"] += 1
        if count["n"] % 2:
            return real(self, *args, **kwargs)
    monkeypatch.setattr(StreamWriter, "write_picture", half)


@pytest.mark.parametrize("direction,fault,number", [
    ("decode", _alter_words, "differ"), ("decode", _short_picture,
                                         "stray_bytes"),
    ("decode", _stale_picture, "differ"),
    ("decode", _half_left_out, "missing"),
    ("encode", _alter_payload, "differ"), ("encode", _short_payload,
                                           "differ"),
    ("encode", _stale_payload, "differ"),
    ("encode", _half_written, "missing")])
def test_fault_is_not_correct(direction, fault, number, monkeypatch):
    """The timed path broken underneath: an answer altered (or cut short)
    where it is made, a step that hands back its last state, half of the
    pictures left out. The run has to come out not correct, by the number
    named."""
    fault(monkeypatch)
    rc, result, err = drive(f"hq1080.{direction}", direction)
    assert rc == 0, err
    assert result["correct"] is False
    assert result["checks"][number]["value"] > 0


@pytest.mark.parametrize("direction", ["decode", "encode"])
def test_control_is_not_correct(direction):
    """The reference in float16 in the program's place fails the check."""
    cfg = config()
    cli = Control(cfg, traffic(f"{direction}_closed"), 2**31 + 5,
                  torch.device("cpu"))
    rc, result, err = drive(f"hq1080.{direction}", direction, cli_module=cli,
                            cfg=cfg)
    assert rc == 0, err
    assert result["correct"] is False
    assert result["checks"]["differ"]["value"] > 0


def test_refuses_without_a_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for where in (ROOT, _bare_copy(tmp_path)):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "hq1080.decode", "--seed", str(2**31 + 3), "--seconds", "1",
             "--trace", "0"], cwd=where, env=env, capture_output=True,
            text=True, timeout=300)
        assert p.returncode != 0
        assert p.stdout.strip() == ""


def _bare_copy(tmp_path) -> str:
    """A directory holding only BENCHMARK.json and the benchmark's files."""
    bare = tmp_path / "bare"
    shutil.copytree(BENCH, bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    return str(bare)


def test_parts_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a metric and a kernel count dropped
    into their folders are found by name, with no edit to another file."""
    bare = _bare_copy(tmp_path)
    bench = os.path.join(bare, "benchmark")
    with open(os.path.join(bare, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    shutil.copy(os.path.join(bench, "configs", "hq_cbr_1080p50.json"),
                os.path.join(bench, "configs", "new_cfg.json"))
    shutil.copy(os.path.join(bench, "traffic", "decode_closed.json"),
                os.path.join(bench, "traffic", "new_mix.json"))
    with open(os.path.join(bench, "metrics", "new.metric.py"), "w") as f:
        f.write("SPANS = {}\n\n\ndef read(run):\n    return 1.5\n")
    with open(os.path.join(bench, "kernels", "new_kernel.py"), "w") as f:
        f.write("def matches(name):\n    return name == 'k'\n\n\n"
                "def launches(run):\n    return 1\n\n\n"
                "def count(run):\n    return 1, 1\n")
    manifest["configs"].append({"name": "new_cfg", "source": "x",
                                "file": "benchmark/configs/new_cfg.json",
                                "reduced": [], "why": "x"})
    manifest["workloads"].append({"name": "new.cell", "config": "new_cfg",
                                  "traffic": "new_mix", "chips": 1,
                                  "why": "x"})
    with open(os.path.join(bare, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    monkeypatch.setattr(run, "ROOT", bare)
    monkeypatch.setattr(run, "HERE", bench)
    monkeypatch.setattr(measure, "HERE", bench)
    _m, cell, cfg, mix = run.cell_of("new.cell")
    assert cell["traffic"] == "new_mix" and cfg["name"] == "hq_cbr_1080p50"
    assert mix["direction"] == "decode"
    assert "new.metric" in measure.names("metrics")
    assert measure.load("metrics", "new.metric").read(None) == 1.5
    assert "new_kernel" in measure.names("kernels")
    assert measure.load("kernels", "new_kernel").count(None) == (1, 1)


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_forbidden_imports():
    """No module of the benchmark imports JAX or the JAX package, and none
    of the reference imports the program: top-level names compared whole
    (``vc2tpu_torch`` begins with ``vc2tpu``)."""
    for top, _dirs, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(top, f)
            names = _imports(path)
            assert not names & {"jax", "jaxlib", "flax", "vc2tpu"}, path
            if os.sep + "reference" + os.sep in path:
                assert "vc2tpu_torch" not in names, path


def test_manifest_parts_exist():
    """Every file a cell, a configuration or a metric of BENCHMARK.json
    needs is there, and every metric reader and kernel count has its
    functions."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in manifest["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    for m in manifest["per_layer"]:
        mod = measure.load("metrics", m["name"])
        assert callable(mod.read) and isinstance(mod.SPANS, dict)
    for k in measure.names("kernels"):
        mod = measure.load("kernels", k)
        assert callable(mod.matches) and callable(mod.count)


def test_encode_flags_state_the_coding():
    """The CLI flags of each configuration give the coding the reference
    codes (the port's own parser reads them)."""
    from vc2tpu_torch.cli import encode_stream

    for name in ("hq_cbr_1080p50", "ld_1080p50"):
        with open(os.path.join(BENCH, "configs", name + ".json")) as f:
            cfg = json.load(f)
        args = encode_stream.build_parser().parse_args(
            cfg["encode_flags"] + ["-", "-"])
        ec = encode_stream.config_from_args(args)
        c = cfg["coding"]
        assert (ec.width, ec.height, ec.luma_depth, ec.wavelet_depth) == (
            c["width"], c["height"], c["depth_bits"], c["wavelet_depth"])
        assert (ec.y_size, ec.x_size) == tuple(c["slice_units"])
        assert (ec.mode.value, ec.kernel.name, int(ec.frame_rate)) == (
            c["mode"], c["kernel"], c["frame_rate"])
        assert ec.compressed_bytes == c["compressed_bytes"]
        if c["mode"] == "HQ_CBR":
            assert (ec.slice_scalar, ec.slice_prefix) == (
                c["slice_scalar"], c["slice_prefix"])
        assert str(ec.chroma_format) == c["chroma"]
