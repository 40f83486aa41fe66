"""The port's multi-process frame axis on the CPU: two processes joined by
gloo on 127.0.0.1 (``vc2tpu_torch.shard.multihost.launch``, each process
and its process group under a 110 s limit) encode a frame each; process
0's stream, its fragment-streamed stream and the two-process decode equal
the single-device encoder's and decoder's. The stream parse that feeds
the multi-process decode is held to vc2tpu's."""

import io
import os

import numpy as np
import pytest
import torch.distributed as dist

from vc2tpu.shard.multihost import collect_hq_payloads as j_collect

from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.pipeline.encoder import Encoder
from vc2tpu_torch.pipeline.sharded import ShardedEncoder
from vc2tpu_torch.shard import multihost
from vc2tpu_torch.shard.mesh import make_mesh

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("space", [1, 2])
def test_two_processes_match_one_device(tmp_path, space):
    out = str(tmp_path / "mh.vc2")
    logs = multihost.launch(out, world=2, device="cpu", space=space,
                            size="tiny", fragment_length=256, timeout=110)
    assert [ln.strip().splitlines()[-1] for ln in logs] == [
        "worker 0 done", "worker 1 done"]
    cfg = multihost.harness_config("tiny")
    enc = Encoder(cfg, device="cpu")
    encoded = [enc.encode_picture(p)
               for p in multihost.harness_frames(cfg, 2)]
    with open(out, "rb") as f:
        assert f.read() == multihost.harness_stream(cfg, encoded)
    frag = multihost.harness_stream(cfg, encoded, 256)
    with open(out + ".frag", "rb") as f:
        assert f.read() == frag
    sink = io.BytesIO()
    assert Decoder(sink=sink, device="cpu").run(frag) == 0
    with open(out + ".dec", "rb") as f:
        assert f.read() == sink.getvalue()


def test_a_failing_process_fails_the_run(tmp_path):
    """A process that fails (here on a device torch does not know) makes
    ``launch`` raise, and no process is left running."""
    with pytest.raises(RuntimeError, match="process 0 exited"):
        multihost.launch(str(tmp_path / "x.vc2"), world=2, device="nodev",
                         timeout=60)


@pytest.mark.parametrize("case", ["cbr_fragmented", "cbr_legall_d2",
                                  "constq_interlaced"])
def test_collect_hq_payloads_matches_vc2tpu(case):
    with open(os.path.join(GOLDEN, f"{case}.vc2"), "rb") as f:
        stream = f.read()
    hdr, items = multihost.collect_hq_payloads(stream)
    jhdr, jitems = j_collect(stream)
    assert (hdr.width, hdr.height, hdr.bitdepth) == (
        jhdr.width, jhdr.height, jhdr.bitdepth)
    assert len(items) == len(jitems) > 0
    for (n, pre, pay), (jn, jpre, jpay) in zip(items, jitems):
        assert n == jn
        assert (pre.slices_x, pre.slices_y, pre.slice_prefix,
                pre.slice_size_scalar, int(pre.wavelet_kernel), pre.depth) \
            == (jpre.slices_x, jpre.slices_y, jpre.slice_prefix,
                jpre.slice_size_scalar, int(jpre.wavelet_kernel), jpre.depth)
        assert np.array_equal(pay, jpay)


@pytest.fixture
def one_process_group():
    multihost.init_distributed(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                               timeout=60)
    yield
    dist.destroy_process_group()


def test_one_process_group(one_process_group):
    """In a group of one: the gather is the identity, the global mesh's
    rows are this process's, a space row asked of more devices than a
    process has is refused, and the multi-process encoder and decoder
    equal the sharded ones."""
    assert multihost.all_gather_bytes(b"vc2") == [b"vc2"]
    assert multihost.all_gather_bytes(b"") == [b""]
    mesh = multihost.make_global_mesh(data=2, space=2, device="cpu")
    assert mesh.shape == {"data": 2, "space": 2}
    assert mesh.processes == [0, 0]
    with pytest.raises(ValueError, match="!= 2 devices"):
        multihost.make_global_mesh(data=1, space=4, devices=["cpu"] * 2)
    cfg = multihost.harness_config("tiny")
    pics = multihost.harness_frames(cfg, 2, seed=3)
    got = multihost.MultiHostEncoder(cfg, mesh).encode_local_batch(pics)
    want = ShardedEncoder(cfg, make_mesh(2, 2, device="cpu")).encode_batch(
        pics)
    for g, w in zip(got, want, strict=True):
        assert g.payload == w.payload
        assert np.array_equal(g.q_indices, w.q_indices)
    _hdr, items = multihost.collect_hq_payloads(
        multihost.harness_stream(cfg, got))
    g = cfg.geometry
    frames = multihost.MultiHostDecoder(
        cfg.kernel, 2, multihost.MultiHostEncoder(cfg, mesh).enc.geo,
        devices=["cpu"] * 4).decode_pictures(
        [(n, p) for n, _pre, p in items], 0, 1,
        (g.luma_height, g.luma_width), (g.chroma_height, g.chroma_width))
    enc = Encoder(cfg, device="cpu")
    for planes, pic in zip(frames, pics, strict=True):
        dec = enc.decode_inprocess(enc.encode_picture(pic, keep_planes=True),
                                   g)
        for a, b in zip(planes, (dec.y, dec.c1, dec.c2)):
            assert np.array_equal(a, b)


def test_a_space_row_across_processes_is_refused(monkeypatch):
    """Two processes of two devices each cannot hold a 1 x 4 row: the halo
    exchange across processes is not ported."""
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    with pytest.raises(ValueError, match="span processes"):
        multihost.make_global_mesh(data=1, space=4, devices=["cpu"] * 2)
    mesh = multihost.make_global_mesh(data=2, space=2, devices=["cpu"] * 2)
    assert mesh.processes == [0, 1]
    assert multihost.local_mesh(mesh, 1).shape == {"data": 1, "space": 2}


def test_scaling_harness_runs():
    cfg = multihost.harness_config("tiny")
    fps = multihost.scaling_efficiency(cfg, make_mesh(2, 2, device="cpu"),
                                       n_frames=3)
    assert fps > 0
