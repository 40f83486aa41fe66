"""The port's multi-process paths on the CPU: two processes joined by gloo
on 127.0.0.1 (``vc2tpu_torch.shard.multihost.launch``, each process and
its process group under a 110 s limit) encode a frame each, or split one
1 x 4 row between them; process 0's stream, its fragment-streamed stream
and the two-process decode equal the single-device encoder's and
decoder's, and the halo lift over the split row equals the unsharded
lift. The global mesh's positions follow vc2tpu's process order, and the
stream parse that feeds the multi-process decode is held to vc2tpu's."""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch.distributed as dist

from vc2tpu.shard.multihost import collect_hq_payloads as j_collect
from vc2tpu.shard.multihost import make_global_mesh as j_global_mesh

from vc2tpu_torch.cli.decode_stream import Decoder
from vc2tpu_torch.core.config import Mode, WaveletKernel
from vc2tpu_torch.pipeline.encoder import Encoder
from vc2tpu_torch.pipeline.sharded import ShardedEncoder
from vc2tpu_torch.shard import halo, multihost
from vc2tpu_torch.shard.mesh import make_mesh
from vc2tpu_torch.wavelet import lifting

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


def test_a_flag_raises_after_the_gather(one_process_group):
    """A band whose pack sets a flag raises the single-device encoder's
    error, on every process after the bands' statuses are gathered."""
    cfg = dataclasses.replace(multihost.harness_config("tiny"),
                              mode=Mode.HQ_ConstQ, q_index=0,
                              compressed_bytes=0, x_size=8, y_size=2)
    pics = multihost.harness_frames(cfg, 1)
    with pytest.raises(ValueError) as want:
        Encoder(cfg, device="cpu").encode_picture(pics[0])
    mesh = multihost.make_global_mesh(data=1, space=2, device="cpu")
    with pytest.raises(ValueError, match=str(want.value)):
        multihost.MultiHostEncoder(cfg, mesh).encode_local_batch(pics)


@pytest.mark.parametrize("world,local,data,space", [
    (2, 2, 1, 4), (4, 1, 2, 2), (2, 2, 2, 2), (2, 3, 3, 2), (3, 2, 2, 3),
    (1, 8, 2, 4), (2, 4, None, None), (2, 4, 4, None)])
def test_global_mesh_positions_in_process_order(monkeypatch, world, local,
                                                data, space):
    """Position (d, s) belongs to process (d * space + s) // local, as the
    JAX package's reshape of every process's devices in process order
    gives it; each process's local mesh holds the rows it has a position
    in."""
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    mesh = multihost.make_global_mesh(data=data, space=space,
                                      devices=["cpu"] * local)
    d, s = mesh.shape["data"], mesh.shape["space"]
    assert d * s == world * local
    want = np.repeat(np.arange(world), local).reshape(d, s)
    assert mesh.owners == want.tolist()
    assert mesh.processes == [r[0] if len(set(r)) == 1 else None
                              for r in want.tolist()]
    for rank in range(world):
        lm = multihost.local_mesh(mesh, rank)
        rows = [r for r in range(d) if rank in want[r]]
        assert multihost.local_rows(mesh, rank) == rows
        assert lm.owners == [want[r].tolist() for r in rows]


def test_global_mesh_refuses_what_vc2tpu_refuses(monkeypatch):
    """1x4 over two processes of two devices gives owners [0, 0, 1, 1];
    2x2 over four of one device gives rows [0, 1] and [2, 3]; every shape
    of 8 devices in one process is taken or refused as vc2tpu's
    ``make_global_mesh`` takes or refuses it over the 8 virtual CPU
    devices; a shape that does not fit still raises."""
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    assert multihost.make_global_mesh(
        data=1, space=4, devices=["cpu"] * 2).owners == [[0, 0, 1, 1]]
    cpu = multihost.make_global_mesh(data=1, space=4, device="cpu")
    assert cpu.owners == [[0, 0, 1, 1]]
    with pytest.raises(ValueError, match="does not divide over 2"):
        multihost.make_global_mesh(data=1, space=3, device="cpu")
    with pytest.raises(ValueError, match="mesh 1x3 != 4 devices"):
        multihost.make_global_mesh(data=1, space=3, devices=["cpu"] * 2)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    assert multihost.make_global_mesh(
        data=2, space=2, devices=["cpu"]).owners == [[0, 1], [2, 3]]
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    import jax

    assert len(jax.devices()) == 8
    for data, space in [(1, 8), (2, 4), (4, 2), (8, 1), (3, None), (2, 3),
                        (1, 4), (16, None), (None, 8), (None, 4), (None,
                                                                  None)]:
        try:
            j = j_global_mesh(data, space)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                multihost.make_global_mesh(data, space, devices=["cpu"] * 8)
            continue
        got = multihost.make_global_mesh(data, space, devices=["cpu"] * 8)
        assert (got.shape["data"], got.shape["space"]) == j.devices.shape


def test_a_row_split_over_two_processes_matches_one_device(tmp_path):
    """Two gloo processes of two bands each hold one 1 x 4 row: the stream,
    the fragment-streamed stream and the decode equal one device's; in the
    same run the halo lift over the split row (every wavelet at depths
    1-3, the thinnest bands the JAX package takes and bands three times
    as high) equals ``lifting.forward_planes`` and ``inverse_planes``."""
    out = str(tmp_path / "row.vc2")
    logs = multihost.launch(out, world=2, device="cpu", space=4, data=1,
                            size="tiny", fragment_length=256, timeout=110,
                            check_halo=True)
    assert [ln.strip().splitlines()[-1] for ln in logs] == [
        "worker 0 done", "worker 1 done"]
    cfg = multihost.harness_config("tiny")
    encoded = [Encoder(cfg, device="cpu").encode_picture(
        multihost.harness_frames(cfg, 1)[0])]
    with open(out, "rb") as f:
        assert f.read() == multihost.harness_stream(cfg, encoded)
    frag = multihost.harness_stream(cfg, encoded, 256)
    with open(out + ".frag", "rb") as f:
        assert f.read() == frag
    sink = io.BytesIO()
    assert Decoder(sink=sink, device="cpu").run(frag) == 0
    with open(out + ".dec", "rb") as f:
        assert f.read() == sink.getvalue()
    bands = {}
    for rank in (0, 1):
        with np.load(f"{out}.halo{rank}.npz") as z:
            bands.update({k: z[k] for k in z.files})
    owners = {int(k.rsplit("_", 1)[1]) for k in bands}
    assert owners == {0, 1, 2, 3}
    cases = 0
    for kernel in WaveletKernel:
        if kernel == WaveletKernel.NullKernel:
            continue
        for depth in (1, 2, 3):
            planes = multihost.halo_planes(kernel, depth, 4)
            for x in planes:
                halo.check_rows(x.shape[0], 4, kernel, depth)

            def whole(p, kind):
                return np.concatenate([bands[f"{kernel.name}_{depth}_{p}_"
                                             f"{kind}_{s}"] for s in range(4)])
            fwd = lifting.forward_planes(planes, kernel, depth)
            inv = lifting.inverse_planes(fwd, kernel, depth)
            for p, (x, f, i) in enumerate(zip(planes, fwd, inv)):
                assert np.array_equal(whole(p, "f"), f.numpy())
                assert np.array_equal(whole(p, "i"), i.numpy())
                assert np.array_equal(whole(p, "i"), x.numpy())
                cases += 1
    assert cases == 42


def test_scaling_harness_runs():
    cfg = multihost.harness_config("tiny")
    fps = multihost.scaling_efficiency(cfg, make_mesh(2, 2, device="cpu"),
                                       n_frames=3)
    assert fps > 0
