"""Device meshes for the multi-device paths.

Port of ``vc2tpu.shard.mesh``. A mesh is a (data, space) grid of torch
devices with two named axes:

* ``data``  — frame parallelism (an intra-only codec's frames are
  independent);
* ``space`` — row bands of one picture; the lifting DWT exchanges halo
  rows between neighbouring bands (``shard.halo``).

``make_mesh`` takes one distinct card a position by default. On the CPU
(``device="cpu"``) the one CPU device fills every position, the port's
counterpart of the virtual CPU devices the JAX package's tests run on. A
caller may pass an explicit device list that repeats a card (``[cuda:0] *
4``): the shards then share that card and its stream, which runs the mesh
paths on one card. Repeats are never chosen silently.
"""

from __future__ import annotations

import torch

from vc2tpu_torch.core import device as core_device

class Mesh:
    """A (data, space) grid of torch devices. ``shape`` is a dict, as the
    JAX package's ``mesh.shape["space"]``; ``devices[d][s]`` is the device
    of data row ``d``, row band ``s``. ``owners[d][s]`` is the process that
    holds position (d, s) (0 for a mesh of one process); only the owner's
    device is real."""

    def __init__(self, grid, owners=None):
        grid = [[torch.device(d) for d in row] for row in grid]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a mesh is a non-empty (data, space) grid")
        self.devices = grid
        self.shape = {"data": len(grid), "space": len(grid[0])}
        self.owners = ([list(r) for r in owners] if owners is not None
                       else [[0] * len(grid[0]) for _ in grid])
        if [len(r) for r in self.owners] != [len(r) for r in grid]:
            raise ValueError("a mesh's owners have its (data, space) shape")

    @property
    def processes(self) -> list:
        """The process of each data row where one process holds the whole
        row, else None."""
        return [r[0] if len(set(r)) == 1 else None for r in self.owners]

    @property
    def first(self) -> torch.device:
        """The device of position (0, 0): where a mesh path gathers what
        runs whole."""
        return self.devices[0][0]

    def row(self, d: int) -> list:
        return list(self.devices[d])

    def distinct(self) -> list:
        """The mesh's devices, each once, in mesh order."""
        out = []
        for row in self.devices:
            for d in row:
                if d not in out:
                    out.append(d)
        return out

    def __repr__(self) -> str:
        return (f"Mesh({self.shape['data']}x{self.shape['space']}, "
                f"{[[str(d) for d in r] for r in self.devices]})")


def from_spec(spec, device=None) -> Mesh:
    """The mesh of a ``--mesh`` argument: ``"DxS"`` is ``make_mesh(D, S,
    device=device)``; a ``Mesh`` is itself."""
    if isinstance(spec, Mesh):
        return spec
    d, s = (int(v) for v in spec.lower().split("x"))
    return make_mesh(d, s, device=device)


def make_mesh(data: int = 1, space: int | None = None, devices=None,
              device=None) -> Mesh:
    """A ``data`` x ``space`` mesh. ``devices`` (a list, repeats allowed)
    fills it in order; else ``device`` picks the kind: None or a CUDA device
    means the visible cards, one distinct card a position (RuntimeError
    without a card); ``"cpu"`` means the CPU device in every position.
    ``space`` defaults to the devices left per data row (1 on the CPU).
    Raises the JAX package's ValueError when there are too few devices."""
    devices = ([torch.device(d) for d in devices] if devices is not None
               else devices_of(device))
    if devices is None:                  # the CPU: as many as asked
        n = data * (1 if space is None else space)
        devices = [torch.device("cpu")] * max(n, 1)
    if space is None:
        space = len(devices) // data if data > 0 else 0
    if data < 1 or space < 1 or data * space > len(devices):
        raise ValueError(f"mesh {data}x{space} needs more than "
                         f"{len(devices)} devices")
    devices = devices[: data * space]
    return Mesh([devices[d * space:(d + 1) * space] for d in range(data)])


def devices_of(device=None):
    """The devices a default mesh takes for ``device``: the visible cards
    for a CUDA device (or None), None (any number) for the CPU."""
    dev = core_device.resolve(device)
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"no mesh of {dev.type} devices")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
