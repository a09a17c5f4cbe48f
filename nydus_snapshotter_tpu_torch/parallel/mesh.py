"""The device mesh of the conversion data plane: an ordered list of devices.

Counterpart of the reference's parallel/mesh.py. The reference's mesh is
single-controller: one process drives every device through a
``jax.sharding.Mesh`` and its ``shard_map`` bodies exchange data with
``all_gather``, ``psum`` and ``all_to_all``. Here one process holds a
:class:`Mesh` of torch devices; a sharded array is a list with one tensor
per shard, on that shard's device, and the three collectives are plain
functions over such lists whose every transfer is a copy to the target
shard's device (peer-to-peer between cards, a copy within one). No process
group is involved: ``torch.distributed`` carries only the multi-host
rendezvous of parallel/multihost.py, as ``jax.distributed`` does there.

A mesh may name one device more than once: ``["cpu"] * 8`` is the
counterpart of the reference tests' eight virtual CPU devices, and
``["cuda:0"] * 8`` eight logical shards on one card.

- axis ``data`` — shards of the window and chunk batches (batch parallelism)
- axis ``dict`` — shards of the chunk dictionary, on the same devices
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.tensors import resolve_device

AXIS_DATA = "data"
AXIS_DICT = "dict"


class Mesh:
    """An ordered 1-D mesh of torch devices; shard ``i`` lives on
    ``devices[i]``."""

    def __init__(self, devices: Sequence["str | torch.device"]):
        if not len(devices):
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(resolve_device(d) for d in devices)

    @property
    def shape(self) -> dict[str, int]:
        return {AXIS_DATA: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: "int | None" = None, devices=None) -> Mesh:
    """A 1-D mesh over every visible CUDA device (or the first n), or over
    ``devices`` when given.

    With ``n_devices`` unset, the ``[mesh] devices`` knob (env
    ``NTPU_MESH_DEVICES``) caps the mesh width; 0 keeps every device.
    Without ``devices`` the card is required: no CUDA raises, never a
    fallback to the CPU.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass devices=['cpu'] * n to build a "
                "mesh on the host"
            )
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = list(devices)
    if n_devices is None:
        from nydus_snapshotter_tpu_torch.ops.mesh_pack import resolve_mesh_config

        cap = resolve_mesh_config().devices
        if cap:
            devs = devs[: min(cap, len(devs))]
    else:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(devs)


def _tensor(array) -> torch.Tensor:
    if isinstance(array, torch.Tensor):
        return array
    arr = np.ascontiguousarray(array)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _split(t: torch.Tensor, n: int, what: str) -> list[torch.Tensor]:
    if t.shape[0] % n:
        raise ValueError(f"{what}: leading axis {t.shape[0]} does not split over {n} shards")
    k = t.shape[0] // n
    return [t[i * k : (i + 1) * k] for i in range(n)]


def shard_rows(array, mesh: Mesh) -> list[torch.Tensor]:
    """Split the leading axis evenly over the shards (the reference's
    ``data_sharding``): one tensor per shard, on its device."""
    parts = _split(_tensor(array), mesh.size, "shard_rows")
    return [p.to(dev, copy=True) for p, dev in zip(parts, mesh.devices)]


def replicate(array, mesh: Mesh) -> list[torch.Tensor]:
    """One whole copy per shard (the reference's ``replicated``)."""
    t = _tensor(array)
    return [t.to(dev, copy=True) for dev in mesh.devices]


def all_gather(parts: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Tiled all_gather over axis 0: every shard receives the
    concatenation of all shards' parts."""
    return [torch.cat([p.to(dev) for p in parts]) for dev in mesh.devices]


def all_to_all(parts: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """Tiled all_to_all, split and concat on axis 0: shard ``i`` splits its
    part into ``n`` pieces and sends piece ``j`` to shard ``j``, which
    concatenates the pieces it receives in source order."""
    n = mesh.size
    pieces = [_split(p, n, f"all_to_all shard {i}") for i, p in enumerate(parts)]
    return [
        torch.cat([pieces[i][j].to(dev) for i in range(n)])
        for j, dev in enumerate(mesh.devices)
    ]


def sum_shards(parts: list[torch.Tensor], device: "torch.device | None" = None) -> torch.Tensor:
    """Elementwise sum of the shards' parts on ``device`` (default: the
    first part's): the reference's psum, read on one device."""
    dev = parts[0].device if device is None else device
    out = parts[0].to(dev, copy=True)
    for p in parts[1:]:
        out += p.to(dev)
    return out
