"""Sharding utilities: logical-axis constraints bound to a device mesh.

PyTorch counterpart of ``repro.distributed.shard`` over
``torch.distributed.device_mesh.DeviceMesh`` and DTensor. A spec is a
:class:`P`, one entry a tensor dimension, as the reference's
``PartitionSpec``: ``None`` leaves the dimension whole, a mesh axis name
shards it over that axis, and a tuple of names shards it over several
axes, the first the major part. :func:`placements` turns a spec into
DTensor placements, one a mesh dimension: an axis that shards dimension
``d`` becomes ``Shard(d)``, an unused axis ``Replicate()``.

Model code may call ``constrain(x, "data", None, "model")``: outside a mesh
(:func:`use_mesh`), and on any tensor that is not a DTensor, it returns
``x`` unchanged; on a DTensor under a mesh it redistributes it.

Axis conventions:
  "data"  — batch / FSDP axis (x pod axis when multi-pod)
  "model" — tensor/expert/sequence-parallel axis
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, NamedTuple, Optional, Sequence, Union

import torch

_state = threading.local()

Axis = Union[str, None, tuple]


class P(tuple):
    """A partition spec: ``P("data", None, ("data", "model"))``. A tuple of
    one name is that name, as in the reference's ``PartitionSpec``."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


class NamedSharding(NamedTuple):
    """A spec bound to a mesh, with its DTensor placements (the arguments
    ``distribute_tensor`` and ``redistribute`` take)."""

    mesh: Any
    spec: P
    placements: tuple


def placements(mesh, spec: P) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``. A dimension sharded over
    several axes takes them in the mesh's order (DTensor splits by the
    first mesh dimension first, so the first axis is the major part)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in
               (entry if isinstance(entry, tuple) else (entry,))]
        if idx != sorted(idx):
            raise ValueError(f"{entry!r} on dimension {d}: DTensor shards a "
                             f"dimension over mesh axes {names} in the "
                             "mesh's order only")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions of {spec!r}")
            out[i] = Shard(d)
    return tuple(out)


def current_mesh():
    return getattr(_state, "mesh", None)


def data_axes() -> tuple:
    """Mesh axes backing the logical 'data' axis (('pod','data') multi-pod)."""
    return getattr(_state, "data_axes", ("data",))


@contextlib.contextmanager
def use_mesh(mesh, data: Sequence[str] = ("data",)):
    prev = getattr(_state, "mesh", None)
    prev_data = getattr(_state, "data_axes", ("data",))
    _state.mesh = mesh
    _state.data_axes = tuple(data)
    try:
        yield
    finally:
        _state.mesh = prev
        _state.data_axes = prev_data


def resolve(*logical: Axis) -> P:
    """Map logical axis names to a spec under the active mesh."""
    out = []
    for ax in logical:
        if ax == "data":
            out.append(data_axes() if len(data_axes()) > 1 else data_axes()[0])
        else:
            out.append(ax)
    return P(*out)


def sharding(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec, placements(mesh, spec))


def named(mesh, *logical: Axis) -> NamedSharding:
    with use_mesh(mesh, data_axes()):
        return sharding(mesh, resolve(*logical))


def constrain(x: torch.Tensor, *logical: Axis) -> torch.Tensor:
    """``x`` redistributed to the logical axes if a mesh is active and ``x``
    is a DTensor; ``x`` itself otherwise."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, named(mesh, *logical).placements)


def round_robin_devices(n: int, devices: Optional[Sequence] = None) -> list:
    """Device assignment for ``n`` independent launches (e.g. one a
    distinct ``Topology`` of a multi-topology sweep): ``devices[i % D]``
    for launch ``i``, over the visible CUDA cards by default, so the
    launches spread over the cards instead of queueing on one. With one
    card every launch goes to ``cuda:0``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if not devices:
        raise ValueError("no devices visible")
    return [devices[i % len(devices)] for i in range(n)]
