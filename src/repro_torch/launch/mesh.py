"""Device meshes (the reference's ``launch/mesh.py``): the ``distributed``
backend's, and the LM side's, on which ``launch/serve.py`` places
parameters and caches by ``parallel/sharding.py``'s rules and runs each
data shard and each expert-parallel shard of a MoE layer.

A :class:`Mesh` is single-controller, as a JAX ``Mesh`` is: an object array
of ``torch.device``\\ s with one name per axis, driven by one process that
holds every shard (``core/distributed.py``).  The reference's API is
``run(global grid) -> global grid``, so its runtime needs no process per
device; one card cannot hold two NCCL ranks, so a process group could not
run a halo exchange on one card at all; and the same code moves halos
between cards by peer copies when a machine has several.

A mesh named ``("data", "model")`` (or ``("pod", "data", "model")``)
serves the LM side (``parallel/sharding.py`` places on it, and its
``submesh`` is one data shard's view, the mesh a data shard's prefill or
decode step runs its MoE layers on).

``make_production_mesh`` (the reference's 256 TPU chips) serves only its
dry run (``launch/dryrun.py``) and comes with it (ROADMAP A17).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices``: an array of ``torch.device`` of the mesh's shape;
    ``axis_names``: one name per axis.  A device may appear more than once:
    its shards then run in turn on that device, which is how a mesh of
    logical shards on one card exercises the exchange."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"a {arr.ndim}D device array needs {arr.ndim} "
                             f"axis names, got {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"mesh axis names repeat: {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        types = sorted({d.type for d in arr.flat})
        if len(types) > 1:
            raise ValueError(f"a mesh's devices must be of one type; got "
                             f"{types}")
        self.devices = arr
        self.axis_names: Tuple[str, ...] = names

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in mesh order."""
        return tuple(dict.fromkeys(self.devices.flat))

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.distinct_devices)
        return f"Mesh({self.shape}, devices=[{devs}])"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` named ``axes`` over ``devices`` (row-major), by
    default every visible CUDA device, which must then number
    ``prod(shape)``.  ``devices`` may repeat an entry
    (``[torch.device("cuda", 0)] * 4`` is four logical shards on one
    card) and may name CPU devices (the tests' meshes); devices of two
    types are refused."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(tuple(axes)):
        raise ValueError(f"mesh shape {shape} and axes {tuple(axes)} differ "
                         "in length")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an axis under 1")
    n = math.prod(shape)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices= "
                               "(e.g. [torch.device('cpu')] * n)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if len(devices) != n:
            raise ValueError(
                f"mesh shape {shape} needs {n} devices and {len(devices)} "
                "CUDA devices are visible; pass devices= (an entry may "
                "repeat: logical shards on one card)")
    if len(devices) != n:
        raise ValueError(f"mesh shape {shape} needs {n} devices, got "
                         f"{len(devices)}")
    return Mesh(np.asarray(list(devices), dtype=object).reshape(shape), axes)


def dp_axes(mesh: Mesh) -> tuple:
    """The mesh's data-parallel axes: ``pod`` and ``data``, those it has."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)

