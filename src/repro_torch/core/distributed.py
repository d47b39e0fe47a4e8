"""The blocked engine over a mesh of devices — the paper's future work
(§8: "spatial distribution of large stencils on multiple FPGAs"), as the
reference's ``core/distributed.py`` runs it on a TPU mesh.

The grid is cut into equal shards over the mesh's axes
(``axis_map[d]``: the mesh axes that split grid axis ``d``); each shard
runs the same combined spatial and temporal blocking locally
(``core/engine.py``), and halos ``rad * par_time`` wide are exchanged
**once a super-step**, so temporal blocking divides the exchanges by
``par_time``.  One process drives every shard (``launch/mesh.py`` says
why): an exchange hands each shard its neighbours' strips, a peer copy
where the two shards sit on two cards and a slice where they share one.

Correctness, as in the reference:
  * A shard extended by received halos is exact up to ``rad * par_time``
    cells from its extended edge — the overlapped-blocking argument one
    level up; the rim is dropped at write-back.
  * At the grid's true edges the shard passes ``bounds`` to the engine,
    which re-imposes the BC at the global edge, not the shard's, before
    every stage application; the zeros an edge shard receives there are
    never read.  A seam's bounds span the whole extended shard, so the
    engine re-imposes nothing there.
  * A periodic sharded axis exchanges on a ring that wraps: shard 0's
    leading halo is shard ``n-1``'s trailing strip.  Locally the axis
    becomes clamp under bounds that span the extended shard (a no-op);
    a local wrap would wrap the shard, not the grid.
  * Axes are exchanged in turn, each on the array the previous exchange
    extended, which is how the corner cells arrive.
  * The decomposition is a function of (mesh, grid shape) alone.

The reference's ``_superstep_stub`` (the dry run's stand-in for the Pallas
kernel) comes with its dry run (ROADMAP A17); each shard runs the engine,
not the streaming kernel (ROADMAP A15-kernel).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import boundary
from repro_torch.core.blocking import BlockGeometry
from repro_torch.core.engine import (blocked_superstep,
                                     blocked_superstep_chain,
                                     blocked_superstep_dag)
from repro_torch.core.stencils import Stencil
from repro_torch.programs import DagSpec, dag_radius
from repro_torch.resilience.faults import fault_point, register_point

#: fires at every halo exchange, before a strip moves: a failed peer copy
#: (the reference fires it when its exchange is traced, once a compiled
#: program; the port has nothing to trace)
FP_EXCHANGE = register_point(
    "distributed.exchange", "at every halo exchange, before a strip moves "
    "— models a failed peer copy")

#: exchanges since :func:`reset_exchange_counts`: ``state`` (one per sharded
#: axis a super-step, for a whole batch), ``aux`` (one per sharded axis a
#: run), and the bytes of the strips each kind handed between shards
EXCHANGES: Dict[str, int] = {"state": 0, "aux": 0, "state_bytes": 0,
                             "aux_bytes": 0}
_EXCHANGES_LOCK = threading.Lock()


def reset_exchange_counts() -> None:
    with _EXCHANGES_LOCK:
        for k in EXCHANGES:
            EXCHANGES[k] = 0


def _linear_index(coord: Dict[str, int], axis_names: Tuple[str, ...],
                  sizes: Dict[str, int]) -> int:
    """The shard index over (possibly several) mesh axes, row-major in
    their order in ``axis_names``."""
    idx = coord[axis_names[0]]
    for name in axis_names[1:]:
        idx = idx * sizes[name] + coord[name]
    return idx


def _axis_total(axis_names: Tuple[str, ...], sizes: Dict[str, int]) -> int:
    return math.prod(sizes[a] for a in axis_names)


def normalize_axis_map(axis_map) -> tuple:
    """One entry per grid axis: a tuple of mesh axis names or None (a bare
    string is one name)."""
    return tuple((a,) if isinstance(a, str) else tuple(a) if a else None
                 for a in axis_map)


def shard_extents(dims, axis_map, mesh) -> Tuple[int, ...]:
    """Each shard's extents; raises unless every sharded axis divides
    evenly, names only the mesh's axes, and no mesh axis splits two grid
    axes."""
    sizes = mesh.shape
    axis_map = normalize_axis_map(axis_map)
    if len(axis_map) != len(dims):
        raise ValueError(f"axis_map {axis_map} must have one entry per grid "
                         f"axis ({len(dims)})")
    used = [a for names in axis_map if names for a in names]
    unknown = sorted(set(used) - set(sizes))
    if unknown:
        raise ValueError(f"axis_map names {unknown}, not axes of the mesh "
                         f"{tuple(sizes)}")
    if len(set(used)) != len(used):
        raise ValueError(f"axis_map {axis_map} splits two grid axes over "
                         "one mesh axis")
    out = []
    for ax, (d, names) in enumerate(zip(dims, axis_map)):
        n = _axis_total(names, sizes) if names else 1
        if d % n:
            raise ValueError(f"grid axis {ax} (extent {d}) not divisible by "
                             f"its {n} mesh shards")
        out.append(d // n)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where each shard of a grid lives.  ``counts[d]``: shards along grid
    axis ``d``; ``local``: a shard's extents; ``devices``: shard coordinate
    -> the first device of the mesh (row-major) that holds it.  A mesh
    axis that no grid axis names replicates the shards along it; one
    controller computes each distinct shard once."""
    dims: Tuple[int, ...]
    axis_map: tuple
    counts: Tuple[int, ...]
    local: Tuple[int, ...]
    devices: Dict[Tuple[int, ...], torch.device]

    def slices(self, coord) -> tuple:
        return tuple(slice(c * ld, (c + 1) * ld)
                     for c, ld in zip(coord, self.local))


def shard_layout(dims, axis_map, mesh, halo: int = 0) -> ShardLayout:
    """The layout of a grid of ``dims`` split over ``mesh`` by
    ``axis_map``; raises where :func:`shard_extents` does, and where a
    shard is narrower than the ``halo`` its neighbours need of it."""
    axis_map = normalize_axis_map(axis_map)
    local = shard_extents(dims, axis_map, mesh)
    short = [ax for ax, names in enumerate(axis_map)
             if names and local[ax] < halo]
    if short:
        raise ValueError(
            f"shards of extent {[local[a] for a in short]} on grid axes "
            f"{short} are narrower than the halo {halo} (rad x par_time): "
            "use fewer shards or a smaller par_time")
    sizes = mesh.shape
    counts = tuple(_axis_total(names, sizes) if names else 1
                   for names in axis_map)
    devices: Dict[Tuple[int, ...], torch.device] = {}
    for pos in np.ndindex(mesh.devices.shape):
        coord = dict(zip(mesh.axis_names, pos))
        shard = tuple(_linear_index(coord, names, sizes) if names else 0
                      for names in axis_map)
        devices.setdefault(shard, mesh.devices[pos])
    return ShardLayout(tuple(dims), axis_map, counts, local, devices)


def scatter(x: torch.Tensor, layout: ShardLayout,
            lead: int = 0) -> Dict[tuple, torch.Tensor]:
    """The shards of ``x`` (``lead`` leading axes, never split), each on
    its device."""
    return {c: x[(slice(None),) * lead + layout.slices(c)].to(dev)
            for c, dev in layout.devices.items()}


def gather(shards: Dict[tuple, torch.Tensor], layout: ShardLayout,
           lead_shape: tuple, device) -> torch.Tensor:
    """The grid of ``shards`` on ``device``."""
    any_shard = next(iter(shards.values()))
    out = torch.empty(tuple(lead_shape) + layout.dims, dtype=any_shard.dtype,
                      device=device)
    for c, x in shards.items():
        out[(slice(None),) * len(lead_shape) + layout.slices(c)] = x
    return out


def _exchange_halo(shards: Dict[tuple, torch.Tensor], grid_axis: int,
                   axis: int, n: int, h: int, periodic: bool = False,
                   kind: str = "state") -> Dict[tuple, torch.Tensor]:
    """Extend every shard by ``h``-wide neighbour strips along tensor axis
    ``grid_axis`` (grid axis ``axis``, ``n`` shards along it).

    Neighbour ``i-1``'s trailing strip becomes shard ``i``'s leading halo
    and neighbour ``i+1``'s leading strip its trailing one.  Not periodic:
    the outermost shards receive zeros (the bounds re-imposition never
    reads them).  Periodic: the ring wraps."""
    fault_point(FP_EXCHANGE, {"axis": axis, "halo": h, "periodic": periodic})
    moved = 0
    out = {}
    for c, x in shards.items():
        i = c[axis]
        halos = []
        for src, lead in ((i - 1, False), (i + 1, True)):
            if not periodic and not 0 <= src < n:
                shape = list(x.shape)
                shape[grid_axis] = h
                halos.append(x.new_zeros(shape))
                continue
            y = shards[c[:axis] + (src % n,) + c[axis + 1:]]
            start = 0 if lead else y.shape[grid_axis] - h
            strip = y.narrow(grid_axis, start, h)
            moved += strip.numel() * strip.element_size()
            halos.append(strip.to(x.device))
        out[c] = torch.cat([halos[0], x, halos[1]], grid_axis)
    with _EXCHANGES_LOCK:
        EXCHANGES[kind] += 1
        EXCHANGES[f"{kind}_bytes"] += moved
    return out


def exchange(shards: Dict[tuple, torch.Tensor], layout: ShardLayout,
             h: int, kinds: Sequence[str], lead: int = 0,
             kind: str = "state") -> Dict[tuple, torch.Tensor]:
    """One exchange per sharded grid axis, in turn, each on the shards the
    previous one extended (the corners arrive)."""
    for ax, names in enumerate(layout.axis_map):
        if names:
            shards = _exchange_halo(shards, ax + lead, ax, layout.counts[ax],
                                    h, kinds[ax] == "periodic", kind)
    return shards


def _localize(bc_s, axis_map):
    """A stage's BC on a shard: a sharded periodic axis becomes clamp (its
    wrapped halo arrives by exchange)."""
    if bc_s is None:
        return None
    return dataclasses.replace(bc_s, kinds=tuple(
        "clamp" if (names and k == "periodic") else k
        for names, k in zip(axis_map, bc_s.kinds)))


def halo_width(stencil: Stencil, par_time: int, stages=None,
               dag: Optional[DagSpec] = None) -> int:
    """``rad * par_time``: ``rad`` the stencil's radius, a chain's summed
    stage radii, or a DAG's critical-path radius (its branches run side
    by side)."""
    if dag is not None:
        rad = dag_radius(dag)
    elif stages is not None:
        rad = sum(st.radius for st, _ in stages)
    else:
        rad = stencil.radius
    return rad * par_time


def build_distributed_fn(stencil: Stencil, dims, par_time: int, bsize,
                         mesh, axis_map, *, batch: bool = False,
                         aux_batched: bool = False, bc=None, stages=None,
                         dag: Optional[DagSpec] = None):
    """The runner ``fn(grid, aux, coeffs, iters) -> grid`` of ``iters``
    steps over ``mesh``, the grid split by ``axis_map`` (per grid axis,
    the mesh axes that split it, or None).

    ``coeffs``: one dict (one stage), or one per stage.  ``batch``: the
    grid carries a leading batch axis, never split; each super-step makes
    one exchange per sharded axis for the whole batch, and ``aux_batched``
    says whether the aux grid carries the batch axis too or is shared.
    ``bc``: the structural (stage 0's) BC, None for clamp.  ``stages``:
    the ``((stencil, bc), ...)`` chain of a program; ``dag``: the
    ``DagSpec`` of a DAG, whose ``(F, *shape)`` state keeps its field axis
    whole (one exchange carries every field).  The aux grid is read-only:
    its halo is exchanged once a run.  The result lands on the input
    grid's device, so a grid larger than one card is passed on the CPU."""
    nd = len(dims)
    if isinstance(bsize, int):
        bsize = (bsize,) * (nd - 1)
    h = halo_width(stencil, par_time, stages, dag)
    rad = h // par_time
    layout = shard_layout(dims, axis_map, mesh, h)
    axis_map = layout.axis_map
    kinds = boundary.kinds_of(bc, nd)
    if dag is not None:
        local_dag = DagSpec(
            stages=tuple((st, _localize(b, axis_map), refs)
                         for st, b, refs in dag.stages),
            n_fields=dag.n_fields, updates=dag.updates, topo=dag.topo)
        has_aux = any(st.has_aux for st, _, _ in dag.stages)
        n_fields = dag.n_fields
    elif stages is not None:
        local_stages = tuple((st, _localize(b, axis_map)) for st, b in stages)
        has_aux = any(st.has_aux for st, _ in stages)
        n_fields = 1
    else:
        bc_local = _localize(bc, axis_map)
        has_aux = stencil.has_aux
        n_fields = 1
    ext_dims = tuple(ld + (2 * h if names else 0)
                     for ld, names in zip(layout.local, axis_map))
    geom = BlockGeometry(nd, ext_dims, rad, par_time, tuple(bsize))
    lead = int(batch) + int(n_fields > 1)
    keep = (slice(None),) * lead + tuple(
        slice(h, h + ld) if names else slice(None)
        for names, ld in zip(axis_map, layout.local))

    def shard_bounds(c) -> tuple:
        out = []
        for ax, (names, ld) in enumerate(zip(axis_map, layout.local)):
            if names is None:
                out.append((0, ld - 1))
            elif kinds[ax] == "periodic":
                out.append((0, ld + 2 * h - 1))
            else:
                n = layout.counts[ax]
                out.append((h if c[ax] == 0 else 0,
                            h + ld - 1 if c[ax] == n - 1
                            else ld + 2 * h - 1))
        return tuple(out)

    bounds = {c: shard_bounds(c) for c in layout.devices}

    def step_local(ext, aux_ext, cf, steps, bd):
        if dag is not None:
            return blocked_superstep_dag(local_dag, geom, ext, cf, steps,
                                         aux_ext, bd)
        if stages is not None:
            return blocked_superstep_chain(local_stages, geom, ext, cf,
                                           steps, aux_ext, bd)
        return blocked_superstep(stencil, geom, ext, cf[0], steps, aux_ext,
                                 bd, bc_local)

    def run(grid: torch.Tensor, aux: Optional[torch.Tensor], coeffs,
            iters: int) -> torch.Tensor:
        cf = coeffs if isinstance(coeffs, tuple) else (coeffs,)
        iters = int(iters)
        shards = scatter(grid, layout, lead)
        aux_ext = None
        if has_aux:
            aux_lead = int(batch and aux_batched)
            aux_ext = exchange(scatter(aux, layout, aux_lead), layout, h,
                               kinds, aux_lead, kind="aux")
        for s in range(-(-iters // par_time)):
            steps = min(par_time, iters - s * par_time)
            ext = exchange(shards, layout, h, kinds, lead)
            shards = {c: step_local(e, aux_ext[c] if has_aux else None, cf,
                                    steps, bounds[c])[keep]
                      for c, e in ext.items()}
        return gather(shards, layout, tuple(grid.shape[:lead]), grid.device)

    return run


def distributed_run(stencil: Stencil, grid: torch.Tensor, coeffs: dict,
                    iters: int, par_time: int, bsize, mesh, axis_map,
                    aux: Optional[torch.Tensor] = None, *,
                    bc=None) -> torch.Tensor:
    """``iters`` steps of ``stencil`` on ``grid`` split over ``mesh``."""
    fn = build_distributed_fn(stencil, tuple(grid.shape), par_time, bsize,
                              mesh, axis_map, bc=bc)
    return fn(grid, aux, coeffs, iters)
