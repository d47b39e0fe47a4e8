"""Logical-axis sharding rules (MaxText-style), applied through an ambient
context, and the placement of tensors on a single-controller mesh.

Models name the axes of their parameters, caches and activations with
*logical* names; a :class:`ShardingRules` table maps those to the axes of
a ``launch/mesh.py`` :class:`~repro_torch.launch.mesh.Mesh`.  The rules
and :func:`resolve_spec` (its divisibility fallback, "first dim wins")
are the reference's (``repro.parallel.sharding``), so a leaf splits over
the same mesh axes in both packages.

Default logical axes:
  batch      -> ('pod', 'data')   data parallel
  seq        -> None              (or 'model' for sequence parallelism)
  heads/ff/vocab/experts -> 'model'   tensor/expert parallel
  kv_seq     -> 'model'           context-parallel decode (KV cache on seq)
  wt_fsdp    -> 'data'            ZeRO-3 weight shard (gathered per layer)
  layers     -> None              scan-stacked leading dim

The port has no GSPMD.  One process drives every shard (as
``core/distributed.py`` does), so a JAX ``device_put(tree,
NamedSharding)`` becomes :func:`shard_tree`: each leaf becomes a
:class:`Sharded`, one piece per distinct shard coordinate on the first
device of the mesh (row-major) that holds it; a mesh axis that the spec
leaves out replicates the leaf, and one piece serves the whole axis.
Where a piece's device is its source's, the piece is a view of the
source, not a copy.  :func:`gather_tree` rebuilds whole tensors.
``with_sharding_constraint`` changes no value, so :func:`logical_shard`
returns its input unchanged under any rules: it is kept for the API.

Under autograd a gather (:meth:`Sharded.region`) is differentiable: its
backward sends each piece's slice of the gradient to the piece's device
(:class:`_Gather`), so where several data shards gather a piece, autograd
sums their slices there (the reduce-scatter of ZeRO-3).  The pieces are
the autograd leaves of a placed tree (:func:`pieces_of`), and
:func:`map_pieces` builds the optimizer's trees piece by piece, each
placed like the parameter it belongs to.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AxisVal = Union[None, str, Tuple[str, ...]]


def _entry(v) -> AxisVal:
    """A spec entry as the reference's ``PartitionSpec`` stores it: a list
    becomes a tuple and a tuple of one name that name."""
    if isinstance(v, (list, tuple)):
        v = tuple(v)
        return v[0] if len(v) == 1 else v
    return v


class PartitionSpec(tuple):
    """One entry a dim: ``None`` (not split), a mesh axis name, or a tuple
    of names (split over their product, row-major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def names_of(v: AxisVal) -> Tuple[str, ...]:
    """The mesh axis names of a spec entry."""
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


class ShardingRules(dict):
    """logical axis name -> mesh axis (str | tuple | None)."""

    def spec(self, logical_axes: Sequence[Optional[str]]) -> PartitionSpec:
        return P(*(self.get(ax) if ax is not None else None
                   for ax in logical_axes))


def default_rules(multi_pod: bool = False, fsdp_over_pod: bool = False,
                  seq_parallel: bool = False) -> ShardingRules:
    dp = ("pod", "data") if multi_pod else ("data",)
    fsdp = (("pod", "data") if (multi_pod and fsdp_over_pod) else ("data",))
    return ShardingRules(
        batch=dp,
        seq="model" if seq_parallel else None,
        moe_seq="model",
        heads="model",
        kv_heads="model",
        kv_seq="model",
        d_model=None,
        ff="model",
        vocab="model",
        experts="model",
        wt_fsdp=fsdp,
        layers=None,
        stage=None,
    )


class _State(threading.local):
    rules: Optional[ShardingRules] = None
    mesh = None


_STATE = _State()


@contextlib.contextmanager
def use_sharding_rules(mesh, rules: ShardingRules):
    """Make ``(mesh, rules)`` what :func:`current_rules` returns inside the
    block (per thread)."""
    prev = (_STATE.rules, _STATE.mesh)
    _STATE.rules, _STATE.mesh = rules, mesh
    try:
        yield
    finally:
        _STATE.rules, _STATE.mesh = prev


def current_rules():
    """``(mesh, rules)``, both ``None`` outside :func:`use_sharding_rules`."""
    return _STATE.mesh, _STATE.rules


def logical_spec(*logical_axes) -> Optional[PartitionSpec]:
    _, rules = current_rules()
    if rules is None:
        return None
    return rules.spec(logical_axes)


def axis_size(mesh, v: AxisVal) -> int:
    """The number of shards a spec entry makes on ``mesh``."""
    return math.prod(mesh.shape[name] for name in names_of(v))


def resolve_spec(shape, logical_axes, mesh, rules: ShardingRules
                 ) -> PartitionSpec:
    """Spec with per-dim divisibility fallback: a logical axis whose mesh
    extent does not divide the dim is replicated (e.g. GQA kv=2 heads on a
    16-way 'model' axis). A mesh axis consumed by an earlier dim is not
    reused (first dim wins): two logical axes may share a mesh axis in the
    rules (e.g. kv_seq and kv_heads both -> 'model'), and usually at most one
    survives the divisibility check — when both do, the later is replicated."""
    out = []
    used: set = set()
    for dim, ax in zip(shape, logical_axes):
        v = _entry(rules.get(ax)) if ax is not None else None
        if v is not None:
            names = set(names_of(v))
            if dim % axis_size(mesh, v) != 0 or used & names:
                v = None
            else:
                used |= names
        out.append(v)
    return P(*out)


def logical_shard(x, *logical_axes):
    """The reference's sharding annotation: the identity on values under
    any rules (``with_sharding_constraint`` moves no value), so it returns
    ``x`` itself."""
    return x


# --- mesh indices ------------------------------------------------------------

def submesh(mesh, fixed: dict):
    """The part of ``mesh`` at the indices ``fixed`` ({axis name: index})
    gives, with those axes kept at size 1 (one data shard's view of the
    mesh: its MoE layers route over the ``model`` axis alone)."""
    index = tuple(slice(fixed[a], fixed[a] + 1) if a in fixed else slice(None)
                  for a in mesh.axis_names)
    return type(mesh)(mesh.devices[index], mesh.axis_names)


def unravel(mesh, names, idx: int) -> dict:
    """The indices ({axis name: index}) of shard ``idx`` over the axes
    ``names``, row-major in their order."""
    at = {}
    for a in reversed(tuple(names)):
        at[a] = idx % mesh.shape[a]
        idx //= mesh.shape[a]
    return at


def device_at(mesh, at: dict) -> torch.device:
    """The device at the mesh indices ``at`` ({axis name: index}); an
    axis it leaves out is taken at 0 (the first device, row-major)."""
    return mesh.devices[tuple(at.get(a, 0) for a in mesh.axis_names)]


# --- placement ---------------------------------------------------------------

def _linear(pos: Dict[str, int], names: Tuple[str, ...], mesh) -> int:
    """A shard index over ``names``, row-major in their order."""
    idx = 0
    for name in names:
        idx = idx * mesh.shape[name] + pos[name]
    return idx


def _slices(coord, local) -> tuple:
    return tuple(slice(c * n, (c + 1) * n) for c, n in zip(coord, local))


def _overlap(a: slice, b: slice) -> Optional[Tuple[int, int]]:
    lo, hi = max(a.start, b.start), min(a.stop, b.stop)
    return (lo, hi) if lo < hi else None


class Sharded:
    """A tensor placed on a mesh: ``pieces[coord]`` is the block
    ``_slices(coord, local)`` of the whole tensor on ``devices[coord]``.
    ``coord`` has one entry a dim: the piece's index along that dim
    (``counts[d]`` pieces of ``local[d]`` elements).  ``spec`` and
    ``mesh`` say how it was placed (``None`` for a part that
    :meth:`select` took from one)."""

    __slots__ = ("shape", "dtype", "spec", "mesh", "counts", "local",
                 "pieces", "devices")

    def __init__(self, shape, dtype, spec, mesh, counts, pieces, devices):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.spec = spec
        self.mesh = mesh
        self.counts = tuple(counts)
        self.local = tuple(s // n for s, n in zip(self.shape, self.counts))
        self.pieces = pieces
        self.devices = devices

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, spec="
                f"{self.spec}, {len(self.pieces)} pieces)")

    def _region(self, index) -> tuple:
        """``index`` (ints, slices, fewer entries than dims) as one
        ``slice`` with bounds a dim, and the dims an int drops."""
        if not isinstance(index, tuple):
            index = (index,)
        out, drop = [], []
        for d, n in enumerate(self.shape):
            ix = index[d] if d < len(index) else slice(None)
            if isinstance(ix, slice):
                lo, hi, step = ix.indices(n)
                if step != 1:
                    raise ValueError("a Sharded region takes unit steps")
                out.append(slice(lo, max(lo, hi)))
            else:
                ix = int(ix) + (n if int(ix) < 0 else 0)
                out.append(slice(ix, ix + 1))
                drop.append(d)
        return tuple(out), drop

    def _parts(self, region):
        """``(coord, piece index, output index)`` of each piece that the
        region overlaps."""
        for coord, piece in self.pieces.items():
            src, dst = [], []
            for r, sl in zip(region, _slices(coord, self.local)):
                ov = _overlap(r, sl)
                if ov is None:
                    break
                src.append(slice(ov[0] - sl.start, ov[1] - sl.start))
                dst.append(slice(ov[0] - r.start, ov[1] - r.start))
            else:
                yield coord, tuple(src), tuple(dst)

    def region(self, index, device) -> torch.Tensor:
        """The block ``index`` of the whole tensor on ``device``: a view of
        a piece where one piece on ``device`` holds all of it, else
        assembled from the pieces it overlaps."""
        region, drop = self._region(index)
        shape = tuple(r.stop - r.start for r in region)
        parts = list(self._parts(region))
        device = torch.device(device)
        if len(parts) == 1:
            coord, src, _ = parts[0]
            piece = self.pieces[coord]
            if tuple(s.stop - s.start for s in src) == shape:
                out = piece[src].to(device)
                return out.squeeze(drop) if drop else out
        out = _Gather.apply((shape, self.dtype, device,
                             [(src, dst) for _, src, dst in parts]),
                            *(self.pieces[c] for c, _, _ in parts))
        return out.squeeze(drop) if drop else out

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``."""
        return self.region((), device)

    def write(self, index, value: torch.Tensor) -> None:
        """Copy ``value`` into the block ``index``, piece by piece, in
        place."""
        region, drop = self._region(index)
        shape = tuple(r.stop - r.start for r in region)
        value = value.reshape(shape) if drop else value
        for coord, src, dst in self._parts(region):
            piece = self.pieces[coord]
            piece[src] = value[dst].to(piece.device)

    def __getitem__(self, index) -> "Sharded":
        """Index the leading dims by ints (a layer of a stacked leaf); each
        indexed dim must be unsplit.  The pieces are views."""
        if not isinstance(index, tuple):
            index = (index,)
        k = len(index)
        if any(c != 1 for c in self.counts[:k]):
            raise ValueError(f"{self!r}: a split leading dim cannot be "
                             "indexed")
        return Sharded(self.shape[k:], self.dtype,
                       None if self.spec is None else P(*self.spec[k:]),
                       self.mesh, self.counts[k:],
                       {c[k:]: p[index] for c, p in self.pieces.items()},
                       {c[k:]: d for c, d in self.devices.items()})

    def unbind(self, dim: int = 0) -> list:
        """The leaves of each index of dim 0, which must be unsplit: one
        ``unbind`` a piece, so under autograd each piece has one backward
        node that stacks its layers' gradients (indexing a piece once a
        layer would give each layer's backward a zero gradient the size
        of the whole piece)."""
        if dim != 0:
            raise ValueError("Sharded.unbind takes dim 0")
        if self.counts[0] != 1:
            raise ValueError(f"{self!r}: a split leading dim cannot be "
                             "indexed")
        per = {c: p.unbind(0) for c, p in self.pieces.items()}
        spec = None if self.spec is None else P(*self.spec[1:])
        devices = {c[1:]: d for c, d in self.devices.items()}
        return [Sharded(self.shape[1:], self.dtype, spec, self.mesh,
                        self.counts[1:], {c[1:]: t[i] for c, t in per.items()},
                        devices)
                for i in range(self.shape[0])]

    def with_pieces(self, pieces: dict) -> "Sharded":
        """A :class:`Sharded` placed as this one (shape, spec, mesh,
        devices) whose pieces are ``pieces`` ({coord: tensor}, each of
        this one's piece shape on its device); its dtype is theirs."""
        if pieces.keys() != self.pieces.keys():
            raise ValueError(f"{self!r}: pieces at {sorted(pieces)}")
        dtype = next(iter(pieces.values())).dtype
        return Sharded(self.shape, dtype, self.spec, self.mesh, self.counts,
                       pieces, self.devices)

    def select(self, dim: int, index: int) -> "Sharded":
        """The part of piece index ``index`` along ``dim`` (e.g. one data
        shard's rows of a batch-split cache): the same piece tensors."""
        keep = {c: p for c, p in self.pieces.items() if c[dim] == index}
        if not keep:
            raise ValueError(f"{self!r} has no piece {index} along dim {dim}")

        def renumber(c):
            return c[:dim] + (0,) + c[dim + 1:]
        shape = list(self.shape)
        shape[dim] = self.local[dim]
        counts = list(self.counts)
        counts[dim] = 1
        return Sharded(shape, self.dtype, None, None, counts,
                       {renumber(c): p for c, p in keep.items()},
                       {renumber(c): self.devices[c] for c in keep})

    def nbytes_by_device(self) -> Dict[torch.device, int]:
        out: Dict[torch.device, int] = {}
        for coord, p in self.pieces.items():
            dev = self.devices[coord]
            out[dev] = out.get(dev, 0) + p.numel() * p.element_size()
        return out


class _Gather(torch.autograd.Function):
    """A region of a :class:`Sharded` assembled on one device from the
    pieces it overlaps; the backward sends each piece its slice of the
    gradient, on the piece's device (zeros where the region leaves a
    piece partly out)."""

    @staticmethod
    def forward(ctx, meta, *pieces):
        shape, dtype, device, parts = meta
        out = torch.empty(shape, dtype=dtype, device=device)
        for (src, dst), piece in zip(parts, pieces):
            out[dst] = piece[src]
        ctx.parts = parts
        ctx.pieces = [(p.shape, p.device) for p in pieces]
        return out

    @staticmethod
    def backward(ctx, grad):
        out = [None]
        for (src, dst), (shape, dev), need in zip(
                ctx.parts, ctx.pieces, ctx.needs_input_grad[1:]):
            if not need:
                out.append(None)
                continue
            g = grad[dst].to(dev, copy=True)
            if g.shape != shape:
                full = g.new_zeros(shape)
                full[src] = g
                g = full
            out.append(g)
        return tuple(out)


def placement(shape, spec: PartitionSpec, mesh):
    """``(counts, devices)`` of a leaf of ``shape`` split by ``spec`` over
    ``mesh``: the pieces a dim and, for each piece coordinate, the first
    device of the mesh (row-major) that holds it."""
    counts = tuple(axis_size(mesh, v) for v in spec)
    for d, (n, c) in enumerate(zip(shape, counts)):
        if n % c:
            raise ValueError(f"dim {d} of {tuple(shape)} ({n}) does not "
                             f"split into {c} shards ({spec})")
    devices: Dict[tuple, torch.device] = {}
    for pos in np.ndindex(mesh.devices.shape):
        at = dict(zip(mesh.axis_names, pos))
        coord = tuple(_linear(at, names_of(v), mesh) for v in spec)
        devices.setdefault(coord, mesh.devices[pos])
    return counts, devices


def shard_leaf(x, spec: PartitionSpec, mesh, copy: bool = False
               ) -> Sharded:
    """``x`` (a tensor, or a :class:`Sharded` of any layout) placed by
    ``spec`` on ``mesh``.  A piece on the device of the tensor it comes
    from is a view of it (a copy of its own with ``copy``, so that ``x``
    can be freed); a :class:`Sharded` already placed so is returned as it
    is."""
    spec = P(*spec)
    spec = P(*spec, *([None] * (len(x.shape) - len(spec))))
    if isinstance(x, Sharded) and x.mesh is mesh and x.spec == spec:
        return x
    counts, devices = placement(x.shape, spec, mesh)
    local = tuple(s // n for s, n in zip(x.shape, counts))
    if isinstance(x, Sharded):
        pieces = {c: x.region(_slices(c, local), dev)
                  for c, dev in devices.items()}
    else:
        pieces = {c: x[_slices(c, local)].to(dev, copy=copy)
                  for c, dev in devices.items()}
    return Sharded(x.shape, x.dtype, spec, mesh, counts, pieces, devices)


def _map(fn, axes_tree, tree, path=""):
    if isinstance(axes_tree, dict):
        if not isinstance(tree, dict) or sorted(tree) != sorted(axes_tree):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'tree'}: axes keys "
                             f"{sorted(axes_tree)}, tree keys {got}")
        return {k: _map(fn, axes_tree[k], tree[k], f"{path}/{k}")
                for k in axes_tree}
    return fn(axes_tree, tree, path)


def shard_tree(tree, axes_tree, mesh, rules: ShardingRules,
               copy: bool = False):
    """Each leaf of ``tree`` placed by ``resolve_spec`` of its axes (the
    reference launchers' ``_shard_tree``; ``copy`` as for
    :func:`shard_leaf`).  ``None`` leaves and non-tensor leaves (a
    cache's ``"length"``) stay as they are."""
    def one(axes, leaf, path):
        if leaf is None or not isinstance(leaf, (torch.Tensor, Sharded)):
            return leaf
        if len(axes) != len(leaf.shape):
            raise ValueError(f"{path}: axes {axes} for a leaf of rank "
                             f"{len(leaf.shape)}")
        return shard_leaf(leaf, resolve_spec(leaf.shape, axes, mesh, rules),
                          mesh, copy)
    return _map(one, axes_tree, tree)


def tree_map(fn, tree):
    """``fn`` of each leaf of nested dicts, in their shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def gather_tree(tree, device=None):
    """Whole tensors for the :class:`Sharded` leaves of ``tree``, on
    ``device`` (default: each leaf's first piece's device); other leaves
    unchanged."""
    def one(x):
        if not isinstance(x, Sharded):
            return x
        return x.gather(device if device is not None
                        else next(iter(x.devices.values())))
    return tree_map(one, tree)


def as_tensor(x, device) -> torch.Tensor:
    """``x`` on ``device``: a :class:`Sharded` gathered, a tensor moved."""
    if isinstance(x, Sharded):
        return x.gather(device)
    return x.to(device)


def bytes_by_device(tree) -> Dict[torch.device, int]:
    """The bytes of the pieces each device holds (tensors that are not
    :class:`Sharded` count on their own device)."""
    out: Dict[torch.device, int] = {}

    def one(x):
        if isinstance(x, Sharded):
            for dev, n in x.nbytes_by_device().items():
                out[dev] = out.get(dev, 0) + n
        elif isinstance(x, torch.Tensor):
            out[x.device] = out.get(x.device, 0) + x.numel() \
                * x.element_size()
    tree_map(one, tree)
    return out


def bytes_by_position(tree, mesh) -> Dict[tuple, int]:
    """The bytes each mesh position would hold at rest if each held its
    own copy of the pieces it is a shard of (a replicated leaf counted at
    every position), keyed by the position's mesh index."""
    out = {pos: 0 for pos in np.ndindex(mesh.devices.shape)}

    def one(x):
        if not isinstance(x, Sharded) or x.mesh is None:
            return
        per = math.prod(x.local) * torch.empty((), dtype=x.dtype) \
            .element_size()
        for pos in out:
            out[pos] += per
    tree_map(one, tree)
    return out


# --- piece by piece ----------------------------------------------------------

def pieces_of(x) -> list:
    """The tensors that hold ``x``: a :class:`Sharded` leaf's pieces (each
    element of the whole tensor in exactly one of them: a mesh axis that
    the spec leaves out has one piece for the whole axis), a tensor
    itself, ``None`` none."""
    if x is None:
        return []
    return list(x.pieces.values()) if isinstance(x, Sharded) else [x]


def map_pieces(fn, *xs):
    """``fn`` of the pieces at each coordinate of ``xs`` (leaves placed
    alike; a ``None`` among them passes ``None``), as a :class:`Sharded`
    placed like ``xs[0]``; of tensors, ``fn(*xs)``.  ``fn`` may return
    ``None`` (the result is then ``None``)."""
    first = xs[0]
    if not isinstance(first, Sharded):
        return fn(*xs)
    for x in xs[1:]:
        if isinstance(x, Sharded) and x.counts != first.counts:
            raise ValueError(f"{x!r} is not placed like {first!r}")
    out = {c: fn(*(None if x is None else x.pieces[c] for x in xs))
           for c in first.pieces}
    if any(v is None for v in out.values()):
        return None
    return first.with_pieces(out)


def square_sum(x, device, chunk: int = 1 << 26) -> torch.Tensor:
    """``sum(x**2)`` in f32 on ``device``, over the pieces of a
    :class:`Sharded` (each element counted once) or a tensor, widening
    ``chunk`` elements at a time where they lie."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    for p in pieces_of(x):
        for part in p.reshape(-1).split(chunk):
            total = total + part.float().square().sum().to(device)
    return total
