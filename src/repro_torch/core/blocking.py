"""Block/halo geometry — paper Eqs. (1)-(7).

The streaming dimension is axis 0 (y of a 2D grid ``(ny, nx)``, z of a 3D
grid ``(nz, ny, nx)``); the trailing axes are blocked.  Temporal blocking
widens each halo to ``size_halo = rad * par_time`` (Eq. 2); overlapped
blocks of extent ``bsize`` advance by ``csize = bsize - 2*size_halo``
(Eq. 4); there are ``ceil(dim / csize)`` blocks per blocked dimension
(Eq. 5), and compute past the grid in the last block is discarded.

On Hopper the on-chip budget is the shared memory of one CTA, not a TPU's
VMEM: :func:`smem_bytes` is the streaming kernel's own footprint.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

#: shared memory one CTA may use on H100 (232,448 bytes = 227 KB)
SMEM_LIMIT = 232448
#: threads per CTA on any CUDA device
MAX_THREADS = 1024


@dataclasses.dataclass(frozen=True)
class BlockGeometry:
    """Static description of one combined spatial/temporal blocking plan."""
    ndim: int                      # grid rank (1, 2 or 3; streaming axis 0)
    dims: Tuple[int, ...]          # grid extents, streaming axis first
    rad: int
    par_time: int                  # fused time-steps per device round-trip
    bsize: Tuple[int, ...]         # block extent per blocked (trailing) dim
    par_vec: int = 1               # rows/planes advanced per pipeline tick

    def __post_init__(self):
        if self.ndim != len(self.dims):
            raise ValueError(f"dims {self.dims} are not {self.ndim}-D")
        if len(self.bsize) != self.ndim - 1:
            raise ValueError(f"bsize {self.bsize} needs {self.ndim - 1} "
                             "entries: the streaming axis is not blocked")
        if self.par_time < 1:
            raise ValueError(f"par_time must be >= 1, got {self.par_time}")
        if self.par_vec < 1:
            raise ValueError(f"par_vec must be >= 1, got {self.par_vec}")
        if any(b <= 2 * self.size_halo for b in self.bsize):
            raise ValueError(
                f"bsize {self.bsize} too small for halo {self.size_halo} "
                f"(need bsize > 2*rad*par_time = {2 * self.size_halo})")

    # --- paper Eq. (2): halo width per side ----------------------------------
    @property
    def size_halo(self) -> int:
        return self.rad * self.par_time

    # --- paper Eq. (4): compute-block extent ---------------------------------
    @property
    def csize(self) -> Tuple[int, ...]:
        return tuple(b - 2 * self.size_halo for b in self.bsize)

    # --- paper Eq. (5): blocks per blocked dimension -------------------------
    @property
    def bnum(self) -> Tuple[int, ...]:
        return tuple(math.ceil(d / c)
                     for d, c in zip(self.blocked_dims, self.csize))

    @property
    def stream_dim(self) -> int:
        return self.dims[0]

    @property
    def slab_lag(self) -> int:
        """Slabs each stage lags its producer by: ``ceil(rad / par_vec)``."""
        return -(-self.rad // self.par_vec)

    @property
    def win_slots(self) -> int:
        """Slab slots per rolling stage window: ``2*slab_lag + 1``."""
        return 2 * self.slab_lag + 1

    def stream_slabs(self, stream: int | None = None) -> int:
        """Ticks needed to stream ``stream`` rows, ``par_vec`` at a time."""
        n = self.stream_dim if stream is None else stream
        return -(-n // self.par_vec)

    @property
    def blocked_dims(self) -> Tuple[int, ...]:
        return self.dims[1:]

    # --- padded extents: bnum*csize + 2*halo ---------------------------------
    @property
    def padded_dims(self) -> Tuple[int, ...]:
        return tuple(n * c + 2 * self.size_halo
                     for n, c in zip(self.bnum, self.csize))

    @property
    def num_blocks(self) -> int:
        return math.prod(self.bnum)

    # --- paper Eq. (7): traversed cells per blocked dimension ----------------
    @property
    def trav(self) -> Tuple[int, ...]:
        """The Eq. (7) traversed extent, which is the padded extent."""
        return self.padded_dims

    # --- paper Eq. (6): cells read from external memory per input buffer -----
    @property
    def cells_read(self) -> int:
        r = self.stream_dim
        for n, b in zip(self.bnum, self.bsize):
            r *= n * b
        return r

    @property
    def cells_written(self) -> int:
        return math.prod(self.dims)

    @property
    def redundancy(self) -> float:
        """Read amplification from overlapped halos + out-of-bound cells."""
        return self.cells_read / math.prod(self.dims)


def smem_bytes(geom: BlockGeometry, has_aux: bool = False,
               cell_bytes: int = 4) -> int:
    """Shared memory one CTA of ``kernels/csrc/stencil_stream.cu`` needs:
    a ring of ``win_slots`` slabs of one block plane per producer — the
    input stream and every chain entry but the last, which writes straight
    to device memory — so ``par_time`` windows in all.  ``has_aux`` adds
    nothing: the kernel reads the aux centre from device memory (L2), as the
    TPU kernel only reads the aux centre too."""
    del has_aux
    plane = math.prod(geom.bsize)
    return geom.par_time * geom.win_slots * geom.par_vec * plane * cell_bytes


def stream_extension(geom: BlockGeometry, bc) -> int:
    """Streaming-axis cells per side materialized for a periodic stream BC
    (0 otherwise): the rolling window cannot reach the far end of the
    stream, so the wrap is staged in device memory as ``size_halo`` extra
    rows, refreshed per super-step."""
    if bc is not None and bc.kinds[0] == "periodic":
        return geom.size_halo
    return 0


def extended_geometry(geom: BlockGeometry, bc) -> BlockGeometry:
    """``geom`` with the periodic stream extension applied."""
    ext = stream_extension(geom, bc)
    if not ext:
        return geom
    return dataclasses.replace(
        geom, dims=(geom.stream_dim + 2 * ext,) + geom.blocked_dims)


def bsize_feasible(rad: int, par_time: int, bsize: Sequence[int]) -> bool:
    """True iff ``bsize`` leaves a positive compute block after the halo is
    widened to ``rad * par_time``."""
    halo = rad * par_time
    return all(b > 2 * halo for b in bsize)


def superstep_traffic_bytes(geom: BlockGeometry, num_read: int,
                            num_write: int, cell_bytes: int = 4) -> int:
    """External-memory bytes per super-step (paper Eq. 7/8 numerator), with
    reads of fully out-of-bound columns clipped."""
    read_cells = geom.stream_dim
    for n, b, c, d in zip(geom.bnum, geom.bsize, geom.csize,
                          geom.blocked_dims):
        per_dim = n * b - max(0, (n * c + 2 * geom.size_halo) - d)
        read_cells *= per_dim
    return (read_cells * num_read
            + geom.cells_written * num_write) * cell_bytes
