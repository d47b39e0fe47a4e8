"""Execution configuration — how to run a :class:`StencilProblem`."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import precision
from repro_torch.core.distributed import normalize_axis_map
from repro_torch.core.perf_model import DEVICES, H100_SXM, Device, device_for

#: accepted ``RunConfig.autotune`` modes (``False`` disables; ``True`` is
#: ``"model"``)
AUTOTUNE_MODES = ("model", "measure")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Backend, schedule and device of one plan.

    ``par_time``/``bsize`` left as ``None`` (or ``autotune`` set) hands
    the choice to the tuner: ``autotune="model"`` (or ``True``) ranks the
    schedules the kernel runs by the performance model alone (paper §5.3,
    ``core/perf_model.py``); ``autotune="measure"`` times the model's
    ``tune_top_k`` best on the backend (``api/tuner.py``) and keeps the
    fastest, through the persistent schedule cache
    (``api/schedule_cache.py``), so the timing is paid once per key.
    Pinning one of ``par_time``, ``bsize``, ``par_vec`` constrains the
    tuner to it.  ``par_vec`` left as ``None`` is 1 on a pinned schedule.

    ``device`` is where the grids live and the backend runs: ``"cuda"``
    (the default) launches the kernels, ``"cpu"`` runs their plain
    versions (and the measured tuner times those).  ``perf_device`` is the
    card the model prices (a :class:`~repro_torch.core.perf_model.Device`
    or a name of ``perf_model.DEVICES``); ``None`` is the card's own
    variant when ``device`` is CUDA, else the H100 SXM, so a CPU plan
    ranks as the card would.

    ``cache``: ``None``/``True`` is the default cache file (the
    ``REPRO_TORCH_SCHEDULE_CACHE`` variable, else
    ``~/.cache/repro_torch/schedules.json``), a path that file, ``False``
    no cache.

    ``mesh`` and ``axis_map`` place the ``distributed`` backend: a
    :class:`~repro_torch.launch.mesh.Mesh`, and per grid axis the mesh
    axes that split it (a name, a sequence of names, or None); unset, the
    streaming axis is split over every mesh axis.  ``device`` stays where
    the whole grid lives: the shards live on the mesh's devices."""
    backend: str = "hopper"
    par_time: Optional[int] = None
    bsize: Optional[Union[int, Tuple[int, ...]]] = None
    par_vec: Optional[int] = None
    device: Union[str, torch.device] = "cuda"
    autotune: Union[bool, str] = False
    perf_device: Union[Device, str, None] = None
    #: storage bytes a cell for pricing; ``None`` is the problem dtype's
    cell_bytes: Optional[int] = None
    par_time_max: int = 64
    #: the iterations the model ranks and predicts for
    iters_hint: int = 100
    #: the distributed backend's mesh (``launch/mesh.py``) and the mesh
    #: axes that split each grid axis
    mesh: Optional[object] = None
    axis_map: Optional[Tuple] = None
    # --- measured tuning (autotune="measure") ------------------------------
    cache: Union[None, bool, str] = None
    tune_top_k: int = 4          # model candidates the tuner times
    tune_warmup: int = 1         # untimed runs a candidate (build + warm)
    tune_repeats: int = 3        # timed runs a candidate (the least kept)
    tune_iters: Optional[int] = None  # iters a timed run (None: 1 super-step)

    def __post_init__(self):
        if isinstance(self.autotune, bool):
            object.__setattr__(self, "autotune",
                               "model" if self.autotune else False)
        elif self.autotune not in AUTOTUNE_MODES:
            raise ValueError(f"autotune must be a bool or one of "
                             f"{AUTOTUNE_MODES}, got {self.autotune!r}")
        if self.tune_top_k < 1:
            raise ValueError(f"tune_top_k must be >= 1, got {self.tune_top_k}")
        if self.tune_warmup < 0 or self.tune_repeats < 1:
            raise ValueError("need tune_warmup >= 0 and tune_repeats >= 1, "
                             f"got {self.tune_warmup}/{self.tune_repeats}")
        if self.tune_iters is not None and self.tune_iters < 1:
            raise ValueError(f"tune_iters must be >= 1, got {self.tune_iters}")
        if self.par_time is not None and self.par_time < 1:
            raise ValueError(f"par_time must be >= 1, got {self.par_time}")
        if self.par_vec is not None and self.par_vec < 1:
            raise ValueError(f"par_vec must be >= 1, got {self.par_vec}")
        if self.bsize is not None and not isinstance(self.bsize, int):
            object.__setattr__(self, "bsize",
                               tuple(int(b) for b in self.bsize))
        object.__setattr__(self, "device", torch.device(self.device))
        if self.axis_map is not None:
            object.__setattr__(self, "axis_map",
                               normalize_axis_map(self.axis_map))

    def normalized_bsize(self, ndim: int) -> Optional[Tuple[int, ...]]:
        """bsize as a per-blocked-dim tuple (``ndim - 1`` entries)."""
        if self.bsize is None:
            return None
        if isinstance(self.bsize, int):
            return (self.bsize,) * (ndim - 1)
        if len(self.bsize) != ndim - 1:
            raise ValueError(f"bsize {self.bsize} has {len(self.bsize)} "
                             f"entries; a {ndim}D grid blocks {ndim - 1} dims")
        return self.bsize

    def resolved_cell_bytes(self, dtype="float32") -> int:
        """The cell bytes the model prices: the explicit ``cell_bytes``,
        else the storage dtype's."""
        if self.cell_bytes is not None:
            return int(self.cell_bytes)
        return precision.cell_bytes(dtype)

    def resolved_perf_device(self) -> Device:
        """The card the model prices: ``perf_device`` (a ``Device`` or a
        name of ``perf_model.DEVICES``), else, on a CUDA ``device``, the
        card's variant (matched by name) with its SM count, else the H100
        SXM."""
        if isinstance(self.perf_device, Device):
            return self.perf_device
        if self.perf_device is not None:
            if self.perf_device not in DEVICES:
                raise ValueError(f"unknown perf_device "
                                 f"{self.perf_device!r}; have: "
                                 f"{sorted(DEVICES)}")
            return DEVICES[self.perf_device]
        if self.device.type == "cuda" and torch.cuda.is_available():
            index = self.device.index or 0
            return device_for(torch.cuda.get_device_name(index)).on_card(
                index)
        return H100_SXM
