"""Performance model — paper §4 (Eqs. 3-9) priced for the streaming kernel
on Hopper.

The paper predicts run time from external-memory traffic alone (Eq. 8).
This module keeps that accounting exactly (Eqs. 4-7, ``core.blocking``'s
``superstep_traffic_bytes`` on the ``extended_geometry``) and the FLOP
count, and takes ``time = max(t_mem, t_compute, t_issue)`` a super-step,
plus the driver's passes over the padded state (``t_driver``).
On the card the bytes term is not what bounds the kernel: a super-step of
diffusion2d at 16384², ``par_time`` 8, bsize 256 moves its bytes in about
0.66 ms and takes 2.76 (H100 80GB HBM3, 700 W, PERF.md §6).  What bounds
it is the **issue term**: the launch's waves of CTAs, times the ticks one
CTA streams (its segment, its warm-up and the output lag), times what one
tick costs the form the launch takes.  Between two launches the host loop
refreshes the padded state's halo columns (``kernels/ops.py``
``_reclamp_padded``: one gather of the whole padded state a padded
blocked axis, and one for a periodic stream), serial with the kernel:
``t_driver`` bills those bytes at the card's rate, and ``t_once`` the
padding in and the slice out a run.  Every input of the issue term comes from
the launcher's own rules in pure Python (``kernels/builder.py``:
``launch_shape``, ``model_split``, ``cta_shape``, ``segment_plan``,
``stream_warmup``, ``launch_smem``, ``static_smem``), and the CTAs an SM
holds from :func:`occupancy`, the CUDA occupancy calculator's rule over
threads, registers and shared memory.  The cost of a tick of each form is
fitted from chip runs (:data:`TICK_COSTS`, ``chip_calibrate.py``).

Two roles, as in the paper:
  1. Predict a super-step for a given ``(bsize, par_time, par_vec)`` (§4).
  2. Prune the design space (§5.3): :func:`autotune` keeps the schedules
     the kernel runs (``builder.kernel_limits``, the rule the ``hopper``
     backend refuses by) and ranks them by predicted run time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core.blocking import (SMEM_LIMIT, BlockGeometry,
                                       bsize_feasible,
                                       choose_bsize_candidates,
                                       extended_geometry,
                                       superstep_traffic_bytes)

#: baseline ``par_vec`` sweep of :func:`autotune`: one row a tick up to
#: sixteen; 16-bit cells go to 32 (:func:`par_vec_candidates`)
PAR_VEC_CANDIDATES = (1, 2, 4, 8, 16)


def par_vec_candidates(cell_bytes: int = 4):
    """The ``par_vec`` sweep for a cell width: 16-bit cells also try 32
    rows a tick (a slab of the same bytes as 16 rows of f32)."""
    if cell_bytes <= 2:
        return PAR_VEC_CANDIDATES + (32,)
    return PAR_VEC_CANDIDATES


#: the cost of one tick of each form, ``(a, b, c)`` in seconds: ``a`` a
#: tick, ``b`` per FLOP an SM makes in the tick (its resident CTAs, times
#: the cells of a slab, times ``par_time`` times the program's FLOPs a
#: cell), ``c`` per CTA barrier of the tick.  Fitted by
#: ``chip_calibrate.py --fit`` from 507 super-steps measured by
#: ``chip_calibrate.py`` on an NVIDIA H100 80GB HBM3 at a 700.00 W power
#: limit, torch 2.11.0+cu128 (``tests/torch_calibration_h100.json``).
#: They are the H100 SXM's: every :data:`DEVICES` entry is priced with
#: them, unmeasured on the other variants
TICK_COSTS = {
    "chain": (1.651e-06, 3.48e-11, 4.243e-07),
    "chain_wide": (2.062e-06, 1.023e-10, 8.201e-07),
    "chain_win": (7.914e-07, 5.033e-11, 0.0),
    "dag": (1.538e-06, 1.733e-10, 0.0),
    "dag_wide": (0.0, 4.983e-11, 7.017e-06),
    "dag_win": (1.381e-06, 1.044e-10, 0.0),
    "main_reg": (7.508e-07, 8.27e-12, 0.0),
    "main_ring": (2.256e-06, 2.318e-11, 0.0),
    "main_rows": (1.314e-06, 3.849e-11, 0.0),
    "main_wide": (3.79e-06, 6.469e-11, 0.0),
}
#: the sources, under the package root, of the kernels and launch rules
#: the calibration sweep measured: an edit to any of them makes
#: :data:`TICK_COSTS` and :data:`KERNEL_REGISTERS` stale until the sweep
#: is run again on the card (the sweep records their hash)
CALIBRATED_SOURCES = ("kernels/builder.py", "kernels/csrc/stencil_stream.cu",
                      "kernels/csrc/hopper.cuh")
#: registers a thread of the kernels the calibration sweep launched, per
#: storage bytes a cell, from their ``ptxas`` lines in the same sweep;
#: any other kernel is priced at the cap of its launch bounds
#: (:func:`kernel_registers`)
KERNEL_REGISTERS = {
    4: {"chain_kernel<0,0>": 63, "chain_kernel<1,0>": 63,
        "chain_kernel<2,0>": 62, "chain_kernel<3,0>": 64,
        "chain_win_kernel<0,0>": 56, "chain_win_kernel<0,4>": 63,
        "chain_win_kernel<0,8>": 64, "dag_kernel<-2,0>": 64,
        "main_kernel<0,0,0,0>": 32, "main_kernel<0,0,0,4>": 56,
        "main_kernel<0,0,0,8>": 64, "main_kernel<0,0,0,16>": 96,
        "main_kernel<0,2,0,0>": 64, "main_kernel<0,3,0,0>": 45,
        "main_kernel<1,0,0,0>": 40, "main_kernel<1,0,0,4>": 64,
        "main_kernel<1,0,0,8>": 64, "main_kernel<1,0,0,16>": 121,
        "main_kernel<1,2,0,0>": 54, "main_kernel<1,3,0,0>": 46,
        "main_kernel<2,0,0,4>": 64, "main_kernel<2,0,0,8>": 64,
        "main_kernel<2,2,0,0>": 64, "main_kernel<2,3,0,0>": 45,
        "main_kernel<3,0,0,4>": 64, "main_kernel<3,0,0,8>": 64,
        "main_kernel<3,2,0,0>": 56, "main_kernel<3,3,0,0>": 48,
        "stream_kernel<-2,1,0>": 64, "stream_kernel<-2,2,0>": 64,
        "stream_kernel_x<-2,3,0>": 64},
    2: {"main_kernel<0,0,0,4>": 63, "main_kernel<0,0,0,8>": 64,
        "main_kernel<0,0,0,16>": 100, "main_kernel<0,2,0,0>": 62,
        "main_kernel<0,3,0,0>": 40},
}


@dataclasses.dataclass(frozen=True)
class Device:
    """One card's figures, all data sheet, unmeasured (the fitted tick
    costs are :data:`TICK_COSTS`, the H100 SXM's).  ``match`` is the substring
    of ``torch.cuda.get_device_name`` that names the card (the first
    match in :data:`DEVICES` order wins)."""
    name: str = "h100_sxm"
    match: str = "H100"
    #: device-memory bytes/s (data sheet, unmeasured)
    mem_bw: float = 3.35e12
    #: f32 FLOP/s outside the tensor cores (data sheet, unmeasured)
    f32_flops: float = 67e12
    #: dense bf16 tensor-core FLOP/s, for the LM roofline (data sheet,
    #: unmeasured)
    bf16_tc_flops: float = 989e12
    #: shared memory one CTA may use (``core/blocking.SMEM_LIMIT``), one
    #: SM has, and the runtime reserves a CTA (data sheet, unmeasured)
    smem_per_cta: int = SMEM_LIMIT
    smem_per_sm: int = 233472
    smem_reserved: int = 1024
    #: SMs; ``torch.cuda.get_device_properties(...).multi_processor_count``
    #: overrides it on the card (:meth:`on_card`)
    n_sm: int = 132
    threads_per_sm: int = 2048
    ctas_per_sm: int = 32
    regs_per_sm: int = 65536
    #: device-memory bytes (data sheet, unmeasured)
    hbm_bytes: int = 80 * 10 ** 9
    #: NVLink bytes/s one way (data sheet, unmeasured)
    link_bw: float = 450e9

    def scaled(self, **kw) -> "Device":
        return dataclasses.replace(self, **kw)

    def on_card(self, index: int = 0) -> "Device":
        """This device with the SM count the card reports."""
        import torch
        props = torch.cuda.get_device_properties(index)
        return dataclasses.replace(self, n_sm=props.multi_processor_count)


# the card variants (paper §6.3's projection targets)
H100_SXM = Device()
H100_PCIE = Device(name="h100_pcie", match="H100 PCIe", mem_bw=2.0e12,
                   f32_flops=51.2e12, bf16_tc_flops=756e12, n_sm=114,
                   link_bw=300e9)
H100_NVL = Device(name="h100_nvl", match="H100 NVL", mem_bw=3.9e12,
                  f32_flops=60.0e12, bf16_tc_flops=835e12,
                  hbm_bytes=94 * 10 ** 9, link_bw=300e9)
H200 = Device(name="h200", match="H200", mem_bw=4.8e12, f32_flops=67.0e12,
              bf16_tc_flops=989e12, hbm_bytes=141 * 10 ** 9)

#: name -> device, most specific match first
DEVICES = {d.name: d for d in (H100_PCIE, H100_NVL, H200, H100_SXM)}


def device_for(card_name: str) -> Device:
    """The :data:`DEVICES` entry whose ``match`` is in ``card_name``
    (``torch.cuda.get_device_name``), most specific first."""
    for d in DEVICES.values():
        if d.match in card_name:
            return d
    raise ValueError(f"no data-sheet figures for {card_name!r}; have "
                     f"{[d.match for d in DEVICES.values()]}")


@dataclasses.dataclass(frozen=True)
class Prediction:
    geom: BlockGeometry
    t_mem: float                 # s per super-step (memory term)
    t_compute: float             # s per super-step (compute term)
    t_halo: float                # s per super-step (collective term)
    n_super: int
    run_time: float
    gbytes_s: float              # paper Eq. 9 "throughput"
    gcells_s: float
    gflops: float
    smem_bytes: int              # shared memory a CTA (dynamic + static)
    bound: str                   # "memory" | "compute" | "issue" | ...
    batch: int = 1               # problems advanced per batched super-step
    t_issue: float = 0.0         # s per super-step (issue term)
    t_driver: float = 0.0        # s per super-step (halo refresh passes)
    t_once: float = 0.0          # s a run (padding in, slice out)
    form: str = ""               # the form class of TICK_COSTS
    kernel: str = ""             # the kernel the launch picks
    ctas: int = 0                # CTAs a launch
    per_sm: int = 0              # CTAs an SM holds (:func:`occupancy`)
    waves: int = 0               # ceil(ctas / (per_sm * n_sm))
    ticks: int = 0               # ticks a CTA: segment + warm-up + lag

    def describe(self) -> str:
        return (f"bsize={self.geom.bsize} par_time={self.geom.par_time} "
                f"par_vec={self.geom.par_vec} -> "
                f"{self.run_time / self.n_super * 1e3:.3f} ms/super "
                f"({self.bound}-bound, {self.form} {self.kernel}, "
                f"{self.ctas} CTAs, {self.per_sm}/SM, {self.waves} waves x "
                f"{self.ticks} ticks, {self.gcells_s / 1e9:.2f} GCell/s, "
                f"red={self.geom.redundancy:.2f})")


def _program(stencil_or_program, bc, dims):
    """The ``programs.DagSpec`` the kernel runs, from a ``Stencil`` (one
    stage under ``bc``), a ``StencilProgram`` (resolved under ``bc``) or a
    ``DagSpec``."""
    from repro_torch.core.boundary import BoundaryCondition
    from repro_torch.programs import DagSpec, StencilProgram, StencilStage
    if isinstance(stencil_or_program, DagSpec):
        return stencil_or_program
    nd = len(dims)
    bc = bc if bc is not None else "clamp"
    if isinstance(stencil_or_program, StencilProgram):
        return stencil_or_program.resolved(bc, tuple(dims)).dag
    bc = BoundaryCondition.make(bc, nd)
    return StencilProgram((StencilStage(stencil_or_program,
                                        boundary=bc),)).dag


def _stats(dag) -> tuple:
    """``(radius, num_read, num_write, flop_pcu, has_aux)`` of a DAG."""
    from repro_torch.programs import dag_radius
    has_aux = any(st.has_aux for st, _, _ in dag.stages)
    return (dag_radius(dag), dag.n_fields + int(has_aux), dag.n_fields,
            sum(st.flop_pcu for st, _, _ in dag.stages), has_aux)


def kernel_registers(kernel: str, cell_bytes: int = 4) -> int:
    """Registers a thread of ``kernel`` (as ``StreamSplit.kernel`` names
    it) takes: its ``ptxas`` count where :data:`KERNEL_REGISTERS` has it,
    else the cap of its launch bounds (128 for the main path's 16-entry
    register form, bound to 512 threads; 64 for every other kernel, bound
    to 1024)."""
    regs = KERNEL_REGISTERS.get(cell_bytes, {}).get(kernel)
    if regs is not None:
        return regs
    return 128 if kernel.startswith("main_kernel<") and kernel.endswith(
        ",16>") else 64


def occupancy(threads: int, smem: int, regs: int,
              device: Device = H100_SXM) -> int:
    """CTAs of ``threads`` threads, ``smem`` bytes of shared memory
    (static and dynamic) and ``regs`` registers a thread that one SM
    holds: the CUDA occupancy calculator's rule (warps of 32, registers
    allocated 256 to a warp in four sub-partitions, shared memory in 128-
    byte units plus the runtime's reserve a CTA), the least of the warp,
    CTA, register and shared-memory limits."""
    warps = -(-threads // 32)
    by_warps = (device.threads_per_sm // 32) // warps
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = ((device.regs_per_sm // 4) // per_warp) * 4 // warps
    if smem > device.smem_per_cta:
        return 0
    by_smem = device.smem_per_sm // (
        -(-(smem + device.smem_reserved) // 128) * 128)
    return min(device.ctas_per_sm, by_warps, by_regs, by_smem)


def form_class(kernel: str) -> str:
    """The form of :data:`TICK_COSTS` a kernel (``StreamSplit.kernel``)
    runs.  No schedule of the calibration sweep takes the large-table
    route: it is priced as the chain body's wide form, whose per-entry
    loop it shares."""
    name, _, args = kernel.partition("<")
    args = [int(a) for a in args.rstrip(">").split(",") if a]
    if name.endswith("_big"):
        return "chain_wide"
    if name == "main_kernel":
        op, form, _, kt = args
        return ("main_reg" if kt else "main_wide" if form == 3
                else "main_ring" if form == 0 else "main_rows")
    if name == "chain_win_kernel":
        return "chain_win"
    if name == "dag_kernel":
        return "dag_win"
    if name == "chain_kernel":
        return "chain_wide" if args[0] == 3 else "chain"
    return "dag_wide" if args[1] == 3 else "dag"


def launch_terms(dag, geom: BlockGeometry, cell_bytes: int,
                 device: Device, batch: int = 1) -> dict:
    """What the issue term of one launch of ``dag`` at ``geom`` reads: the
    split (``builder.model_split`` at :func:`occupancy`), its form, waves,
    ticks a CTA, the work a tick, and the seconds."""
    from repro_torch.kernels import builder
    prog = builder.launch_shape(dag, geom, cell_bytes)
    tab = builder.tables_of(geom, dag)
    _, _, threads = builder.cta_shape(geom, tab)
    kernel = builder.model_split(dag, geom, cell_bytes, 1, device.n_sm,
                                 batch).kernel
    smem = (builder.launch_smem(dag, geom, cell_bytes)
            + builder.static_smem(dag, geom, cell_bytes))
    per_sm = occupancy(threads, smem, kernel_registers(kernel, cell_bytes),
                       device)
    if per_sm < 1:
        raise ValueError(f"no CTA of {kernel} fits an SM ({threads} "
                         f"threads, {smem} bytes of shared memory)")
    sp = builder.model_split(dag, geom, cell_bytes, per_sm, device.n_sm,
                             batch)
    form = form_class(sp.kernel)
    slots = per_sm * device.n_sm
    waves = -(-sp.ctas // slots)
    resident = min(per_sm, -(-sp.ctas // device.n_sm))
    ticks = sp.seg + sp.warm + prog.out_lag
    flops = sum(st.flop_pcu for st, _, _ in dag.stages)
    work = (resident * math.prod(geom.bsize) * geom.par_vec * geom.par_time
            * flops)
    a, b, c = TICK_COSTS[form]
    tick = a + b * work + c * sp.barriers
    return {"split": sp, "form": form, "per_sm": per_sm, "waves": waves,
            "ticks": ticks, "work": work, "tick_s": tick,
            "smem": smem, "t_issue": waves * ticks * tick}


def driver_times(geom_t: BlockGeometry, dag, batch: int, has_aux: bool,
                 cell_bytes: int, device: Device) -> tuple:
    """``(t_driver, t_once)``: the seconds a super-step of
    ``kernels/ops.fused_dag_loop``'s halo refresh (one read and one write
    of the padded state, every field and member, a padded blocked axis,
    and one more for a periodic stream), and a run's padding in (as many
    passes, and the aux grid's) and slice out, at the card's rate."""
    stream = geom_t.stream_slabs() * geom_t.par_vec
    padded = stream * math.prod(geom_t.padded_dims)
    passes = sum(p != d for p, d in zip(geom_t.padded_dims,
                                        geom_t.blocked_dims))
    bc0 = dag.stages[0][1]
    passes += int(bc0 is not None and bc0.kinds[0] == "periodic")
    state = dag.n_fields * batch * padded * cell_bytes
    refresh = 2 * passes * state
    cells = dag.n_fields * batch * math.prod(geom_t.blocked_dims) * stream
    once = (2 * max(passes, 1) * (state + (padded * cell_bytes if has_aux
                                           else 0))
            + 2 * cells * cell_bytes)
    return refresh / device.mem_bw, once / device.mem_bw


def predict(stencil, dims: Sequence[int], iters: int, bsize,
            par_time: int, device: Device = H100_SXM, cell_bytes: int = 4,
            n_chips: int = 1, chip_grid: Sequence[int] | None = None,
            batch: int = 1, bc=None, par_vec: int = 1,
            n_cards: int | None = None) -> Prediction:
    """Paper Eqs. (3)-(9) with the compute, collective and issue terms.

    ``stencil``: a ``Stencil`` (one stage under ``bc``), a
    ``StencilProgram`` or a ``programs.DagSpec``.  ``batch``: ``run_batch``
    advances ``batch`` problems a launch; grid traffic and compute scale
    with it, the read-only aux stream (Hotspot's power, shared by the
    batch) is billed once.  ``bc``: a periodic stream axis bills the
    ``2 * rad * par_time`` stream extension the kernels stream.
    ``n_chips``/``chip_grid``: the grid split into shards along the
    streaming axis (or ``chip_grid``), each exchanging a ``rad *
    par_time`` halo a super-step, on ``n_cards`` distinct cards (None: one
    a shard).  Shards on distinct cards run at once and their exchange,
    over ``link_bw``, overlaps them; logical shards that share a card run
    one after another on it, and their exchange is a copy in its device
    memory (each strip read and written once at ``mem_bw``), after them.
    The issue term is one launch's (:func:`launch_terms`)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if isinstance(bsize, int):
        bsize = (bsize,) * (len(dims) - 1)
    dag = _program(stencil, bc, dims)
    rad, num_read, num_write, flop_pcu, has_aux = _stats(dag)
    local_dims = tuple(dims)
    cg = (1,) * len(dims)
    if n_chips > 1:
        cg = (tuple(chip_grid) if chip_grid
              else (n_chips,) + (1,) * (len(dims) - 1))
        local_dims = tuple(math.ceil(d / c) for d, c in zip(dims, cg))
    geom = BlockGeometry(len(dims), local_dims, rad, par_time,
                         tuple(bsize), par_vec)
    geom_t = extended_geometry(geom, dag.stages[0][1])

    # --- memory term (paper Eq. 3: th_mem saturates at the card's bw) -----
    step_bytes = superstep_traffic_bytes(geom_t, num_read, num_write,
                                         cell_bytes)
    if batch > 1:
        aux_bytes = (superstep_traffic_bytes(geom_t, 1, 0, cell_bytes)
                     if has_aux else 0)
        step_bytes = batch * step_bytes - (batch - 1) * aux_bytes
    t_mem = step_bytes / device.mem_bw

    # --- compute term: every traversed cell is updated par_time times -----
    cells_per_super = batch * geom_t.stream_dim * math.prod(
        n * b for n, b in zip(geom.bnum, geom.bsize))
    t_compute = cells_per_super * par_time * flop_pcu / device.f32_flops

    # --- issue term: waves x ticks a CTA x the form's cost a tick ---------
    terms = launch_terms(dag, geom, cell_bytes, device, batch)
    t_issue = terms["t_issue"]

    # --- collective term: halo exchange once per super-step ---------------
    t_halo = 0.0
    cards = n_chips if n_cards is None else max(1, min(n_cards, n_chips))
    per_card = -(-n_chips // cards)      # shards a card runs in turn
    if n_chips > 1:
        local_cells = math.prod(local_dims)
        halo_cells = sum(geom.size_halo * local_cells // local_dims[ax]
                         for ax, c in enumerate(cg) if c > 1)
        halo_bytes = 2 * batch * halo_cells * cell_bytes * max(num_read, 1)
        t_halo = (halo_bytes / device.link_bw if cards > 1
                  else n_chips * 2 * halo_bytes / device.mem_bw)

    n_super = math.ceil(iters / par_time)
    # --- driver term: the halo refresh between launches, serial with them
    t_driver, t_once = driver_times(geom_t, dag, batch, has_aux,
                                    cell_bytes, device)
    t_kernel = per_card * max(t_mem, t_compute, t_issue)
    t_step = max(t_kernel, t_halo) if cards > 1 else t_kernel + t_halo
    run_time = n_super * (t_step + per_card * t_driver) + per_card * t_once
    total_cells = batch * math.prod(dims) * iters
    bound = ("issue" if t_issue >= max(t_mem, t_compute, t_halo)
             else "memory" if t_mem >= max(t_compute, t_halo)
             else "compute" if t_compute >= t_halo else "collective")
    sp = terms["split"]
    return Prediction(
        geom=geom, t_mem=t_mem, t_compute=t_compute, t_halo=t_halo,
        n_super=n_super, run_time=run_time,
        gbytes_s=n_super * step_bytes / run_time,
        gcells_s=total_cells / run_time,
        gflops=total_cells * flop_pcu / run_time,
        smem_bytes=terms["smem"], bound=bound, batch=batch, t_issue=t_issue,
        t_driver=t_driver, t_once=t_once,
        form=terms["form"], kernel=sp.kernel, ctas=sp.ctas,
        per_sm=terms["per_sm"], waves=terms["waves"], ticks=terms["ticks"])


def autotune(stencil, dims: Sequence[int], iters: int,
             device: Device = H100_SXM, cell_bytes: int = 4,
             par_time_max: int = 64, n_chips: int = 1,
             chip_grid: Sequence[int] | None = None, *,
             n_cards: int | None = None,
             par_time: int | None = None,
             bsize: Sequence[int] | None = None,
             par_vec: int | None = None,
             par_vecs: Sequence[int] | None = None,
             top_k: int | None = None, bc=None) -> list:
    """Design-space pruning (paper §5.3): power-of-two ``par_time`` up to
    ``par_time_max`` × ``choose_bsize_candidates`` × ``par_vec`` over
    :func:`par_vec_candidates`, keeping the schedules the kernel runs
    (``bsize_feasible`` and ``builder.kernel_limits``, the rule the
    ``hopper`` backend refuses by), ranked by predicted run time, best
    first.  A pinned ``par_time``, ``bsize`` or ``par_vec`` constrains the
    sweep to that value.  ``top_k`` keeps the best ``top_k``.  May return
    ``[]``."""
    from repro_torch.kernels import builder
    dag = _program(stencil, bc, dims)
    rad = _stats(dag)[0]
    nd = len(dims)
    local = tuple(dims)
    if n_chips > 1:
        cg = (tuple(chip_grid) if chip_grid
              else (n_chips,) + (1,) * (nd - 1))
        local = tuple(math.ceil(d / c) for d, c in zip(dims, cg))
    if par_time is not None:
        pts = [par_time]
    else:
        pts, pt = [], 1
        while pt <= par_time_max:
            pts.append(pt)
            pt *= 2
    if par_vecs is None:
        par_vecs = par_vec_candidates(cell_bytes)
    pvs = [par_vec] if par_vec is not None else list(par_vecs)
    cands = []
    for pt in pts:
        if bsize is not None:
            bss = [tuple(bsize)] if bsize_feasible(rad, pt, bsize) else []
        else:
            bss = choose_bsize_candidates(nd, local, rad, pt, cell_bytes)
        for bs in bss:
            for pv in pvs:
                geom = BlockGeometry(nd, local, rad, pt, tuple(bs), pv)
                if builder.kernel_limits(geom, dag, cell_bytes) is not None:
                    continue
                cands.append(predict(dag, dims, iters, bs, pt, device,
                                     cell_bytes, n_chips, chip_grid,
                                     par_vec=pv, n_cards=n_cards))
    cands.sort(key=lambda p: p.run_time)
    return cands if top_k is None else cands[:top_k]


def model_accuracy(measured_s: float, predicted: Prediction) -> float:
    """Paper §6.2: estimated over measured time."""
    return predicted.run_time / measured_s

