#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port runs on the card.

    python3 chip_smoke.py

On one CUDA card, from the root of a checkout:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the streaming kernel and the flash forward and backward kernels
   from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, in
   parallel) and prints the build seconds and the compiler's register
   reports;
3. drives ``plan(StencilProblem(s, dims), RunConfig(backend="hopper",
   par_time=T, bsize=B)).run(grid, iters=2T+3, aux=...)`` for the four
   Table-2 stencils at the paper's sizes (16384^2 and 448^3, inputs made
   from a seed on the card), asserts that the run launched the kernel
   ``ceil(iters/T)`` times, and holds the result against the port's
   ``reference`` backend within ``precision.tolerance``; then times warm
   runs and profiles one for the kernel's share of device time;
4. for one super-step per stencil, with ``steps = T`` and ``steps < T``,
   holds the kernel against its plain version on the same padded inputs,
   with the output pre-filled with NaN so that a column the kernel should
   write and does not shows; times kernel, plain version and a cuDNN
   convolution yardstick (checked against the oracle on a small grid
   first) with CUDA events, and computes the bound from the bytes and
   FLOPs of the super-step; for this row and every later row of the
   streaming kernel (main path, chains and the DAG bodies) it prints how
   the launch split the stream (segments, CTAs a launch and an SM,
   warm-up slabs and share, barriers a tick and why a DAG launch takes
   one an entry, slabs copied ahead, the bytes of the kernel's rings) and
   the kernel's registers and spills (its build log);
5. drives the stage programs of ``PROGRAMS`` (the chains of
   ``benchmarks/programs.py::FULL_CASES`` and a 3D chain, at the same
   sizes): ``plan(StencilProblem([StencilStage(...), ...], dims),
   RunConfig(backend="hopper", ...)).run(grid, iters=2T+3)`` through the
   chain body's one-barrier form, ``chain_win_kernel`` (Table-2 device
   functions and ``make_star`` tap tables in one chain, radius-0
   stages), asserting ``ceil(iters/T)`` launches, every one of them a
   launch of that kernel (``builder.KERNEL_LAUNCHES``, set to empty just
   before the run; every later counted run holds its launches to its
   route the same way), and the result within
   ``precision.tolerance(..., stages=S)`` of the ``reference`` backend;
   prints run ms and GCell/s, one profiled run, one super-step of the
   kernel against its plain version bit for bit (with and without PE
   forwarding), kernel, plain and cuDNN yardstick times (``S x T``
   convolutions with the same taps) against the bound, for
   advect_diffuse2d the chain form's ring form at T = 8 (16 entries,
   past the register form's 8) held bit for bit against the plain
   version and timed, and the fused plan against ``S``
   chained single-stage ``hopper`` plans at T=1 (run ms, speedup, max
   abs difference within the same tolerance);
6. drives the stage DAGs of ``DAGS`` (``benchmarks/programs.py::
   DAG_FULL_CASES``' wave equation and diamond, and the wave equation in
   3D, at the same sizes): ``plan(StencilProblem(program, dims,
   boundary=...), RunConfig(backend="hopper", ...)).run(state,
   iters=2T+3)`` through the kernel's DAG body in its one-barrier form
   (two field streams, a 3-way combine and state nodes; fan-out and a
   2-way fan-in; periodic and clamp boundaries; the stream split across
   CTAs), asserting ``ceil(iters/T)`` launches and the result within
   ``precision.tolerance(..., stages=S)`` of the ``reference`` backend;
   prints run ms and GCell/s (grid cells x iterations), one profiled run,
   one super-step of the kernel against its plain version bit for bit
   (with and without forwarding), kernel, plain and a composed yardstick
   (one cuDNN convolution per tap stage, ``torch.mul``/``torch.add`` per
   combine) against the bound;
7. drives V-row slabs (``PAR_VEC``: the four stencils at V = 2, 4, 8 in 2D
   and 2, 4 in 3D, advect_diffuse2d and wave2d at V = 4, on the earlier
   phases' inputs and schedules) and the 1D entry (``star1d_r2`` over
   2**20 cells, one block whose stream is split across thousands of
   CTAs, T=4, at V = 1 against the reference backend and
   the conv1d yardstick, then V = 16): for each, one super-step bit for
   bit against the plain version, then ``plan(..., RunConfig(...,
   par_vec=V)).run`` with ``ceil(iters/T)`` launches and a result equal
   to the V = 1 run bit for bit; prints run ms and GCell/s, the super-step
   beside V = 1's, plain, the V = 1 yardstick and the bound, and the
   phase's seconds;
8. runs the bf16 phase (``BF16_VECS``: the four stencils, advect_diffuse2d
   and wave2d on their f32 cells' inputs cast to bf16, at V = 1 and the
   Vs of the f32 runs — 2D also at V = 16, which plans only in bf16 — and
   the 1D star at V = 16): per V one super-step bit for bit against the
   plain version, the counted run in bf16 equal to the bf16 V = 1 run bit
   for bit (V = 1 within ``precision.tolerance("bfloat16", ...)`` of the
   reference backend), the times beside f32's at the same V, the bytes
   bound at 2 bytes a cell, a cuDNN yardstick in bf16 and the DMA bytes,
   at most 0.6 of f32's;
9. runs the boundary phase (``BC_CASES``: diffusion2d under reflect and
   constant 1.5, hotspot3d mixed per axis, advect_diffuse2d with a reflect
   and a constant stage, diamond2d under reflect, and diffusion2d constant
   1.5 in bf16): the same checks and times at V = 1, beside the clamp
   cell's, with the yardstick padded under the same boundary;
10. runs the B1k/B1j phase (``B1KJ_CASES``): diamond2d at 16384², T=2,
    bsize 256 with a clamp, b reflect and m constant 0, in f32 and bf16,
    and wave3d at 448³, T=2, 32×32 with a reflect Laplacian and a clamp
    combine, through the mixed-boundary DAG body; the four stencils at
    bsize 2048 (2D, T=8) and 64×64 (3D, T=4) through the wide form; two
    ``make_box(3, 2)`` stages (250 taps) at 448³, 32×32, T=2 through the
    large-table route: per case a super-step bit for bit against the plain
    version, the counted run within tolerance of the reference backend,
    times with their spread, the bound, CTAs and redundancy, the
    yardstick, and the rows of the same cell it is compared with; for the
    large-table chain also what bounds it: the cells its CTAs compute a
    cell they own, its taps a cell, and the instructions and
    shared-memory loads of one tap in ``chain_kernel_big``'s SASS;
11. runs the custom phase (``CUSTOM_CASES``): programs of stencils with
    their own ``apply`` — Allen-Cahn at 16384², T=8, bsize 256 in f32 and
    bf16; the two-field periodic Gray-Scott DAG at 2 × 16384², T=4; upwind
    transport at 448³, 32×32, T=4 with a standard normal velocity — each
    through a library generated for it (``kernels/codegen.py``; the four
    built at once, one ``nvcc`` each, and timed): a super-step bit for
    bit against the plain version, the counted run within
    ``tolerance(dtype, iters, stages)`` of the reference backend, the warm
    run (median of 5), a composed yardstick (cuDNN for the linear part,
    torch elementwise ops for the rest, checked on a small grid first),
    the bound and the build seconds;
12. runs the batch phase (``BATCH_CASES``: diffusion2d and hotspot2d with
    one shared power grid at 16384^2, B = 4; hotspot3d at 448^3, B = 8,
    a power grid per member; advect_diffuse2d and the periodic wave2d,
    B = 2; diffusion2d in bf16 at V = 8, B = 4; iters = 2T+3): per case
    ``run_batch`` bit for bit against the B sequential ``run``s, one launch
    per super-step for the whole batch (``ceil(iters/T)``, B x num_blocks
    CTAs each), ``run_batch`` ms against the sequential loop's, one
    batched super-step bit for bit against the plain version, the batched
    cuDNN yardstick (N = B), the bound and the peak memory; then
    ``prewarm((1, 2, 4, 8))`` of a 4096^2 plan, first call and repeat;
13. serves stencil requests (``serve_phase``): one ``StencilService`` with
    a diffusion2d and a hotspot2d bucket (a power grid per request) at
    4096^2, T=8, bsize 256, batch classes (1, 2, 4, 8); 64 requests each,
    iters 8 or 16, seeded open-loop Poisson arrivals at twice the rate of
    the sequential ``plan.run`` loop timed first; every delivered grid bit
    for bit with the loop's; delivered GCell/s against the loop's, p50/p99
    latency, batch fill, rounds, rejections and launches; then an injected
    ``serve.launch`` failure (retried and served), a NaN member
    (quarantined with ``NumericalFault`` while its three neighbours
    deliver) and a checkpointed request killed after its first chunk and
    resubmitted (resumed bit for bit); and the kernel at the serving shape
    (hotspot2d, B = 8) against its plain version and yardstick;
14. serves full-width qwen3-1.7b (bf16, random weights from a seed)
    through ``repro_torch.launch.serve.generate`` at batch 8 x prompt 4096
    + 16 new tokens, asserts 28 flash-kernel launches in prefill (one per
    layer) and none in decode, tokens in the vocab and finite logits; times
    a warm run and profiles one prefill for the kernel's share of device
    time; holds the kernel against its plain version on layer 0's q, k, v
    (output pre-filled with NaN), the ``"flash"`` prefill against the
    ``"xla"`` one, and teacher-forced decode against prefill; times kernel,
    plain version and ``scaled_dot_product_attention`` as the yardstick;
15. trains full-width qwen3-1.7b (bf16, AdamW, ``remat_policy="full"``,
    ``attn_impl="flash"``) through ``make_train_step`` at batch 8 x 4096
    (``train_4k``'s sequence, its batch of 256 cut to 8): 4 steps with one
    microbatch and 2 with two, asserting finite losses, the first within
    1.0 of the same batch's loss without autograd, and 56 forward, 28 dQ
    and 28 dK/dV kernel launches per step (twice that with two
    microbatches); prints step time, tokens/s, peak memory and one
    profiled step; holds both backward kernels against their plain version
    on layer 0's q, k, v and the real output gradient from the first
    batch's backward (``check_bwd_against_plain``), times them beside the
    plain version and the backward of ``scaled_dot_product_attention``;
    holds the ``"flash"`` loss and every gradient leaf against ``"xla"`` at
    full width on a 1 x 4096 batch; and runs ``fault_tolerant_train`` at
    the smoke width (bf16, head dim 128, so the kernels run) with an
    injected failure and a restart, asserting the uninterrupted run's
    losses bit for bit;
16. runs the A16b phase: (a) every flash form this slice adds
    (``NEW_FORMS``: f32 at head dims 8, 12, 16, 64, 112, 128, bf16 at 64
    and 112; forward, dQ and dK/dV) at B 8, S 4096, H 16, Hkv 8, causal,
    each held against its plain version (outputs pre-filled with NaN,
    ``check_against_plain``/``check_bwd_against_plain`` for its dtype) and
    timed beside its plain version, ``scaled_dot_product_attention``
    (causal, GQA; forward, and backward as grad minus forward, checked to
    compute the same function) and its bound at the dtype's peak rate,
    and the bf16 dQ and dK/dV at granite-3-8b's and glm4-9b's heads (H 32
    on Hkv 8 and 2) the same way;
    (b) serves granite-3-8b, phi4-mini-3.8b and glm4-9b at full width in
    bf16 like qwen3-1.7b (``serve_arch``: prefill, decode, tokens/s, peak
    memory, n_layers flash launches a prefill, layer 0's flash output
    against its plain version), one after another; (c) trains phi4-mini
    at batch 2 x 4096 for 3 steps (``train_arch``: step ms, tokens/s,
    peak memory, launches a step, both backward kernels against their
    plain version through ``capture_layer0``) and says why granite and
    glm4 do not train at full width; (d) serves and trains the four dense
    archs' smoke configs in f32, and qwen3-1.7b's at the other head dims
    (``SWEEP``), on the card and on the CPU from the same weights
    (``smoke_run``: exact launch counts, logits and losses within
    ``SMOKE_TOL``); every new form must have launched on (b)-(d);
17. prints one ``{"kernels": [...]}`` line and, last, the device line.

Every timed median is printed and reported with the min and max of its
samples.  Any failed check raises, and the script exits non-zero.  It
exits non-zero without a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))

#: the paper-scale sizes of benchmarks/table4_stencil.py (FULL_DIMS)
FULL_DIMS = {2: (16384, 16384), 3: (448, 448, 448)}
#: pinned schedules: (par_time, bsize) per rank
SCHEDULE = {2: (8, (256,)), 3: (4, (32, 32))}
STENCILS = ("diffusion2d", "hotspot2d", "diffusion3d", "hotspot3d")
SOURCE = "src/repro_torch/kernels/csrc/stencil_stream.cu"
#: the names of its kernels: the main-path, chain and DAG bodies (the
#: chain body's one-barrier form is ``chain_win_kernel``)
STENCIL_KERNELS = ("main_kernel", "chain_kernel", "chain_win_kernel",
                   "stream_kernel", "dag_kernel")
REPLACES = "src/repro/kernels/builder.py:81"

#: data-sheet peaks per card variant: (device-memory bytes/s, f32 FLOP/s
#: outside the tensor cores, dense bf16 tensor-core FLOP/s), matched
#: against the nvidia-smi name
PEAKS = (("H100 PCIe", 2.0e12, 51.2e12, 756e12),
         ("H100 NVL", 3.9e12, 60.0e12, 835e12),
         ("H200", 4.8e12, 67.0e12, 989e12),
         ("H100", 3.35e12, 67.0e12, 989e12))


def peaks_for(card_name: str):
    for key, *peaks in PEAKS:
        if key in card_name:
            return tuple(peaks)
    raise RuntimeError(f"no data-sheet peaks for {card_name!r}")


class Timing(float):
    """A median of device milliseconds that carries the ``lo`` and ``hi``
    of its samples."""
    lo: float
    hi: float

    def __new__(cls, times):
        t = super().__new__(cls, statistics.median(times))
        t.lo, t.hi = min(times), max(times)
        return t

    def __str__(self):
        return f"{float(self):.3f} ms [{self.lo:.3f}-{self.hi:.3f}]"


def with_spread(row: dict) -> dict:
    """``row`` with the min and max beside each :class:`Timing` ``x_ms``
    (``x_min_ms``, ``x_max_ms``; ``min_ms``, ``max_ms`` beside ``ms``),
    for the JSON line."""
    out = {}
    for k, v in row.items():
        out[k] = v
        if isinstance(v, Timing):
            pre = k[:-2] if k.endswith("ms") else f"{k}_"
            out[f"{pre}min_ms"], out[f"{pre}max_ms"] = v.lo, v.hi
    return out


def time_ms(fn, reps: int, warmup: int = 1) -> Timing:
    """Median device milliseconds of ``fn`` over ``reps`` runs (CUDA
    events, after ``warmup`` untimed runs), with their min and max."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return Timing(times)


def bound(problem, par_time: int, peaks) -> dict:
    """The least time one super-step could take: every field (and aux)
    read once and every field written once at the storage dtype's cell
    size, against ``par_time`` times the FLOPs of every stage
    (``flop_pcu`` sums them) on every cell."""
    cells = math.prod(problem.shape)
    bytes_once = ((problem.stencil.num_read + len(problem.fields)) * cells
                  * problem.cell_bytes)
    flops = par_time * problem.stencil.flop_pcu * cells
    bw, fp32, _ = peaks
    t_bytes, t_ops = bytes_once / bw * 1e3, flops / fp32 * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": bytes_once, "bound_flops": flops}


def inputs(name, dims, device, seed):
    """Grid ``uniform(0.5, 2)`` and, for Hotspot, power ``uniform(0,
    0.1)``, made on ``device`` from ``seed``."""
    import torch
    from repro_torch.core.stencils import STENCILS as ST
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.empty(dims, device=device).uniform_(0.5, 2.0, generator=gen)
    aux = None
    if ST[name].has_aux:
        aux = torch.empty(dims, device=device).uniform_(0.0, 0.1,
                                                        generator=gen)
    return g, aux


def drive_main_path(name, dims, par_time, bsize, device, seed=0) -> dict:
    """plan().run() through the kernel, its launch count, and the result
    against the port's oracle on the same device."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import precision
    from repro_torch.kernels import builder
    iters = 2 * par_time + 3
    g, aux = inputs(name, dims, device, seed)
    p = plan(StencilProblem(name, dims),
             RunConfig(backend="hopper", par_time=par_time, bsize=bsize,
                       device=device))
    torch.cuda.synchronize()
    builder.LAUNCHES = 0
    builder.KERNEL_LAUNCHES.clear()
    out = p.run(g, iters, aux=aux)
    torch.cuda.synchronize()
    launches = builder.LAUNCHES
    by_kernel = launched_kernels(name, p)
    want = math.ceil(iters / par_time)
    if launches != want:
        raise AssertionError(f"{name}: run launched the kernel {launches} "
                             f"times, expected {want}")
    if tuple(out.shape) != tuple(dims) or not bool(out.isfinite().all()):
        raise AssertionError(f"{name}: result not finite of shape {dims}")
    ref = plan(StencilProblem(name, dims),
               RunConfig(backend="reference", device=device)).run(
                   g, iters, aux=aux)
    scale = 100 if name.startswith("hotspot") else None
    torch.testing.assert_close(out, ref, **precision.tolerance(
        "float32", iters, scale=scale))
    err = (out - ref).abs().max().item()
    return {"iters": iters, "launches": launches,
            "oracle_max_abs_err": err, "plan": p, "g": g, "aux": aux,
            "out": out, "launches_by_kernel": by_kernel}


#: the marker kernel that :func:`device_profile` launches before and after
#: the call it profiles (``torch.cuda._sleep``), its length in clocks, and
#: the spins of a pad and the clocks of each
PROFILE_MARKER = "spin_kernel"
PROFILE_MARKER_CYCLES = 1000
PROFILE_PAD_SPINS, PROFILE_PAD_CYCLES = 64, 6_000_000


def _pad():
    """A pad: ``PROFILE_PAD_SPINS`` spins of about 3 ms each, waited for."""
    import torch
    for _ in range(PROFILE_PAD_SPINS):
        torch.cuda._sleep(PROFILE_PAD_CYCLES)
    torch.cuda.synchronize()


def _marked_profile(fn):
    """``fn`` profiled between two marker kernels: its device events
    (start us, end us, name) without the markers and pads, the markers'
    (start, end) in order of start, and its milliseconds between CUDA
    events.  In some of this script's profiles the profiler lost, on an
    H100, the device events of the session's first 54 ms: a 50 ms spin,
    the marker after it and the first kernels of a prefill.  So a pad of
    about 200 ms of spins runs before the first marker and one after the
    last, and the markers show that nothing of ``fn`` was lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad()
        torch.cuda._sleep(PROFILE_MARKER_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda._sleep(PROFILE_MARKER_CYCLES)
        torch.cuda.synchronize()
        _pad()
    # device-side events only (CPU ops also carry their kernels' time)
    device = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
    # a marker runs for a microsecond or two, a pad's spin for milliseconds
    marks = [(s, t) for s, t, n in device
             if PROFILE_MARKER in n and t - s < 100]
    spans = [e for e in device
             if PROFILE_MARKER not in e[2] and e[1] > e[0]]
    return spans, marks, start.elapsed_time(end)


def device_profile(fn, kernel_key, top: int = 3) -> dict:
    """One profiled call of ``fn``: its own span between CUDA events, the
    union of its device-event intervals (busy), the share of busy time in
    kernels whose name holds ``kernel_key`` (a string or a tuple of them;
    when given), the idle share of
    the span, and the ``top`` largest other device times.  Busy and the
    span it is a share of are both read on the device's clock: the span
    runs from the end of a marker kernel launched just before ``fn`` to
    the start of one launched just after it, on the same stream, after a
    synchronize that leaves nothing earlier in flight.  A span read on the
    host (CUDA events, or the profiler's host range) is on another clock,
    and a device busy about 1% short of a nearly saturated span exceeded
    it by 0.6% on an H100 with CUDA events and by 0.4% with the host
    range.  Every device event must lie between the markers."""
    spans, marks, run_ms = _marked_profile(fn)
    if len(marks) != 2:
        raise AssertionError(f"the profiler saw {len(marks)} marker kernels "
                             f"({PROFILE_MARKER}) at {marks}, expected 2")
    lo, hi = marks[0][1], marks[1][0]
    if not spans:
        raise AssertionError("the profiler saw no device time")
    outside = [e for e in spans if e[0] < lo or e[1] > hi]
    if outside:
        raise AssertionError(
            f"{len(outside)} device events lie outside the markers' span "
            f"[{lo}, {hi}] us, e.g. {outside[:3]}")
    span_us = hi - lo
    busy, reach = 0.0, -math.inf
    for s, t, _ in spans:
        busy += max(0.0, t - max(s, reach))
        reach = max(reach, t)
    per_name = {}
    for s, t, n in spans:
        per_name[n] = per_name.get(n, 0.0) + (t - s)
    keys = ((kernel_key,) if isinstance(kernel_key, str)
            else kernel_key or ("\0",))
    kernel = sum(t for n, t in per_name.items()
                 if any(k in n for k in keys))
    if kernel_key and kernel <= 0:
        raise AssertionError(f"the profiler saw no {kernel_key} launch")
    if kernel > busy or busy > span_us:
        raise AssertionError(f"device times do not add up: kernel {kernel} "
                             f"us, busy {busy} us, span {span_us} us")
    # summed by the name's first 60 characters: templated kernels share them
    short = {}
    for n, t in per_name.items():
        if not any(k in n for k in keys):
            short[n[:60]] = short.get(n[:60], 0.0) + t
    others = sorted(((t, n) for n, t in short.items()), reverse=True)[:top]
    out = {"profiled_run_ms": run_ms,
           "device_busy_ms": busy / 1e3,
           "device_idle_share": 1 - busy / span_us,
           "device_ops": len(spans),
           "top_other_device_us": {n: t for t, n in others}}
    if kernel_key:
        out["kernel_share_of_device"] = kernel / busy
    return out


def breakdown(main: dict) -> dict:
    """Where one warm ``run`` spends its time: its milliseconds between
    CUDA events (median of 3), and :func:`device_profile` of one run."""
    p, g, aux, iters = main["plan"], main["g"], main["aux"], main["iters"]
    run_ms = time_ms(lambda: p.run(g, iters, aux=aux), reps=3)
    prof = device_profile(lambda: p.run(g, iters, aux=aux), STENCIL_KERNELS)
    cells = math.prod(p.problem.shape)     # grid cells, not field values
    return {"run_ms": run_ms,
            "run_gcells_per_s": cells * iters / run_ms / 1e6, **prof}


#: boundary kind -> the ``F.pad`` mode that applies it
PAD_MODES = {"clamp": "replicate", "periodic": "circular",
             "reflect": "reflect", "constant": "constant"}


def pad_bc(x, r: int, bc):
    """``x`` of shape ``(1, C, *grid)`` padded by ``r`` on every grid axis
    under ``bc`` (None: clamp): one ``F.pad`` when every axis has one
    kind, else one per axis."""
    import torch.nn.functional as F
    from repro_torch.core import boundary
    nd = x.ndim - 2
    kinds = boundary.kinds_of(bc, nd)
    fill = boundary.fill_of(bc)
    if len(set(kinds)) == 1:
        value = fill if kinds[0] == "constant" else None
        return F.pad(x, (r,) * (2 * nd), mode=PAD_MODES[kinds[0]],
                     value=value)
    for ax, kind in enumerate(kinds):
        pad = [0] * (2 * nd)
        pad[2 * (nd - 1 - ax)] = pad[2 * (nd - 1 - ax) + 1] = r
        x = F.pad(x, pad, mode=PAD_MODES[kind],
                  value=fill if kind == "constant" else None)
    return x


def library_yardstick(name, g, aux, par_time, bc=None):
    """``par_time`` steps of one cuDNN convolution with bias over the grid
    padded under ``bc`` (clamp when None), in the grid's dtype (full
    float32 or bf16): the same update as one PyTorch call per step.  Every
    Table-2 update is linear: the taps weigh channel 0, the grid; for
    Hotspot, channel 1 is the edge-padded power, weighed ``sdc`` at the
    centre, and the ambient term is the bias."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.stencils import STENCILS as ST
    from repro_torch.core.stencils import TEMP_AMB, default_coeffs
    c = {k: float(v) for k, v in default_coeffs(ST[name]).items()}
    nd = ST[name].ndim
    mid = (1,) * nd
    if name == "hotspot2d":
        sdc = c["sdc"]
        c = {"cc": 1 - 2 * sdc * c["ry1"] - 2 * sdc * c["rx1"]
             - sdc * c["rz1"], "cn": sdc * c["ry1"], "cs": sdc * c["ry1"],
             "cw": sdc * c["rx1"], "ce": sdc * c["rx1"], "sdc": sdc,
             "bias": sdc * c["rz1"] * TEMP_AMB}
    elif name == "hotspot3d":
        c["bias"] = c["ca"] * TEMP_AMB
    chans = 1 if aux is None else 2
    w = torch.zeros((1, chans) + (3,) * nd, device=g.device, dtype=g.dtype)
    w0 = w[0, 0]
    w0[mid] = c["cc"]
    w0[(0,) + mid[1:]] = c["cn"] if nd == 2 else c["cb"]
    w0[(2,) + mid[1:]] = c["cs"] if nd == 2 else c["ca"]
    w0[mid[:-1] + (0,)] = c["cw"]
    w0[mid[:-1] + (2,)] = c["ce"]
    if nd == 3:
        w0[1, 0, 1] = c["cn"]
        w0[1, 2, 1] = c["cs"]
    bias = None
    if aux is not None:
        w[(0, 1) + mid] = c["sdc"]
        bias = torch.tensor([c["bias"]], device=g.device, dtype=g.dtype)
    conv = F.conv2d if nd == 2 else F.conv3d
    pad = (1, 1) * nd
    # a batch (a leading axis on g) is the convolution's N; the power is
    # shared by the batch or one per member
    x0 = g[:, None] if g.ndim > nd else g[None, None]
    aux_p = None
    if aux is not None:
        aux_p = F.pad(aux[:, None] if aux.ndim > nd else aux[None, None],
                      pad, mode="replicate").expand(
                          (x0.shape[0], 1) + (-1,) * nd)

    def run():
        x = x0
        for _ in range(par_time):
            x = pad_bc(x, 1, bc)
            if aux_p is not None:
                x = torch.cat([x, aux_p], dim=1)
            x = conv(x, w, bias)
        return x[:, 0] if g.ndim > nd else x[0, 0]
    return run


def check_yardstick(name, par_time, device, seed=1, bc="clamp",
                    dtype="float32") -> float:
    """The yardstick against the port's oracle on a small grid, under
    ``bc`` and in ``dtype``: it must compute the same function to stand
    beside the kernel."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import precision
    dims = (40, 56) if name.endswith("2d") else (12, 20, 28)
    g, aux = inputs(name, dims, device, seed)
    problem = StencilProblem(name, dims, boundary=bc, dtype=dtype)
    g = g.to(problem.torch_dtype)
    aux = None if aux is None else aux.to(problem.torch_dtype)
    got = library_yardstick(name, g, aux, par_time, problem.bc)()
    want = plan(problem, RunConfig(backend="reference", device=device)).run(
        g, par_time, aux=aux)
    scale = 100 if name.startswith("hotspot") else None
    torch.testing.assert_close(got, want, **precision.tolerance(
        dtype, par_time, scale=scale))
    return (got - want).abs().max().item()


_PTXAS: dict = {}


def ptxas_of(library: str, kernel: str) -> dict:
    """Registers and spill bytes of ``kernel`` in the stencil library
    ``library`` (its build log, ``-Xptxas -v``)."""
    import re
    from pathlib import Path
    from repro_torch.kernels import _build
    if library not in _PTXAS:
        _PTXAS[library] = dict(_build.ptxas_report(Path(library),
                                                   all_args=True))
    report = _PTXAS[library].get(kernel, "")
    num = lambda pat: int(m.group(1)) if (  # noqa: E731
        m := re.search(pat, report)) else None
    return {"registers": num(r"Used (\d+) registers"),
            "spill_stores": num(r"(\d+) bytes spill stores"),
            "spill_loads": num(r"(\d+) bytes spill loads")}


def split_fields(name: str) -> dict:
    """How the launch just timed split the stream (``builder.LAST_SPLIT``):
    its segments, CTAs a launch and an SM, warm-up share, barriers a tick
    and their form, the bytes of the kernel's rings, and the kernel's
    registers and spills, printed for every row of the streaming kernel."""
    from repro_torch.kernels import builder
    sp = builder.LAST_SPLIT
    if sp is None:
        return {}
    out = {"segments": sp.nseg, "segment_slabs": sp.seg,
           "warm_slabs": sp.warm, "ctas_per_launch": sp.ctas,
           "ctas_per_sm": sp.per_sm, "warm_share": sp.warm_share,
           "barriers_per_tick": sp.barriers, "barrier_form": sp.form,
           "copies_ahead": sp.look, "ring_bytes": sp.ring_bytes,
           "kernel": sp.kernel, **ptxas_of(sp.library, sp.kernel)}
    print(f"  split ({name}): {sp.nseg} segments of {sp.seg} slabs, "
          f"{sp.ctas} CTAs a launch ({sp.per_sm} an SM), warm-up "
          f"{sp.warm} slabs ({sp.warm_share:.4f} of the stream), "
          f"{sp.barriers} barrier(s) a tick ({sp.form}), {sp.look} slabs "
          f"copied ahead, rings {sp.ring_bytes} bytes; {sp.kernel}: "
          f"{out['registers']} registers, spills {out['spill_stores']}/"
          f"{out['spill_loads']} B", flush=True)
    return out


def compare_and_time(name, main: dict, peaks) -> dict:
    """One super-step, kernel against plain version, with and without PE
    forwarding; then the times and the bound."""
    import torch
    from repro_torch.core import precision
    from repro_torch.core.stencils import STENCILS as ST
    from repro_torch.core.stencils import default_coeffs
    from repro_torch.kernels import builder, ops
    st = ST[name]
    geom = main["plan"].geometry
    T = geom.par_time
    gp = ops._pad_blocked(main["g"], geom)
    aux_p = None if main["aux"] is None else ops._pad_blocked(main["aux"],
                                                             geom)
    c = ops.pack_coeffs(st, default_coeffs(st))
    h = geom.size_halo
    region = (slice(None),) + tuple(slice(h, h + n * cs) for n, cs in
                                    zip(geom.bnum, geom.csize))
    stages = ((st, None),)
    out = torch.empty_like(gp)
    err = 0.0
    for steps in (T, T - 1):
        out.fill_(float("nan"))
        builder.superstep_chain(stages, geom, gp, c, steps, aux_p, out=out)
        torch.cuda.synchronize()
        plain = builder.superstep_plain(stages, geom, gp, c, steps, aux_p,
                                        torch.full_like(gp, float("nan")))
        got, want = out[region], plain[region]
        if bool(got.isnan().any()):
            raise AssertionError(f"{name}: kernel left compute cells "
                                 f"unwritten (steps={steps})")
        if int((~out.isnan()).sum()) != got.numel():
            raise AssertionError(f"{name}: kernel wrote outside the "
                                 f"compute region (steps={steps})")
        torch.testing.assert_close(got, want, **precision.tolerance(
            "float32", steps, scale=100))
        err = max(err, (got - want).abs().max().item())
        del plain, got, want
    kernel_ms = time_ms(lambda: builder.superstep_chain(
        stages, geom, gp, c, T, aux_p, out=out), reps=5)
    split = split_fields(name)
    plain_ms = time_ms(lambda: builder.superstep_plain(
        stages, geom, gp, c, T, aux_p, torch.empty_like(gp)), reps=3)
    library_err = check_yardstick(name, T, gp.device)
    library_ms = time_ms(library_yardstick(name, main["g"], main["aux"], T),
                         reps=3)
    # halo and overhang cells are not needed by the bound: clamping reads
    # edge values
    dma = ops.dma_traffic_bytes(st, geom)
    return {
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms, **split,
        "library_ms": library_ms, "library_small_max_abs_err": library_err,
        **bound(main["plan"].problem, T, peaks), "dma_bytes": dma,
        "dma_bound_ms": dma / peaks[0] * 1e3,
        "gcells_per_s": math.prod(geom.dims) * T / kernel_ms / 1e6,
    }


# --- stage programs: linear chains fused into one super-step --------------

#: the chains of benchmarks/programs.py::FULL_CASES and tests/
#: test_programs.py's two-stage 3D chain, at FULL_DIMS: (rank, par_time,
#: bsize) per program
PROGRAMS = {"advect_diffuse2d": (2, 4, (256,)),
            "diffuse_damp2d": (2, 4, (256,)),
            "star_diffuse3d": (3, 2, (32, 32))}


def program_stages(name):
    """The stages of program ``name``: ``star2d_r1`` with the advect
    coefficients of ``benchmarks/programs.py::_advect2d`` then
    ``diffusion2d``; ``diffusion2d`` then a ``star2d_r0`` damp (``c0 =
    0.995``); ``star3d_r1`` then ``diffusion3d``."""
    from repro_torch.api import StencilStage
    from repro_torch.core.stencils import make_star
    if name == "advect_diffuse2d":
        return [StencilStage(make_star(2, 1),
                             coeffs={"c0": 0.7, "c_0_-1": 0.1, "c_0_1": 0.0,
                                     "c_1_-1": 0.2, "c_1_1": 0.0},
                             name="advect"),
                StencilStage("diffusion2d")]
    if name == "diffuse_damp2d":
        return [StencilStage("diffusion2d"),
                StencilStage(make_star(2, 0), coeffs={"c0": 0.995},
                             name="damp")]
    return [StencilStage(make_star(3, 1)), StencilStage("diffusion3d")]


def grid_input(dims, device, seed):
    """A grid ``uniform(0.5, 2)`` made on ``device`` from ``seed``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.empty(dims, device=device).uniform_(0.5, 2.0,
                                                     generator=gen)


def drive_plan(name, problem, par_time, bsize, device, seed=0) -> dict:
    """plan().run() of a stage program through the kernel, its launch
    count, and the result against the port's reference backend."""
    import torch
    from repro_torch.api import RunConfig, plan
    from repro_torch.core import precision
    from repro_torch.kernels import builder
    iters = 2 * par_time + 3
    g = grid_input(problem.state_shape, device, seed)
    p = plan(problem, RunConfig(backend="hopper", par_time=par_time,
                                bsize=bsize, device=device))
    torch.cuda.synchronize()
    builder.LAUNCHES = 0
    builder.KERNEL_LAUNCHES.clear()
    out = p.run(g, iters)
    torch.cuda.synchronize()
    launches = builder.LAUNCHES
    by_kernel = launched_kernels(name, p)
    want = math.ceil(iters / par_time)
    if launches != want:
        raise AssertionError(f"{name}: run launched the kernel {launches} "
                             f"times, expected {want}")
    if (tuple(out.shape) != problem.state_shape
            or not bool(out.isfinite().all())):
        raise AssertionError(f"{name}: result not finite of shape "
                             f"{problem.state_shape}")
    ref = plan(problem, RunConfig(backend="reference", device=device)).run(
        g, iters)
    tol = precision.tolerance("float32", iters, stages=problem.n_stages)
    torch.testing.assert_close(out, ref, **tol)
    err = (out - ref).abs().max().item()
    del ref
    return {"iters": iters, "launches": launches, "oracle_max_abs_err": err,
            "plan": p, "g": g, "aux": None, "out": out, "tol": tol,
            "launches_by_kernel": by_kernel}


def drive_program(name, device) -> dict:
    """:func:`drive_plan` of the chain ``name`` of :data:`PROGRAMS`."""
    from repro_torch.api import StencilProblem
    nd, par_time, bsize = PROGRAMS[name]
    return drive_plan(name, StencilProblem(program_stages(name),
                                           FULL_DIMS[nd]),
                      par_time, bsize, device)


def program_yardstick(problem, g, par_time):
    """``par_time`` iterations of one cuDNN convolution per stage over the
    grid padded under that stage's boundary, in the grid's dtype: the same
    chain as one PyTorch call per stage and iteration.  Each stage is a
    linear tap sum, so its weights are its ``apply`` on one-hot taps."""
    import torch
    import torch.nn.functional as F
    nd = problem.ndim
    convs = []
    for stage, cf in zip(problem.stages,
                         problem.resolve_coeffs(device=g.device)):
        r = stage.stencil.radius

        def one_hot(off, r=r):
            e = torch.zeros((2 * r + 1,) * nd, device=g.device)
            e[tuple(o + r for o in off)] = 1.0
            return e
        convs.append((stage.stencil.apply(one_hot, cf)[None, None].to(
            g.dtype), r, stage.boundary))
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    batched = g.ndim > nd     # a batch is the convolution's N

    def run():
        x = g[:, None] if batched else g[None, None]
        for _ in range(par_time):
            for w, r, bc in convs:
                if r:
                    x = pad_bc(x, r, bc)
                x = conv(x, w)
        return x[:, 0] if batched else x[0, 0]
    return run


def check_program_yardstick(problem, par_time, device, seed=1) -> float:
    """The yardstick against the port's oracle on a small grid, in the
    problem's dtype."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import precision
    dims = {1: (200,), 2: (40, 56), 3: (12, 20, 28)}[problem.ndim]
    small = StencilProblem(problem.program, dims,
                           boundary=problem.structural_bc,
                           dtype=problem.dtype)
    g = grid_input(dims, device, seed).to(small.torch_dtype)
    got = program_yardstick(small, g, par_time)()
    want = plan(small, RunConfig(backend="reference", device=device)).run(
        g, par_time)
    torch.testing.assert_close(got, want, **precision.tolerance(
        small.dtype, par_time, stages=small.n_stages))
    return (got - want).abs().max().item()


def superstep_vs_plain(name, problem, geom, g, aux=None,
                       plain_reps: int = 3) -> dict:
    """One super-step of a stage program through the kernel against its
    plain version on the same padded state, bit for bit, with and without
    forwarding (the output starts as NaN, so a cell the kernel misses or
    writes outside its compute region, the stream rows below ``dom``,
    shows); then both times (the plain version's ``plain_reps`` runs after
    the check's; with 0, the check's own call at ``steps = T``)."""
    import torch
    from repro_torch.kernels import builder, ops
    dag, bc0 = problem.exec_dag, problem.structural_bc
    T = geom.par_time
    gp = ops._pad_blocked(g, geom, bc0)
    aux_p = None if aux is None else ops._pad_blocked(aux, geom, bc0)
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    h = geom.size_halo
    region = (Ellipsis, slice(0, builder._stream_dom(geom, bc0))) + tuple(
        slice(h, h + n * cs) for n, cs in zip(geom.bnum, geom.csize))
    out = torch.empty_like(gp)
    err = 0.0
    checked = []
    for steps in (T, T - 1):
        out.fill_(float("nan"))
        builder.superstep_dag(dag, geom, gp, c, steps, aux_p, out=out)
        plain = torch.full_like(gp, float("nan"))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        builder.superstep_dag_plain(dag, geom, gp, c, steps, aux_p, plain)
        end.record()
        end.synchronize()
        checked.append(start.elapsed_time(end))
        got, want = out[region], plain[region]
        if bool(got.isnan().any()):
            raise AssertionError(f"{name}: kernel left compute cells "
                                 f"unwritten (steps={steps})")
        if int((~out.isnan()).sum()) != got.numel():
            raise AssertionError(f"{name}: kernel wrote outside the "
                                 f"compute region (steps={steps})")
        if not torch.equal(got, want):
            raise AssertionError(
                f"{name}: kernel differs from its plain version by "
                f"{(got - want).abs().max().item()} (steps={steps})")
        err = max(err, (got - want).abs().max().item())
        del plain, got, want
        torch.cuda.empty_cache()
    kernel_ms = time_ms(lambda: builder.superstep_dag(
        dag, geom, gp, c, T, aux_p, out=out), reps=5, warmup=0)
    split = split_fields(name)
    plain_ms = Timing(checked[:1]) if not plain_reps else time_ms(
        lambda: builder.superstep_dag_plain(dag, geom, gp, c, T, aux_p,
                                            torch.empty_like(gp)),
        reps=plain_reps, warmup=0)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            **split}


#: the chain whose 16 entries (T = 8) run the chain body's one-barrier
#: form past its unrolled entries, the ring form: one super-step of it bit
#: for bit against the plain version, and its time
RING_FORM_CHAIN = ("advect_diffuse2d", 8)


def ring_form_probe(name, problem, geom, g) -> dict:
    """The chain body's one-barrier form in its ring form
    (``chain_win_kernel<bc,0>``: the entries in a loop, every tap from the
    rings) on :data:`RING_FORM_CHAIN` at the cell's grid and ``bsize``:
    one super-step at ``steps = T`` and ``T - 1`` bit for bit against the
    plain version, and its time (median of 5); ``{}`` for any other
    chain."""
    from repro_torch.api import RunConfig, plan
    if name != RING_FORM_CHAIN[0]:
        return {}
    ring = plan(problem, RunConfig(backend="hopper",
                                   par_time=RING_FORM_CHAIN[1],
                                   bsize=geom.bsize, device=g.device))
    res = superstep_vs_plain(f"{name} T={RING_FORM_CHAIN[1]}", problem,
                             ring.geometry, g, plain_reps=0)
    if not res["kernel"].endswith(",0>"):
        raise AssertionError(f"{name} T={RING_FORM_CHAIN[1]}: "
                             f"{res['kernel']} is not the ring form")
    print(f"  probe ({name} T={RING_FORM_CHAIN[1]}): the chain form's ring "
          f"form {res['kernel']} {res['ms']} (bit for bit with the plain "
          f"version)", flush=True)
    return {"ring_form_par_time": RING_FORM_CHAIN[1],
            "ring_form_ms": res["ms"], "ring_form_kernel": res["kernel"]}


def compare_program(name, main: dict, fused_run_ms: float, peaks) -> dict:
    """One super-step of the chain kernel against its plain version, bit
    for bit, with and without PE forwarding; the times and the bound; and
    the fused plan against chained single-stage plans at T=1."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core.blocking import smem_bytes
    from repro_torch.kernels import ops
    p = main["plan"]
    problem, geom = p.problem, p.geometry
    stages = problem.exec_stages
    T = geom.par_time
    g = main["g"]
    res = superstep_vs_plain(name, problem, geom, g)
    probe = ring_form_probe(name, problem, geom, g)
    library_err = check_program_yardstick(problem, T, g.device)
    library_ms = time_ms(program_yardstick(problem, g, T), reps=3)
    cells = math.prod(geom.dims)

    # fusion: S single-stage plans at T=1, chained stage by stage
    singles = [plan(StencilProblem([s], geom.dims),
                    RunConfig(backend="hopper", par_time=1,
                              bsize=geom.bsize, device=g.device))
               for s in problem.stages]
    iters = main["iters"]

    def chained():
        x = g
        for _ in range(iters):
            for sp in singles:
                x = sp.run(x, 1)
        return x
    seq = chained()
    torch.testing.assert_close(main["out"], seq, **main["tol"])
    fusion_err = (main["out"] - seq).abs().max().item()
    del seq
    chained_ms = time_ms(chained, reps=3)
    return {
        **res, **probe, "library_ms": library_ms,
        "library_small_max_abs_err": library_err,
        **bound(problem, T, peaks),
        "dma_bytes": ops.dma_traffic_bytes(problem.stencil, geom),
        "gcells_per_s": cells * T / res["ms"] / 1e6,
        "smem_bytes": smem_bytes(geom, stages),
        "chained_run_ms": chained_ms, "fused_run_ms": fused_run_ms,
        "fusion_speedup": chained_ms / fused_run_ms,
        "fused_vs_chained_max_abs_err": fusion_err,
    }


def program_phase(device, peaks, bases: dict) -> list:
    """Every program of :data:`PROGRAMS` through the chain kernel: the main
    path's run and checks, its breakdown, the kernel against its plain
    version, and fused against chained.  Keeps the V = 1 run of each
    :data:`PAR_VEC` case in ``bases``."""
    import torch
    rows = []
    for name in PROGRAMS:
        main_run = drive_program(name, device)
        e2e = breakdown(main_run)
        p = main_run["plan"]
        geom = p.geometry
        stage_names = [s.name for s in p.problem.stages]
        print(f"{name} {stage_names} {geom.dims} T={geom.par_time} "
              f"bsize={geom.bsize} ({geom.num_blocks} blocks): run of "
              f"{main_run['iters']} iters {e2e['run_ms']}, "
              f"{e2e['run_gcells_per_s']:.3f} GCell/s, "
              f"{main_run['launches']} launches, oracle max_abs_err "
              f"{main_run['oracle_max_abs_err']:.3g}; kernel share of "
              f"device time {e2e['kernel_share_of_device']:.3f}, device "
              f"idle {e2e['device_idle_share']:.3f}", flush=True)
        res = compare_program(name, main_run, e2e["run_ms"], peaks)
        print(f"  superstep: kernel {res['ms']} (bit for bit with plain), "
              f"plain {res['plain_ms']}, library {res['library_ms']}, bound "
              f"{res['bound_ms']:.3f} ms ({res['bound_by']}); fused run "
              f"{res['fused_run_ms']} vs chained T=1 plans "
              f"{res['chained_run_ms']}: {res['fusion_speedup']:.3f}x, "
              f"max_abs_diff {res['fused_vs_chained_max_abs_err']:.3g}",
              flush=True)
        if name in PAR_VEC:
            bases[name] = v1_base(main_run, res)
        rows.append({
            "name": f"stencil_stream[{name}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": main_run["launches"],
            "launches_by_kernel": main_run["launches_by_kernel"], **res,
            "stages": stage_names, "dims": list(geom.dims),
            "par_time": geom.par_time, "bsize": list(geom.bsize),
            "iters": main_run["iters"],
            "oracle_max_abs_err": main_run["oracle_max_abs_err"], **e2e,
        })
        del main_run
        torch.cuda.empty_cache()
    return rows


# --- stage DAGs: field streams, fan-in and state nodes ---------------------

#: the DAG programs of benchmarks/programs.py::DAG_FULL_CASES and the wave
#: equation in 3D, at FULL_DIMS: (rank, boundary, par_time, bsize)
DAGS = {"wave2d": (2, "periodic", 4, (256,)),
        "diamond2d": (2, "clamp", 2, (256,)),
        "wave3d": (3, "clamp", 2, (32, 32))}


def dag_program(name):
    """``examples/wave2d_program.py::wave_program(0.4)`` (a ``make_star``
    Laplacian, c0 = -2 x rank and 1.0 on each neighbour, fanned with ``u``
    and ``u_prev`` into a 3-way combine 2, -1, 0.16; both fields rotated),
    in 2D or 3D; ``benchmarks/programs.py::_diamond_program`` (two star
    views of ``u`` recombined)."""
    from repro_torch.api import StencilProgram, StencilStage
    from repro_torch.core.stencils import make_combine, make_star
    if name == "diamond2d":
        s = make_star(2, 1)
        return StencilProgram(
            (StencilStage(s, name="a", inputs=("u",)),
             StencilStage(s, name="b", inputs=("u",),
                          coeffs={"c0": 0.5, "c_0_1": 0.2}),
             StencilStage(make_combine(2, 2), name="m", inputs=("a", "b"),
                          coeffs={"w0": 0.6, "w1": 0.4})))
    nd = int(name[-2])
    lap = {"c0": -2.0 * nd}
    lap.update({f"c_{a}_{d}": 1.0 for a in range(nd) for d in (-1, 1)})
    return StencilProgram(
        (StencilStage(make_star(nd, 1), coeffs=lap, name="lapu",
                      inputs=("u",)),
         StencilStage(make_combine(nd, 3), name="unext",
                      inputs=("u", "u_prev", "lapu"),
                      coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.4 * 0.4})),
        fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def drive_dag(name, device) -> dict:
    """:func:`drive_plan` of the DAG ``name`` of :data:`DAGS`, through the
    kernel's DAG body."""
    from repro_torch.api import StencilProblem
    nd, bc, par_time, bsize = DAGS[name]
    return drive_plan(name, StencilProblem(dag_program(name), FULL_DIMS[nd],
                                           boundary=bc),
                      par_time, bsize, device)


def dag_yardstick(problem, g, par_time):
    """``par_time`` iterations of the DAG in composed PyTorch calls, in the
    state's dtype: one cuDNN convolution per tap stage over its input
    padded under the stage's boundary (:func:`pad_bc`), ``torch.mul`` and
    ``torch.add`` for a combine in its ``apply`` order.  No single call
    computes a DAG."""
    import torch
    import torch.nn.functional as F
    nd = problem.ndim
    prog = problem.program
    conv = F.conv2d if nd == 2 else F.conv3d
    ops_ = []
    for stage, cf in zip(prog.stages,
                         problem.resolve_coeffs(device=g.device)):
        st = stage.stencil
        if st.combine:
            ops_.append(("combine", [cf[n] for n in st.coeff_names], 0,
                         None))
            continue
        r = st.radius

        def one_hot(off, r=r):
            e = torch.zeros((2 * r + 1,) * nd, device=g.device)
            e[tuple(o + r for o in off)] = 1.0
            return e
        ops_.append(("conv", st.apply(one_hot, cf)[None, None].to(g.dtype),
                     r, stage.boundary))
    F_ = len(prog.fields)
    # a batch (a leading axis on the state) is the convolutions' N
    lead = g.ndim - nd - (F_ > 1)

    def run():
        fields = list(g.unbind(lead)) if F_ > 1 else [g]
        for _ in range(par_time):
            vals = [None] * len(prog.stages)
            for si in prog.topo:
                kind, w, r, bc = ops_[si]
                ins = [vals[i] if i >= 0 else fields[~i]
                       for i in prog.inputs_idx[si]]
                if kind == "conv":
                    x = ins[0][:, None] if lead else ins[0][None, None]
                    if r:
                        x = pad_bc(x, r, bc)
                    x = conv(x, w)
                    vals[si] = x[:, 0] if lead else x[0, 0]
                else:
                    acc = torch.mul(w[0], ins[0])
                    for wi, xi in zip(w[1:], ins[1:]):
                        acc = torch.add(acc, torch.mul(wi, xi))
                    vals[si] = acc
            fields = [vals[u] if u >= 0 else fields[~u]
                      for u in prog.updates_idx]
        return torch.stack(fields, lead) if F_ > 1 else fields[0]
    return run


def check_dag_yardstick(problem, par_time, device, seed=1) -> float:
    """The composed yardstick against the port's oracle on a small grid, in
    the problem's dtype."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import precision
    dims = (40, 56) if problem.ndim == 2 else (12, 20, 28)
    small = StencilProblem(problem.program, dims,
                           boundary=problem.structural_bc,
                           dtype=problem.dtype)
    g = grid_input(small.state_shape, device, seed).to(small.torch_dtype)
    got = dag_yardstick(small, g, par_time)()
    want = plan(small, RunConfig(backend="reference", device=device)).run(
        g, par_time)
    torch.testing.assert_close(got, want, **precision.tolerance(
        small.dtype, par_time, stages=small.n_stages))
    return (got - want).abs().max().item()


def compare_dag(name, main: dict, peaks) -> dict:
    """One super-step of the DAG body against its plain version, bit for
    bit, with and without forwarding through the state nodes; the times
    and the bound."""
    from repro_torch.core.blocking import smem_bytes
    from repro_torch.kernels import ops
    p = main["plan"]
    problem, geom = p.problem, p.geometry
    T = geom.par_time
    g = main["g"]
    res = superstep_vs_plain(name, problem, geom, g)
    library_err = check_dag_yardstick(problem, T, g.device)
    library_ms = time_ms(dag_yardstick(problem, g, T), reps=3)
    cells = math.prod(problem.shape)
    return {
        **res, "library_ms": library_ms,
        "library_small_max_abs_err": library_err,
        "library": "composed: one cuDNN convolution per tap stage, "
                   "torch.mul/torch.add per combine, per iteration",
        **bound(problem, T, peaks),
        "dma_bytes": ops.dma_traffic_bytes(problem.stencil, geom,
                                           bc=problem.structural_bc),
        "gcells_per_s": cells * T / res["ms"] / 1e6,
        "smem_bytes": smem_bytes(geom, problem.exec_dag),
    }


def dag_phase(device, peaks, bases: dict) -> list:
    """Every program of :data:`DAGS` through the DAG body of the kernel: the
    main path's run and checks, its breakdown, and the kernel against its
    plain version.  Keeps the V = 1 run of each :data:`PAR_VEC` case in
    ``bases``."""
    import torch
    rows = []
    for name in DAGS:
        main_run = drive_dag(name, device)
        e2e = breakdown(main_run)
        p = main_run["plan"]
        geom = p.geometry
        prob = p.problem
        print(f"{name} fields {list(prob.fields)} stages "
              f"{[s.name for s in prob.stages]} {geom.dims} "
              f"{prob.structural_bc.token()} T={geom.par_time} "
              f"bsize={geom.bsize} ({geom.num_blocks} blocks): run of "
              f"{main_run['iters']} iters {e2e['run_ms']}, "
              f"{e2e['run_gcells_per_s']:.3f} GCell/s, "
              f"{main_run['launches']} launches, oracle max_abs_err "
              f"{main_run['oracle_max_abs_err']:.3g}; kernel share of "
              f"device time {e2e['kernel_share_of_device']:.3f}, device "
              f"idle {e2e['device_idle_share']:.3f}", flush=True)
        res = compare_dag(name, main_run, peaks)
        print(f"  superstep: kernel {res['ms']} (bit for bit with plain), "
              f"plain {res['plain_ms']}, composed library "
              f"{res['library_ms']}, bound {res['bound_ms']:.3f} ms "
              f"({res['bound_by']}), rings {res['smem_bytes']} bytes",
              flush=True)
        if name in PAR_VEC:
            bases[name] = v1_base(main_run, res)
        rows.append({
            "name": f"stencil_stream[{name}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": main_run["launches"],
            "launches_by_kernel": main_run["launches_by_kernel"], **res,
            "fields": list(prob.fields),
            "stages": [s.name for s in prob.stages],
            "boundary": prob.structural_bc.token(), "dims": list(geom.dims),
            "par_time": geom.par_time, "bsize": list(geom.bsize),
            "iters": main_run["iters"],
            "oracle_max_abs_err": main_run["oracle_max_abs_err"], **e2e,
        })
        del main_run
        torch.cuda.empty_cache()
    return rows


# --- V-row slabs (par_vec > 1) and the 1D entry -----------------------------

#: name -> the par_vec values run beside the V = 1 plan of that name (the
#: main path's, the program phase's or the DAG phase's, at its schedule and
#: on its inputs); the 1D star runs here at V = 1 first
PAR_VEC = {"diffusion2d": (2, 4, 8), "hotspot2d": (2, 4, 8),
           "diffusion3d": (2, 4), "hotspot3d": (2, 4),
           "advect_diffuse2d": (4,), "wave2d": (4,), "star1d_r2": (16,)}
#: the 1D entry: one block of 2**20 cells (the TPU kernel's grid (1,)),
#: its stream split across CTAs, par_time 4
STAR1D = ("star1d_r2", (1 << 20,), 4)


def v1_base(main: dict, res: dict) -> dict:
    """What the V > 1 runs of a case reuse from its V = 1 run: the plan,
    inputs, result and iterations, and the super-step's and yardstick's
    times."""
    keep = ("plan", "g", "aux", "out", "iters")
    return {**{k: main[k] for k in keep}, "ms": res["ms"],
            "library_ms": res["library_ms"],
            "library": res.get("library")}


#: the launches per kernel of the last counted run (``launched_kernels``)
LAST_RUN_KERNELS: dict = {}


def launched_kernels(label, p) -> dict:
    """The launches per kernel of the run of plan ``p`` just made
    (``builder.KERNEL_LAUNCHES``, set to empty just before it): every one
    of them a kernel of its route, ``chain_win_kernel`` for a chain that
    ``builder.win_form`` sends to the chain body's one-barrier form,
    ``chain_kernel`` or ``chain_kernel_big`` for any other chain (its
    per-entry form).  Kept in :data:`LAST_RUN_KERNELS`; raises otherwise."""
    from repro_torch.kernels import builder
    counts = dict(builder.KERNEL_LAUNCHES)
    if sum(counts.values()) != builder.LAUNCHES or not counts:
        raise AssertionError(f"{label}: launches per kernel {counts} do not "
                             f"add up to {builder.LAUNCHES}")
    problem, geom = p.problem, p.geometry
    stages = builder._as_chain(problem.exec_dag)
    if stages is not None and not builder.is_main_path(stages):
        why = builder.win_form(problem.exec_dag, geom, problem.cell_bytes)
        want = "chain_win_kernel" if why is None else "chain_kernel"
        wrong = [k for k in counts if not k.startswith(want)]
        if wrong:
            raise AssertionError(f"{label}: the run launched {wrong}, not "
                                 f"{want} ({why or 'one barrier a tick'})")
    LAST_RUN_KERNELS.clear()
    LAST_RUN_KERNELS.update(counts)
    return counts


def counted_run(p, g, aux, iters):
    """``p.run`` with the launch count at 0 just before and read just
    after, timed with CUDA events: ``(out, launches, run ms)``."""
    import torch
    from repro_torch.kernels import builder
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    builder.LAUNCHES = 0
    builder.KERNEL_LAUNCHES.clear()
    start.record()
    out = p.run(g, iters, aux=aux)
    end.record()
    end.synchronize()
    launches = builder.LAUNCHES
    want = math.ceil(iters / p.geometry.par_time)
    if launches != want:
        raise AssertionError(f"{p.problem.stencil.name}: run launched the "
                             f"kernel {launches} times, expected {want}")
    launched_kernels(p.problem.stencil.name, p)
    return out, launches, Timing([start.elapsed_time(end)])


def par_vec_row(name, base, V, device, peaks) -> dict:
    """The plan of ``base`` at ``par_vec = V``: one super-step bit for bit
    against the plain version (which also warms the kernel up), then the
    counted, timed run, which must equal the V = 1 run bit for bit."""
    import torch
    from repro_torch.api import RunConfig, plan
    from repro_torch.core.blocking import smem_bytes
    from repro_torch.kernels import builder, ops
    problem, g1 = base["plan"].problem, base["plan"].geometry
    T, iters = g1.par_time, base["iters"]
    p = plan(problem, RunConfig(backend="hopper", par_time=T,
                                bsize=g1.bsize, par_vec=V, device=device))
    geom = p.geometry
    res = superstep_vs_plain(f"{name} V={V}", problem, geom, base["g"],
                             base["aux"], plain_reps=1)
    out, launches, run_ms = counted_run(p, base["g"], base["aux"], iters)
    if not torch.equal(out, base["out"]):
        raise AssertionError(
            f"{name}: the run at V={V} differs from V=1 by "
            f"{(out - base['out']).abs().max().item()}")
    del out
    vt, rows, _ = builder.cta_shape(geom)
    cells = math.prod(problem.shape)
    dma = ops.dma_traffic_bytes(problem.stencil, geom,
                                bc=problem.structural_bc)
    row = {"name": f"stencil_stream[{name} V={V}]", "route": "cuda",
           "source": SOURCE, "replaces": REPLACES, "launches": launches,
           **res, **bound(problem, T, peaks),
           "library_ms": base["library_ms"], "par_vec": V,
           "v1_ms": base["ms"], "speedup_vs_v1": base["ms"] / res["ms"],
           "equal_to_v1": True, "dims": list(problem.shape),
           "par_time": T, "bsize": list(geom.bsize), "iters": iters,
           "run_ms": run_ms, "run_gcells_per_s": cells * iters / run_ms / 1e6,
           "gcells_per_s": cells * T / res["ms"] / 1e6,
           "smem_bytes": smem_bytes(geom, problem.exec_dag),
           "dma_bytes": dma, "dma_bound_ms": dma / peaks[0] * 1e3,
           "rows_at_once": vt, "rows_per_thread": rows}
    if base["library"]:
        row["library"] = base["library"]
    print(f"{name} V={V} {tuple(problem.shape)} T={T} bsize={geom.bsize} "
          f"({geom.num_blocks} blocks, {vt} rows at once x {rows} per thread, "
          f"rings {row['smem_bytes']} B): run of {iters} iters {run_ms} "
          f"({row['run_gcells_per_s']:.3f} GCell/s), {launches} launches, "
          f"equal to V=1 bit for bit; superstep: kernel {res['ms']} (bit "
          f"for bit with plain) vs V=1 {base['ms']}: "
          f"{row['speedup_vs_v1']:.3f}x; plain {res['plain_ms']}, library "
          f"(V=1) {base['library_ms']}, bound {row['bound_ms']:.3f} ms "
          f"({row['bound_by']}), slab-padded DMA bound "
          f"{row['dma_bound_ms']:.3f} ms", flush=True)
    return row


def star1d_base(device, peaks):
    """The 1D entry at V = 1: the counted run against the reference
    backend, one super-step against the plain version, and the conv1d
    yardstick; ``(base, row)``."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import precision
    name, dims, T = STAR1D
    problem = StencilProblem(name, dims)
    iters = 2 * T + 3
    g = grid_input(dims, device, 0)
    p = plan(problem, RunConfig(backend="hopper", par_time=T, bsize=(),
                                device=device))
    res = superstep_vs_plain(f"{name} V=1", problem, p.geometry, g)
    out, launches, run_ms = counted_run(p, g, None, iters)
    ref = plan(problem, RunConfig(backend="reference", device=device)).run(
        g, iters)
    torch.testing.assert_close(out, ref, **precision.tolerance(
        "float32", iters))
    err = (out - ref).abs().max().item()
    del ref
    library_err = check_program_yardstick(problem, T, device)
    library_ms = time_ms(program_yardstick(problem, g, T), reps=3)
    cells = math.prod(dims)
    row = {"name": f"stencil_stream[{name} V=1]", "route": "cuda",
           "source": SOURCE, "replaces": REPLACES, "launches": launches,
           **res, **bound(problem, T, peaks), "library_ms": library_ms,
           "library_small_max_abs_err": library_err,
           "library": "cuDNN conv1d per iteration (edge-padded)",
           "par_vec": 1, "dims": list(dims), "par_time": T, "bsize": [],
           "iters": iters, "oracle_max_abs_err": err, "run_ms": run_ms,
           "run_gcells_per_s": cells * iters / run_ms / 1e6,
           "gcells_per_s": cells * T / res["ms"] / 1e6}
    print(f"{name} V=1 {dims} T={T} (one block): run of {iters} iters "
          f"{run_ms} ({row['run_gcells_per_s']:.3f} GCell/s), {launches} "
          f"launches, oracle max_abs_err {err:.3g}; superstep: kernel "
          f"{res['ms']} (bit for bit with plain), plain {res['plain_ms']}, "
          f"library {library_ms}, bound {row['bound_ms']:.3f} ms "
          f"({row['bound_by']})", flush=True)
    base = {"plan": p, "g": g, "aux": None, "out": out, "iters": iters,
            "ms": res["ms"], "library_ms": library_ms,
            "library": row["library"]}
    return base, row


def par_vec_phase(bases: dict, device, peaks) -> list:
    """Every case of :data:`PAR_VEC` at each of its V beside its V = 1 run
    (``bases``, filled by the earlier phases; the 1D star's here)."""
    import torch
    t0 = time.perf_counter()
    base, row = star1d_base(device, peaks)
    bases[STAR1D[0]] = base
    rows = [row]
    for name, vs in PAR_VEC.items():
        for V in vs:
            rows.append(par_vec_row(name, bases[name], V, device, peaks))
            torch.cuda.empty_cache()
        del bases[name]
    print(f"par_vec phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return rows


# --- bf16 storage (B1e) ----------------------------------------------------

#: name -> the par_vec values run in bf16 on the f32 cells' inputs and
#: schedules, V = 1 first (the run every V > 1 must equal); the 1D star at
#: V = 16 only (its V = 1 run takes 20 s)
BF16_VECS = {"diffusion2d": (1, 8, 16), "hotspot2d": (1, 8, 16),
             "diffusion3d": (1, 4), "hotspot3d": (1, 4),
             "advect_diffuse2d": (1, 4), "wave2d": (1, 4),
             "star1d_r2": (16,)}
#: the bf16 DMA bytes of a super-step may be at most this share of f32's
#: (the gate of benchmarks/kernels.py:128-150)
BF16_DMA_RATIO = 0.6


def case_problem(name, dtype="float32", boundary=None):
    """``(problem, inputs(device), par_time, bsize)`` of the cell ``name``
    in ``dtype``: a Table-2 stencil, a program of :data:`PROGRAMS`, a DAG
    of :data:`DAGS` or the 1D star, under its own boundary unless
    ``boundary`` is given; the inputs are the f32 cell's (seed 0) cast to
    ``dtype``."""
    from repro_torch.api import StencilProblem
    if name in STENCILS:
        nd = int(name[-2])
        dims = FULL_DIMS[nd]
        problem = StencilProblem(name, dims, dtype=dtype,
                                 boundary=boundary or "clamp")
        T, bsize = SCHEDULE[nd]

        def make(device):
            g, aux = inputs(name, dims, device, 0)
            return g.to(problem.torch_dtype), (
                None if aux is None else aux.to(problem.torch_dtype))
        return problem, make, T, bsize
    if name in PROGRAMS:
        nd, T, bsize = PROGRAMS[name]
        program, bc = program_stages(name), boundary or "clamp"
    elif name in DAGS:
        nd, bc, T, bsize = DAGS[name]
        program, bc = dag_program(name), boundary or bc
    else:
        program, (nd, T, bsize) = STAR1D[0], (1, STAR1D[2], ())
        bc = boundary or "clamp"
    dims = STAR1D[1] if nd == 1 else FULL_DIMS[nd]
    problem = StencilProblem(program, dims, boundary=bc, dtype=dtype)
    return problem, lambda device: (grid_input(
        problem.state_shape, device, 0).to(problem.torch_dtype), None), \
        T, bsize


def f32_times(rows) -> dict:
    """``(case, V) -> super-step ms`` of the f32 rows so far."""
    out = {}
    for row in rows:
        case = row["name"][len("stencil_stream["):-1]
        name, _, v = case.partition(" V=")
        out[(name, int(v or 1))] = row["ms"]
    return out


def storage_row(label, problem, g, aux, T, bsize, V, device, peaks,
                library) -> tuple:
    """One plan of ``problem`` at ``par_vec = V``: a super-step bit for bit
    against the plain version at ``steps = T`` and ``T - 1`` (the first
    plain call timed), the counted run (``ceil(iters/T)`` launches, the
    storage dtype out), the times and the bound; ``(row, run's output)``.
    ``library`` is ``(ms, small max abs err, what)``."""
    from repro_torch.api import RunConfig, plan
    from repro_torch.core.blocking import smem_bytes
    from repro_torch.kernels import builder, ops
    p = plan(problem, RunConfig(backend="hopper", par_time=T, bsize=bsize,
                                par_vec=V, device=device))
    geom = p.geometry
    iters = 2 * T + 3
    res = superstep_vs_plain(label, problem, geom, g, aux, plain_reps=0)
    out, launches, run_ms = counted_run(p, g, aux, iters)
    if out.dtype != problem.torch_dtype:
        raise AssertionError(f"{label}: the run returned {out.dtype}")
    vt, rows, _ = builder.cta_shape(geom)
    cells = math.prod(problem.shape)
    bc = problem.structural_bc
    dma = ops.dma_traffic_bytes(problem.stencil, geom, problem.cell_bytes,
                                bc=bc)
    row = {"name": f"stencil_stream[{label}]", "route": "cuda",
           "source": SOURCE, "replaces": REPLACES, "launches": launches,
           "launches_by_kernel": dict(LAST_RUN_KERNELS),
           **res, **bound(problem, T, peaks), "library_ms": library[0],
           "library_small_max_abs_err": library[1], "library": library[2],
           "dtype": problem.dtype, "boundary": [
               s.boundary.token() for s in problem.stages],
           "par_vec": V, "dims": list(problem.shape), "par_time": T,
           "bsize": list(geom.bsize), "iters": iters, "run_ms": run_ms,
           "run_gcells_per_s": cells * iters / run_ms / 1e6,
           "gcells_per_s": cells * T / res["ms"] / 1e6,
           "smem_bytes": smem_bytes(geom, problem.exec_dag,
                                    problem.cell_bytes),
           "dma_bytes": dma, "dma_bound_ms": dma / peaks[0] * 1e3,
           "dma_bytes_f32": ops.dma_traffic_bytes(problem.stencil, geom, 4,
                                                  bc=bc),
           "rows_at_once": vt, "rows_per_thread": rows}
    return row, out


def check_reference(label, problem, g, aux, out, iters) -> float:
    """The run against the port's ``reference`` backend within
    ``precision.tolerance(dtype, iters, stages)``; its max abs error."""
    import torch
    from repro_torch.api import RunConfig, plan
    from repro_torch.core import precision
    ref = plan(problem, RunConfig(backend="reference", device=g.device)).run(
        g, iters, aux=aux)
    torch.testing.assert_close(out, ref, **precision.tolerance(
        problem.dtype, iters, stages=problem.n_stages,
        scale=100 if problem.needs_aux else None))
    return (out.float() - ref.float()).abs().max().item()


def case_library(name, problem, g, aux, T, device):
    """The cell's yardstick in the problem's dtype and boundary: checked on
    a small grid, then timed on ``g``; ``(ms, small max abs err, what)``."""
    if name in STENCILS:
        err = check_yardstick(name, T, device, bc=problem.bc,
                              dtype=problem.dtype)
        fn, what = library_yardstick(name, g, aux, T, problem.bc), (
            f"cuDNN conv per step, {problem.dtype}")
    elif problem.is_dag:
        err = check_dag_yardstick(problem, T, device)
        fn, what = dag_yardstick(problem, g, T), (
            f"composed: cuDNN conv per tap stage, torch.mul/add per "
            f"combine, {problem.dtype}")
    else:
        err = check_program_yardstick(problem, T, device)
        fn, what = program_yardstick(problem, g, T), (
            f"cuDNN conv per stage, {problem.dtype}")
    return time_ms(fn, reps=3), err, what


def bf16_phase(device, peaks, f32_rows) -> list:
    """Every case of :data:`BF16_VECS` in bf16 on the f32 cell's inputs:
    per V a super-step bit for bit against the plain version, the counted
    run equal to the bf16 V = 1 run bit for bit (and V = 1, or the 1D
    star's one V, within tolerance of the reference backend), the times
    beside f32's at the same V, and the DMA bytes against f32's."""
    import torch
    t0 = time.perf_counter()
    f32 = f32_times(f32_rows)
    rows = []
    for name, vs in BF16_VECS.items():
        problem, make, T, bsize = case_problem(name, "bfloat16")
        g, aux = make(device)
        library = case_library(name, problem, g, aux, T, device)
        first = None
        for V in vs:
            label = f"{name} bf16 V={V}"
            row, out = storage_row(label, problem, g, aux, T, bsize, V,
                                   device, peaks, library)
            if first is None:
                row["oracle_max_abs_err"] = check_reference(
                    label, problem, g, aux, out, row["iters"])
                first = out
            elif not torch.equal(out, first):
                raise AssertionError(f"{label}: differs from V={vs[0]}")
            else:
                row["equal_to_v1"] = True
            del out
            ratio = row["dma_bytes"] / row["dma_bytes_f32"]
            if ratio > BF16_DMA_RATIO:
                raise AssertionError(f"{label}: bf16 DMA bytes are {ratio} "
                                     f"of f32's (at most {BF16_DMA_RATIO})")
            row["dma_ratio_vs_f32"] = ratio
            row["f32_ms"] = f32.get((name, V))
            print(f"{label} {tuple(problem.shape)} T={T} bsize={bsize} "
                  f"(rings {row['smem_bytes']} B, {row['rows_at_once']} "
                  f"rows at once x {row['rows_per_thread']}): run "
                  f"{row['run_ms']}, {row['launches']} launches, "
                  + ("equal to V=1 bit for bit" if "equal_to_v1" in row
                     else f"oracle max_abs_err "
                          f"{row['oracle_max_abs_err']:.3g}")
                  + f"; superstep: kernel {row['ms']} (bit for bit with "
                  f"plain) vs f32 {row['f32_ms'] or 'refused'}, plain "
                  f"{row['plain_ms']}, library {row['library_ms']}, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}); DMA "
                  f"{ratio:.3f} of f32's", flush=True)
            rows.append(row)
            torch.cuda.empty_cache()
        del g, aux, first
        torch.cuda.empty_cache()
    print(f"bf16 phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return rows


# --- reflect and constant boundaries (B1c) ----------------------------------

#: (label, cell, boundary, dtype): the main path under each kind, mixed per
#: axis in 3D, a chain whose stages differ, a DAG under one boundary, and
#: the rounded constant fill in bf16
BC_CASES = (
    ("diffusion2d reflect", "diffusion2d", "reflect", "float32"),
    ("diffusion2d constant:1.5", "diffusion2d", "constant:1.5", "float32"),
    ("hotspot3d clamp,reflect,constant:0.0", "hotspot3d",
     ("clamp", "reflect", "constant:0.0"), "float32"),
    ("advect_diffuse2d reflect|constant:0.0", "advect_diffuse2d", None,
     "float32"),
    ("diamond2d reflect", "diamond2d", "reflect", "float32"),
    ("diffusion2d constant:1.5 bf16", "diffusion2d", "constant:1.5",
     "bfloat16"),
)


def bc_problem(name, bc, dtype):
    """:func:`case_problem` under ``bc``; for the chain, stage 0 (the advect
    star) under reflect and stage 1 (diffusion2d) under constant 0."""
    import dataclasses
    from repro_torch.api import StencilProblem
    if bc is not None:
        return case_problem(name, dtype, bc)
    problem, make, T, bsize = case_problem(name, dtype)
    adv, dif = problem.program.stages
    chain = [dataclasses.replace(adv, boundary="reflect"),
             dataclasses.replace(dif, boundary="constant:0.0")]
    return StencilProblem(chain, problem.shape, dtype=dtype), make, T, bsize


def bc_phase(device, peaks, f32_rows) -> list:
    """Every case of :data:`BC_CASES` at V = 1: a super-step bit for bit
    against the plain version, the counted run within tolerance of the
    reference backend, and the times beside the clamp cell's."""
    import torch
    t0 = time.perf_counter()
    f32 = f32_times(f32_rows)
    rows = []
    for label, name, bc, dtype in BC_CASES:
        problem, make, T, bsize = bc_problem(name, bc, dtype)
        g, aux = make(device)
        library = case_library(name, problem, g, aux, T, device)
        row, out = storage_row(label, problem, g, aux, T, bsize, 1, device,
                               peaks, library)
        row["oracle_max_abs_err"] = check_reference(label, problem, g, aux,
                                                    out, row["iters"])
        row["clamp_f32_ms"] = f32.get((name, 1))
        print(f"{label} {tuple(problem.shape)} T={T} bsize={bsize}: run "
              f"{row['run_ms']}, {row['launches']} launches, oracle "
              f"max_abs_err {row['oracle_max_abs_err']:.3g}; superstep: "
              f"kernel {row['ms']} (bit for bit with plain) vs f32 clamp "
              f"{row['clamp_f32_ms']}, plain {row['plain_ms']}, library "
              f"{row['library_ms']}, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        rows.append(row)
        del g, aux, out
        torch.cuda.empty_cache()
    print(f"bc phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return rows


# --- mixed-boundary DAGs (B1k), wide planes and large tables (B1j) --------

#: (label, cell, dtype, par_time, bsize, labels of the rows it is compared
#: with): diamond2d with a clamp, b reflect and m constant 0 (f32, bf16);
#: wave3d with a reflect Laplacian and a clamp combine; the four stencils
#: at bsize 2048 (2D) and 64 x 64 (3D), the largest T whose rings fit; two
#: make_box(3, 2) stages (250 taps, past the kernel parameter's 128)
B1KJ_CASES = (
    ("diamond2d clamp|reflect|constant:0.0", "diamond2d mixed", "float32",
     2, (256,), ("diamond2d reflect", "diamond2d")),
    ("diamond2d clamp|reflect|constant:0.0 bf16", "diamond2d mixed",
     "bfloat16", 2, (256,), ("diamond2d clamp|reflect|constant:0.0",)),
    ("wave3d reflect|clamp", "wave3d mixed", "float32", 2, (32, 32),
     ("wave3d",)),
    ("diffusion2d bsize=2048", "diffusion2d", "float32", 8, (2048,),
     ("diffusion2d",)),
    ("hotspot2d bsize=2048", "hotspot2d", "float32", 8, (2048,),
     ("hotspot2d",)),
    ("diffusion3d 64x64", "diffusion3d", "float32", 4, (64, 64),
     ("diffusion3d",)),
    ("hotspot3d 64x64", "hotspot3d", "float32", 4, (64, 64),
     ("hotspot3d",)),
    ("box3d_r2 x2", "box3d_r2 x2", "float32", 2, (32, 32), ()),
)


def b1kj_problem(cell, dtype):
    """``(problem, inputs(device))`` of a :data:`B1KJ_CASES` cell at
    :data:`FULL_DIMS`: a Table-2 stencil; diamond2d or wave3d with their
    stages' boundaries replaced; the box chain."""
    import dataclasses
    from repro_torch.api import StencilProblem, StencilProgram, StencilStage
    from repro_torch.core.stencils import make_box
    if cell in STENCILS:
        problem, make, _, _ = case_problem(cell, dtype)
        return problem, make
    if cell == "box3d_r2 x2":
        program = [StencilStage(make_box(3, 2)), StencilStage(make_box(3, 2))]
    else:
        name = cell.split()[0]
        prog = dag_program(name)
        bcs = (("clamp", "reflect", "constant:0.0") if name == "diamond2d"
               else ("reflect", "clamp"))
        program = StencilProgram(
            tuple(dataclasses.replace(st, boundary=bc)
                  for st, bc in zip(prog.stages, bcs)),
            fields=prog.fields, updates=prog.updates)
    problem = StencilProblem(program, FULL_DIMS[3 if "3d" in cell else 2],
                             dtype=dtype)
    return problem, lambda device: (grid_input(
        problem.state_shape, device, 0).to(problem.torch_dtype), None)


def sass_loop_counts(library: str, kernel: str) -> dict:
    """Instructions and shared-memory loads of one multiply-add in the
    innermost loop of ``kernel`` (named as ``_build.ptxas_report(...,
    all_args=True)`` names it) in ``library``'s SASS (``cuobjdump
    -sass``): the shortest backward branch whose body holds an ``FMUL``,
    its instructions and ``LDS`` over its ``FMUL``s (a loop the compiler
    unrolled counts once a copy); ``{}`` without ``cuobjdump``."""
    import re
    import shutil
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, check=True).stdout
    code, cur = [], None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = _build._kernel_label(m.group(1), all_args=True)
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if cur == kernel and m:
            code.append((int(m.group(1), 16), m.group(2)))
    best = None
    for at, ins in code:
        m = re.search(r"BRA (?:\S+, )?0x([0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) >= at:
            continue
        body = [i for a, i in code if int(m.group(1), 16) <= a <= at]
        fmul = sum(bool(re.search(r"\bFMUL\b", i)) for i in body)
        if fmul and (best is None or len(body) < len(best[0])):
            best = (body, fmul)
    if best is None:
        return {}
    body, fmul = best
    lds = sum(bool(re.search(r"\bLDS(\.\S+)?\b", i)) for i in body)
    return {"loop_instructions": len(body), "loop_fmuls": fmul,
            "instructions_per_tap": len(body) / fmul,
            "smem_loads_per_tap": lds / fmul}


def large_table_counts(label, geom, problem) -> dict:
    """What bounds the large-table chain (``box3d_r2 x2``), from the
    launch just made (``builder.LAST_SPLIT``): the cells its CTAs compute
    against those they own (the block plane over the compute plane, and
    the slabs streamed over the slabs owned), the taps of one computed
    cell in a super-step, the shared-memory loads and instructions of one
    tap in ``chain_kernel_big``'s SASS (:func:`sass_loop_counts`), and the
    multiply-adds the operations bound counts."""
    from repro_torch.kernels import builder
    sp = builder.LAST_SPLIT
    stages = problem.exec_stages
    plane, owned = math.prod(geom.bsize), math.prod(geom.csize)
    streamed = (sp.warm_share + 1.0)
    taps = geom.par_time * sum(len(builder.linear_taps(st) or ())
                               for st, _ in stages)
    sass = sass_loop_counts(sp.library, sp.kernel)
    out = {"cells_computed_per_owned": plane / owned * streamed,
           "plane_over_compute_plane": plane / owned,
           "taps_per_cell": taps, "large_table_kernel": sp.kernel, **sass}
    per_tap = sass.get("instructions_per_tap", float("nan"))
    loads = sass.get("smem_loads_per_tap", float("nan"))
    print(f"  bound ({label}, {sp.kernel}): {plane}/{owned} = "
          f"{plane / owned:.3f} cells computed a cell owned in the plane, "
          f"x {streamed:.4f} in the stream; {taps} taps a computed cell "
          f"and super-step; SASS tap loop: {per_tap:.2f} instructions and "
          f"{loads:.2f} shared-memory loads a tap "
          f"({sass.get('loop_instructions')} instructions, "
          f"{sass.get('loop_fmuls')} FMULs)", flush=True)
    return out


def b1kj_phase(device, peaks, rows_so_far) -> list:
    """Every case of :data:`B1KJ_CASES` at V = 1: a super-step bit for bit
    against the plain version (steps = T and T - 1), the counted run
    within tolerance of the reference backend, the times, bound, CTAs and
    redundancy beside the rows it is compared with."""
    import torch
    from repro_torch.api import RunConfig, plan
    from repro_torch.kernels import builder
    t0 = time.perf_counter()
    ms_of = {k[0]: v for k, v in f32_times(rows_so_far).items()
             if k[1] == 1}
    rows = []
    for label, cell, dtype, T, bsize, compare in B1KJ_CASES:
        problem, make = b1kj_problem(cell, dtype)
        g, aux = make(device)
        library = case_library(cell, problem, g, aux, T, device)
        row, out = storage_row(label, problem, g, aux, T, bsize, 1, device,
                               peaks, library)
        row["oracle_max_abs_err"] = check_reference(label, problem, g, aux,
                                                    out, row["iters"])
        del out
        p_geom = plan(problem, RunConfig(backend="hopper", par_time=T,
                                         bsize=bsize, device=device)).geometry
        tab = builder.tables_of(p_geom, problem.exec_dag)
        row.update({
            "blocks": p_geom.num_blocks, "redundancy": p_geom.redundancy,
            "form": ("mixed-boundary DAG body" if problem.is_dag else
                     "large-table route" if tab is not None and tab.big
                     else "wide form"),
            "compared_with": {c: ms_of.get(c) for c in compare}})
        if tab is not None and tab.big:
            row["table"] = tab._asdict()
            row.update(large_table_counts(label, p_geom, problem))
        print(f"{label} {tuple(problem.shape)} T={T} bsize={bsize} "
              f"({row['form']}, {row['blocks']} blocks, redundancy "
              f"{row['redundancy']:.4f}): run {row['run_ms']}, "
              f"{row['launches']} launches, oracle max_abs_err "
              f"{row['oracle_max_abs_err']:.3g}; superstep: kernel "
              f"{row['ms']} (bit for bit with plain), plain "
              f"{row['plain_ms']}, library {row['library_ms']}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}); compared "
              f"with {row['compared_with']}", flush=True)
        rows.append(row)
        del g, aux
        torch.cuda.empty_cache()
    print(f"b1kj phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return rows


# --- stencils with a custom apply (B1i rest) --------------------------------

def _lap2d(x):
    return x((-1, 0)) + x((1, 0)) + x((0, -1)) + x((0, 1)) - 4.0 * x((0, 0))


def _allen_cahn(get, c, aux=None):
    """Allen-Cahn phase field: ``u + dt*(d*lap(u) + u - u^3)``."""
    u = get((0, 0))
    return u + c["dt"] * (c["d"] * _lap2d(get) + u - u * u * u)


def _gray_scott_u(gets, c, aux=None):
    """Gray-Scott's u: ``u + dt*(Du*lap(u) - u*v*v + F*(1 - u))``."""
    u, v = gets[0]((0, 0)), gets[1]((0, 0))
    return u + c["dt"] * (c["Du"] * _lap2d(gets[0]) - u * v * v
                          + c["F"] * (1.0 - u))


def _gray_scott_v(gets, c, aux=None):
    """Gray-Scott's v: ``v + dt*(Dv*lap(v) + u*v*v - (F+k)*v)``."""
    v, u = gets[0]((0, 0)), gets[1]((0, 0))
    return v + c["dt"] * (c["Dv"] * _lap2d(gets[0]) + u * v * v
                          - c["Fk"] * v)


def _upwind(get, c, aux):
    """First-order upwind transport along x at velocity ``aux``."""
    import torch
    u = get((0, 0, 0))
    return u - c["dt"] * (torch.clamp(aux, min=0.0) * (u - get((0, 0, -1)))
                          + torch.clamp(aux, max=0.0) * (get((0, 0, 1)) - u))


#: (label, cell, dtype, rank, boundary, par_time, bsize, the f32 row it is
#: compared with): the paper's grids, seed 0, iters = 2T+3
CUSTOM_CASES = (
    ("allen_cahn2d", "allen_cahn2d", "float32", 2, "clamp", 8, (256,),
     "diffusion2d"),
    ("allen_cahn2d bf16", "allen_cahn2d", "bfloat16", 2, "clamp", 8, (256,),
     "diffusion2d"),
    ("gray_scott2d", "gray_scott2d", "float32", 2, "periodic", 4, (256,),
     "wave2d"),
    ("upwind3d", "upwind3d", "float32", 3, "clamp", 4, (32, 32),
     "hotspot3d"),
)


def custom_program(cell):
    """The program of a :data:`CUSTOM_CASES` cell: Allen-Cahn (dt 0.1, d
    0.2); Gray-Scott with Pearson's Du 0.16, Dv 0.08, F 0.035, F+k 0.095,
    dt 1 (fields u, v; each stage taps its own field at radius 1 and reads
    the other's centre); upwind transport (dt 0.3) at the aux velocity."""
    from repro_torch.api import StencilProgram, StencilStage
    from repro_torch.core.stencils import Stencil
    if cell == "allen_cahn2d":
        return [StencilStage(Stencil("allen_cahn2d", 2, 1, 12, 1, 1, False,
                                     ("dt", "d"), _allen_cahn),
                             coeffs={"dt": 0.1, "d": 0.2})]
    if cell == "upwind3d":
        return [StencilStage(Stencil("upwind3d", 3, 1, 9, 2, 1, True,
                                     ("dt",), _upwind), coeffs={"dt": 0.3})]
    gs_u = Stencil("gs_u", 2, 1, 15, 2, 1, False, ("Du", "F", "dt"),
                   _gray_scott_u, arity=2)
    gs_v = Stencil("gs_v", 2, 1, 15, 2, 1, False, ("Dv", "Fk", "dt"),
                   _gray_scott_v, arity=2)
    return StencilProgram(
        (StencilStage(gs_u, name="un", inputs=("u", "v"),
                      coeffs={"Du": 0.16, "F": 0.035, "dt": 1.0}),
         StencilStage(gs_v, name="vn", inputs=("v", "u"),
                      coeffs={"Dv": 0.08, "Fk": 0.095, "dt": 1.0})),
        fields=("u", "v"), updates={"u": "un", "v": "vn"})


def custom_inputs(problem, device, seed=0):
    """Fields ``uniform(0, 1)`` (u and v's physical range) and a standard
    normal aux (the velocity), made on ``device`` from ``seed``, in the
    problem's dtype."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.empty(problem.state_shape, device=device).uniform_(
        0.0, 1.0, generator=gen)
    aux = None
    if problem.needs_aux:
        aux = torch.empty(problem.shape, device=device).normal_(
            generator=gen).to(problem.torch_dtype)
    return g.to(problem.torch_dtype), aux


def custom_yardstick(cell, problem, g, aux, T):
    """``T`` iterations in composed PyTorch calls, in the state's dtype:
    one cuDNN convolution for each linear part (the Laplacians; upwind's
    backward and forward differences as two output channels) over the
    input padded under the boundary, then the nonlinear update in torch
    elementwise ops.  No single call computes these."""
    import torch
    import torch.nn.functional as F
    coeffs = problem.resolve_coeffs(device=g.device)
    dev, dt = g.device, g.dtype
    bc = problem.structural_bc
    if cell == "upwind3d":
        w = torch.zeros((2, 1, 1, 1, 3), device=dev, dtype=dt)
        w[0, 0, 0, 0, 0], w[0, 0, 0, 0, 1] = -1.0, 1.0    # u - u_w
        w[1, 0, 0, 0, 1], w[1, 0, 0, 0, 2] = -1.0, 1.0    # u_e - u
        c = coeffs[0]
        pos, neg = torch.clamp(aux, min=0.0), torch.clamp(aux, max=0.0)

        def run():
            u = g
            for _ in range(T):
                d = F.conv3d(pad_bc(u[None, None], 1, bc), w)[0]
                d = d[:, 1:-1, 1:-1]
                u = u - c["dt"] * (pos * d[0] + neg * d[1])
            return u
        return run
    lap = torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                       device=dev, dtype=dt)
    if cell == "allen_cahn2d":
        c = coeffs[0]

        def run():
            u = g
            for _ in range(T):
                L = F.conv2d(pad_bc(u[None, None], 1, bc),
                             lap[None, None])[0, 0]
                u = u + c["dt"] * (c["d"] * L + u - u * u * u)
            return u
        return run
    cu, cv = coeffs

    def run():
        u, v = g[0], g[1]
        for _ in range(T):
            L = F.conv2d(pad_bc(torch.stack([u, v])[None], 1, bc),
                         lap.expand(2, 1, 3, 3), groups=2)[0]
            u, v = (u + cu["dt"] * (cu["Du"] * L[0] - u * v * v
                                    + cu["F"] * (1.0 - u)),
                    v + cv["dt"] * (cv["Dv"] * L[1] + u * v * v
                                    - cv["Fk"] * v))
        return torch.stack([u, v])
    return run


def check_custom_yardstick(cell, problem, T, device) -> float:
    """The composed yardstick against the port's reference backend on a
    small grid, within ``tolerance(dtype, T, stages)``."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import precision
    dims = (40, 56) if problem.ndim == 2 else (12, 20, 28)
    small = StencilProblem(problem.program, dims,
                           boundary=problem.structural_bc,
                           dtype=problem.dtype)
    g, aux = custom_inputs(small, device, seed=1)
    got = custom_yardstick(cell, small, g, aux, T)()
    want = plan(small, RunConfig(backend="reference", device=device)).run(
        g, T, aux=aux)
    torch.testing.assert_close(got, want, **precision.tolerance(
        small.dtype, T, stages=small.n_stages))
    return (got.float() - want.float()).abs().max().item()


def custom_phase(device, peaks, rows_so_far) -> list:
    """Every cell of :data:`CUSTOM_CASES` through its generated library:
    the four libraries built at once (one nvcc each, timed), then per cell
    a super-step bit for bit against the plain version (steps = T and
    T - 1; CUDA events, median of 5), the counted run within
    ``tolerance(dtype, iters, stages)`` of the reference backend, the warm
    run (median of 5), the composed yardstick and the bound, beside the
    row it is compared with."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import precision
    from repro_torch.kernels import builder
    t0 = time.perf_counter()
    ms_of = {k[0]: v for k, v in f32_times(rows_so_far).items()
             if k[1] == 1}
    cases = []
    for label, cell, dtype, nd, bc, T, bsize, compare in CUSTOM_CASES:
        problem = StencilProblem(custom_program(cell), FULL_DIMS[nd],
                                 boundary=bc, dtype=dtype)
        geom = plan(problem, RunConfig(backend="hopper", par_time=T,
                                       bsize=bsize, device=device)).geometry
        cases.append((label, cell, problem, geom, T, bsize, compare))

    def build(case):
        start = time.perf_counter()
        lib = builder.custom_library(case[2].exec_dag, case[3],
                                     case[2].torch_dtype)
        return lib, time.perf_counter() - start
    with ThreadPoolExecutor(len(cases)) as pool:     # one nvcc each
        built = list(pool.map(build, cases))
    print(f"custom libraries: {time.perf_counter() - t0:.3f} s for "
          f"{len(cases)} in parallel", flush=True)
    rows = []
    for (label, cell, problem, geom, T, bsize, compare), (lib, secs) in zip(
            cases, built):
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({label}):", line.strip())
        g, aux = custom_inputs(problem, device)
        library = (time_ms(custom_yardstick(cell, problem, g, aux, T),
                           reps=3),
                   check_custom_yardstick(cell, problem, T, device),
                   f"composed: cuDNN conv for the linear part, torch "
                   f"elementwise ops, {problem.dtype}")
        row, out = storage_row(label, problem, g, aux, T, bsize, 1, device,
                               peaks, library)
        iters = row["iters"]
        ref = plan(problem, RunConfig(backend="reference",
                                      device=device)).run(g, iters, aux=aux)
        torch.testing.assert_close(out, ref, **precision.tolerance(
            problem.dtype, iters, stages=problem.n_stages))
        row["oracle_max_abs_err"] = (out.float() - ref.float()).abs().max(
            ).item()
        if (tuple(out.shape) != problem.state_shape
                or not bool(out.isfinite().all())):
            raise AssertionError(f"{label}: result not finite of shape "
                                 f"{problem.state_shape}")
        del out, ref
        p = plan(problem, RunConfig(backend="hopper", par_time=T,
                                    bsize=bsize, device=device))
        run_ms = time_ms(lambda: p.run(g, iters, aux=aux), reps=5)
        cells = math.prod(problem.shape)
        row.update({
            "run_ms": run_ms,
            "run_gcells_per_s": cells * iters / run_ms / 1e6,
            "build_s": secs, "library_file": lib.name,
            "generated_by": "src/repro_torch/kernels/codegen.py",
            "form": ("DAG body" if problem.is_dag else "chain body"),
            "compared_with": {compare: ms_of.get(compare)}})
        print(f"{label} {tuple(problem.shape)} {problem.structural_bc.token()}"
              f" T={T} bsize={bsize} ({row['form']}, {geom.num_blocks} blocks;"
              f" library built in {secs:.3f} s): run of {iters} iters "
              f"{run_ms} ({row['run_gcells_per_s']:.3f} GCell/s), "
              f"{row['launches']} launches, oracle max_abs_err "
              f"{row['oracle_max_abs_err']:.3g}; superstep: kernel "
              f"{row['ms']} (bit for bit with plain), plain "
              f"{row['plain_ms']}, composed library {row['library_ms']}, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
              f"compared with {row['compared_with']}", flush=True)
        rows.append(row)
        del g, aux
        torch.cuda.empty_cache()
    print(f"custom phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return rows


# --- batches along the kernel grid's z axis (B1f) ---------------------------

#: (label, cell, dtype, B, par_vec, aux mode): the main path without aux
#: and with one power grid shared by the batch, 3D with one per member, a
#: chain, a periodic DAG and bf16 at V = 8, each at its cell's size and
#: schedule, iters = 2T+3
BATCH_CASES = (
    ("diffusion2d B=4", "diffusion2d", "float32", 4, 1, None),
    ("hotspot2d B=4 shared aux", "hotspot2d", "float32", 4, 1, "shared"),
    ("hotspot3d B=8 member aux", "hotspot3d", "float32", 8, 1, "member"),
    ("advect_diffuse2d B=2", "advect_diffuse2d", "float32", 2, 1, None),
    ("wave2d B=2", "wave2d", "float32", 2, 1, None),
    ("diffusion2d bf16 B=4 V=8", "diffusion2d", "bfloat16", 4, 8, None),
)
#: the plan whose prewarm is timed: the serve phase's diffusion2d bucket
PREWARM_SIZES = (1, 2, 4, 8)


def batch_inputs(name, problem, B, aux_mode, device):
    """Member b's state and aux from seed b (the f32 cells' inputs at b =
    0), in the problem's dtype: ``(B, *state)`` and the aux, one grid for
    the batch (``"shared"``) or ``(B, *shape)`` (``"member"``)."""
    import torch
    dt = problem.torch_dtype
    g = torch.empty((B,) + problem.state_shape, device=device, dtype=dt)
    auxs = []
    for b in range(B):
        if name in STENCILS:
            gb, ab = inputs(name, problem.shape, device, b)
            auxs.append(ab)
        else:
            gb = grid_input(problem.state_shape, device, b)
        g[b] = gb
        del gb
    aux = None
    if aux_mode == "shared":
        aux = auxs[0].to(dt)
    elif aux_mode == "member":
        aux = torch.stack(auxs).to(dt)
    return g, aux


def batch_bound(problem, T, peaks, B, shared_aux) -> dict:
    """:func:`bound` of ``B`` members: every field of every member read and
    written once, the aux read once per member or once for the batch."""
    cells = math.prod(problem.shape)
    n_aux = 1 if problem.needs_aux else 0
    reads = B * (problem.stencil.num_read - n_aux) + (
        n_aux if shared_aux else B * n_aux)
    bytes_once = (reads + B * len(problem.fields)) * cells * problem.cell_bytes
    flops = B * T * problem.stencil.flop_pcu * cells
    bw, fp32, _ = peaks
    t_bytes, t_ops = bytes_once / bw * 1e3, flops / fp32 * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": bytes_once, "bound_flops": flops}


def counted_batch(p, g, aux, iters):
    """``p.run_batch`` with the launch count at 0 just before and read just
    after, and the peak device memory of the call: ``(out, launches,
    peak bytes)``; it must launch ``ceil(iters/T)`` times whatever B."""
    import torch
    from repro_torch.kernels import builder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    builder.LAUNCHES = 0
    builder.KERNEL_LAUNCHES.clear()
    out = p.run_batch(g, iters, aux=aux)
    torch.cuda.synchronize()
    launches = builder.LAUNCHES
    want = math.ceil(iters / p.geometry.par_time)
    if launches != want:
        raise AssertionError(f"run_batch of {g.shape[0]} launched the "
                             f"kernel {launches} times, expected {want}")
    launched_kernels(f"run_batch of {g.shape[0]}", p)
    return out, launches, torch.cuda.max_memory_allocated()


def batch_row(label, name, dtype, B, V, aux_mode, device, peaks) -> dict:
    """One batch case: ``run_batch`` bit for bit against the B sequential
    ``run``s, its launches, CTAs and peak memory; ``run_batch`` ms against
    the sequential loop's; one batched super-step bit for bit against the
    plain version (one timed call); the batched cuDNN yardstick (N = B)
    and the bound."""
    import torch
    from repro_torch.api import RunConfig, plan
    problem, _, T, bsize = case_problem(name, dtype)
    p = plan(problem, RunConfig(backend="hopper", par_time=T, bsize=bsize,
                                par_vec=V, device=device))
    geom = p.geometry
    iters = 2 * T + 3
    g, aux = batch_inputs(name, problem, B, aux_mode, device)
    out, launches, peak = counted_batch(p, g, aux, iters)
    by_kernel = dict(LAST_RUN_KERNELS)

    def member_aux(b):
        return aux[b] if aux_mode == "member" else aux
    for b in range(B):
        one = p.run(g[b], iters, aux=member_aux(b))
        if not torch.equal(out[b], one):
            raise AssertionError(
                f"{label}: member {b} of run_batch differs from its run by "
                f"{(out[b].float() - one.float()).abs().max().item()}")
        del one
    del out
    torch.cuda.empty_cache()
    batch_ms = time_ms(lambda: p.run_batch(g, iters, aux=aux), reps=3)
    seq_ms = time_ms(lambda: [p.run(g[b], iters, aux=member_aux(b))
                              for b in range(B)], reps=3)
    torch.cuda.empty_cache()
    res = superstep_vs_plain(label, problem, geom, g, aux, plain_reps=0)
    torch.cuda.empty_cache()
    if name in STENCILS:
        fn = library_yardstick(name, g, aux, T, problem.bc)
        what = f"cuDNN conv per step, N = {B}, {dtype}"
    elif problem.is_dag:
        fn = dag_yardstick(problem, g, T)
        what = f"composed cuDNN conv and torch.mul/add, N = {B}, {dtype}"
    else:
        fn = program_yardstick(problem, g, T)
        what = f"cuDNN conv per stage, N = {B}, {dtype}"
    library_ms = time_ms(fn, reps=3)
    cells = math.prod(problem.shape)
    row = {"name": f"stencil_stream[{label}]", "route": "cuda",
           "source": SOURCE, "replaces": REPLACES, "launches": launches,
           "launches_by_kernel": by_kernel,
           **res, **batch_bound(problem, T, peaks, B, aux_mode == "shared"),
           "library_ms": library_ms, "library": what, "batch": B,
           "aux": aux_mode, "dtype": dtype, "par_vec": V,
           "dims": list(problem.shape), "par_time": T,
           "bsize": list(geom.bsize), "iters": iters,
           "ctas_per_launch": res.get("ctas_per_launch",
                                      B * geom.num_blocks),
           "equal_to_sequential": True, "run_batch_ms": batch_ms,
           "sequential_ms": seq_ms, "batch_speedup": seq_ms / batch_ms,
           "run_batch_gcells_per_s": B * cells * iters / batch_ms / 1e6,
           "peak_bytes": peak}
    print(f"{label} {tuple(problem.shape)} T={T} bsize={bsize} V={V}: "
          f"run_batch of {iters} iters {batch_ms} "
          f"({row['run_batch_gcells_per_s']:.3f} GCell/s) vs {B} runs "
          f"{seq_ms}: {row['batch_speedup']:.3f}x, equal bit for bit; "
          f"{launches} launches of {row['ctas_per_launch']} CTAs "
          f"({geom.num_blocks} blocks a member); peak {peak / 2**30:.3f} GiB; "
          f"superstep: kernel {res['ms']} (bit for bit with plain), plain "
          f"{res['plain_ms']}, library {library_ms}, bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']})", flush=True)
    del g, aux
    torch.cuda.empty_cache()
    return row


def prewarm_seconds(device) -> dict:
    """``prewarm(PREWARM_SIZES)`` of the serve phase's diffusion2d plan,
    twice: the first call of a new plan (its batch sizes and buffers met
    for the first time; the library was built and loaded at the start)
    and the repeat."""
    from repro_torch.api import RunConfig, StencilProblem, plan
    p = plan(StencilProblem("diffusion2d", SERVE_DIMS),
             RunConfig(backend="hopper", par_time=SERVE_T,
                       bsize=SERVE_BSIZE, device=device))
    cold = p.prewarm(PREWARM_SIZES)
    warm = p.prewarm(PREWARM_SIZES)
    print(f"prewarm{PREWARM_SIZES} of diffusion2d {SERVE_DIMS}: first "
          f"{ {k: round(v, 4) for k, v in cold.items()} } s, repeat "
          f"{ {k: round(v, 4) for k, v in warm.items()} } s", flush=True)
    return {"prewarm_first_s": cold, "prewarm_repeat_s": warm}


def batch_phase(device, peaks) -> list:
    """Every case of :data:`BATCH_CASES`, then the prewarm timings."""
    t0 = time.perf_counter()
    rows = [batch_row(*case, device, peaks) for case in BATCH_CASES]
    rows[0].update(prewarm_seconds(device))
    print(f"batch phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return rows


# --- serving: StencilService over run_batch ---------------------------------

#: two buckets at 4096^2 f32, T=8, bsize 256 (18 CTAs a member), batch
#: classes up to 8 (144 CTAs)
SERVE_DIMS, SERVE_T, SERVE_BSIZE = (4096, 4096), 8, (256,)
SERVE_STENCILS = ("diffusion2d", "hotspot2d")
SERVE_CLASSES = (1, 2, 4, 8)
#: requests per bucket, their iters, and the distinct seeded grids they
#: draw from (request i of a bucket takes grid i mod SERVE_BASES)
SERVE_N, SERVE_ITERS, SERVE_BASES = 64, (8, 16), 8
#: open-loop arrivals at this multiple of the sequential loop's rate
SERVE_LOAD = 2.0
#: launch slots, each a CUDA stream of its own, run in worker threads so
#: that the event loop keeps admitting while a launch computes (inline, a
#: launch blocks the loop and the arrivals with it, and batches hold about
#: one request)
SERVE_SLOTS = 2


def serve_requests(device):
    """The 2 x :data:`SERVE_N` requests, seeded: ``(bucket, base, iters)``
    per request in arrival order, the exponential gaps, and per bucket the
    numpy base grids (and power grids)."""
    import numpy as np
    rng = np.random.default_rng(2024)
    bases = {}
    for s, name in enumerate(SERVE_STENCILS):
        gs, auxs = [], []
        for k in range(SERVE_BASES):
            g, aux = inputs(name, SERVE_DIMS, device, 100 * s + k)
            gs.append(g.cpu().numpy())
            auxs.append(None if aux is None else aux.cpu().numpy())
        bases[name] = (gs, auxs)
    order = [(name, i) for name in SERVE_STENCILS for i in range(SERVE_N)]
    rng.shuffle(order)
    reqs = [(name, i % SERVE_BASES, int(rng.choice(SERVE_ITERS)))
            for name, i in order]
    return reqs, rng, bases


def serve_phase(device, peaks) -> dict:
    """One ``StencilService`` with a diffusion2d and a hotspot2d bucket
    (per-request power) at :data:`SERVE_DIMS`: the sequential ``plan.run``
    loop over the requests (its rate, and each request's result), then
    the service under seeded open-loop arrivals at :data:`SERVE_LOAD`
    times that rate (every delivered grid bit for bit with the loop's);
    then an injected launch failure (retried and served), a NaN member
    (quarantined while its neighbours deliver) and a checkpointed request
    killed after its first chunk and resubmitted (resumed bit for bit)."""
    import asyncio
    import tempfile
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.kernels import builder
    from repro_torch.resilience import FaultPlan, FaultSpec
    from repro_torch.serve import (LaunchFailed, NumericalFault,
                                   ServiceConfig, ServiceOverloaded,
                                   StencilRequest, serve)
    t_phase = time.perf_counter()
    run = {"backend": "hopper", "par_time": SERVE_T,
           "bsize": list(SERVE_BSIZE), "device": str(device)}
    plans = {name: plan(StencilProblem(name, SERVE_DIMS), RunConfig(**run))
             for name in SERVE_STENCILS}
    reqs, rng, bases = serve_requests(device)

    def request(name, k, iters, **kw):
        gs, auxs = bases[name]
        return StencilRequest(name, gs[k], iters, aux=auxs[k], **kw)

    # the sequential loop: one plan.run per request, host to host
    want = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, k, iters in reqs:
        gs, auxs = bases[name]
        want[(name, k, iters)] = plans[name].run(gs[k], iters,
                                                 aux=auxs[k]).cpu()
    seq_s = time.perf_counter() - t0
    cells = math.prod(SERVE_DIMS)
    work = sum(cells * iters for _, _, iters in reqs)
    rate = len(reqs) / seq_s
    gaps = rng.exponential(1.0 / (SERVE_LOAD * rate), len(reqs))

    with tempfile.TemporaryDirectory() as ckdir:
        cfg = ServiceConfig.make({
            "buckets": [{"problem": {"stencil": name,
                                     "shape": list(SERVE_DIMS)},
                         "run": run, "max_batch": max(SERVE_CLASSES),
                         "batch_classes": list(SERVE_CLASSES),
                         "max_wait_ms": 4.0, "queue_cap": 64}
                        for name in SERVE_STENCILS],
            "max_concurrent_batches": SERVE_SLOTS, "offload_compute": True,
            "checkpoint_dir": ckdir})

        async def main():
            t_boot = time.perf_counter()
            svc = await serve(cfg)
            boot_s = time.perf_counter() - t_boot
            torch.cuda.synchronize()
            builder.LAUNCHES = 0
            t_start = time.perf_counter()
            outcomes = [None] * len(reqs)

            async def one(i):
                try:
                    fut = svc.submit_nowait(request(*reqs[i]))
                except ServiceOverloaded as e:
                    outcomes[i] = e
                    return
                outcomes[i] = await fut

            tasks = []
            for i, gap in enumerate(gaps):
                await asyncio.sleep(float(gap))
                tasks.append(asyncio.create_task(one(i)))
            await asyncio.gather(*tasks)
            wall = time.perf_counter() - t_start
            launches = builder.LAUNCHES
            snap = svc.snapshot()
            # one injected launch failure: retried and served
            name, k, iters = reqs[0]
            with FaultPlan([FaultSpec("serve.launch", nth=1)]).active():
                retried = await svc.submit(request(name, k, iters))
            retries = svc.snapshot()["retries"] - snap["retries"]
            # one NaN member among three healthy ones, in one launch
            gs, _ = bases["diffusion2d"]
            poisoned = gs[0].copy()
            poisoned[SERVE_DIMS[0] // 3, SERVE_DIMS[1] // 4] = float("nan")
            batch = [StencilRequest("diffusion2d", g, 8)
                     for g in (gs[1], poisoned, gs[2], gs[3])]
            nan_out = await asyncio.gather(
                *[svc.submit_nowait(r) for r in batch],
                return_exceptions=True)
            # a checkpointed request killed after its first chunk (every
            # later save fails, so do the retries), then resubmitted
            ck = dict(checkpoint_key="job", checkpoint_every=SERVE_T)
            kill = FaultSpec("checkpoint.save", p=1.0, max_fires=None,
                             match=lambda ctx: ctx["step"] > SERVE_T)
            with FaultPlan([kill]).active():
                killed = await asyncio.gather(svc.submit_nowait(request(
                    "hotspot2d", 1, 3 * SERVE_T, **ck)),
                    return_exceptions=True)
            resumed = await svc.submit(request("hotspot2d", 1, 3 * SERVE_T,
                                               **ck))
            final = svc.snapshot()
            await svc.stop()
            return (boot_s, outcomes, wall, launches, snap, retried,
                    retries, nan_out, killed, resumed, final)

        (boot_s, outcomes, wall, launches, snap, retried, retries, nan_out,
         killed, resumed, final) = asyncio.run(main())

    served = [(r, o) for r, o in zip(reqs, outcomes)
              if not isinstance(o, Exception)]
    rejected = [o for o in outcomes if isinstance(o, ServiceOverloaded)]
    failed = [o for o in outcomes
              if isinstance(o, Exception) and o not in rejected]
    if failed:
        raise AssertionError(f"serve: {len(failed)} requests failed: "
                             f"{failed[:3]}")
    for (name, k, iters), res in served:
        if not torch.equal(res.grid, want[(name, k, iters)]):
            raise AssertionError(f"serve: a {name} request of {iters} iters "
                                 f"differs from plan.run")
    if launches < 1:
        raise AssertionError("serve: the kernel was launched no time")
    name, k, iters = reqs[0]
    if retries < 1 or not torch.equal(retried.grid, want[(name, k, iters)]):
        raise AssertionError("serve: the injected launch failure was not "
                             "retried and served")
    p = plans["diffusion2d"]
    gs, _ = bases["diffusion2d"]
    if not (isinstance(nan_out[1], NumericalFault)
            and nan_out[1].kind == "nan"
            and final["quarantined"] - snap["quarantined"] == 1
            and all(torch.equal(nan_out[j].grid, p.run(gs[g], 8).cpu())
                    for j, g in ((0, 1), (2, 2), (3, 3)))):
        raise AssertionError(f"serve: the NaN member was not quarantined "
                             f"with its neighbours delivered: {nan_out}")
    hp = plans["hotspot2d"]
    hg, ha = bases["hotspot2d"]
    whole = hp.run(hg[1], 3 * SERVE_T, aux=ha[1]).cpu()
    if not (isinstance(killed[0], LaunchFailed) and resumed.rounds == 2
            and torch.equal(resumed.grid, whole)):
        raise AssertionError(f"serve: the checkpointed request did not "
                             f"resume bit for bit: {killed}, rounds "
                             f"{resumed.rounds}")
    done = [iters for (_, _, iters), _ in served]
    served_work = cells * sum(done)
    lat = snap["latency_ms"]
    out = {"requests": len(reqs), "served": len(served),
           "rejected": len(rejected), "sequential_s": seq_s,
           "sequential_gcells_per_s": work / seq_s / 1e9,
           "offered_rate_per_s": SERVE_LOAD * rate, "wall_s": wall,
           "delivered_gcells_per_s": served_work / wall / 1e9,
           "speedup_vs_loop": served_work / wall / (work / seq_s),
           "p50_ms": lat["p50"], "p99_ms": lat["p99"],
           "batch_fill": snap["batch_fill"], "batches": snap["batches"],
           "rounds": snap["rounds"], "launches": launches,
           "boot_s": boot_s, "prewarm_s": snap["prewarm_s"],
           "retried_ok": True, "quarantined_ok": True, "resumed_ok": True}
    print(f"serve {list(SERVE_STENCILS)} {SERVE_DIMS} T={SERVE_T} "
          f"bsize={SERVE_BSIZE} classes {SERVE_CLASSES}, {SERVE_SLOTS} "
          f"offloaded launch slots: sequential loop "
          f"{seq_s:.3f} s for {len(reqs)} requests "
          f"({out['sequential_gcells_per_s']:.3f} GCell/s); service at "
          f"{out['offered_rate_per_s']:.1f} req/s offered: {len(served)} "
          f"served, {len(rejected)} rejected in {wall:.3f} s "
          f"({out['delivered_gcells_per_s']:.3f} GCell/s, "
          f"{out['speedup_vs_loop']:.3f}x the loop), p50 {lat['p50']:.3f} ms, p99 {lat['p99']:.3f} ms, "
          f"batch fill {snap['batch_fill']:.3f}, {snap['batches']} batches, "
          f"{snap['rounds']} rounds, {launches} launches; every grid bit "
          f"for bit with plan.run; boot {boot_s:.3f} s; injected launch "
          f"failure retried and served, NaN member quarantined, "
          f"checkpointed request resumed bit for bit ({resumed.rounds} of "
          f"3 chunks rerun)", flush=True)
    print(f"serve phase: {time.perf_counter() - t_phase:.3f} s", flush=True)
    return out


def serve_kernel_row(device, peaks, serve_out: dict) -> dict:
    """The kernel at the serving shape: one super-step of a full batch
    class of hotspot2d (per-member power), bit for bit against the plain
    version, its time, the batched cuDNN yardstick and the bound; with the
    serve phase's launches and numbers."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    B = max(SERVE_CLASSES)
    problem = StencilProblem("hotspot2d", SERVE_DIMS)
    p = plan(problem, RunConfig(backend="hopper", par_time=SERVE_T,
                                bsize=SERVE_BSIZE, device=device))
    g, aux = batch_inputs("hotspot2d", problem, B, "member", device)
    res = superstep_vs_plain(f"serve hotspot2d B={B}", problem, p.geometry,
                             g, aux, plain_reps=0)
    library_ms = time_ms(library_yardstick("hotspot2d", g, aux, SERVE_T,
                                           problem.bc), reps=3)
    row = {"name": f"stencil_stream[serve {'+'.join(SERVE_STENCILS)} "
                   f"{SERVE_DIMS[0]}^2]", "route": "cuda", "source": SOURCE,
           "replaces": REPLACES, "launches": serve_out["launches"], **res,
           **batch_bound(problem, SERVE_T, peaks, B, False),
           "library_ms": library_ms,
           "library": f"cuDNN conv per step, N = {B}",
           "kernel_case": f"hotspot2d B={B}, per-member power",
           "ctas_per_launch": res.get("ctas_per_launch",
                                      B * p.geometry.num_blocks),
           **serve_out}
    print(f"  serve kernel (hotspot2d B={B}, {row['ctas_per_launch']} CTAs): "
          f"superstep {res['ms']} (bit for bit with plain), plain "
          f"{res['plain_ms']}, library {library_ms}, bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']})", flush=True)
    del g, aux
    torch.cuda.empty_cache()
    return row


# --- LM serving: qwen3-1.7b through the flash-attention kernel ------------

LM_ARCH = "qwen3-1.7b"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 4096, 16
#: teacher-forced decode: prefill this many tokens, then decode
#: LM_TF_STEPS more; every prefill length stays at most 512 (attn_q_chunk)
#: so the flash wrapper accepts it
LM_TF_PROMPT, LM_TF_STEPS = 508, 4
LM_SOURCE = "src/repro_torch/kernels/csrc/flash_fwd.cu"
LM_REPLACES = "src/repro/kernels/flash_attention.py:66"
#: two bf16 paths through 28 layers, compared on the true-vocab logits by
#: ||a - b|| / ||b||: "flash" against "xla" prefill, and decode against
#: prefill
LOGIT_REL_TOL = 5e-2


def rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def flash_bound(kernel: str, q, k, peaks) -> dict:
    """The least time the card could take for one flash kernel's work on
    q, k (causal): its products' FLOPs at the dtype's peak (989 TFLOP/s
    bf16 on the tensor cores, 67 f32 FMAs) against its bytes at 3.35
    TB/s, the larger of the two."""
    import torch
    from repro_torch.kernels import flash_attention as flash
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    bw, f32_rate, bf16_rate = peaks
    f32 = q.dtype == torch.float32
    el = q.element_size()
    if kernel == "fwd":
        flops = flash.flash_flops(B, S, S, H, D, True, False)
        nbytes = flash.flash_traffic_bytes(B, S, S, H, Hkv, D, el, False)
    else:
        flops = flash.flash_bwd_kernel_flops(B, S, S, H, D, True, kernel)
        nbytes = flash.flash_bwd_kernel_bytes(B, S, S, H, Hkv, D, kernel, el)
    t_ops = flops / (f32_rate if f32 else bf16_rate) * 1e3
    t_bytes = nbytes / bw * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def forward_kernel_vs_plain(q, k, v, peaks) -> dict:
    """The flash forward on q, k, v (causal; output and lse pre-filled with
    NaN) against ``flash_fwd_plain`` within ``check_against_plain``'s
    bound for the dtype, then CUDA-event times of the kernel, the plain
    version and ``scaled_dot_product_attention`` (causal, GQA; held to the
    same bound), the bound, the kernel's TFLOP/s, its share of the bound
    (bound / ms) and its ratio to SDPA (ms / SDPA ms)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash
    B, S, H, D = q.shape
    with torch.inference_mode():
        o = torch.full_like(q, float("nan"))
        lse = torch.full((B, H, S), float("nan"), device=q.device)
        flash.flash_attention_lse(q, k, v, True, out=(o, lse))
        torch.cuda.synchronize()
        # raises past the bounds stated in check_against_plain
        vs_plain = flash.check_against_plain(o, q, k, v, True, lse=lse)
        print(f"flash kernel vs plain (B {B}, S {S}, H {H}, Hkv "
              f"{k.shape[2]}, D {D}, {q.dtype}): {vs_plain}", flush=True)
        del o, lse
        kernel_ms = time_ms(lambda: flash.flash_attention_lse(q, k, v, True),
                            reps=10)
        plain_ms = time_ms(lambda: flash.flash_fwd_plain(q, k, v, True),
                           reps=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        lib_vs_plain = flash.check_against_plain(sdpa().transpose(1, 2), q,
                                                 k, v, True)
        print(f"scaled_dot_product_attention vs plain: {lib_vs_plain}",
              flush=True)
        library_ms = time_ms(sdpa, reps=10)
    bound = flash_bound("fwd", q, k, peaks)
    flops = flash.flash_flops(B, S, S, H, D, True, False)
    out = {"readings": vs_plain, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library_max_abs_err": lib_vs_plain["max_abs_err"],
           "library_row_rel_err": lib_vs_plain["row_rel_err"], **bound,
           "tflop_per_s": flops / kernel_ms / 1e9,
           "share_of_bound": bound["bound_ms"] / kernel_ms,
           "ms_over_library": kernel_ms / library_ms}
    print(f"  forward: {out['tflop_per_s']:.1f} TFLOP/s, "
          f"{out['share_of_bound']:.3f} of the bound, "
          f"{out['ms_over_library']:.3f}x SDPA", flush=True)
    return out


def lm_phase(device, peaks) -> dict:
    """Serve full-width qwen3-1.7b (random weights from a seed) through
    ``generate`` and hold the flash kernel, the prefill and the decode
    against their plain counterparts on the card."""
    return serve_arch(LM_ARCH, device, peaks, extras=True)


def serve_arch(arch, device, peaks, extras: bool = False) -> dict:
    """Serve full-width ``arch`` (bf16, random weights from seed 0) through
    ``generate`` at batch LM_BATCH x prompt LM_PROMPT + LM_NEW, and hold
    the flash kernel on layer 0's q, k, v against its plain version, with
    kernel, plain and SDPA times, and profile one prefill (the flash share
    of its device time); with ``extras`` (qwen3-1.7b's cell) also profile
    decode and hold the "flash" prefill against "xla" and decode against
    prefill."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import layers as L
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.transformer import _unstack
    cfg = get_config(arch)
    B, S, H, Hkv, D = LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv, cfg.d_head
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"{arch}: {n_par} parameters ({n_par * 2 / 1e9:.3f} GB bf16, "
          f"padded vocab {cfg.padded_vocab}) made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    kv_gb = cfg.n_layers * B * (S + LM_NEW) * Hkv * D * 2 * 2 / 1e9
    full_kv_gb = cfg.n_layers * 32 * (32768 + LM_NEW) * Hkv * D * 2 * 2 / 1e9
    print(f"cut: prefill_32k (batch 32 x 32768) needs {full_kv_gb:.1f} GB of "
          f"KV cache, more than one card holds; served batch {B} x prompt "
          f"{S} + {LM_NEW} new ({kv_gb:.2f} GB of KV cache)", flush=True)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, (B, S),
                                                dtype=np.int32)
    tokens = torch.from_numpy(prompts).long().to(device)

    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    out = generate(cfg, params, tokens, LM_NEW)
    launches = flash.LAUNCHES
    forms = dict(flash.FORM_LAUNCHES)
    if (out.prefill_launches, out.decode_launches, launches) != (
            cfg.n_layers, 0, cfg.n_layers):
        raise AssertionError(
            f"flash launches: {out.prefill_launches} in prefill, "
            f"{out.decode_launches} in decode, {launches} in all; expected "
            f"{cfg.n_layers}, 0, {cfg.n_layers}")
    if tuple(out.tokens.shape) != (B, LM_NEW) or not bool(
            ((out.tokens >= 0) & (out.tokens < cfg.vocab)).all()):
        raise AssertionError("generated tokens outside [0, vocab)")
    if not bool(out.logits.isfinite().all()):
        raise AssertionError("non-finite logits")
    print(f"generate (cold): prefill {out.prefill_s * 1e3:.3f} ms, decode "
          f"{out.decode_s * 1e3:.3f} ms for {LM_NEW - 1} steps; launches "
          f"{out.prefill_launches} + {out.decode_launches}; tokens[0] "
          f"{out.tokens[0].tolist()}", flush=True)
    warm = generate(cfg, params, tokens, LM_NEW)
    e2e = {"prefill_ms": warm.prefill_s * 1e3,
           "prefill_tok_per_s": B * S / warm.prefill_s,
           "decode_ms_per_step": warm.decode_s * 1e3 / (LM_NEW - 1),
           "decode_tok_per_s": B * (LM_NEW - 1) / warm.decode_s,
           "serve_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"generate (warm): prefill {e2e['prefill_ms']:.3f} ms "
          f"({e2e['prefill_tok_per_s']:.1f} tok/s), decode "
          f"{e2e['decode_ms_per_step']:.3f} ms/step "
          f"({e2e['decode_tok_per_s']:.1f} tok/s); peak memory "
          f"{e2e['serve_peak_memory_gb']:.3f} GB", flush=True)
    with torch.inference_mode():
        prof = device_profile(lambda: prefill(params, cfg, tokens, S),
                              "flash_fwd_kernel")
    e2e["kernel_share_of_prefill_device"] = prof.pop("kernel_share_of_device")
    e2e.update({f"prefill_{k}": v for k, v in prof.items()})
    print(f"flash share of {arch}'s prefill device time "
          f"{e2e['kernel_share_of_prefill_device']:.4f}, device idle "
          f"{e2e['prefill_device_idle_share']:.4f}, profiled prefill "
          f"{e2e['prefill_profiled_run_ms']:.3f} ms", flush=True)
    if extras:
        with torch.inference_mode():
            _, caches = prefill(params, cfg, tokens, S + 1)
            nxt = tokens[:, -1:]
            prof = device_profile(
                lambda: decode_step(params, cfg, nxt, caches), None, top=5)
            del caches
        e2e.update({f"decode_{k}": v for k, v in prof.items()})
        print(f"device idle {e2e['decode_device_idle_share']:.4f} in one "
              f"decode step "
              f"({e2e['decode_device_ops']} device ops)", flush=True)

    with torch.inference_mode():
        # the kernel against its plain version on layer 0's q, k, v
        x = L.embed_tokens(tokens, params["embed"], cfg.tdtype)
        bp = _unstack(params["blocks"], cfg.n_layers)[0]
        q, k, v = _project_qkv(L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                               bp["attn"], cfg,
                               torch.arange(S, device=device))
        del x
        kernel = forward_kernel_vs_plain(q, k, v, peaks)
        del q, k, v
        checks = {}
        if extras:
            checks = prefill_and_decode_checks(params, cfg, tokens)
    del params
    torch.cuda.empty_cache()

    res = {"name": f"flash_fwd[{arch}]", "route": "cuda",
           "source": LM_SOURCE, "replaces": LM_REPLACES,
           "launches": launches, "form_launches": _form_counts(forms),
           **kernel.pop("readings"), **kernel,
           "shape": {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D},
           **checks, "tokens_in_range": True, "logits_finite": True, **e2e}
    print(f"  flash_fwd[{arch}]: kernel {res['ms']}, plain "
          f"{res['plain_ms']}, library {res['library_ms']}, bound "
          f"{res['bound_ms']:.3f} ms ({res['bound_by']})", flush=True)
    return res


def prefill_and_decode_checks(params, cfg, tokens) -> dict:
    """The "flash" prefill against "xla" (chunked torch ops), and
    teacher-forced decode against prefill over the same tokens, by the
    relative L2 of the true-vocab logits (LOGIT_REL_TOL)."""
    import dataclasses
    from repro_torch.models import decode_step, prefill
    S = tokens.shape[1]
    lf, cf = prefill(params, cfg, tokens, S)
    del cf
    lx, cx = prefill(params, dataclasses.replace(cfg, attn_impl="xla"),
                     tokens, S)
    del cx
    flash_xla = rel_err(lf[..., :cfg.vocab], lx[..., :cfg.vocab])
    print(f"prefill logits, flash vs xla: rel err {flash_xla}, max abs "
          f"{(lf - lx).abs().max().item()}", flush=True)
    tf = []
    short = tokens[:, :LM_TF_PROMPT + LM_TF_STEPS]
    _, caches = prefill(params, cfg, short[:, :LM_TF_PROMPT],
                        LM_TF_PROMPT + LM_TF_STEPS)
    for t in range(LM_TF_PROMPT, LM_TF_PROMPT + LM_TF_STEPS):
        ld, caches = decode_step(params, cfg, short[:, t:t + 1], caches)
        lp, _ = prefill(params, cfg, short[:, :t + 1], t + 1)
        tf.append(rel_err(ld[..., :cfg.vocab], lp[..., :cfg.vocab]))
    print(f"teacher-forced decode vs prefill (prompt {LM_TF_PROMPT}, "
          f"{LM_TF_STEPS} steps): rel err {tf}", flush=True)
    del caches
    if flash_xla > LOGIT_REL_TOL or max(tf) > LOGIT_REL_TOL:
        raise AssertionError(f"logits differ beyond {LOGIT_REL_TOL}")
    return {"flash_vs_xla_logit_rel_err": flash_xla,
            "teacher_forced_logit_rel_err": tf}


# --- LM training: qwen3-1.7b through the flash backward kernels ----------

TRAIN_BATCH, TRAIN_SEQ = 8, 4096
#: steps with one microbatch, then with two
TRAIN_STEPS = (4, 2)
#: the full-width "flash" against "xla" check: one 4096-token row
XLA_BATCH, XLA_SEQ = 1, 4096
#: two bf16 paths through 28 layers and back, compared by ||a - b|| / ||b||
#: on the loss and on each gradient leaf (the serving check's bound)
GRAD_REL_TOL = 5e-2
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_bwd.cu"
DQ_REPLACES = "src/repro/kernels/flash_attention.py:162"
DKV_REPLACES = "src/repro/kernels/flash_attention.py:198"


def _launch_counts():
    from repro_torch.kernels import flash_attention as flash
    return (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)


def _zero_launch_counts():
    from repro_torch.kernels import flash_attention as flash
    flash.LAUNCHES = flash.DQ_LAUNCHES = flash.DKV_LAUNCHES = 0
    flash.FORM_LAUNCHES.clear()


def _form_counts(forms: dict) -> dict:
    """``FORM_LAUNCHES`` as JSON: ``"kernel[dtype,dD]"`` -> count."""
    return {f"{k}[{t},d{D}]": n for (k, t, D), n in sorted(forms.items())}


def capture_layer0(params, cfg, batch) -> dict:
    """Layer 0's q, k, v and the gradient of its attention output from one
    backward of the batch's loss (the gradient taken with respect to the
    stacked ``wq``, which every layer's q projection reads)."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import lm_loss
    seen = {}
    real = A.flash_attention

    def spy(q, k, v, *args):
        o = real(q, k, v, *args)
        if "q" not in seen and o.requires_grad:
            seen.update(q=q.detach(), k=k.detach(), v=v.detach())
            o.register_hook(lambda g: seen.setdefault(
                "do", g.detach().clone(memory_format=torch.contiguous_format)))
        return o
    wq = params["blocks"]["attn"]["wq"]
    A.flash_attention = spy
    wq.requires_grad_(True)
    try:
        torch.autograd.grad(lm_loss(params, cfg, batch), [wq])
    finally:
        A.flash_attention = real
        wq.requires_grad_(False)
    if "do" not in seen:
        raise AssertionError("layer 0's output gradient was not captured")
    return seen


def backward_kernels_vs_plain(cap: dict, peaks) -> dict:
    """Both backward kernels against ``flash_bwd_plain`` on ``cap``'s q, k,
    v and dO (outputs pre-filled with NaN) within
    ``check_bwd_against_plain``'s bound for the dtype, then CUDA-event
    times of each kernel, the plain version and the SDPA backward, the
    bound, each kernel's TFLOP/s, its share of the bound (bound / ms) and
    its ratio to the SDPA backward (ms / SDPA ms), and the pair's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as flash
    q, k, v, do = cap["q"], cap["k"], cap["v"], cap["do"]
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    with torch.no_grad():
        o, lse = flash.flash_attention_lse(q, k, v, True)
        nan = float("nan")
        dq, dk, dv = (torch.full_like(t, nan) for t in (q, k, v))
        delta = torch.full((B, H, S), nan, device=q.device)
        flash.flash_bwd_dq(q, k, v, o, lse, do, True, out=(dq, delta))
        flash.flash_bwd_dkv(q, k, v, do, lse, delta, True, out=(dk, dv))
        torch.cuda.synchronize()
        # raises past the bounds stated in check_bwd_against_plain
        vs_plain = flash.check_bwd_against_plain((dq, dk, dv), q, k, v, o,
                                                 lse, do, True)
        print(f"flash backward kernels vs plain (B {B}, S {S}, H {H}, Hkv "
              f"{Hkv}, D {D}, {q.dtype}; dO norm "
              f"{do.float().norm().item():.6g}): {vs_plain}", flush=True)
        dq_ms = time_ms(lambda: flash.flash_bwd_dq(q, k, v, o, lse, do),
                        reps=10)
        dkv_ms = time_ms(lambda: flash.flash_bwd_dkv(q, k, v, do, lse,
                                                      delta), reps=10)
        plain_ms = time_ms(lambda: flash.flash_bwd_plain(q, k, v, o, lse,
                                                         do), reps=3)
        want = flash.flash_bwd_plain(q, k, v, o, lse, do)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)

    def sdpa_grad():
        return torch.autograd.grad(sdpa(), (qt, kt, vt), dot)
    lib = [g.transpose(1, 2) for g in sdpa_grad()]
    lib_rel = [rel_err(g, w) for g, w in zip(lib, want)]
    print(f"scaled_dot_product_attention backward vs plain: rel err "
          f"dq/dk/dv {lib_rel}", flush=True)
    if max(lib_rel) > 1e-2:
        raise AssertionError("the SDPA yardstick does not compute the same "
                             "gradients")
    with torch.no_grad():
        fwd_ms = time_ms(sdpa, reps=10)
    grad_ms = time_ms(sdpa_grad, reps=10)
    library_ms = Timing([t - fwd_ms for t in (grad_ms.lo, grad_ms,
                                              grad_ms.hi)])
    del qt, kt, vt, lib, want, o, lse, dq, dk, dv, delta
    out = {}
    for kernel, ms, err in (("dq", dq_ms, vs_plain["dq_max_abs_err"]),
                            ("dkv", dkv_ms, max(vs_plain["dk_max_abs_err"],
                                                vs_plain["dv_max_abs_err"]))):
        bound = flash_bound(kernel, q, k, peaks)
        flops = flash.flash_bwd_kernel_flops(B, S, S, H, D, True, kernel)
        out[kernel] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       **bound, "library_ms": library_ms,
                       "tflop_per_s": flops / ms / 1e9,
                       "share_of_bound": bound["bound_ms"] / ms,
                       "ms_over_library": ms / library_ms}
        print(f"  flash_bwd_{kernel}: kernel {ms}, plain (dq, dk, dv "
              f"together) {plain_ms}, SDPA backward (dq, dk, dv) "
              f"{library_ms}, bound {bound['bound_ms']:.3f} ms "
              f"({bound['bound_by']}); {out[kernel]['tflop_per_s']:.1f} "
              f"TFLOP/s, {out[kernel]['share_of_bound']:.3f} of the bound, "
              f"{out[kernel]['ms_over_library']:.3f}x the SDPA backward",
              flush=True)
    pair = dq_ms + dkv_ms
    out["pair"] = {"ms": pair,
                   "share_of_bound": (out["dq"]["bound_ms"]
                                      + out["dkv"]["bound_ms"]) / pair,
                   "ms_over_library": pair / library_ms}
    print(f"  backward pair (dq + dkv): {pair:.3f} ms, "
          f"{out['pair']['share_of_bound']:.3f} of the bound, "
          f"{out['pair']['ms_over_library']:.3f}x the SDPA backward",
          flush=True)
    out["readings"] = vs_plain
    out["library_rel_err"] = lib_rel
    out["shape"] = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D}
    return out


def flash_vs_xla(params, cfg, batch) -> dict:
    """Loss and gradients through "flash" and through "xla" (chunked torch
    ops under autograd) at full width: relative L2 of each."""
    import dataclasses
    from repro_torch.train.steps import _loss_and_grads
    from repro_torch.optim.adamw import leaves
    lf, gf = _loss_and_grads(params, cfg, batch)
    lx, gx = _loss_and_grads(
        params, dataclasses.replace(cfg, attn_impl="xla"), batch)
    out = {"loss_flash": lf.item(), "loss_xla": lx.item(),
           "loss_rel_err": abs(lf.item() - lx.item()) / abs(lx.item())}
    names = _leaf_names(gf)
    for name, a, b in zip(names, leaves(gf), leaves(gx)):
        out[f"grad_rel_err[{name}]"] = rel_err(a, b)
    worst = max(v for k, v in out.items() if k.startswith("grad_rel"))
    print(f"flash vs xla at full width, batch {XLA_BATCH} x {XLA_SEQ}: "
          f"{out}", flush=True)
    if out["loss_rel_err"] > GRAD_REL_TOL or worst > GRAD_REL_TOL:
        raise AssertionError(f"flash and xla loss or gradients differ "
                             f"beyond {GRAD_REL_TOL}")
    return out


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in tree for n in _leaf_names(tree[k],
                                                     f"{prefix}{k}/")]
    return [] if tree is None else [prefix[:-1]]


def loop_restart_check(device) -> dict:
    """``fault_tolerant_train`` at the smoke width on the card (bf16, head
    dim 128: the flash kernels' form), deterministic algorithms on: 8 steps
    uninterrupted, then 6 with a failure injected at step 3 and a restart
    to 8, whose losses must equal the first run's bit for bit."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import (TrainLoopConfig, fault_tolerant_train,
                                   make_train_step)
    cfg = dataclasses.replace(smoke_config(LM_ARCH), dtype="bfloat16",
                              d_head=128)
    step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=2,
                                            total_steps=8))
    data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=256,
                                         global_batch=4, seed=1))
    root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)

    def run(name, total, hook=None):
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            0), device)
        loop = TrainLoopConfig(total_steps=total, checkpoint_every=2,
                               checkpoint_dir=os.path.join(root, name),
                               straggler_factor=1e9)
        return fault_tolerant_train(
            loop, step, (params, adamw_init(params)), iter(()),
            lambda s: device_batch(data.batch_at(s), device),
            failure_hook=hook, log=lambda *_: None)[2]
    boom = {3}

    def hook(s):
        if s in boom:
            boom.remove(s)
            raise RuntimeError("simulated device loss")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        before = _launch_counts()
        want = run("a", 8)["losses"]
        first = run("b", 6, hook)
        second = run("b", 8)
        launched = [a - b for a, b in zip(_launch_counts(), before)]
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    got = first["losses"] + second["losses"]
    print(f"fault_tolerant_train (smoke width, bf16, d_head 128): "
          f"uninterrupted {want}; with a failure at step 3 and a restart "
          f"{got}; retries {first['retries']}; launches {launched}",
          flush=True)
    if first["retries"] != 1 or got != want or not all(launched):
        raise AssertionError("the checkpointed loop did not repeat the "
                             "uninterrupted losses")
    return {"losses": want, "retries": first["retries"]}


def train_phase(device, peaks) -> dict:
    """Train full-width qwen3-1.7b through ``make_train_step`` and hold the
    backward kernels, the "flash" gradients and the checkpointed loop
    against their plain counterparts on the card."""
    return train_arch(LM_ARCH, device, peaks, TRAIN_BATCH,
                      [1] * TRAIN_STEPS[0] + [2] * TRAIN_STEPS[1],
                      extras=True)


def train_arch(arch, device, peaks, B, plan, extras: bool = False) -> dict:
    """Train full-width ``arch`` (bf16, random weights from seed 0, AdamW)
    through ``make_train_step``, one step per entry of ``plan`` (its
    microbatches), at batch ``B`` x TRAIN_SEQ, and hold both backward
    kernels against their plain version on layer 0's q, k, v and real
    output gradient; with ``extras`` (qwen3-1.7b's cell) also profile a
    step and hold the "flash" gradients against "xla" and the checkpointed
    loop against its uninterrupted run."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init_params, lm_loss
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    cfg = get_config(arch)
    S = TRAIN_SEQ
    full = SHAPES["train_4k"]
    print(f"cut: train_4k is batch {full['batch']} x {full['seq']} tokens "
          f"per step, {full['batch'] // B}x this one, and does not fit one "
          f"card without microbatching; trained {arch} at batch {B} x {S}, "
          f"remat_policy={cfg.remat_policy}, attn_impl={cfg.attn_impl}",
          flush=True)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    opt = adamw_init(params)
    data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=S,
                                         global_batch=B, seed=0))
    batches = [device_batch(data.batch_at(s), device)
               for s in range(len(plan))]
    with torch.no_grad():
        loss0 = lm_loss(params, cfg, batches[0]).item()
    cap = capture_layer0(params, cfg, batches[0])
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=len(plan))
    steps = {mb: make_train_step(cfg, ocfg, mb) for mb in sorted(set(plan))}

    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, secs, per_step = [], [], []
    for batch, mb in zip(batches, plan):
        c0, t0 = _launch_counts(), time.perf_counter()
        params, opt, metrics = steps[mb](params, opt, batch)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(tuple(b - a for a, b in zip(c0, _launch_counts())))
    launches = _launch_counts()
    forms = dict(flash.FORM_LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    L = cfg.n_layers
    want = [(2 * L * mb, L * mb, L * mb) for mb in plan]
    print(f"train steps (mb {plan}): losses {losses}; seconds {secs}; "
          f"launches per step (fwd, dq, dkv) {per_step}; peak memory "
          f"{peak_gb:.3f} GB; loss of batch 0 without autograd {loss0}",
          flush=True)
    if per_step != want or launches != tuple(map(sum, zip(*want))):
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{want}")
    if not all(math.isfinite(x) for x in losses) \
            or abs(losses[0] - loss0) > 1.0:
        raise AssertionError("training losses not finite, or the first "
                             "step's loss far from the batch's loss")
    one = [t for t, mb in zip(secs, plan) if mb == 1]
    two = [t for t, mb in zip(secs[1:], plan[1:]) if mb == 2]
    e2e = {"train_step_ms": statistics.median(one[1:]) * 1e3,
           "train_cold_step_ms": secs[0] * 1e3,
           "train_peak_memory_gb": peak_gb, "train_losses": losses,
           "train_loss_no_grad": loss0,
           "train_launches_per_step": per_step}
    if two:
        e2e["train_mb2_step_ms"] = statistics.median(two) * 1e3
    e2e["train_tok_per_s"] = B * S / (e2e["train_step_ms"] / 1e3)
    print(f"train (warm, mb 1): {e2e['train_step_ms']:.3f} ms per step, "
          f"{e2e['train_tok_per_s']:.1f} tok/s; cold first step "
          f"{e2e['train_cold_step_ms']:.3f} ms"
          + (f"; mb 2 {e2e['train_mb2_step_ms']:.3f} ms" if two else ""),
          flush=True)
    if extras:
        prof = device_profile(lambda: steps[1](params, opt, batches[0]),
                              "flash_", top=6)
        e2e["train_kernel_share_of_device"] = prof.pop(
            "kernel_share_of_device")
        e2e.update({f"train_{k}": v for k, v in prof.items()})
        print(f"flash kernels' share of device time "
              f"{e2e['train_kernel_share_of_device']:.4f}, device idle "
              f"{e2e['train_device_idle_share']:.4f} "
              f"({e2e['train_device_ops']} device ops); largest other "
              f"device times {e2e['train_top_other_device_us']}",
              flush=True)
    del batches

    bwd = backward_kernels_vs_plain(cap, peaks)
    del cap
    torch.cuda.empty_cache()
    more = {}
    if extras:
        xb = device_batch(SyntheticLMDataset(DataConfig(
            vocab=cfg.vocab, seq_len=XLA_SEQ, global_batch=XLA_BATCH,
            seed=1)).batch_at(0), device)
        more["flash_vs_xla"] = flash_vs_xla(params, cfg, xb)
        del xb
    del params, opt
    torch.cuda.empty_cache()
    if extras:
        more["loop_restart"] = loop_restart_check(device)

    common = {"route": "cuda", "source": BWD_SOURCE,
              "plain_covers": "dq, dk and dv together",
              "library": "scaled_dot_product_attention backward (grad "
                         "minus forward), dq, dk and dv together",
              "shape": bwd["shape"], **bwd["readings"],
              "library_rel_err": bwd["library_rel_err"],
              "pair": bwd["pair"]}
    kernels = [
        {"name": f"flash_bwd_dq[{arch}]", "replaces": DQ_REPLACES,
         "launches": launches[1], "form_launches": _form_counts(forms),
         **bwd["dq"], **common, **e2e, **more},
        {"name": f"flash_bwd_dkv[{arch}]", "replaces": DKV_REPLACES,
         "launches": launches[2], **bwd["dkv"], **common}]
    return {"kernels": kernels, "fwd_per_step": [p[0] for p in per_step]}


# --- A16b: the dense configs, and every form of the flash kernels ---------

A16B_ARCHS = ("granite-3-8b", "phi4-mini-3.8b", "glm4-9b")
#: (a) the kernel rows' shape, causal: B, S, H, Hkv (qwen3-1.7b's serving
#: batch and heads)
FORM_SHAPE = (8, 4096, 16, 8)
#: the forms this slice adds, (dtype, head dim); bf16 at 128 has qwen3-1.7b's
#: rows
NEW_FORMS = tuple(("float32", D) for D in (8, 12, 16, 64, 112, 128)) + (
    ("bfloat16", 64), ("bfloat16", 112))
#: (c) full-width training: train_4k's sequence, its batch of 256 cut to 2
A16B_TRAIN_ARCH, A16B_TRAIN_BATCH, A16B_TRAIN_STEPS = "phi4-mini-3.8b", 2, 3
#: (d) the smoke runs: generate at batch 2 x prompt 64 + 8 new, then 3
#: AdamW steps of make_train_step at batch 2 x 64
SMOKE_BATCH, SMOKE_PROMPT, SMOKE_NEW, SMOKE_STEPS = 2, 64, 8, 3
#: (d) the head-dim sweep: qwen3-1.7b's smoke config at the head dims no
#: ported config has yet (A16f's 64 and seamless's smoke 8, A16e's 112),
#: so that every new form runs on a served and trained path
SWEEP = (("float32", 8), ("float32", 64), ("float32", 112),
         ("float32", 128), ("bfloat16", 64), ("bfloat16", 112))
#: (d) the card against the CPU (the plain versions) on the same weights
#: and batches, by relative L2: f32 sums in other orders (kernels, cuBLAS
#: against the CPU's BLAS), so the first pick's logits and each of the 3
#: losses within 1e-4; bf16 rounds at other places, so the logits within
#: LOGIT_REL_TOL and the losses within 1e-2
SMOKE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (LOGIT_REL_TOL, 1e-2)}


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def form_rows(dtype: str, D: int, device, peaks) -> list:
    """The forward, dQ and dK/dV kernels of one form at FORM_SHAPE (q, k,
    v and dO standard normal from seed D on the card), each held against
    its plain version and timed beside it, SDPA and its bound
    (``forward_kernel_vs_plain``, ``backward_kernels_vs_plain``)."""
    import torch
    B, S, H, Hkv = FORM_SHAPE
    gen = torch.Generator(device=device).manual_seed(D)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            getattr(torch, dtype))
    cap = {"q": normal(B, S, H, D), "k": normal(B, S, Hkv, D),
           "v": normal(B, S, Hkv, D), "do": normal(B, S, H, D)}
    fwd = forward_kernel_vs_plain(cap["q"], cap["k"], cap["v"], peaks)
    bwd = backward_kernels_vs_plain(cap, peaks)
    del cap
    torch.cuda.empty_cache()
    tag = f"{'f32' if dtype == 'float32' else 'bf16'},d{D}"
    shape = {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D, "dtype": dtype}
    fwd_readings = fwd.pop("readings")
    rows = [{"name": f"flash_fwd[{tag}]", "source": LM_SOURCE,
             "replaces": LM_REPLACES, "form": ("fwd", dtype, D),
             "max_abs_err": fwd_readings["max_abs_err"], **fwd,
             "readings": fwd_readings}] + bwd_rows(bwd, tag, dtype, D)
    for row in rows:
        row.update(route="cuda", shape=shape)
        print(f"  {row['name']} (B {B}, S {S}, H {H}, Hkv {Hkv}): kernel "
              f"{row['ms']}, plain {row['plain_ms']}, SDPA "
              f"{row['library_ms']}, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}); max abs err {row['max_abs_err']:.3g}",
              flush=True)
    return rows


def bwd_rows(bwd: dict, tag: str, dtype: str, D: int) -> list:
    """The dQ and dK/dV rows of ``backward_kernels_vs_plain``'s readings
    ``bwd`` for the form (``dtype``, ``D``), named ``flash_bwd_*[tag]``."""
    return [{"name": f"flash_bwd_{kernel}[{tag}]", "source": BWD_SOURCE,
             "replaces": replaces, "form": (kernel, dtype, D), **bwd[kernel],
             "plain_covers": "dq, dk and dv together",
             "library_rel_err": bwd["library_rel_err"], "pair": bwd["pair"],
             "readings": bwd["readings"]}
            for kernel, replaces in (("dq", DQ_REPLACES),
                                     ("dkv", DKV_REPLACES))]


def config_bwd_rows(arch: str, device, peaks) -> list:
    """dQ and dK/dV at ``arch``'s heads (bf16, its head dim) at FORM_SHAPE's
    batch and length: q, k, v and dO standard normal from seed H + Hkv on
    the card, held against their plain version and timed beside it, the
    SDPA backward and the bound (``backward_kernels_vs_plain``); for the
    A16b configs that do not train at full width on one card."""
    import torch
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    B, S = FORM_SHAPE[:2]
    H, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.d_head
    gen = torch.Generator(device=device).manual_seed(H + Hkv)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device).to(
            getattr(torch, cfg.dtype))
    cap = {"q": normal(B, S, H, D), "k": normal(B, S, Hkv, D),
           "v": normal(B, S, Hkv, D), "do": normal(B, S, H, D)}
    bwd = backward_kernels_vs_plain(cap, peaks)
    del cap
    torch.cuda.empty_cache()
    rows = bwd_rows(bwd, f"{arch} heads", cfg.dtype, D)
    for row in rows:
        row.update(route="cuda", shape={**bwd["shape"], "dtype": cfg.dtype})
    return rows


def smoke_run(label: str, cfg, device) -> dict:
    """``generate`` (batch 2, prompt 64, 8 new) then 3 AdamW steps of
    ``make_train_step`` of ``cfg`` on the CPU (the plain versions) and on
    the card (the flash kernels in ``cfg``'s dtype and head dim), from the
    same weights (seed 0, made on the CPU) and batches: launch counts
    exact, the first pick's logits and the losses within SMOKE_TOL."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    t0 = time.perf_counter()
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, (SMOKE_BATCH, SMOKE_PROMPT), dtype=np.int32)
    data = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=SMOKE_PROMPT, global_batch=SMOKE_BATCH,
        seed=0))
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=SMOKE_STEPS))
    runs = {}
    for where in ("cpu", device):
        params = _tree_to(init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu"), where)
        opt = adamw_init(params)
        tokens = torch.from_numpy(prompts).long().to(where)
        batches = [device_batch(data.batch_at(s), where)
                   for s in range(SMOKE_STEPS)]
        if where == device:
            # the main path: counts at 0 just before, read just after
            torch.cuda.synchronize()
            _zero_launch_counts()
        gen = generate(cfg, params, tokens, SMOKE_NEW)
        losses = []
        for batch in batches:
            params, opt, metrics = step(params, opt, batch)
            losses.append(metrics["loss"].item())
        runs[where] = (gen, losses)
    counts, forms = _launch_counts(), dict(flash.FORM_LAUNCHES)
    L = cfg.n_layers
    want = (L + 2 * L * SMOKE_STEPS, L * SMOKE_STEPS, L * SMOKE_STEPS)
    (gen_c, loss_c), (gen_g, loss_g) = runs["cpu"], runs[device]
    dtype = cfg.dtype
    key = ("f32" if dtype == "float32" else "bf16") + f",d{cfg.d_head}"
    logits_rel = rel_err(gen_g.logits[:, 0, :cfg.vocab].cpu(),
                         gen_c.logits[:, 0, :cfg.vocab])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_g, loss_c))
    out = {"label": label, "form": key, "launches": counts,
           "form_launches": _form_counts(forms),
           "prefill_launches": gen_g.prefill_launches,
           "decode_launches": gen_g.decode_launches,
           "logits_rel_err": logits_rel, "losses_card": loss_g,
           "losses_cpu": loss_c, "loss_rel_err": loss_rel,
           "tokens_equal": float((gen_g.tokens.cpu() == gen_c.tokens)
                                 .float().mean()),
           "seconds": time.perf_counter() - t0}
    print(f"  smoke {label} ({dtype}, d_head {cfg.d_head}, H {cfg.n_heads}, "
          f"Hkv {cfg.n_kv}): launches (fwd, dq, dkv) {counts}, prefill "
          f"{gen_g.prefill_launches} + decode {gen_g.decode_launches}; "
          f"first-pick logits rel err {logits_rel:.3g}; losses card "
          f"{loss_g} cpu {loss_c} (max rel err {loss_rel:.3g}); tokens equal "
          f"{out['tokens_equal']:.3f}; {out['seconds']:.1f} s", flush=True)
    logit_tol, loss_tol = SMOKE_TOL[dtype]
    if counts != want or (gen_g.prefill_launches, gen_g.decode_launches) \
            != (L, 0):
        raise AssertionError(f"smoke {label}: launches {counts}, prefill "
                             f"{gen_g.prefill_launches}; expected {want}, "
                             f"{L}")
    if not all(math.isfinite(x) for x in loss_g) or logits_rel > logit_tol \
            or loss_rel > loss_tol:
        raise AssertionError(f"smoke {label}: the card and the CPU differ "
                             f"beyond {SMOKE_TOL[dtype]}")
    return out


def a16b_phase(device, peaks) -> list:
    """(a) every new flash form at FORM_SHAPE against its plain version,
    timed beside SDPA and its bound, and the backward kernels at the heads
    of the A16b configs that do not train at full width; (b)
    granite-3-8b, phi4-mini-3.8b and glm4-9b served at full width in
    bf16; (c) phi4-mini trained at full width; (d) the four dense archs'
    smoke configs in f32, and the head-dim sweep, served and trained on
    the card against the CPU.  Every form's launches are those of the
    (b)-(d) main paths."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    t0 = time.perf_counter()
    form_rows_ = []
    for dtype, D in NEW_FORMS:
        form_rows_ += form_rows(dtype, D, device, peaks)
    for arch in A16B_ARCHS:
        if arch != A16B_TRAIN_ARCH:
            form_rows_ += config_bwd_rows(arch, device, peaks)
    print(f"A16b (a) kernel rows: {time.perf_counter() - t0:.3f} s",
          flush=True)
    rows = []
    forms: dict = {}

    def add(counts: dict):
        for key, n in counts.items():
            forms[key] = forms.get(key, 0) + n
    for arch in A16B_ARCHS:
        rows.append(serve_arch(arch, device, peaks))
        add(rows[-1]["form_launches"])
    for arch in A16B_ARCHS:
        if arch != A16B_TRAIN_ARCH:
            cfg = get_config(arch)
            print(f"not trained at full width: {arch}'s {cfg.n_params} "
                  f"parameters take about {cfg.n_params * 14 / 1e9:.0f} GB "
                  f"with AdamW (bf16 weights, f32 moments and master), more "
                  f"than the card's 80 GB; trained at its smoke config "
                  f"below", flush=True)
    train = train_arch(A16B_TRAIN_ARCH, device, peaks, A16B_TRAIN_BATCH,
                       [1] * A16B_TRAIN_STEPS)
    train["kernels"][0]["train_fwd_launches_per_step"] = train.pop(
        "fwd_per_step")
    rows += train["kernels"]
    add(rows[-2]["form_launches"])
    torch.cuda.empty_cache()
    smoke = [smoke_run(arch, smoke_config(arch), device)
             for arch in (LM_ARCH,) + A16B_ARCHS]
    smoke += [smoke_run(f"{LM_ARCH} d_head {D}", dataclasses.replace(
        smoke_config(LM_ARCH), d_head=D, dtype=dtype), device)
        for dtype, D in SWEEP]
    for run in smoke:
        add(run["form_launches"])
    for row in form_rows_:
        kernel, dtype, D = row.pop("form")
        row["launches"] = forms.get(
            f"{kernel}[{dtype.removeprefix('torch.')},d{D}]", 0)
        row["smoke_runs"] = [r for r in smoke if r["form"] == row["name"][
            row["name"].index("[") + 1:-1]] if kernel == "fwd" else []
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} was launched no time on "
                                 f"the phase's main paths")
    print(f"A16b phase: {time.perf_counter() - t0:.3f} s; launches by form "
          f"on its main paths {forms}", flush=True)
    return form_rows_ + rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    peaks = peaks_for(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.LIBRARIES)) as pool:  # one nvcc each
        libs = list(pool.map(_build.build, _build.LIBRARIES))
    for bf16 in (False, True):
        for batch in (False, True):
            _build.stencil_stream(bf16, batch)
    _build.flash_fwd()
    _build.flash_bwd()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(lib.name for lib in libs)})")
    for lib in libs:
        stem = lib.stem.rsplit('_', 1)[0]
        if stem.startswith("libflash"):      # one line per (dtype, D) form
            for kernel, report in _build.ptxas_report(lib):
                print(f"  ptxas ({stem}) {kernel}: {report}")
            continue
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({stem}):", line.strip())
    device = torch.device("cuda", 0)
    t_main = time.perf_counter()
    kernels = []
    bases = {}      # the V = 1 runs the par_vec phase compares against
    for name in STENCILS:
        nd = int(name[-2])
        dims = FULL_DIMS[nd]
        par_time, bsize = SCHEDULE[nd]
        main_run = drive_main_path(name, dims, par_time, bsize, device)
        e2e = breakdown(main_run)
        print(f"{name} {dims} T={par_time} bsize={bsize}: run of "
              f"{main_run['iters']} iters {e2e['run_ms']}, "
              f"{main_run['launches']} launches, oracle max_abs_err "
              f"{main_run['oracle_max_abs_err']:.3g}; kernel share of "
              f"device time {e2e['kernel_share_of_device']:.3f}, device "
              f"idle {e2e['device_idle_share']:.3f}", flush=True)
        res = compare_and_time(name, main_run, peaks)
        print(f"  superstep: kernel {res['ms']}, plain {res['plain_ms']}, "
              f"library {res['library_ms']}, bound {res['bound_ms']:.3f} ms "
              f"({res['bound_by']})", flush=True)
        if name in PAR_VEC:
            bases[name] = v1_base(main_run, res)
        kernels.append({
            "name": f"stencil_stream[{name}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": main_run["launches"],
            "launches_by_kernel": main_run["launches_by_kernel"], **res,
            "dims": list(dims), "par_time": par_time, "bsize": list(bsize),
            "iters": main_run["iters"],
            "oracle_max_abs_err": main_run["oracle_max_abs_err"], **e2e,
        })
        del main_run
        torch.cuda.empty_cache()
    kernels.extend(program_phase(device, peaks, bases))
    kernels.extend(dag_phase(device, peaks, bases))
    kernels.extend(par_vec_phase(bases, device, peaks))
    torch.cuda.empty_cache()
    kernels.extend(bf16_phase(device, peaks, kernels))
    kernels.extend(bc_phase(device, peaks, kernels))
    kernels.extend(b1kj_phase(device, peaks, kernels))
    torch.cuda.empty_cache()
    kernels.extend(custom_phase(device, peaks, kernels))
    torch.cuda.empty_cache()
    kernels.extend(batch_phase(device, peaks))
    kernels.append(serve_kernel_row(device, peaks, serve_phase(device,
                                                               peaks)))
    torch.cuda.empty_cache()
    kernels.append(lm_phase(device, peaks))
    train = train_phase(device, peaks)
    kernels[-1]["train_launches_per_step"] = train.pop("fwd_per_step")
    kernels.extend(train["kernels"])
    torch.cuda.empty_cache()
    kernels.extend(a16b_phase(device, peaks))
    print(f"chip_smoke: {time.perf_counter() - t_main:.3f} s after the "
          f"build", flush=True)
    print(json.dumps({"kernels": [with_spread(k) for k in kernels],
                      "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
