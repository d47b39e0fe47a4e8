#!/usr/bin/env python3
"""Quickest proof that the PyTorch/H100 port runs on the card.

    python3 chip_smoke.py

On one CUDA card, from the root of a checkout:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the streaming kernel from ``src/repro_torch/kernels/csrc`` and
   prints the build seconds and the compiler's register report;
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
   FLOPs of the super-step;
5. prints one ``{"kernels": [...]}`` line and, last, the device line.

Any failed check raises, and the script exits non-zero.  It exits non-zero
without a result when no CUDA device is present.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: the paper-scale sizes of benchmarks/table4_stencil.py (FULL_DIMS)
FULL_DIMS = {2: (16384, 16384), 3: (448, 448, 448)}
#: pinned schedules: (par_time, bsize) per rank
SCHEDULE = {2: (8, (256,)), 3: (4, (32, 32))}
STENCILS = ("diffusion2d", "hotspot2d", "diffusion3d", "hotspot3d")
SOURCE = "src/repro_torch/kernels/csrc/stencil_stream.cu"
REPLACES = "src/repro/kernels/builder.py:81"

#: data-sheet peaks per card variant: (device-memory bytes/s, f32 FLOP/s
#: outside the tensor cores), matched against the nvidia-smi name
PEAKS = (("H100 PCIe", 2.0e12, 51.2e12), ("H100 NVL", 3.9e12, 60.0e12),
         ("H200", 4.8e12, 67.0e12), ("H100", 3.35e12, 67.0e12))


def peaks_for(card_name: str):
    for key, bw, flops in PEAKS:
        if key in card_name:
            return bw, flops
    raise RuntimeError(f"no data-sheet peaks for {card_name!r}")


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device milliseconds of ``fn`` over ``reps`` runs (CUDA
    events, after ``warmup`` untimed runs)."""
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
    return statistics.median(times)


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
    out = p.run(g, iters, aux=aux)
    torch.cuda.synchronize()
    launches = builder.LAUNCHES
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
            "oracle_max_abs_err": err, "plan": p, "g": g, "aux": aux}


def breakdown(main: dict) -> dict:
    """Where one warm ``run`` spends its time: its milliseconds between
    CUDA events (median of 3); and from one profiled run, its own span
    between CUDA events, the union of its device-event intervals, the
    streaming kernel's share of that busy time and the idle share of the
    span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    p, g, aux, iters = main["plan"], main["g"], main["aux"], main["iters"]
    run_ms = time_ms(lambda: p.run(g, iters, aux=aux), reps=3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        p.run(g, iters, aux=aux)
        end.record()
        end.synchronize()
    span_us = start.elapsed_time(end) * 1e3
    # device-side events only: CPU ops also carry their kernels' time
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    if not spans:
        raise AssertionError("the profiler saw no device time")
    busy, reach = 0.0, -math.inf
    for s, t, _ in spans:
        busy += max(0.0, t - max(s, reach))
        reach = max(reach, t)
    per_name = {}
    for s, t, n in spans:
        per_name[n] = per_name.get(n, 0.0) + (t - s)
    kernel = sum(t for n, t in per_name.items() if "stream_kernel" in n)
    if kernel <= 0:
        raise AssertionError("the profiler saw no stream_kernel launch")
    if kernel > busy or busy > span_us:
        raise AssertionError(f"device times do not add up: kernel {kernel} "
                             f"us, busy {busy} us, span {span_us} us")
    others = sorted(((t, n) for n, t in per_name.items()
                     if "stream_kernel" not in n), reverse=True)[:3]
    return {"run_ms": run_ms,
            "run_gcells_per_s": math.prod(g.shape) * iters / run_ms / 1e6,
            "profiled_run_ms": span_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "kernel_share_of_device": kernel / busy,
            "device_idle_share": 1 - busy / span_us,
            "top_other_device_us": {n[:60]: t for t, n in others}}


def library_yardstick(name, g, aux, par_time):
    """``par_time`` steps of one cuDNN convolution with bias over the
    edge-padded grid (full float32): the same update as one PyTorch call
    per step.  Every Table-2 update is linear: the taps weigh channel 0,
    the grid; for Hotspot, channel 1 is the edge-padded power, weighed
    ``sdc`` at the centre, and the ambient term is the bias."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.stencils import STENCILS as ST
    from repro_torch.core.stencils import TEMP_AMB, default_coeffs
    c = {k: float(v) for k, v in default_coeffs(ST[name]).items()}
    nd = g.ndim
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
    w = torch.zeros((1, chans) + (3,) * nd, device=g.device)
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
        bias = torch.tensor([c["bias"]], device=g.device)
    conv = F.conv2d if nd == 2 else F.conv3d
    pad = (1, 1) * nd
    aux_p = None if aux is None else F.pad(aux[None, None], pad,
                                           mode="replicate")

    def run():
        x = g[None, None]
        for _ in range(par_time):
            x = F.pad(x, pad, mode="replicate")
            if aux_p is not None:
                x = torch.cat([x, aux_p], dim=1)
            x = conv(x, w, bias)
        return x[0, 0]
    return run


def check_yardstick(name, par_time, device, seed=1) -> float:
    """The yardstick against the port's oracle on a small grid: it must
    compute the same function to stand beside the kernel."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import precision
    dims = (40, 56) if name.endswith("2d") else (12, 20, 28)
    g, aux = inputs(name, dims, device, seed)
    got = library_yardstick(name, g, aux, par_time)()
    want = plan(StencilProblem(name, dims),
                RunConfig(backend="reference", device=device)).run(
                    g, par_time, aux=aux)
    scale = 100 if name.startswith("hotspot") else None
    torch.testing.assert_close(got, want, **precision.tolerance(
        "float32", par_time, scale=scale))
    return (got - want).abs().max().item()


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
        plain = builder.superstep_plain(st, geom, gp, c, steps, aux_p,
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
    plain_ms = time_ms(lambda: builder.superstep_plain(
        st, geom, gp, c, T, aux_p, torch.empty_like(gp)), reps=3)
    library_err = check_yardstick(name, T, gp.device)
    library_ms = time_ms(library_yardstick(name, main["g"], main["aux"], T),
                         reps=3)
    # bound: each real input cell read once, each real output cell written
    # once (halo and overhang cells are not needed: clamping reads edge
    # values); the stencil's FLOPs on the cells it advances
    n_in = 2 if aux_p is not None else 1
    bytes_once = (n_in + 1) * math.prod(geom.dims) * 4
    flops = st.flop_pcu * math.prod(geom.dims) * T
    bw, fp32 = peaks
    t_bytes, t_ops = bytes_once / bw * 1e3, flops / fp32 * 1e3
    dma = ops.dma_traffic_bytes(st, geom)
    return {
        "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "library_small_max_abs_err": library_err,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_bytes": bytes_once, "dma_bytes": dma,
        "dma_bound_ms": dma / bw * 1e3,
        "gcells_per_s": math.prod(geom.dims) * T / kernel_ms / 1e6,
    }


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
    lib_path = _build.build("stencil_stream.cu", "stencil")
    _build.stencil_stream()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib_path.name})")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    device = torch.device("cuda", 0)
    kernels = []
    for name in STENCILS:
        nd = int(name[-2])
        dims = FULL_DIMS[nd]
        par_time, bsize = SCHEDULE[nd]
        main_run = drive_main_path(name, dims, par_time, bsize, device)
        e2e = breakdown(main_run)
        print(f"{name} {dims} T={par_time} bsize={bsize}: run of "
              f"{main_run['iters']} iters {e2e['run_ms']:.3f} ms, "
              f"{main_run['launches']} launches, oracle max_abs_err "
              f"{main_run['oracle_max_abs_err']:.3g}; kernel share of "
              f"device time {e2e['kernel_share_of_device']:.3f}, device "
              f"idle {e2e['device_idle_share']:.3f}", flush=True)
        res = compare_and_time(name, main_run, peaks)
        print(f"  superstep: kernel {res['ms']:.3f} ms, plain "
              f"{res['plain_ms']:.3f} ms, library {res['library_ms']:.3f} "
              f"ms, "
              f"bound {res['bound_ms']:.3f} ms ({res['bound_by']})",
              flush=True)
        kernels.append({
            "name": f"stencil_stream[{name}]", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES,
            "launches": main_run["launches"], **res,
            "dims": list(dims), "par_time": par_time, "bsize": list(bsize),
            "iters": main_run["iters"],
            "oracle_max_abs_err": main_run["oracle_max_abs_err"], **e2e,
        })
        del main_run
        torch.cuda.empty_cache()
    print(json.dumps({"kernels": kernels, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
