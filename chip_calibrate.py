#!/usr/bin/env python3
"""Measures the streaming kernel's super-step over a sweep of schedules on
one card, for fitting the tick costs of ``repro_torch.core.perf_model``:

    python3 chip_calibrate.py [OUT.json]          # on the card
    python3 chip_calibrate.py --fit OUT.json      # anywhere, no card

``tests/torch_calibration_h100.json`` is the sweep the constants of
``perf_model`` were fitted from.

The first form builds the f32 and bf16 stencil libraries, then, for each
case of :data:`SWEEPS` (the four Table-2 stencils at the paper's sizes,
the 1D star over 2**20 cells, a chain and a DAG at 16384², diffusion2d
in bf16), each ``(par_time, bsize, par_vec)`` that
``builder.kernel_limits`` admits: pads a seeded grid, times one full
super-step (``builder.superstep_dag``, CUDA events, the median of 3
after one warm-up), and records how the launch split the stream
(``builder.LAST_SPLIT``: segments, CTAs, the CTAs an SM holds by the
occupancy API, threads, shared memory, barriers, the kernel), the
kernel's registers and static shared memory (its ``ptxas`` line), the
card's name and power limit, and the hash of the sources it ran
(``perf_model.CALIBRATED_SOURCES``, as ``sources_salt``).  It writes one
JSON file (default ``chiprun_out/calibration.json``).

``--fit`` reads such a file and fits, per form of
``perf_model.form_class``, the cost of a tick (:func:`fit_tick_costs`),
prints the constants to paste into ``perf_model.TICK_COSTS`` and, per case,
the predicted against the measured super-step; it also checks that
``builder.occupancy`` equals the occupancy API on every record.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: case -> (par_times, bsizes, par_vecs); a bsize of 0 is the 1D entry
SWEEPS = {
    "diffusion2d": ((1, 2, 4, 8, 16, 32),
                    (64, 128, 256, 512, 1024, 2048, 4096), (1, 2, 4, 8, 16)),
    "hotspot2d": ((1, 2, 4, 8, 16, 32),
                  (64, 128, 256, 512, 1024, 2048, 4096), (1, 2, 4, 8, 16)),
    "diffusion3d": ((1, 2, 4, 8, 16), (8, 16, 32, 64), (1, 2, 4, 8)),
    "hotspot3d": ((1, 2, 4, 8, 16), (8, 16, 32, 64), (1, 2, 4, 8)),
    "star1d_r2": ((1, 2, 4, 8, 16, 32, 64), (0,), (1, 2, 4, 8, 16, 32)),
    "advect_diffuse2d": ((1, 2, 4, 8), (128, 256, 512, 1024, 2048),
                         (1, 2, 4)),
    "diamond2d": ((1, 2, 4), (128, 256, 512, 2048), (1, 2, 4)),
    "diffusion2d_bf16": ((4, 8, 16), (128, 256, 512, 2048),
                         (1, 2, 4, 8, 16, 32)),
}


def case_problem(case: str):
    """The ``StencilProblem`` of ``case`` at the paper's sizes."""
    import chip_smoke as cs
    from repro_torch.api import StencilProblem
    if case == "star1d_r2":
        return StencilProblem(case, cs.STAR1D[1])
    if case == "advect_diffuse2d":
        return StencilProblem(cs.program_stages(case), cs.FULL_DIMS[2])
    if case == "diamond2d":
        return StencilProblem(cs.dag_program(case), cs.FULL_DIMS[2])
    if case == "diffusion2d_bf16":
        return StencilProblem("diffusion2d", cs.FULL_DIMS[2],
                              dtype="bfloat16")
    return StencilProblem(case, cs.FULL_DIMS[int(case[-2])])


def schedules(problem, sweep):
    """The ``BlockGeometry`` of every point of ``sweep`` the kernel runs."""
    from repro_torch.core.blocking import BlockGeometry, bsize_feasible
    from repro_torch.kernels import builder
    pts, bss, pvs = sweep
    nd = problem.ndim
    for T in pts:
        for b in bss:
            bsize = () if nd == 1 else (b,) * (nd - 1)
            if not bsize_feasible(problem.stencil.radius, T, bsize):
                continue
            for V in pvs:
                geom = BlockGeometry(nd, problem.shape,
                                     problem.stencil.radius, T, bsize, V)
                if builder.kernel_limits(geom, problem.exec_dag,
                                         problem.cell_bytes) is None:
                    yield geom


def measure(out_path: str) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("chip_calibrate: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    import chip_smoke as cs
    from repro_torch.api.schedule_cache import salt_of
    from repro_torch.core import perf_model
    from repro_torch.kernels import _build, builder, ops
    sources = salt_of(os.path.join(ROOT, "src", "repro_torch"),
                      perf_model.CALIBRATED_SOURCES)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        libs = list(pool.map(_build.build, ("stencil_f32", "stencil_bf16")))
    print(f"build: {time.perf_counter() - t0:.3f} s", flush=True)
    ptxas = {}
    for lib in libs:
        ptxas[lib.name] = dict(_build.ptxas_report(lib, all_args=True))
    device = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(device)
    records, errors = [], []
    t_all = time.perf_counter()
    for case, sweep in SWEEPS.items():
        t_case = time.perf_counter()
        problem = case_problem(case)
        dag, bc0 = problem.exec_dag, problem.structural_bc
        dtype = problem.torch_dtype
        g = cs.grid_input(problem.state_shape, device, 0).to(dtype)
        aux = None
        if problem.needs_aux:
            aux = cs.grid_input(problem.shape, device, 1).to(dtype) * 0.05
        c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
        n = 0
        for geom in schedules(problem, sweep):
            try:
                gp = ops._pad_blocked(g, geom, bc0)
                aux_p = None if aux is None else ops._pad_blocked(aux, geom,
                                                                  bc0)
                out = torch.empty_like(gp)
                T = geom.par_time
                ms = cs.time_ms(lambda: builder.superstep_dag(
                    dag, geom, gp, c, T, aux_p, out=out), reps=3, warmup=1)
                sp = builder.LAST_SPLIT
                records.append({
                    "case": case, "dims": list(problem.shape),
                    "dtype": problem.dtype, "par_time": T,
                    "bsize": list(geom.bsize), "par_vec": geom.par_vec,
                    "ms": float(ms), "ms_min": ms.lo, "ms_max": ms.hi,
                    **sp._asdict(),
                    "ptxas": ptxas.get(Path(sp.library).name, {}).get(
                        sp.kernel, ""),
                })
                n += 1
                del gp, aux_p, out
            except Exception as e:   # recorded and reported below
                errors.append({"case": case, "par_time": geom.par_time,
                               "bsize": list(geom.bsize),
                               "par_vec": geom.par_vec, "error": repr(e)})
                print(f"  {case} T={geom.par_time} bsize={geom.bsize} "
                      f"V={geom.par_vec}: {e!r}", flush=True)
            torch.cuda.empty_cache()
        print(f"{case}: {n} schedules in "
              f"{time.perf_counter() - t_case:.1f} s", flush=True)
        del g, aux
        torch.cuda.empty_cache()
    print(f"sweep: {len(records)} schedules, {len(errors)} errors, "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    dump(compact({"card": card, "name": torch.cuda.get_device_name(0),
                  "n_sm": props.multi_processor_count,
                  "torch": torch.__version__, "cuda": torch.version.cuda,
                  "sources_salt": sources, "records": records, "errors": errors}), out_path)
    print(f"wrote {out_path}", flush=True)
    return 1 if errors else 0


#: the fields of a record kept by :func:`compact`
KEEP = ("case", "par_time", "bsize", "par_vec", "ms", "ms_min", "ms_max",
        "seg", "nseg", "warm", "per_sm", "ctas", "threads", "smem",
        "barriers", "kernel")


def compact(data: dict) -> dict:
    """``data`` with each record cut to :data:`KEEP` plus its kernel's
    registers and static shared memory from its ``ptxas`` line."""
    import re

    def num(pat, text):
        m = re.search(pat, text)
        return int(m.group(1)) if m else 0
    out = {k: v for k, v in data.items() if k != "records"}
    out["records"] = [
        {**{k: r[k] for k in KEEP},
         "registers": num(r"Used (\d+) registers", r["ptxas"]),
         "static_smem": num(r"(\d+) bytes smem", r["ptxas"]),
         "cell_bytes": 2 if r["dtype"] == "bfloat16" else 4}
        for r in data["records"]]
    return out


def dump(data: dict, path: str) -> None:
    """Write ``data`` as JSON with one record a line."""
    head = {k: v for k, v in data.items() if k != "records"}
    lines = [json.dumps(r, separators=(",", ":")) for r in data["records"]]
    with open(path, "w") as f:
        f.write(json.dumps(head)[:-1] + ', "records": [\n'
                + ",\n".join(lines) + "\n]}\n")


def fit_tick_costs(records, n_sm: int):
    """Per form of ``perf_model.form_class``, the non-negative ``(a, b, c)``
    of ``perf_model.TICK_COSTS`` that minimize the squared relative error
    of ``waves * ticks * (a + b * work + c * barriers)`` against each
    measured super-step (the records whose bytes term takes over 0.9 of
    the time left out).  Returns ``(costs, rows)``: ``rows`` each record
    with ``rule_per_sm`` (``perf_model.occupancy``) and the refitted
    model's seconds (the issue term, or the bytes term where larger)."""
    import numpy as np
    from scipy.optimize import nnls

    from repro_torch.core import perf_model
    from repro_torch.core.blocking import (BlockGeometry, extended_geometry,
                                           superstep_traffic_bytes)
    device = perf_model.H100_SXM.scaled(n_sm=n_sm)
    problems, feats = {}, []
    for r in records:
        prob = problems.get(r["case"])
        if prob is None:
            prob = problems[r["case"]] = case_problem(r["case"])
        geom = BlockGeometry(prob.ndim, prob.shape, prob.stencil.radius,
                             r["par_time"], tuple(r["bsize"]), r["par_vec"])
        t = perf_model.launch_terms(prob.exec_dag, geom, prob.cell_bytes,
                                    device)
        mem = superstep_traffic_bytes(
            extended_geometry(geom, prob.structural_bc),
            prob.stencil.num_read, prob.stencil.num_write,
            prob.cell_bytes) / device.mem_bw
        feats.append((r, t, mem))
    costs = {}
    for form in sorted({t["form"] for _, t, _ in feats}):
        A = []
        for r, t, mem in feats:
            m = r["ms"] * 1e-3
            if t["form"] != form or mem > 0.9 * m:
                continue
            n = t["waves"] * t["ticks"]
            A.append([n / m, n * t["work"] / m,
                      n * t["split"].barriers / m])
        if not A:
            continue
        A = np.asarray(A)
        scale = np.maximum(A.max(axis=0), 1e-30)
        coef, _ = nnls(A / scale, np.ones(len(A)))
        costs[form] = tuple(float(x) for x in coef / scale)
    rows = []
    for r, t, mem in feats:
        a, b, c = costs.get(t["form"], perf_model.TICK_COSTS[t["form"]])
        issue = t["waves"] * t["ticks"] * (a + b * t["work"]
                                           + c * t["split"].barriers)
        rows.append((dict(r, rule_per_sm=t["per_sm"], form=t["form"],
                          waves=t["waves"], ticks=t["ticks"],
                          work=t["work"]), max(issue, mem)))
    return costs, rows


def fit(path: str) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    with open(path) as f:
        data = json.load(f)
    costs, rows = fit_tick_costs(data["records"], data["n_sm"])
    print(f"card: {data['card']} ({data['n_sm']} SMs, torch "
          f"{data['torch']}, CUDA {data['cuda']})")
    print("TICK_COSTS = {")
    for form, (a, b, c) in sorted(costs.items()):
        print(f"    {form!r}: ({a:.4g}, {b:.4g}, {c:.4g}),")
    print("}")
    bad = 0
    for r, pred in rows:
        print(f"{r['case']:18s} T={r['par_time']:2d} bsize="
              f"{'x'.join(map(str, r['bsize'])) or '-':9s} "
              f"V={r['par_vec']:2d} {r['kernel']:26s} {r['form']:10s} "
              f"per_sm {r['per_sm']} (rule {r['rule_per_sm']}) waves "
              f"{r['waves']} ticks {r['ticks']} measured {r['ms']:.3f} ms, "
              f"model {pred * 1e3:.3f} ms "
              f"({pred / (r['ms'] * 1e-3):.3f})")
        bad += r["per_sm"] != r["rule_per_sm"]
    errs = sorted(abs(math.log(pred / (r["ms"] * 1e-3))) for r, pred in rows)
    print(f"{len(rows)} records; occupancy rule differs on {bad}; median "
          f"|log(model/measured)| {errs[len(errs) // 2]:.3f}, 90th "
          f"{errs[len(errs) * 9 // 10]:.3f}, max {errs[-1]:.3f}")
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) >= 2 and sys.argv[1] == "--fit":
        sys.exit(fit(sys.argv[2]))
    sys.exit(measure(sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "chiprun_out", "calibration.json")))
