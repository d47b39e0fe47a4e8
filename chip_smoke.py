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
   FLOPs of the super-step;
5. serves full-width qwen3-1.7b (bf16, random weights from a seed)
   through ``repro_torch.launch.serve.generate`` at batch 8 x prompt 4096
   + 16 new tokens, asserts 28 flash-kernel launches in prefill (one per
   layer) and none in decode, tokens in the vocab and finite logits; times
   a warm run and profiles one prefill for the kernel's share of device
   time; holds the kernel against its plain version on layer 0's q, k, v
   (output pre-filled with NaN), the ``"flash"`` prefill against the
   ``"xla"`` one, and teacher-forced decode against prefill; times kernel,
   plain version and ``scaled_dot_product_attention`` as the yardstick;
6. trains full-width qwen3-1.7b (bf16, AdamW, ``remat_policy="full"``,
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
7. prints one ``{"kernels": [...]}`` line and, last, the device line.

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
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))

#: the paper-scale sizes of benchmarks/table4_stencil.py (FULL_DIMS)
FULL_DIMS = {2: (16384, 16384), 3: (448, 448, 448)}
#: pinned schedules: (par_time, bsize) per rank
SCHEDULE = {2: (8, (256,)), 3: (4, (32, 32))}
STENCILS = ("diffusion2d", "hotspot2d", "diffusion3d", "hotspot3d")
SOURCE = "src/repro_torch/kernels/csrc/stencil_stream.cu"
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


def device_profile(fn, kernel_key: Optional[str], top: int = 3) -> dict:
    """One profiled call of ``fn``: its own span between CUDA events, the
    union of its device-event intervals (busy), the share of busy time in
    kernels whose name holds ``kernel_key`` (when given), the idle share of
    the span, and the ``top`` largest other device times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
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
    key = kernel_key or "\0"
    kernel = sum(t for n, t in per_name.items() if key in n)
    if kernel_key and kernel <= 0:
        raise AssertionError(f"the profiler saw no {kernel_key} launch")
    if kernel > busy or busy > span_us:
        raise AssertionError(f"device times do not add up: kernel {kernel} "
                             f"us, busy {busy} us, span {span_us} us")
    # summed by the name's first 60 characters: templated kernels share them
    short = {}
    for n, t in per_name.items():
        if key not in n:
            short[n[:60]] = short.get(n[:60], 0.0) + t
    others = sorted(((t, n) for n, t in short.items()), reverse=True)[:top]
    out = {"profiled_run_ms": span_us / 1e3,
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
    prof = device_profile(lambda: p.run(g, iters, aux=aux), "stream_kernel")
    return {"run_ms": run_ms,
            "run_gcells_per_s": math.prod(g.shape) * iters / run_ms / 1e6,
            **prof}


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
    bw, fp32, _ = peaks
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


def lm_phase(device, peaks) -> dict:
    """Serve full-width qwen3-1.7b (random weights from a seed) through
    ``generate`` and hold the flash kernel, the prefill and the decode
    against their plain counterparts on the card."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import layers as L
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.transformer import _unstack
    cfg = get_config(LM_ARCH)
    B, S, H, Hkv, D = LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv, cfg.d_head
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"{LM_ARCH}: {n_par} parameters ({n_par * 2 / 1e9:.3f} GB bf16, "
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
    flash.LAUNCHES = 0
    out = generate(cfg, params, tokens, LM_NEW)
    launches = flash.LAUNCHES
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
           "decode_tok_per_s": B * (LM_NEW - 1) / warm.decode_s}
    with torch.inference_mode():
        prof = device_profile(lambda: prefill(params, cfg, tokens, S),
                              "flash_fwd_kernel")
    e2e["kernel_share_of_prefill_device"] = prof.pop(
        "kernel_share_of_device")
    e2e.update({f"prefill_{k}": v for k, v in prof.items()})
    with torch.inference_mode():
        _, caches = prefill(params, cfg, tokens, S + 1)
        nxt = tokens[:, -1:]
        prof = device_profile(lambda: decode_step(params, cfg, nxt, caches),
                              None, top=5)
        del caches
    e2e.update({f"decode_{k}": v for k, v in prof.items()})
    print(f"generate (warm): prefill {e2e['prefill_ms']:.3f} ms "
          f"({e2e['prefill_tok_per_s']:.1f} tok/s), decode "
          f"{e2e['decode_ms_per_step']:.3f} ms/step "
          f"({e2e['decode_tok_per_s']:.1f} tok/s); flash share of prefill "
          f"device time {e2e['kernel_share_of_prefill_device']:.4f}, device "
          f"idle {e2e['prefill_device_idle_share']:.4f} in prefill, "
          f"{e2e['decode_device_idle_share']:.4f} in one decode step "
          f"({e2e['decode_device_ops']} device ops)", flush=True)

    with torch.inference_mode():
        # the kernel against its plain version on layer 0's q, k, v
        x = L.embed_tokens(tokens, params["embed"], cfg.tdtype)
        bp = _unstack(params["blocks"], cfg.n_layers)[0]
        q, k, v = _project_qkv(L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                               bp["attn"], cfg,
                               torch.arange(S, device=device))
        del x
        o = torch.full_like(q, float("nan"))
        lse = torch.full((B, H, S), float("nan"), device=device)
        flash.flash_attention_lse(q, k, v, True, out=(o, lse))
        torch.cuda.synchronize()
        # raises past the bounds stated in check_against_plain
        vs_plain = flash.check_against_plain(o, q, k, v, True, lse=lse)
        print(f"flash kernel vs plain (B {B}, S {S}, H {H}, Hkv {Hkv}, D "
              f"{D}): {vs_plain}", flush=True)
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
        del q, k, v, qt, kt, vt, o, lse

        # "flash" prefill against "xla" (chunked torch ops)
        lf, cf = prefill(params, cfg, tokens, S)
        del cf
        lx, cx = prefill(params, dataclasses.replace(cfg, attn_impl="xla"),
                            tokens, S)
        del cx
        flash_xla = rel_err(lf[..., :cfg.vocab], lx[..., :cfg.vocab])
        print(f"prefill logits, flash vs xla: rel err {flash_xla}, max abs "
              f"{(lf - lx).abs().max().item()}", flush=True)

        # teacher-forced decode against prefill over the same tokens
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

    bw, _, bf16 = peaks
    t_ops = flash.flash_flops(B, S, S, H, D, True, False) / bf16 * 1e3
    t_bytes = flash.flash_traffic_bytes(B, S, S, H, Hkv, D, 2, False) \
        / bw * 1e3
    res = {"name": f"flash_fwd[{LM_ARCH}]", "route": "cuda",
           "source": LM_SOURCE, "replaces": LM_REPLACES,
           "launches": launches, **vs_plain, "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": library_ms,
           "library_max_abs_err": lib_vs_plain["max_abs_err"],
           "library_row_rel_err": lib_vs_plain["row_rel_err"],
           "shape": {"B": B, "S": S, "H": H, "Hkv": Hkv, "D": D},
           "flash_vs_xla_logit_rel_err": flash_xla,
           "teacher_forced_logit_rel_err": tf,
           "tokens_in_range": True, "logits_finite": True, **e2e}
    print(f"  flash_fwd: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"library {library_ms:.3f} ms, bound {res['bound_ms']:.3f} ms "
          f"({res['bound_by']})", flush=True)
    del params
    torch.cuda.empty_cache()
    return res


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
    v and real dO (outputs pre-filled with NaN), then CUDA-event times of
    each kernel, the plain version and the SDPA backward, and the bound."""
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
              f"{Hkv}, D {D}; dO from the first batch's backward, norm "
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
    library_ms = time_ms(sdpa_grad, reps=10) - fwd_ms
    del qt, kt, vt, lib, want, o, lse, dq, dk, dv, delta
    bw, _, bf16 = peaks
    out = {}
    for kernel, ms, err in (("dq", dq_ms, vs_plain["dq_max_abs_err"]),
                            ("dkv", dkv_ms, max(vs_plain["dk_max_abs_err"],
                                                vs_plain["dv_max_abs_err"]))):
        t_ops = flash.flash_bwd_kernel_flops(B, S, S, H, D, True, kernel) \
            / bf16 * 1e3
        t_bytes = flash.flash_bwd_kernel_bytes(B, S, S, H, Hkv, D, kernel) \
            / bw * 1e3
        out[kernel] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": max(t_ops, t_bytes),
                       "bound_by": "operations" if t_ops >= t_bytes
                       else "bytes", "library_ms": library_ms}
        print(f"  flash_bwd_{kernel}: kernel {ms:.3f} ms, plain (dq, dk, dv "
              f"together) {plain_ms:.3f} ms, SDPA backward (dq, dk, dv) "
              f"{library_ms:.3f} ms, bound {out[kernel]['bound_ms']:.3f} ms "
              f"({out[kernel]['bound_by']})", flush=True)
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
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init_params, lm_loss
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    cfg = get_config(LM_ARCH)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    full = SHAPES["train_4k"]
    print(f"cut: train_4k is batch {full['batch']} x {full['seq']} tokens "
          f"per step, {full['batch'] // B}x this one, and does not fit one "
          f"card without microbatching; trained batch {B} x {S}, "
          f"remat_policy={cfg.remat_policy}, attn_impl={cfg.attn_impl}",
          flush=True)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    opt = adamw_init(params)
    data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=S,
                                         global_batch=B, seed=0))
    batches = [device_batch(data.batch_at(s), device)
               for s in range(sum(TRAIN_STEPS))]
    with torch.no_grad():
        loss0 = lm_loss(params, cfg, batches[0]).item()
    cap = capture_layer0(params, cfg, batches[0])
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=sum(TRAIN_STEPS))
    steps = {mb: make_train_step(cfg, ocfg, mb) for mb in (1, 2)}
    plan = [1] * TRAIN_STEPS[0] + [2] * TRAIN_STEPS[1]

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
    n1 = TRAIN_STEPS[0]
    e2e = {"train_step_ms": statistics.median(secs[1:n1]) * 1e3,
           "train_cold_step_ms": secs[0] * 1e3,
           "train_mb2_step_ms": statistics.median(secs[n1:]) * 1e3,
           "train_peak_memory_gb": peak_gb, "train_losses": losses,
           "train_loss_no_grad": loss0,
           "train_launches_per_step": per_step}
    e2e["train_tok_per_s"] = B * S / (e2e["train_step_ms"] / 1e3)
    prof = device_profile(lambda: steps[1](params, opt, batches[0]),
                          "flash_", top=6)
    e2e["train_kernel_share_of_device"] = prof.pop("kernel_share_of_device")
    e2e.update({f"train_{k}": v for k, v in prof.items()})
    print(f"train (warm, mb 1): {e2e['train_step_ms']:.3f} ms per step, "
          f"{e2e['train_tok_per_s']:.1f} tok/s; cold first step "
          f"{e2e['train_cold_step_ms']:.3f} ms; mb 2 "
          f"{e2e['train_mb2_step_ms']:.3f} ms; flash kernels' share of "
          f"device time {e2e['train_kernel_share_of_device']:.4f}, device "
          f"idle {e2e['train_device_idle_share']:.4f} "
          f"({e2e['train_device_ops']} device ops); largest other device "
          f"times {e2e['train_top_other_device_us']}", flush=True)
    del batches

    bwd = backward_kernels_vs_plain(cap, peaks)
    del cap
    torch.cuda.empty_cache()
    xb = device_batch(SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=XLA_SEQ, global_batch=XLA_BATCH,
        seed=1)).batch_at(0), device)
    vs_xla = flash_vs_xla(params, cfg, xb)
    del params, opt, xb
    torch.cuda.empty_cache()
    loop = loop_restart_check(device)

    common = {"route": "cuda", "source": BWD_SOURCE,
              "plain_covers": "dq, dk and dv together",
              "library": "scaled_dot_product_attention backward (grad "
                         "minus forward), dq, dk and dv together",
              "shape": bwd["shape"], **bwd["readings"],
              "library_rel_err": bwd["library_rel_err"]}
    kernels = [
        {"name": f"flash_bwd_dq[{LM_ARCH}]", "replaces": DQ_REPLACES,
         "launches": launches[1], **bwd["dq"], **common, **e2e,
         "flash_vs_xla": vs_xla, "loop_restart": loop},
        {"name": f"flash_bwd_dkv[{LM_ARCH}]", "replaces": DKV_REPLACES,
         "launches": launches[2], **bwd["dkv"], **common}]
    return {"kernels": kernels, "fwd_per_step": [p[0] for p in per_step]}


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
    sources = (("stencil_stream.cu", "stencil"), ("flash_fwd.cu", "flash_fwd"),
               ("flash_bwd.cu", "flash_bwd"))
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        libs = list(pool.map(lambda src: _build.build(*src), sources))
    _build.stencil_stream()
    _build.flash_fwd()
    _build.flash_bwd()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(lib.name for lib in libs)})")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas ({lib.name.split('_')[0]}):", line.strip())
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
    kernels.append(lm_phase(device, peaks))
    train = train_phase(device, peaks)
    kernels[-1]["train_launches_per_step"] = train.pop("fwd_per_step")
    kernels.extend(train["kernels"])
    print(json.dumps({"kernels": kernels, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
