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
3a. right after step 3's runs, drives the ``engine`` backend on the same
   four cells (``engine_phase``: no kernel launch, within ``tolerance``
   of the reference backend, run ms and ms a super-step beside the
   ``hopper`` run's) and the ``distributed`` backend (``distributed_phase``,
   ``DIST_CASES``: diffusion2d on a mesh of 4 logical shards of the card
   along the stream, hotspot3d on 2x2 over the stream and the first
   blocked axis, the periodic wave2d on a 4-shard ring), each bit for bit
   the single-device engine on the card, with its counted exchanges
   (``ceil(iters/T)`` per split axis, one a run for aux), their bytes a
   super-step and one exchange timed;
4a. tunes the four stencils (``tune_phase``): (a) plans each with
   ``RunConfig(backend="hopper", autotune="model")`` and prints the
   performance model's best schedules (predicted ms a super-step, the
   issue, bytes and FLOP terms, form and kernel, CTAs, CTAs an SM, waves
   and ticks, shared memory); (b) plans each with ``autotune="measure"``,
   ``tune_top_k=4`` and a cache in a temporary directory, prints each
   candidate's measured ms a super-step and the model accuracy (the
   paper's Table 4 columns) beside the pinned ``SCHEDULE`` timed the same
   way, asserts the winner's time an iteration within
   ``TUNED_VS_PINNED`` of the pinned one's, and runs the winner at
   ``iters = 2T+3`` (``ceil(iters/T)`` launches of the kernel the model
   named, within ``tolerance`` of the reference backend); (c) plans each
   again and asserts ``tuned_from_cache`` and no launch in ``plan()``;
   (d) asserts the model's ranking rules (diffusion2d at bsize 256 ahead
   of 2048, V = 1 ahead of V = 2, 4, 8 on diffusion2d and hotspot2d),
   plans ``star1d_r2`` over 2**20 cells (V >= 8, its super-step at least
   ``STAR1D_TUNED_SPEEDUP`` times faster than V = 1's at the same
   ``par_time``) and diffusion2d in bf16 under the model and runs both
   against the reference backend; (e) asserts, for every timed candidate,
   that ``perf_model.occupancy`` equals ``stencil_stream_occupancy``;
   prints its seconds;
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
17. runs the A16f phase: (a) serves full-width seamless-m4t-large-v2
    (encoder-decoder, bf16, MHA: 16 heads on 16 KV heads, head dim 64)
    through ``generate`` at batch 8 x 4096 frames (standard normal from a
    seed on the card) and a 4096-token prompt + 16 new tokens, asserting
    24 flash launches in prefill (its decoder's causal self-attention, one
    a layer) and none in decode, and holding decoder layer 0's flash output
    against its plain version, the ``"flash"`` prefill against ``"xla"``
    and teacher-forced decode against prefill; prints prefill ms, decode ms
    a step, tokens/s, peak memory and the shares of a profiled prefill's
    device time in the flash kernel, in the encoder's and the
    cross-attention's ``chunked_attention`` torch ops and in GEMMs; (b)
    trains it at ``train_4k``'s sequence, batch 2, for 3 AdamW steps
    (48 forward, 24 dQ and 24 dK/dV launches a step, both backward kernels
    against their plain version on decoder layer 0, finite losses, the
    first within 1.0 of the batch's loss without autograd; step ms,
    tokens/s, peak memory); (c) serves and trains its SMOKE config (f32,
    head dim 8) on the card against the CPU within ``SMOKE_TOL``;
18. runs the A16d/e phase: (a) serves full-width mamba2-1.3b (the SSM
    family, bf16, 48 SSM layers, no attention) through ``generate`` at
    batch 8 x 4096 + 16 new tokens, asserting no flash launch, tokens in
    range and finite logits, holding teacher-forced decode after a 512-
    token prefill against ``forward`` over 1024 tokens at the same
    positions (past a scan chunk's boundary); prints prefill ms and tok/s,
    decode ms a step, peak memory and the SSD scan's and the GEMMs' shares
    of a profiled prefill's device time (one ``ssd_scan`` call profiled
    alone at the calls' shape, times their count), then holds the same
    checks in f32 at full width, batch 2, within 1e-3; (b) trains it at
    batch 2 x 4096 for 3 AdamW steps, no flash launch, the first loss
    finite and equal to the batch's loss without autograd; a later loss
    may be NaN only where the scan's masked decay overflows f32's exp
    (its largest argument is printed; the reference's arithmetic, ROADMAP
    queue C);
    (c) serves full-width zamba2-7b (the hybrid: 13 groups of one shared
    attention block and 5 SSM layers, then 3 SSM layers) the same way,
    asserting 13 flash launches a prefill (head dim 112, 32 heads on 32 KV
    heads) and none in decode, holding the first shared application's
    flash output against its plain version beside SDPA and the bound, the
    teacher-forced check, and the ``"flash"`` prefill against ``"xla"``
    (printed in bf16, held in f32), with the flash, SSD and GEMM shares;
    (d) trains it cut to 27 layers (4 groups and the tail: the 81 layers'
    AdamW state passes 80 GB) at 2 x 4096 for 3 steps, 8 forward, 4 dQ
    and 4 dK/dV launches a step, both backward kernels against their
    plain version on the first shared application's q, k, v (with a
    seeded dO when its real one is not finite); (e) serves and trains
    both SMOKE configs (f32) on the card against the CPU within
    ``SMOKE_TOL``;
19. runs the A16c phase: (a) serves full-width qwen3-moe-30b-a3b (the MoE
    family, bf16, 48 layers of 128 experts, top-8; 32 heads on 4 KV heads
    at head dim 128) through ``generate`` at batch 8 x 4096 + 16 new
    tokens, asserting 48 flash launches a prefill and none in decode and a
    peak under 80 GB, holding layer 0's flash output against its plain
    version beside SDPA and the bound, and the MoE layer's grouped route
    against its plain every-expert route on layer 0's normed input (the
    first 512 tokens; relative L2 within 2**-8, the same routing); prints
    prefill ms and tok/s, decode ms a step and its idle share, peak memory
    and the shares of a profiled prefill's device time in routing,
    gather/scatter, the expert GEMMs, the other GEMMs and flash (layer 0's
    MoE pieces profiled alone, times 48); prints the "flash" prefill
    against "xla" and teacher-forced decode against ``forward`` at full
    depth in bf16 with the share of (token, layer) expert sets that differ,
    and (b) holds both in f32 at full width on 4 layers, batch 2 x 512,
    within 1e-3; (c) trains it cut to 4 layers at 2 x 4096 for 3 AdamW
    steps, 8 forward, 4 dQ and 4 dK/dV launches a step, both backward
    kernels against their plain version on layer 0's q, k, v and real dO,
    finite losses, the first equal to the batch's loss without autograd
    (the MoE aux loss included); (d) serves full-width qwen3-moe-235b-a22b
    cut to 8 of its 94 layers (64 heads on 4 KV heads: G 16) the same way,
    8 flash launches a prefill; (e) serves and trains both SMOKE configs
    (f32) on the card against the CPU within ``SMOKE_TOL``;
20. runs the A16g/h phase: (a) serves full-width internvl2-76b (the VLM
    family, bf16: dense blocks at 64 heads on 8 KV heads, head dim 128,
    and 1024 positions of patch embeddings in front of the tokens, from
    seed 2) cut to the deeper of 32 and 24 of its 80 layers whose
    reckoned peak (weights, KV cache, the MLP's transients) stays under
    76 GB, through ``generate`` at batch 8 x (1024 + 4096) + 16 new
    tokens, asserting a flash launch a layer in prefill and none in
    decode and a peak under 80 GB, holding layer 0's flash output against
    its plain version beside SDPA and the bound at S 5120; prints prefill
    ms with text tokens/s and positions/s, decode ms a step and its idle
    share, peak memory, the flash and GEMM shares of a profiled prefill,
    and the bf16 "flash" prefill against "xla"; holds both in f32 on 2
    layers at 2 x (1024 + 1024) within 1e-3, with teacher-forced decode
    against ``forward``; (b) trains it cut to 2 layers at 2 x (1024 +
    4096) for 3 AdamW steps, 4 forward, 2 dQ and 2 dK/dV launches a step,
    both backward kernels against their plain version on layer 0's q, k,
    v and real dO, the first loss equal to the no-grad loss; (c) trains
    full-width qwen3-1.7b under ``remat_policy="dots"`` against "full"
    (2 steps at 8 x 4096 in two microbatches from the same weights and
    batches: the first loss bit for bit; later losses, gradient norms,
    step ms, peaks and a profiled step's idle share printed); (d) trains
    it through ``make_compressed_train_step`` (keep 0.05, int8; 3 steps)
    against the exact step (the first loss bit for bit; kept + residual
    against g + e on every leaf; one leaf's mask, kept values and residual
    against the CPU's bit for bit; step ms, the compression's ms, wire
    bytes, peak); (e) serves and trains internvl2-76b's SMOKE config (a
    60-token prompt after its 4-position prefix) and qwen3-1.7b's under
    "dots" and compressed on the card against the CPU within
    ``SMOKE_TOL``;
21. runs the A16i phase (``a16i_phase``: LM serving on a mesh of logical
    shards of the card, ``generate(..., mesh=)``): (a) full-width
    qwen3-moe-30b-a3b at batch 8 x 4096 + 16 on a (1, 4) mesh (prefill
    through the expert-parallel all-to-all route with its capacity,
    decode through the broadcast route) and with no mesh in the same run:
    prefill ms, decode ms a step, the (token, pick) pairs dropped a layer
    and in all, each all-to-all call's kept pairs held to the capacity
    rule's count from the routed expert ids, 48 + 0 flash launches each,
    bytes at rest a shard, peak memory; the same on the launchers'
    default one-card mesh (1, 1); layer 0's route with real activations
    held on the card in f32 against the CPU within 1e-3 (its bf16 figure
    printed); 4 layers trained on (1, 1) (the all-to-all route under
    autograd, the first loss bit for bit the no-grad one); both launchers
    at the smoke width with their default mesh; (b) full-width
    qwen3-1.7b on (2, 2) (two data shards, the KV cache split on its
    sequence): 56 + 0 flash launches, bf16 tokens and every pick's logits
    against no mesh printed, 2 layers in f32 held within 1e-3 with the
    tokens equal; each arch's figures go to its flash entry
    (``"mesh_serve"``);
22. prints the tuning phase's rows as one ``{"tuning": [...]}`` line,
    step 3a's as one ``{"backends": ...}`` line, then one ``{"kernels":
    [...], "card": ...}`` line and, last, the device line.

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

def peaks_for(card_name: str):
    """The data-sheet peaks of the card: (device-memory bytes/s, f32
    FLOP/s outside the tensor cores, dense bf16 tensor-core FLOP/s), from
    ``repro_torch.core.perf_model.DEVICES``, matched against its name."""
    from repro_torch.core.perf_model import device_for
    try:
        d = device_for(card_name)
    except ValueError as e:
        raise RuntimeError(str(e)) from None
    return d.mem_bw, d.f32_flops, d.bf16_tc_flops


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


def device_profile(fn, kernel_key, top: int = 3, detail=None) -> dict:
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
    range.  Every device event must lie between the markers.
    ``detail(spans)``, when given, adds its dict."""
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
    if detail is not None:
        out.update(detail(spans))
    return out


#: substrings of the names of cuBLAS's and CUTLASS's matrix-product kernels
GEMM_KEYS = ("gemm", "nvjet", "xmma", "cutlass")


def _is_gemm(name: str) -> bool:
    return any(k in name.lower() for k in GEMM_KEYS)


def _gemm_us(spans) -> dict:
    return {"gemm_us": sum(t - s for s, t, n in spans if _is_gemm(n))}


def call_shares(prefill_fn, module, name: str, kernel_key=None,
                parts=None) -> dict:
    """:func:`device_profile` of one call of ``prefill_fn`` and of one call
    of ``module.<name>`` alone, replayed on the arguments of the prefill's
    first call: the shares of the prefill's device busy time taken by the
    kernels that ``kernel_key`` names (when given: the flash forward), by
    the prefill's calls of ``name`` (their count times the lone call's busy
    time, their matrix products included), by matrix-product kernels
    outside those calls (projections, MLP, logits; every GEMM of the
    prefill less the calls' count times the lone call's) and by the rest.
    A spy counts the prefill's calls and holds each to the first call's
    shapes, dtypes and other arguments.  (Kernels credited to the CPU ops
    inside ``record_function`` ranges summed past the prefill's busy time
    on an H100, so the calls are profiled alone and multiplied.)
    ``parts(args, kw, calls, busy_us)``, when given, adds its dict, made
    from the first call's arguments before they are dropped."""
    import torch
    real, seen, first = getattr(module, name), [], []

    def sig(a):
        if isinstance(a, dict):
            return tuple(sorted((k, sig(v)) for k, v in a.items()))
        return ((tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
                else a)

    def spy(*args, **kw):
        seen.append((tuple(map(sig, args)),
                     tuple(sorted((k, sig(v)) for k, v in kw.items()))))
        if not first:
            first.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, spy)
    try:
        pre = device_profile(prefill_fn, kernel_key, top=8, detail=_gemm_us)
    finally:
        setattr(module, name, real)
    if not seen or len(set(seen)) != 1:
        raise AssertionError(f"the prefill's {name} calls differ in shape "
                             f"or arguments, or there are none: "
                             f"{sorted(set(seen), key=str)}")
    args, kw = first.pop()
    one = device_profile(lambda: real(*args, **kw), None, detail=_gemm_us)
    calls = len(seen)
    busy = pre["device_busy_ms"] * 1e3
    more = parts(args, kw, calls, busy) if parts is not None else {}
    del args, kw
    inside = calls * one["device_busy_ms"] * 1e3
    gemm_inside = calls * one["gemm_us"]
    kernel = pre.get("kernel_share_of_device", 0.0) * busy
    if inside + kernel > busy * 1.02 or gemm_inside > pre["gemm_us"] * 1.02:
        raise AssertionError(
            f"{calls} {name} calls of {one['device_busy_ms']} ms each (GEMMs "
            f"{one['gemm_us']} us) do not fit the prefill's {busy} us busy "
            f"(kernel {kernel} us, GEMMs {pre['gemm_us']} us)")
    return {**pre, f"{name}_calls": calls, f"{name}_call": str(seen[0]),
            f"{name}_call_busy_ms": one["device_busy_ms"],
            f"{name}_call_idle_share": one["device_idle_share"],
            f"{name}_share_of_device": inside / busy,
            f"{name}_gemm_share_of_device": gemm_inside / busy,
            f"gemm_outside_{name}_share_of_device":
                (pre["gemm_us"] - gemm_inside) / busy,
            "other_share_of_device":
                1 - (kernel + inside + pre["gemm_us"] - gemm_inside) / busy,
            **more}


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


# --- the performance model and the tuner (A11) -----------------------------

#: what the measured winner of each Table-2 stencil may take an iteration,
#: as a share of the pinned SCHEDULE's in the same run
TUNED_VS_PINNED = 1.10
#: iterations a timed run of the measured tuner (whole super-steps, so
#: the padding of the grid is shared by several)
TUNE_ITERS = 32
#: how much faster the model's schedule of the 1D star must run its
#: super-step than the same par_time at V = 1
STAR1D_TUNED_SPEEDUP = 3.0


def describe_prediction(pr) -> str:
    """One line of the model's view of a schedule."""
    g = pr.geom
    return (f"T={g.par_time} bsize={g.bsize} V={g.par_vec}: predicted "
            f"{pr.run_time / pr.n_super * 1e3:.3f} ms a super-step "
            f"(issue {pr.t_issue * 1e3:.3f}, bytes {pr.t_mem * 1e3:.3f}, "
            f"FLOPs {pr.t_compute * 1e3:.3f}; {pr.bound}), {pr.form} "
            f"{pr.kernel}, {pr.ctas} CTAs ({pr.per_sm} an SM, {pr.waves} "
            f"waves of {pr.ticks} ticks), {pr.smem_bytes} B of shared memory")


def kernel_per_sm(problem, geom, g, aux) -> int:
    """The CTAs an SM holds of the launch of ``problem`` at ``geom`` by
    ``stencil_stream_occupancy`` (one super-step through the kernel)."""
    import torch
    from repro_torch.kernels import builder, ops
    dag, bc0 = problem.exec_dag, problem.structural_bc
    gp = ops._pad_blocked(g, geom, bc0)
    aux_p = None if aux is None else ops._pad_blocked(aux, geom, bc0)
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    builder.superstep_dag(dag, geom, gp, c, geom.par_time, aux_p)
    torch.cuda.synchronize()
    return builder.LAST_SPLIT.per_sm


def tuned_run(label, p, g, aux) -> dict:
    """The tuned plan's counted run at ``iters = 2T+3``: ``ceil(iters/T)``
    launches, every one of the kernel the model named, the result within
    ``tolerance`` of the reference backend."""
    T = p.geometry.par_time
    iters = 2 * T + 3
    out, launches, run_ms = counted_run(p, g, aux, iters)
    want = p.candidates[0]
    want = getattr(want, "prediction", want).kernel
    if set(LAST_RUN_KERNELS) != {want}:
        raise AssertionError(f"{label}: the tuned run launched "
                             f"{LAST_RUN_KERNELS}, not {want}")
    err = check_reference(label, p.problem, g, aux, out, iters)
    return {"iters": iters, "launches": launches, "run_ms": run_ms,
            "oracle_max_abs_err": err, "kernel": want}


def tune_phase(device) -> list:
    """The performance model and the tuner on the card: (a) the model's
    shortlist of each Table-2 stencil at the paper's size; (b) the
    measured tuner over its 4 best (a cache in a temporary directory),
    each candidate's measured time and model accuracy beside the pinned
    :data:`SCHEDULE`'s, timed the same way, the winner within
    :data:`TUNED_VS_PINNED` of it, its counted run; (c) the same plans
    from the cache, with no launch in ``plan()``; (d) the 1D star and
    diffusion2d in bf16 under the model; (e) for every timed candidate,
    ``perf_model.occupancy`` against ``stencil_stream_occupancy``."""
    import tempfile

    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.api import tuner
    from repro_torch.core import perf_model
    from repro_torch.kernels import builder
    t0 = time.perf_counter()
    rows = []
    cache = tempfile.mkdtemp(prefix="schedules_")
    cache_file = os.path.join(cache, "schedules.json")
    dev_model = perf_model.device_for(torch.cuda.get_device_name(0)).on_card()
    try:
        for name in STENCILS:
            nd = int(name[-2])
            dims = FULL_DIMS[nd]
            problem = StencilProblem(name, dims)
            pm = plan(problem, RunConfig(backend="hopper", autotune="model",
                                         device=device))
            print(f"tune {name} {dims}: the model's shortlist "
                  f"({len(pm.candidates)} schedules run)", flush=True)
            for pr in pm.candidates[:6]:
                print(f"  {describe_prediction(pr)}", flush=True)
            cfg = RunConfig(backend="hopper", autotune="measure",
                            tune_top_k=4, tune_iters=TUNE_ITERS,
                            cache=cache_file, device=device)
            p = plan(problem, cfg)
            if p.tuned_from_cache:
                raise AssertionError(f"{name}: a fresh cache served a "
                                     "schedule")
            g, aux = tuner.make_inputs(problem, device)
            T, bsize = SCHEDULE[nd]
            pinned = tuner.measure_candidate(
                problem, cfg, perf_model.predict(
                    problem.stencil, dims, cfg.iters_hint, bsize, T,
                    dev_model), g, tuner._payload(problem), aux)
            cands = []
            for c in p.candidates:
                per_sm = kernel_per_sm(problem, c.geom, g, aux)
                if per_sm != c.prediction.per_sm:
                    raise AssertionError(
                        f"{name}: occupancy rule {c.prediction.per_sm} != "
                        f"stencil_stream_occupancy {per_sm} at {c.geom}")
                cands.append({
                    "par_time": c.geom.par_time, "bsize": list(c.geom.bsize),
                    "par_vec": c.geom.par_vec, "kernel": c.prediction.kernel,
                    "measured_ms": c.measured_s * 1e3,
                    "predicted_ms": c.prediction.run_time
                    / c.prediction.n_super * 1e3,
                    "model_accuracy": c.model_accuracy,
                    "ms_per_iter": c.s_per_iter * 1e3, "per_sm": per_sm})
                print(f"  measured T={c.geom.par_time} bsize={c.geom.bsize} "
                      f"V={c.geom.par_vec}: {c.measured_s * 1e3:.3f} ms a "
                      f"super-step ({c.s_per_iter * 1e3:.4f} an iteration), "
                      f"predicted {cands[-1]['predicted_ms']:.3f}, model "
                      f"accuracy {c.model_accuracy:.3f}; {per_sm} CTAs an "
                      f"SM by the rule and by the occupancy API", flush=True)
            best = p.candidates[0]
            ratio = best.s_per_iter / pinned.s_per_iter
            print(f"  pinned T={T} bsize={bsize}: {pinned.measured_s * 1e3:.3f}"
                  f" ms a super-step ({pinned.s_per_iter * 1e3:.4f} an "
                  f"iteration), model accuracy {pinned.model_accuracy:.3f}; "
                  f"the winner takes {ratio:.3f} of it an iteration",
                  flush=True)
            if ratio > TUNED_VS_PINNED:
                raise AssertionError(f"{name}: the tuned schedule takes "
                                     f"{ratio:.3f}x the pinned one")
            run = tuned_run(f"{name} tuned", p, g, aux)
            print(f"  tuned run of {run['iters']} iters {run['run_ms']}, "
                  f"{run['launches']} launches of {run['kernel']}, oracle "
                  f"max_abs_err {run['oracle_max_abs_err']:.3g}", flush=True)
            builder.LAUNCHES = 0
            again = plan(problem, cfg)
            if not again.tuned_from_cache or builder.LAUNCHES:
                raise AssertionError(
                    f"{name}: the second plan() was not served from the "
                    f"cache ({builder.LAUNCHES} launches)")
            if again.geometry != p.geometry:
                raise AssertionError(f"{name}: the cache served "
                                     f"{again.geometry}, not {p.geometry}")
            rows.append({"name": name, "dims": list(dims),
                         "model_top": [describe_prediction(pr)
                                       for pr in pm.candidates[:4]],
                         "candidates": cands,
                         "pinned": {"par_time": T, "bsize": list(bsize),
                                    "measured_ms": pinned.measured_s * 1e3,
                                    "ms_per_iter": pinned.s_per_iter * 1e3,
                                    "model_accuracy": pinned.model_accuracy},
                         "winner_vs_pinned": ratio, **run,
                         "run_ms": float(run["run_ms"]),
                         "from_cache": True})
            del g, aux, p, again, pm
            torch.cuda.empty_cache()
        # --- the model's ranking rules, at the pinned schedules ------------
        d2 = StencilProblem("diffusion2d", FULL_DIMS[2])
        h2 = StencilProblem("hotspot2d", FULL_DIMS[2])
        T2 = SCHEDULE[2][0]

        def ms(problem, b, V=1):
            pr = perf_model.predict(problem.stencil, problem.shape, T2, b,
                                    T2, dev_model, par_vec=V)
            return pr.run_time * 1e3
        if not ms(d2, 256) < ms(d2, 2048):
            raise AssertionError("the model ranks d2 bsize 2048 ahead of 256")
        for prob in (d2, h2):
            v1 = ms(prob, 256)
            vs = {V: ms(prob, 256, V) for V in (2, 4, 8)}
            if not all(v1 < t for t in vs.values()):
                raise AssertionError(f"{prob.stencil.name}: the model ranks "
                                     f"V > 1 ahead of V = 1 ({v1}, {vs})")
            print(f"model {prob.stencil.name} T={T2} bsize 256: V=1 "
                  f"{v1:.3f} ms, V=2/4/8 "
                  f"{'/'.join(f'{t:.3f}' for t in vs.values())}; bsize "
                  f"2048 {ms(prob, 2048):.3f}", flush=True)
        # --- the 1D star and bf16 under the model ---------------------------
        name, dims, _ = STAR1D
        problem = StencilProblem(name, dims)
        p = plan(problem, RunConfig(backend="hopper", autotune="model",
                                    device=device))
        geom = p.geometry
        if geom.par_vec < 8:
            raise AssertionError(f"{name}: the model picked V={geom.par_vec}")
        g, _ = tuner.make_inputs(problem, device)
        run = tuned_run(f"{name} tuned", p, g, None)
        v1 = plan(problem, RunConfig(backend="hopper", par_time=geom.par_time,
                                     bsize=(), device=device))
        fast = superstep_vs_plain(f"{name} tuned", problem, geom, g,
                                  plain_reps=0)["ms"]
        slow = superstep_vs_plain(f"{name} T={geom.par_time} V=1", problem,
                                  v1.geometry, g, plain_reps=0)["ms"]
        speedup = slow / fast
        print(f"tune {name} {dims}: the model's T={geom.par_time} "
              f"V={geom.par_vec}: super-step {fast} against {slow} at V=1, "
              f"{speedup:.2f}x; run of {run['iters']} iters {run['run_ms']}, "
              f"{run['launches']} launches of {run['kernel']}, oracle "
              f"max_abs_err {run['oracle_max_abs_err']:.3g}", flush=True)
        if speedup < STAR1D_TUNED_SPEEDUP:
            raise AssertionError(f"{name}: the tuned super-step is only "
                                 f"{speedup:.2f}x V=1's")
        rows.append({"name": name, "dims": list(dims),
                     "par_time": geom.par_time, "par_vec": geom.par_vec,
                     "superstep_ms": fast, "v1_superstep_ms": slow,
                     "speedup_vs_v1": speedup, **run,
                     "run_ms": float(run["run_ms"])})
        problem = StencilProblem("diffusion2d", FULL_DIMS[2],
                                 dtype="bfloat16")
        p = plan(problem, RunConfig(backend="hopper", autotune="model",
                                    device=device))
        g, _ = tuner.make_inputs(problem, device)
        run = tuned_run("diffusion2d bf16 tuned", p, g, None)
        print(f"tune diffusion2d bf16 {FULL_DIMS[2]}: "
              f"{describe_prediction(p.candidates[0])}; run of "
              f"{run['iters']} iters {run['run_ms']}, {run['launches']} "
              f"launches of {run['kernel']}, oracle max_abs_err "
              f"{run['oracle_max_abs_err']:.3g}", flush=True)
        rows.append({"name": "diffusion2d bf16", "dims": list(FULL_DIMS[2]),
                     "par_time": p.geometry.par_time,
                     "bsize": list(p.geometry.bsize),
                     "par_vec": p.geometry.par_vec, **run,
                     "run_ms": float(run["run_ms"])})
        del g, p
        torch.cuda.empty_cache()
    finally:
        for f in os.listdir(cache):
            os.unlink(os.path.join(cache, f))
        os.rmdir(cache)
    print(f"tune phase: {time.perf_counter() - t0:.3f} s", flush=True)
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


def lm_frames(cfg, B: int, S: int, device):
    """An encoder-decoder config's frame embeddings (B, S, d_model), f32
    standard normal from seed 1 on the card; ``None`` for a config that
    takes tokens only."""
    import torch
    if cfg.input_mode != "frames":
        return None
    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randn((B, S, cfg.d_model), generator=gen, device=device)


def lm_embeds(cfg, B: int, device):
    """A VLM config's patch embeddings (B, prefix_len, d_model), f32
    standard normal from seed 2 on the card; ``None`` for the other
    families."""
    import torch
    if cfg.input_mode != "embeds_prefix":
        return None
    gen = torch.Generator(device=device).manual_seed(2)
    return torch.randn((B, cfg.prefix_len, cfg.d_model), generator=gen,
                       device=device)


def serve_arch(arch, device, peaks, extras: bool = False, cfg=None) -> dict:
    """Serve full-width ``arch`` (bf16, random weights from seed 0) through
    ``generate`` at batch LM_BATCH x prompt LM_PROMPT + LM_NEW (an
    encoder-decoder arch with LM_PROMPT frames a prompt, ``lm_frames``; a
    VLM arch with its ``prefix_len`` patch embeddings in front of the
    prompt, ``lm_embeds``),
    with ``cfg.causal_attentions`` flash launches a prefill and none in
    decode; hold the flash kernel on the first causal attention's q, k, v
    (decoder layer 0, or the hybrid's first application of its shared
    block) against its plain version, with kernel, plain and SDPA times;
    and profile one prefill: the flash and GEMM shares of its device time,
    and for an
    encoder-decoder arch the chunked-attention and GEMM shares, for an SSM
    or hybrid arch the SSD scan's and the GEMMs', for a MoE arch the MoE
    layers' and their pieces' (``call_shares``, ``moe_layer0``).  With
    ``extras`` also profile decode and hold the "flash" prefill against
    "xla" and decode against prefill or forward (a MoE arch: printed in
    bf16 with the routing that differs, held in f32 on 4 layers; a VLM
    arch: printed in bf16, held in f32 on 2 layers).  An arch
    with no attention (the SSM family) returns its serving numbers without
    a kernel's readings.  ``cfg``, when given, stands in for the published
    config (a cut depth)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.serve import generate
    from repro_torch.models import attention as A
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import ssm as SSM
    from repro_torch.models.transformer import _embed, _unstack
    cfg = cfg or get_config(arch)
    B, S, H, Hkv, D = LM_BATCH, LM_PROMPT, cfg.n_heads, cfg.n_kv, cfg.d_head
    # the positions a prefill covers: a VLM's patch embeddings, then tokens
    P = cfg.prefix_len if cfg.input_mode == "embeds_prefix" else 0
    n_attn = cfg.causal_attentions
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"{arch}: {n_par} parameters ({n_par * 2 / 1e9:.3f} GB bf16, "
          f"padded vocab {cfg.padded_vocab}) made in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    kv_gb = n_attn * B * (P + S + LM_NEW) * Hkv * D * 2 * 2 / 1e9
    full_kv_gb = n_attn * 32 * (32768 + LM_NEW) * Hkv * D * 2 * 2 / 1e9
    if n_attn:
        print(f"cut: prefill_32k (batch 32 x 32768) needs {full_kv_gb:.1f} "
              f"GB of KV cache, more than one card holds; served batch {B} "
              f"x {f'prefix {P} + ' if P else ''}prompt {S} + {LM_NEW} new "
              f"({kv_gb:.2f} GB of KV cache)", flush=True)
    if cfg.family in ("ssm", "hybrid"):
        state_gb = (cfg.n_layers - n_attn) * B * cfg.ssm_heads \
            * cfg.ssm_head_dim * cfg.d_state * 2 / 1e9
        print(f"served batch {B} x prompt {S} + {LM_NEW} new: SSM state "
              f"{state_gb:.3f} GB ({cfg.n_layers - n_attn} SSM layers, bf16)",
              flush=True)
    prompts = np.random.default_rng(0).integers(1, cfg.vocab, (B, S),
                                                dtype=np.int32)
    tokens = torch.from_numpy(prompts).long().to(device)
    frames = lm_frames(cfg, B, S, device)
    embeds = lm_embeds(cfg, B, device)

    # the main path: counts at 0 just before, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    out = generate(cfg, params, tokens, LM_NEW, frames=frames, embeds=embeds)
    launches = flash.LAUNCHES
    forms = dict(flash.FORM_LAUNCHES)
    if (out.prefill_launches, out.decode_launches, launches) != (
            n_attn, 0, n_attn):
        raise AssertionError(
            f"flash launches: {out.prefill_launches} in prefill, "
            f"{out.decode_launches} in decode, {launches} in all; expected "
            f"{n_attn}, 0, {n_attn}")
    if tuple(out.tokens.shape) != (B, LM_NEW) or not bool(
            ((out.tokens >= 0) & (out.tokens < cfg.vocab)).all()):
        raise AssertionError("generated tokens outside [0, vocab)")
    if not bool(out.logits.isfinite().all()):
        raise AssertionError("non-finite logits")
    print(f"generate (cold): prefill {out.prefill_s * 1e3:.3f} ms, decode "
          f"{out.decode_s * 1e3:.3f} ms for {LM_NEW - 1} steps; launches "
          f"{out.prefill_launches} + {out.decode_launches}; tokens[0] "
          f"{out.tokens[0].tolist()}", flush=True)
    warm = generate(cfg, params, tokens, LM_NEW, frames=frames,
                    embeds=embeds)
    e2e = {"prefill_ms": warm.prefill_s * 1e3,
           "prefill_tok_per_s": B * S / warm.prefill_s,
           "decode_ms_per_step": warm.decode_s * 1e3 / (LM_NEW - 1),
           "decode_tok_per_s": B * (LM_NEW - 1) / warm.decode_s,
           "serve_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"generate (warm): prefill {e2e['prefill_ms']:.3f} ms "
          f"({e2e['prefill_tok_per_s']:.1f} tok/s"
          + (f", {B * (P + S) / warm.prefill_s:.1f} positions/s with the "
             f"{P}-position prefix" if P else "") + "), decode "
          f"{e2e['decode_ms_per_step']:.3f} ms/step "
          f"({e2e['decode_tok_per_s']:.1f} tok/s); peak memory "
          f"{e2e['serve_peak_memory_gb']:.3f} GB", flush=True)
    key = "flash_fwd_kernel" if n_attn else None
    spied = ("ssd_scan" if cfg.family in ("ssm", "hybrid")
             else "chunked_attention" if frames is not None
             else "apply_moe" if cfg.family == "moe" else None)
    if P:
        e2e["prefill_positions_per_s"] = B * (P + S) / warm.prefill_s
    with torch.inference_mode():
        def run():
            prefill(params, cfg, tokens, P + S, frames, embeds=embeds)
        if spied is None:
            prof = device_profile(run, key, detail=_gemm_us)
            prof["gemm_share_of_device"] = prof.pop("gemm_us") / (
                prof["device_busy_ms"] * 1e3)
        else:
            module = {"ssd_scan": SSM, "chunked_attention": A,
                      "apply_moe": MOE}[spied]
            prof = call_shares(run, module, spied, key,
                               moe_layer0 if spied == "apply_moe" else None)
    e2e["kernel_share_of_prefill_device"] = prof.pop(
        "kernel_share_of_device", 0.0)
    e2e.update({f"prefill_{k}": v for k, v in prof.items()})
    print(f"flash share of {arch}'s prefill device time "
          f"{e2e['kernel_share_of_prefill_device']:.4f}, device idle "
          f"{e2e['prefill_device_idle_share']:.4f}, profiled prefill "
          f"{e2e['prefill_profiled_run_ms']:.3f} ms"
          + (f"; GEMMs {e2e['prefill_gemm_share_of_device']:.4f}"
             if spied is None else ""), flush=True)
    if spied is not None:
        print(f"{arch}'s prefill device time: {spied} "
              f"{e2e[f'prefill_{spied}_share_of_device']:.4f} (its GEMMs "
              f"{e2e[f'prefill_{spied}_gemm_share_of_device']:.4f}) in "
              f"{e2e[f'prefill_{spied}_calls']} calls of "
              f"{e2e[f'prefill_{spied}_call_busy_ms']:.3f} ms profiled "
              f"alone, GEMMs outside it "
              f"{e2e[f'prefill_gemm_outside_{spied}_share_of_device']:.4f}, "
              f"flash {e2e['kernel_share_of_prefill_device']:.4f}, the rest "
              f"{e2e['prefill_other_share_of_device']:.4f}; largest other "
              f"kernels {e2e['prefill_top_other_device_us']}", flush=True)
    if spied == "apply_moe":
        print(f"{arch}'s prefill device time by MoE piece (layer 0's pieces "
              f"profiled alone, times {e2e['prefill_apply_moe_calls']}): "
              f"routing {e2e['prefill_moe_route_share_of_device']:.4f}, "
              f"gather/scatter "
              f"{e2e['prefill_moe_gather_scatter_share_of_device']:.4f}, "
              f"expert GEMMs "
              f"{e2e['prefill_moe_expert_gemm_share_of_device']:.4f}, expert "
              f"activations "
              f"{e2e['prefill_moe_expert_act_share_of_device']:.4f}; other "
              f"GEMMs "
              f"{e2e['prefill_gemm_outside_apply_moe_share_of_device']:.4f},"
              f" flash {e2e['kernel_share_of_prefill_device']:.4f}",
              flush=True)
    if extras:
        with torch.inference_mode():
            _, caches, memory = prefill(params, cfg, tokens, P + S + 1,
                                        frames, embeds=embeds)
            nxt = tokens[:, -1:]
            prof = device_profile(
                lambda: decode_step(params, cfg, nxt, caches, memory), None,
                top=5)
            del caches, memory
        e2e.update({f"decode_{k}": v for k, v in prof.items()})
        print(f"device idle {e2e['decode_device_idle_share']:.4f} in one "
              f"decode step "
              f"({e2e['decode_device_ops']} device ops)", flush=True)

    with torch.inference_mode():
        kernel = None
        if n_attn:
            # the kernel against its plain version on the first causal
            # attention's q, k, v
            x = _embed(params, cfg, tokens, embeds)
            bp = (params["shared"] if "shared" in params
                  else _unstack(params["blocks"], cfg.n_layers)[0])
            q, k, v = A._project_qkv(L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                                     bp["attn"], cfg,
                                     torch.arange(P + S, device=device))
            del x
            kernel = forward_kernel_vs_plain(q, k, v, peaks)
            del q, k, v
        checks = {}
        if extras and cfg.family == "moe":
            checks = moe_bf16_checks(params, cfg, tokens)
        elif extras and cfg.family == "vlm":
            checks = vlm_bf16_checks(params, cfg, tokens, embeds)
        elif extras:
            checks = prefill_and_decode_checks(params, cfg, tokens, frames)
        del frames, embeds
    del params
    torch.cuda.empty_cache()
    if extras and cfg.family in ("ssm", "hybrid"):
        checks.update(ssm_f32_checks(arch, tokens, device))
    if extras and cfg.family == "moe":
        checks.update(moe_f32_checks(arch, tokens, device))
    if extras and cfg.family == "vlm":
        checks.update(vlm_f32_checks(arch, tokens, device))

    common = {**checks, "tokens_in_range": True, "logits_finite": True,
              **e2e}
    if kernel is None:
        return {"name": f"serve[{arch}]", "launches": launches, **common}
    res = {"name": f"flash_fwd[{arch}]", "route": "cuda",
           "source": LM_SOURCE, "replaces": LM_REPLACES,
           "launches": launches, "form_launches": _form_counts(forms),
           **kernel.pop("readings"), **kernel,
           "shape": {"B": B, "S": P + S, "H": H, "Hkv": Hkv, "D": D},
           "n_layers": cfg.n_layers, **common}
    print(f"  flash_fwd[{arch}]: kernel {res['ms']}, plain "
          f"{res['plain_ms']}, library {res['library_ms']}, bound "
          f"{res['bound_ms']:.3f} ms ({res['bound_by']})", flush=True)
    return res


def prefill_and_decode_checks(params, cfg, tokens, frames=None) -> dict:
    """The "flash" prefill against "xla" (chunked torch ops; for an arch
    with attention), and teacher-forced decode against the same tokens
    run whole (and ``frames``, the encoder's input), by the relative L2 of
    the true-vocab logits (LOGIT_REL_TOL): against ``prefill`` over each
    step's tokens for the dense and encoder-decoder families, and for the
    families with SSM layers (``teacher_forced_vs_forward``) against
    ``forward``
    over SSM_TF_FORWARD tokens at the same positions."""
    import dataclasses
    from repro_torch.models import decode_step, prefill
    S = tokens.shape[1]
    out = {}
    if cfg.causal_attentions:
        lf, cf, _ = prefill(params, cfg, tokens, S, frames)
        del cf
        lx, cx, _ = prefill(params, dataclasses.replace(cfg,
                                                        attn_impl="xla"),
                            tokens, S, frames)
        del cx
        out["flash_vs_xla_logit_rel_err"] = rel_err(lf[..., :cfg.vocab],
                                                    lx[..., :cfg.vocab])
        print(f"prefill logits, flash vs xla: rel err "
              f"{out['flash_vs_xla_logit_rel_err']}, max abs "
              f"{(lf - lx).abs().max().item()}", flush=True)
    if cfg.family in ("ssm", "hybrid"):
        tf = teacher_forced_vs_forward(params, cfg, tokens)
    else:
        tf = []
        short = tokens[:, :LM_TF_PROMPT + LM_TF_STEPS]
        _, caches, memory = prefill(params, cfg, short[:, :LM_TF_PROMPT],
                                    LM_TF_PROMPT + LM_TF_STEPS, frames)
        for t in range(LM_TF_PROMPT, LM_TF_PROMPT + LM_TF_STEPS):
            ld, caches = decode_step(params, cfg, short[:, t:t + 1], caches,
                                     memory)
            lp, _, _ = prefill(params, cfg, short[:, :t + 1], t + 1, frames)
            tf.append(rel_err(ld[..., :cfg.vocab], lp[..., :cfg.vocab]))
        print(f"teacher-forced decode vs prefill (prompt {LM_TF_PROMPT}, "
              f"{LM_TF_STEPS} steps): rel err {tf}", flush=True)
        del caches, memory
    out["teacher_forced_logit_rel_err"] = tf
    # bf16 paths through an SSM stack part by more than through a dense one
    # (the scan carries each rounding along the sequence); the families
    # with SSM layers hold "flash" against "xla" in f32 (ssm_f32_checks)
    gated = 0.0 if cfg.family in ("ssm", "hybrid") \
        else out.get("flash_vs_xla_logit_rel_err", 0.0)
    if gated > LOGIT_REL_TOL or max(tf) > LOGIT_REL_TOL:
        raise AssertionError(f"logits differ beyond {LOGIT_REL_TOL}")
    return out


#: the families with SSM layers in f32 at full width, batch 2 (a cut of the
#: batch only): "flash" against "xla" prefill and the teacher-forced check,
#: each within 1e-3 relative L2, 50x tighter than LOGIT_REL_TOL: f32 sums
#: in other orders, which the SSM layers carry along the sequence
SSM_F32_BATCH, SSM_F32_TOL = 2, 1e-3


def ssm_f32_checks(arch, tokens, device) -> dict:
    """``arch``'s published config in f32 (weights from seed 0, the f32
    draws its bf16 weights are rounded from) on SSM_F32_BATCH of
    ``tokens``: the "flash" prefill (the f32 flash form) against "xla" for
    an arch with attention, and ``teacher_forced_vs_forward``, within
    SSM_F32_TOL."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    tokens = tokens[:SSM_F32_BATCH]
    S = tokens.shape[1]
    out = {}
    with torch.inference_mode():
        if cfg.causal_attentions:
            lf = prefill(params, cfg, tokens, S)[0]
            lx = prefill(params, dataclasses.replace(cfg, attn_impl="xla"),
                         tokens, S)[0]
            out["f32_flash_vs_xla_logit_rel_err"] = rel_err(
                lf[..., :cfg.vocab], lx[..., :cfg.vocab])
        out["f32_teacher_forced_logit_rel_err"] = teacher_forced_vs_forward(
            params, cfg, tokens)
    del params
    torch.cuda.empty_cache()
    print(f"{arch} in f32 at full width, batch {SSM_F32_BATCH}: {out}",
          flush=True)
    worst = max([out.get("f32_flash_vs_xla_logit_rel_err", 0.0)]
                + out["f32_teacher_forced_logit_rel_err"])
    if worst > SSM_F32_TOL:
        raise AssertionError(f"{arch} in f32: logits differ beyond "
                             f"{SSM_F32_TOL}")
    return out


#: the SSM and hybrid families' teacher-forced check: prefill two whole
#: chunks (512 tokens), decode LM_TF_STEPS tokens past them and compare with
#: ``forward`` over 1024 tokens (4 chunks; the flash wrapper takes a
#: sequence past attn_q_chunk = 512 only in whole multiples of it) at the
#: same positions, so the chunked scan's third chunk, which starts from the
#: state the first two carry, is held against the one-token recurrence
SSM_TF_PROMPT, SSM_TF_FORWARD = 512, 1024


def teacher_forced_vs_forward(params, cfg, tokens, prompt=SSM_TF_PROMPT,
                              total=SSM_TF_FORWARD, embeds=None) -> list:
    """Relative L2 of each teacher-forced decode step's true-vocab logits
    against ``forward``'s at the same position: ``forward`` over ``total``
    tokens, then ``prefill`` of ``prompt`` tokens and LM_TF_STEPS decode
    steps (a MoE arch's ``RouteLog`` sees the routes in that order); a
    VLM's ``embeds`` in front of both."""
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models import layers as L
    whole = tokens[:, :total]
    hidden, _ = forward(params, cfg, whole, embeds=embeds)
    P = hidden.shape[1] - whole.shape[1]
    _, caches, _ = prefill(params, cfg, whole[:, :prompt],
                           P + prompt + LM_TF_STEPS, embeds=embeds)
    tf = []
    for t in range(prompt, prompt + LM_TF_STEPS):
        ld, caches = decode_step(params, cfg, whole[:, t:t + 1], caches)
        lf = L.lm_logits(hidden[:, P + t:P + t + 1], params["embed"],
                         cfg.vocab).float()
        tf.append(rel_err(ld[..., :cfg.vocab], lf[..., :cfg.vocab]))
    del hidden, caches
    where = (", past a chunk boundary" if cfg.family in ("ssm", "hybrid")
             else f", after a {P}-position prefix" if P else "")
    print(f"teacher-forced decode vs forward over {total} tokens (prompt "
          f"{prompt}, {LM_TF_STEPS} steps{where}): rel err {tf}",
          flush=True)
    return tf


# --- the MoE family's checks ----------------------------------------------

#: the grouped route against the plain one on the card: layer 0's normed
#: input for the prefill's first MOE_DENSE_TOKENS tokens (at the whole
#: 32768 the plain route's (T, E, D) bf16 product alone is 17.2 GB), held
#: by relative L2 to one bf16 rounding (2**-8): the same routes, each
#: product summed in f32 and rounded to bf16 once, in other orders
MOE_DENSE_TOKENS, MOE_PATH_TOL = 512, 2 ** -8
#: the f32 checks at full width, cut to MOE_F32_LAYERS layers (12.5 GB; the
#: 48 layers in f32 are 122 GB), batch SSM_F32_BATCH x MOE_F32_SEQ: "flash"
#: against "xla" prefill and teacher-forced decode (LM_TF_PROMPT, then
#: LM_TF_STEPS steps) against ``forward`` over MOE_F32_SEQ tokens, held to
#: SSM_F32_TOL as the SSM families are
MOE_F32_LAYERS, MOE_F32_SEQ = 4, 512


class RouteLog:
    """A spy on ``moe.route`` while it is entered: ``calls`` holds each
    call's expert ids (T, k) in call order."""

    def __enter__(self):
        from repro_torch.models import moe as MOE
        self.calls, self._real = [], MOE.route

        def spy(x2d, router, top_k):
            w, ids, aux = self._real(x2d, router, top_k)
            self.calls.append(ids)
            return w, ids, aux
        MOE.route = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE
        MOE.route = self._real


def route_diff_share(got: list, want: list) -> float:
    """The share of (token, layer) expert sets that differ between two
    lists of ids of the same shapes (each set sorted, so the order of the
    picks does not count)."""
    import torch
    diff = rows = 0
    for a, b in zip(got, want, strict=True):
        ne = (torch.sort(a, -1).values != torch.sort(b, -1).values).any(-1)
        diff += int(ne.sum())
        rows += ne.numel()
    return diff / rows


def tf_route_diff_share(calls: list, n_layers: int, batch: int, prompt: int,
                        total: int) -> float:
    """``route_diff_share`` of the teacher-forced decode steps' routes
    against ``forward``'s at the same positions, from a ``RouteLog`` over
    ``teacher_forced_vs_forward``: ``forward``'s n_layers calls, then the
    prefill's, then n_layers a decode step."""
    fwd = [c.reshape(batch, total, -1) for c in calls[:n_layers]]
    steps = calls[2 * n_layers:]
    got, want = [], []
    for s in range(LM_TF_STEPS):
        for layer in range(n_layers):
            got.append(steps[s * n_layers + layer])
            want.append(fwd[layer][:, prompt + s])
    return route_diff_share(got, want)


def moe_layer0(args, kw, calls: int, busy_us: float) -> dict:
    """From the prefill's first ``apply_moe`` call (layer 0: x, p, cfg):
    each piece of ``grouped_path`` (``route``, ``dispatch``,
    ``expert_products``, ``combine``) profiled alone on that call's
    arguments, and its share of the prefill's device busy time ``busy_us``
    as ``calls`` times its busy time (an estimate: the other layers route
    their own tokens); then ``grouped_path`` against ``dense_path`` on the
    first MOE_DENSE_TOKENS tokens, within MOE_PATH_TOL, with the share of
    tokens routed differently (expected 0: one ``route``)."""
    import torch
    from repro_torch.models import moe as MOE
    x, p, cfg = args
    D = x.shape[-1]
    x2 = x.reshape(-1, D)
    w, ids, _ = MOE.route(x2, p["router"], cfg.top_k)
    order, rows, counts = MOE.dispatch(x2, ids, cfg.n_experts)
    y = MOE.expert_products(rows, counts, p["w_in"], p["w_out"], cfg.act)
    pieces = {
        "route": lambda: MOE.route(x2, p["router"], cfg.top_k),
        "dispatch": lambda: MOE.dispatch(x2, ids, cfg.n_experts),
        "expert_products": lambda: MOE.expert_products(
            rows, counts, p["w_in"], p["w_out"], cfg.act),
        "combine": lambda: MOE.combine(y, order, w, x.dtype)}
    out, busy, gemm = {}, {}, {}
    for name, fn in pieces.items():
        prof = device_profile(fn, None, detail=_gemm_us)
        busy[name], gemm[name] = prof["device_busy_ms"] * 1e3, prof["gemm_us"]
        out[f"moe_{name}_busy_ms"] = busy[name] / 1e3
        out[f"moe_{name}_gemm_ms"] = gemm[name] / 1e3
    out["moe_experts_with_rows"] = sum(1 for n in counts if n)
    out["moe_rows_per_expert_max"] = max(counts)

    def share(us):
        return calls * us / busy_us
    out.update({
        "moe_route_share_of_device": share(busy["route"]),
        "moe_gather_scatter_share_of_device": share(busy["dispatch"]
                                                    + busy["combine"]),
        "moe_expert_gemm_share_of_device": share(gemm["expert_products"]),
        "moe_expert_act_share_of_device": share(busy["expert_products"]
                                                - gemm["expert_products"])})
    del w, ids, order, rows, y
    xs = x2[:MOE_DENSE_TOKENS][None]
    with RouteLog() as log:
        grouped, g_aux = MOE.grouped_path(xs, p, cfg)
        dense, d_aux = MOE.dense_path(xs, p, cfg)
    torch.cuda.synchronize()
    out["grouped_vs_dense"] = {
        "tokens": xs.shape[1], "rel_err": rel_err(grouped, dense),
        "max_abs_err": (grouped.float() - dense.float()).abs().max().item(),
        "aux_abs_err": abs(g_aux.item() - d_aux.item()),
        "route_diff_share": route_diff_share(log.calls[:1], log.calls[1:])}
    del grouped, dense
    print(f"grouped_path vs dense_path on the card (layer 0's normed input, "
          f"first {xs.shape[1]} tokens, {x.dtype}): {out['grouped_vs_dense']}"
          f"; layer 0's pieces alone: busy ms "
          f"{ {k: round(v / 1e3, 3) for k, v in busy.items()} }, GEMM ms "
          f"{ {k: round(v / 1e3, 3) for k, v in gemm.items()} }; "
          f"{out['moe_experts_with_rows']} experts with rows, at most "
          f"{out['moe_rows_per_expert_max']}", flush=True)
    gvd = out["grouped_vs_dense"]
    if not (gvd["rel_err"] <= MOE_PATH_TOL and gvd["route_diff_share"] == 0
            and gvd["aux_abs_err"] == 0):
        raise AssertionError(f"grouped_path differs from dense_path on the "
                             f"card beyond {MOE_PATH_TOL}: {gvd}")
    return out


def moe_bf16_checks(params, cfg, tokens) -> dict:
    """At full depth in bf16, printed and not held (two bf16 paths can pick
    another k-th expert for a token): the "flash" prefill against "xla"
    and teacher-forced decode against ``forward`` over LM_TF_PROMPT +
    LM_TF_STEPS tokens, each with the share of (token, layer) expert sets
    that differ between the two paths; only finite logits are held."""
    import dataclasses

    import torch
    from repro_torch.models import prefill
    B, S = tokens.shape
    total = LM_TF_PROMPT + LM_TF_STEPS
    with RouteLog() as flash_log:
        lf = prefill(params, cfg, tokens, S)[0]
    with RouteLog() as xla_log:
        lx = prefill(params, dataclasses.replace(cfg, attn_impl="xla"),
                     tokens, S)[0]
    out = {"flash_vs_xla_logit_rel_err": rel_err(lf[..., :cfg.vocab],
                                                 lx[..., :cfg.vocab]),
           "flash_vs_xla_route_diff_share": route_diff_share(
               flash_log.calls, xla_log.calls)}
    finite = bool(lf.isfinite().all() and lx.isfinite().all())
    del lf, lx, flash_log, xla_log
    with RouteLog() as tf_log:
        tf = teacher_forced_vs_forward(params, cfg, tokens, LM_TF_PROMPT,
                                       total)
    out["teacher_forced_logit_rel_err"] = tf
    out["teacher_forced_route_diff_share"] = tf_route_diff_share(
        tf_log.calls, cfg.n_layers, B, LM_TF_PROMPT, total)
    del tf_log
    torch.cuda.empty_cache()
    print(f"{cfg.name} in bf16 at full depth (printed, not held): {out}",
          flush=True)
    if not finite or not all(math.isfinite(e) for e in tf):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return out


def moe_f32_checks(arch, tokens, device) -> dict:
    """``arch``'s published config in f32, cut to MOE_F32_LAYERS layers
    (weights from seed 0) on SSM_F32_BATCH x MOE_F32_SEQ of ``tokens``:
    the "flash" prefill (the f32 flash form) against "xla", and
    ``teacher_forced_vs_forward``, within SSM_F32_TOL, each with the share
    of expert sets that differ."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              n_layers=MOE_F32_LAYERS)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    tokens = tokens[:SSM_F32_BATCH, :MOE_F32_SEQ]
    B, S = tokens.shape
    with torch.inference_mode():
        with RouteLog() as flash_log:
            lf = prefill(params, cfg, tokens, S)[0]
        with RouteLog() as xla_log:
            lx = prefill(params, dataclasses.replace(cfg, attn_impl="xla"),
                         tokens, S)[0]
        out = {"f32_layers": MOE_F32_LAYERS,
               "f32_flash_vs_xla_logit_rel_err": rel_err(
                   lf[..., :cfg.vocab], lx[..., :cfg.vocab]),
               "f32_flash_vs_xla_route_diff_share": route_diff_share(
                   flash_log.calls, xla_log.calls)}
        with RouteLog() as tf_log:
            out["f32_teacher_forced_logit_rel_err"] = \
                teacher_forced_vs_forward(params, cfg, tokens, LM_TF_PROMPT,
                                          S)
        out["f32_teacher_forced_route_diff_share"] = tf_route_diff_share(
            tf_log.calls, cfg.n_layers, B, LM_TF_PROMPT, S)
    del params, flash_log, xla_log, tf_log
    torch.cuda.empty_cache()
    print(f"{arch} in f32 at full width, {MOE_F32_LAYERS} layers, batch "
          f"{B} x {S}: {out}", flush=True)
    worst = max([out["f32_flash_vs_xla_logit_rel_err"]]
                + out["f32_teacher_forced_logit_rel_err"])
    if worst > SSM_F32_TOL:
        raise AssertionError(f"{arch} in f32: logits differ beyond "
                             f"{SSM_F32_TOL}")
    return out


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
    stacked ``wq``, which every layer's q projection reads).  The spy sees
    the first flash call: an encoder-decoder model's encoder and
    cross-attention take ``chunked_attention``, so that is the decoder's
    layer 0, and ``wq`` is the decoder's (``params["blocks"]``); the
    hybrid's first causal attention is the first application of its
    shared block, whose ``wq`` is ``params["shared"]``'s."""
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
    wq = params.get("shared", params.get("blocks"))["attn"]["wq"]
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


#: the largest argument f32's exp takes without overflowing: log(FLT_MAX)
F32_EXP_MAX = math.log(3.4028234663852886e38)


def masked_decay_gap(params, cfg, batch) -> float:
    """The largest cs_i - cs_j above the diagonal of ``ssd_scan``'s
    intra-chunk decay over one forward of ``batch`` without autograd: the
    largest argument its masked ``exp`` takes.  cs is the running sum of
    dt·A <= 0 within a chunk, so each chunk's largest gap is its first
    minus its last; a spy reads every call's dt and A."""
    import torch
    from repro_torch.models import lm_loss
    from repro_torch.models import ssm as SSM
    real, gaps = SSM.ssd_scan, []

    def spy(xh, Bh, Ch, dt, A, chunk, init_state=None):
        Bsz, S, H = dt.shape
        Q = min(chunk, S)
        cs = torch.cumsum((dt * A).reshape(Bsz, S // Q, Q, H), dim=2)
        gaps.append((cs[:, :, 0] - cs[:, :, -1]).max().item())
        return real(xh, Bh, Ch, dt, A, chunk, init_state)

    SSM.ssd_scan = spy
    try:
        with torch.no_grad():
            lm_loss(params, cfg, batch)
    finally:
        SSM.ssd_scan = real
    return max(gaps)


def train_phase(device, peaks) -> dict:
    """Train full-width qwen3-1.7b through ``make_train_step`` and hold the
    backward kernels, the "flash" gradients and the checkpointed loop
    against their plain counterparts on the card."""
    return train_arch(LM_ARCH, device, peaks, TRAIN_BATCH,
                      [1] * TRAIN_STEPS[0] + [2] * TRAIN_STEPS[1],
                      extras=True)


def train_arch(arch, device, peaks, B, plan, extras: bool = False,
               cfg=None) -> dict:
    """Train full-width ``arch`` (bf16, random weights from seed 0, AdamW;
    ``cfg``, when given, in place of its published config: a cut depth)
    through ``make_train_step``, one step per entry of ``plan`` (its
    microbatches), at batch ``B`` x TRAIN_SEQ, with ``2 c``, ``c`` and
    ``c`` forward, dQ and dK/dV launches a step and microbatch for ``c =
    cfg.causal_attentions``, and (when ``c``) hold both backward kernels
    against their plain version on the first causal attention's q, k, v
    and real output gradient; with ``extras`` (qwen3-1.7b's cell) also
    profile a step and hold the "flash" gradients against "xla" and the
    checkpointed loop against its uninterrupted run.  Returns the kernel
    rows (none without attention), the forward launches a step and the
    end-to-end numbers."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.train import data_mode, device_batch
    from repro_torch.models import forward, init_params, lm_loss
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    cfg = cfg or get_config(arch)
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
    data = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0,
        prefix_len=cfg.prefix_len, d_model=cfg.d_model,
        mode=data_mode(cfg)))
    batches = [device_batch(data.batch_at(s), device)
               for s in range(len(plan))]
    with torch.no_grad():
        loss0 = lm_loss(params, cfg, batches[0]).item()
        # the MoE layers' summed aux loss, which lm_loss adds at 1e-2
        aux0 = (forward(params, cfg, batches[0]["tokens"])[1].item()
                if cfg.family == "moe" else None)
    L = cfg.causal_attentions
    cap = capture_layer0(params, cfg, batches[0]) if L else None
    gap = None
    if cfg.family in ("ssm", "hybrid"):
        gap = masked_decay_gap(params, cfg, batches[0])
        print(f"the SSD scan's masked decay on batch 0: largest cs_i - cs_j "
              f"above the diagonal {gap:.3f} (f32 exp overflows past "
              f"{F32_EXP_MAX:.3f})", flush=True)
    do_source = "the first causal attention's output gradient"
    if cap is not None and not bool(cap["do"].isfinite().all()):
        # the SSD layers' backward reaches the first attention with NaN
        # when the masked decay overflows (ROADMAP queue C)
        gen = torch.Generator(device=device).manual_seed(cfg.n_heads
                                                         + cfg.n_kv)
        cap["do"] = torch.randn(cap["do"].shape, generator=gen,
                                device=device).to(cap["do"].dtype)
        do_source = ("standard normal from seed H + Hkv: the real output "
                     "gradient is not finite")
        print(f"the first causal attention's real output gradient is not "
              f"finite; the backward kernels are held on its q, k, v with "
              f"dO {do_source}", flush=True)
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
    want = [(2 * L * mb, L * mb, L * mb) for mb in plan]
    print(f"train steps (mb {plan}): losses {losses}; seconds {secs}; "
          f"launches per step (fwd, dq, dkv) {per_step}; peak memory "
          f"{peak_gb:.3f} GB; loss of batch 0 without autograd {loss0}",
          flush=True)
    if per_step != want or launches != tuple(map(sum, zip(*want))):
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{want}")
    if not math.isfinite(losses[0]) or abs(losses[0] - loss0) > 1.0:
        raise AssertionError("the first step's loss is not finite, or far "
                             "from the batch's loss")
    finite = all(math.isfinite(x) for x in losses)
    if not finite and (gap is None or gap <= F32_EXP_MAX):
        raise AssertionError(f"training losses not finite: {losses}")
    if not finite:
        # the reference's arithmetic: exp(cs_i - cs_j) is inf above the
        # diagonal, where only a where() hides it, and autograd's inf * 0
        # makes the first backward NaN (ROADMAP queue C); kept, not fixed
        print(f"NOT FINITE after the first step: losses {losses}; the "
              f"masked decay's largest argument {gap:.3f} passes "
              f"{F32_EXP_MAX:.3f}, so exp gives inf above the diagonal and "
              f"the backward's inf * 0 gives NaN, as the reference's "
              f"arithmetic does (ROADMAP queue C)", flush=True)
    one = [t for t, mb in zip(secs, plan) if mb == 1]
    two = [t for t, mb in zip(secs[1:], plan[1:]) if mb == 2]
    e2e = {"train_step_ms": statistics.median(one[1:]) * 1e3,
           "train_cold_step_ms": secs[0] * 1e3,
           "train_peak_memory_gb": peak_gb, "train_losses": losses,
           "train_losses_finite": finite, "train_loss_no_grad": loss0,
           "train_launches_per_step": per_step}
    if gap is not None:
        e2e["train_masked_decay_gap"] = gap
    if aux0 is not None:
        e2e["train_aux_no_grad"] = aux0
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
    fwd_per_step = [p[0] for p in per_step]
    if not L:
        del params, opt
        torch.cuda.empty_cache()
        return {"kernels": [], "fwd_per_step": fwd_per_step, "e2e": e2e}

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
              "pair": bwd["pair"], "do_source": do_source}
    kernels = [
        {"name": f"flash_bwd_dq[{arch}]", "replaces": DQ_REPLACES,
         "launches": launches[1], "form_launches": _form_counts(forms),
         **bwd["dq"], **common, **e2e, **more},
        {"name": f"flash_bwd_dkv[{arch}]", "replaces": DKV_REPLACES,
         "launches": launches[2], **bwd["dkv"], **common}]
    return {"kernels": kernels, "fwd_per_step": fwd_per_step, "e2e": e2e}


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
#: (d) the head-dim sweep: qwen3-1.7b's smoke config at every head dim
#: the flash kernels take but 12 and 16 (phi4-mini's and the other smoke
#: configs'), so that every form runs on a dense served and trained path;
#: seamless-m4t-large-v2 (A16f) also runs bf16 at 64 and its SMOKE f32 at
#: 8, and no ported config has 112 yet (A16e's zamba2-7b)
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


def smoke_run(label: str, cfg, device, compress=None) -> dict:
    """``generate`` (batch 2, prompt 64, 8 new) then 3 AdamW steps of
    ``make_train_step`` of ``cfg`` (``make_compressed_train_step`` at keep
    ratio ``compress``, when given) on the CPU (the plain versions) and on
    the card (the flash kernels in ``cfg``'s dtype and head dim), from the
    same weights (seed 0, made on the CPU), prompts, frames (an
    encoder-decoder config's), patch embeddings (a VLM config's: its
    prompt is 64 positions, the prefix's and 64 - prefix tokens) and
    batches: launch counts exact, the first pick's logits and the losses
    within SMOKE_TOL."""
    import numpy as np
    import torch
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import data_mode, device_batch
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_compressed_train_step, make_train_step
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    P = cfg.prefix_len if cfg.input_mode == "embeds_prefix" else 0
    S = SMOKE_PROMPT - P
    prompts = rng.integers(1, cfg.vocab, (SMOKE_BATCH, S), dtype=np.int32)
    frames = (rng.standard_normal((SMOKE_BATCH, S, cfg.d_model))
              .astype(np.float32) if cfg.input_mode == "frames" else None)
    embeds = (rng.standard_normal((SMOKE_BATCH, P, cfg.d_model))
              .astype(np.float32) if P else None)
    data = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=SMOKE_BATCH, seed=0,
        prefix_len=cfg.prefix_len, d_model=cfg.d_model,
        mode=data_mode(cfg)))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=SMOKE_STEPS)
    step = (make_train_step(cfg, ocfg) if compress is None
            else make_compressed_train_step(cfg, ocfg, keep_ratio=compress))
    runs = {}
    for where in ("cpu", device):
        params = _tree_to(init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu"), where)
        opt = adamw_init(params)
        if compress is not None:
            opt = (opt, step.init_extra(params))
        tokens = torch.from_numpy(prompts).long().to(where)
        batches = [device_batch(data.batch_at(s), where)
                   for s in range(SMOKE_STEPS)]
        if where == device:
            # the main path: counts at 0 just before, read just after
            torch.cuda.synchronize()
            _zero_launch_counts()
        gen = generate(cfg, params, tokens, SMOKE_NEW, frames=None
                       if frames is None else torch.from_numpy(frames).to(
                           where), embeds=None if embeds is None
                       else torch.from_numpy(embeds).to(where))
        losses = []
        for batch in batches:
            params, opt, metrics = step(params, opt, batch)
            losses.append(metrics["loss"].item())
        runs[where] = (gen, losses)
    counts, forms = _launch_counts(), dict(flash.FORM_LAUNCHES)
    L = cfg.causal_attentions
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


# --- A16f: the encoder-decoder family -------------------------------------

A16F_ARCH = "seamless-m4t-large-v2"
#: (b) full-width training: train_4k's sequence, its batch of 256 cut to 2
A16F_TRAIN_BATCH, A16F_TRAIN_STEPS = 2, 3


def a16f_phase(device, peaks) -> list:
    """(a) seamless-m4t-large-v2 served at full width in bf16
    (``serve_arch`` with ``extras``: batch 8 x 4096 frames and a 4096-token
    prompt + 16 new tokens; 24 flash launches a prefill, none in decode;
    decoder layer 0's flash output against its plain version; the "flash"
    prefill against "xla" and teacher-forced decode against prefill; the
    flash, chunked-attention and GEMM shares of a prefill's device time);
    (b) trained at 2 x 4096 for 3 AdamW steps (``train_arch``: 48/24/24
    launches a step, both backward kernels against their plain version on
    decoder layer 0, finite losses); (c) its SMOKE config (f32, head dim
    8) served and trained on the card against the CPU (``smoke_run``)."""
    import torch
    from repro_torch.configs import get_config, smoke_config
    t0 = time.perf_counter()
    cfg = get_config(A16F_ARCH)
    kv_gb = cfg.n_layers * LM_BATCH * (LM_PROMPT + LM_NEW) * cfg.n_kv \
        * cfg.d_head * 2 * 2 / 1e9
    print(f"A16f: {A16F_ARCH} ({cfg.family}: {cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, H {cfg.n_heads} on Hkv "
          f"{cfg.n_kv}, d_head {cfg.d_head}; {cfg.n_params} parameters by "
          f"the reference's formula); decode KV cache {kv_gb:.2f} GB; AdamW "
          f"state about {cfg.n_params * 14 / 1e9:.1f} GB", flush=True)
    serve = serve_arch(A16F_ARCH, device, peaks, extras=True)
    torch.cuda.empty_cache()
    train = train_arch(A16F_ARCH, device, peaks, A16F_TRAIN_BATCH,
                       [1] * A16F_TRAIN_STEPS)
    serve["train_launches_per_step"] = train.pop("fwd_per_step")
    torch.cuda.empty_cache()
    serve["smoke_run"] = smoke_run(A16F_ARCH, smoke_config(A16F_ARCH),
                                   device)
    print(f"A16f phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return [serve] + train["kernels"]


# --- A16d, A16e: the SSM and hybrid families ------------------------------

A16D_ARCH, A16E_ARCH = "mamba2-1.3b", "zamba2-7b"
#: (b), (d) full-width training: train_4k's sequence, its batch of 256 cut
#: to 2, 3 AdamW steps
A16DE_TRAIN_BATCH, A16DE_TRAIN_STEPS = 2, 3
#: (d) zamba2-7b trained cut to 4 groups + its 3-layer tail: the 81-layer
#: model's AdamW state (about 14 bytes a parameter, 83.4 GB) passes the
#: card's 80 GB
A16E_TRAIN_LAYERS = 27


def a16de_phase(device, peaks) -> list:
    """(a) mamba2-1.3b (the SSM family: 48 SSM layers, no attention)
    served at full width in bf16 (``serve_arch`` with ``extras``: batch 8
    x 4096 + 16 new, no flash launch, teacher-forced decode across a chunk
    boundary against ``forward``, the SSD scan's and the GEMMs' shares of a
    prefill's device time) and (b) trained at 2 x 4096 for 3 AdamW steps
    (no flash launch, finite losses); (c) zamba2-7b (the hybrid: 13 groups
    of its shared attention block and 5 SSM layers, then 3 SSM layers)
    served the same way (13 flash launches a prefill at head dim 112 on 32
    KV heads, none in decode; the first shared application's flash output
    against its plain version beside SDPA; "flash" against "xla"; the
    flash, SSD and GEMM shares) and (d) trained cut to A16E_TRAIN_LAYERS
    layers (8/4/4 launches a step, both backward kernels against their
    plain version on the first shared application); (e) both SMOKE configs
    (f32) served and trained on the card against the CPU (``smoke_run``).
    mamba2-1.3b's rows are nested in zamba2-7b's forward row: it launches
    no kernel."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    t0 = time.perf_counter()
    for arch in (A16D_ARCH, A16E_ARCH):
        cfg = get_config(arch)
        print(f"A16d/e: {arch} ({cfg.family}: {cfg.n_layers} layers, "
              f"{cfg.causal_attentions} causal attentions, {cfg.ssm_heads} "
              f"SSD heads of {cfg.ssm_head_dim}, {cfg.ssm_groups} groups, "
              f"d_state {cfg.d_state}, chunk {cfg.ssd_chunk}; "
              f"{cfg.n_params} parameters by the reference's formula); "
              f"AdamW state about {cfg.n_params * 14 / 1e9:.1f} GB",
              flush=True)
    ssm_serve = serve_arch(A16D_ARCH, device, peaks, extras=True)
    torch.cuda.empty_cache()
    ssm_train = train_arch(A16D_ARCH, device, peaks, A16DE_TRAIN_BATCH,
                           [1] * A16DE_TRAIN_STEPS)
    if any(ssm_train["fwd_per_step"]):
        raise AssertionError("mamba2-1.3b's training launched a kernel")
    torch.cuda.empty_cache()
    serve = serve_arch(A16E_ARCH, device, peaks, extras=True)
    torch.cuda.empty_cache()
    full = get_config(A16E_ARCH)
    cut = dataclasses.replace(full, n_layers=A16E_TRAIN_LAYERS)
    print(f"cut: {A16E_ARCH}'s {full.n_params} parameters take about "
          f"{full.n_params * 14 / 1e9:.1f} GB with AdamW (bf16 weights, f32 "
          f"moments and master), more than the card's 80 GB; trained at "
          f"full width with {cut.n_layers} layers ({cut.hybrid_layout[0]} "
          f"groups + the {cut.hybrid_layout[1]}-layer tail: "
          f"{cut.n_params} parameters, about {cut.n_params * 14 / 1e9:.1f} "
          f"GB)", flush=True)
    train = train_arch(A16E_ARCH, device, peaks, A16DE_TRAIN_BATCH,
                       [1] * A16DE_TRAIN_STEPS, cfg=cut)
    serve["train_launches_per_step"] = train.pop("fwd_per_step")
    serve["train_layers"] = cut.n_layers
    torch.cuda.empty_cache()
    serve["smoke_run"] = smoke_run(A16E_ARCH, smoke_config(A16E_ARCH),
                                   device)
    serve[f"{A16D_ARCH}_serve"] = ssm_serve
    serve[f"{A16D_ARCH}_train"] = ssm_train["e2e"]
    serve[f"{A16D_ARCH}_smoke_run"] = smoke_run(
        A16D_ARCH, smoke_config(A16D_ARCH), device)
    print(f"A16d/e phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return [serve] + train["kernels"]


# --- A16c: the MoE family -------------------------------------------------

A16C_ARCH, A16C_BIG = "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"
#: (c) qwen3-moe-30b-a3b trained at full width cut to 4 of its 48 layers:
#: the 48 layers' AdamW state with the gradient (about 16 bytes a
#: parameter, 490 GB) passes the card; train_4k's sequence, its batch of 256
#: cut to 2, 3 AdamW steps
A16C_TRAIN_LAYERS, A16C_TRAIN_BATCH, A16C_TRAIN_STEPS = 4, 2, 3
#: (d) qwen3-moe-235b-a22b served at full width cut to 8 of its 94 layers
#: (about 42 GB of its 470 GB)
A16C_BIG_LAYERS = 8
#: the serving peak must stay on the card
CARD_GB = 80.0


def a16c_phase(device, peaks) -> list:
    """(a) qwen3-moe-30b-a3b (48 layers of causal GQA attention at head dim
    128, 32 heads on 4 KV heads, and 128 experts, top-8) served at full
    width in bf16 (``serve_arch`` with ``extras``: batch 8 x 4096 + 16 new;
    48 flash launches a prefill, none in decode; layer 0's flash output
    against its plain version beside SDPA; ``grouped_path`` against
    ``dense_path`` on the card (``moe_layer0``); the shares of a prefill's
    device time in routing, gather/scatter, the expert GEMMs, the other
    GEMMs and flash; the bf16 checks at full depth printed with the
    routing that differs, and (b) the f32 checks on 4 layers held to
    1e-3); (c) trained at full width cut to A16C_TRAIN_LAYERS layers at 2 x
    4096 for 3 AdamW steps (8/4/4 launches a step, both backward kernels
    against their plain version on layer 0, finite losses, the first equal
    to the batch's loss without autograd, aux included); (d)
    qwen3-moe-235b-a22b served at full width cut to A16C_BIG_LAYERS layers
    (8 flash launches a prefill, G 16); (e) both SMOKE configs (f32, head
    dim 16) served and trained on the card against the CPU
    (``smoke_run``)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    t0 = time.perf_counter()
    for arch in (A16C_ARCH, A16C_BIG):
        cfg = get_config(arch)
        kv_gb = cfg.n_layers * LM_BATCH * (LM_PROMPT + LM_NEW) * cfg.n_kv \
            * cfg.d_head * 2 * 2 / 1e9
        print(f"A16c: {arch} ({cfg.family}: {cfg.n_layers} layers, H "
              f"{cfg.n_heads} on Hkv {cfg.n_kv}, d_head {cfg.d_head}, "
              f"{cfg.n_experts} experts of ff {cfg.d_ff}, top-{cfg.top_k}; "
              f"{cfg.n_params} parameters by the reference's formula, "
              f"{cfg.n_params * 2 / 1e9:.2f} GB in bf16); decode KV cache "
              f"{kv_gb:.2f} GB; AdamW state with the gradient about "
              f"{cfg.n_params * 16 / 1e9:.0f} GB", flush=True)
    serve = serve_arch(A16C_ARCH, device, peaks, extras=True)
    if serve["serve_peak_memory_gb"] >= CARD_GB:
        raise AssertionError(f"{A16C_ARCH}'s serving peak "
                             f"{serve['serve_peak_memory_gb']} GB")
    torch.cuda.empty_cache()
    full = get_config(A16C_ARCH)
    cut = dataclasses.replace(full, n_layers=A16C_TRAIN_LAYERS)
    print(f"cut: {A16C_ARCH}'s {full.n_params} parameters take about "
          f"{full.n_params * 16 / 1e9:.0f} GB with AdamW and the gradient "
          f"(bf16 weights and gradient, f32 moments and master), more than "
          f"the card's 80 GB; trained at full width with {cut.n_layers} "
          f"layers ({cut.n_params} parameters, about "
          f"{cut.n_params * 16 / 1e9:.1f} GB)", flush=True)
    train = train_arch(A16C_ARCH, device, peaks, A16C_TRAIN_BATCH,
                       [1] * A16C_TRAIN_STEPS, cfg=cut)
    e2e = train["e2e"]
    first, no_grad = e2e["train_losses"][0], e2e["train_loss_no_grad"]
    print(f"{A16C_ARCH} at {cut.n_layers} layers: first step's loss {first} "
          f"against the batch's loss without autograd {no_grad} (aux "
          f"{e2e['train_aux_no_grad']} at 1e-2): difference "
          f"{first - no_grad}", flush=True)
    if not all(math.isfinite(x) for x in e2e["train_losses"]) \
            or first != no_grad:
        raise AssertionError(f"{A16C_ARCH}'s training losses "
                             f"{e2e['train_losses']}, the batch's loss "
                             f"without autograd {no_grad}")
    serve["train_launches_per_step"] = train.pop("fwd_per_step")
    serve["train_layers"] = cut.n_layers
    torch.cuda.empty_cache()
    big = dataclasses.replace(get_config(A16C_BIG), n_layers=A16C_BIG_LAYERS)
    print(f"cut: {A16C_BIG}'s {get_config(A16C_BIG).n_params} parameters "
          f"take {get_config(A16C_BIG).n_params * 2 / 1e9:.1f} GB in bf16, "
          f"more than the card's 80 GB; served at full width with "
          f"{big.n_layers} layers ({big.n_params} parameters, "
          f"{big.n_params * 2 / 1e9:.2f} GB)", flush=True)
    big_serve = serve_arch(A16C_BIG, device, peaks, cfg=big)
    if big_serve["serve_peak_memory_gb"] >= CARD_GB:
        raise AssertionError(f"{A16C_BIG}'s serving peak "
                             f"{big_serve['serve_peak_memory_gb']} GB")
    torch.cuda.empty_cache()
    serve["smoke_run"] = smoke_run(A16C_ARCH, smoke_config(A16C_ARCH),
                                   device)
    big_serve["smoke_run"] = smoke_run(A16C_BIG, smoke_config(A16C_BIG),
                                       device)
    print(f"A16c phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return [serve, big_serve] + train["kernels"]


# --- A16g, A16h: the VLM family, "dots" remat, gradient compression -------

VLM_ARCH = "internvl2-76b"
#: (a) the served depths, the deeper first while its reckoned peak stays
#: under VLM_PEAK_LIMIT_GB (the card's 80 GB less a margin)
VLM_DEPTHS, VLM_PEAK_LIMIT_GB = (32, 24), 76.0
#: (a) the f32 checks at full width on VLM_F32_LAYERS layers, batch
#: SSM_F32_BATCH: "flash" against "xla" over the prefix and VLM_F32_SEQ
#: tokens (2048 positions: whole multiples of attn_kv_chunk 1024; 1024 +
#: 512 would be refused), and teacher-forced decode after the same prefill
#: against ``forward`` over the prefix and VLM_TF_FORWARD tokens, held to
#: SSM_F32_TOL
VLM_F32_LAYERS, VLM_F32_SEQ, VLM_TF_FORWARD = 2, 1024, 2048
#: (b) trained at full width cut to 2 of its 80 layers (weights, gradient
#: and AdamW state about 16 bytes a parameter: 61 GB at 2 layers, 88 at 4),
#: train_4k's sequence after the prefix, its batch of 256 cut to 2, 3 steps
VLM_TRAIN_LAYERS, VLM_TRAIN_BATCH, VLM_TRAIN_STEPS = 2, 2, 3
#: (c) qwen3-1.7b at train_4k's sequence, batch 8 in two microbatches, 2
#: steps under each remat policy; (d) 3 compressed steps at batch 8, keep
#: ratio COMPRESS_KEEP with int8
DOTS_STEPS, COMPRESS_STEPS, COMPRESS_KEEP = 2, 3, 0.05
#: (d) the leaf whose mask and kept values are held against the CPU's
COMPRESS_CPU_LEAF = ("blocks", "attn", "wk")


def vlm_serve_peak_gb(cfg, B: int, S: int, new: int) -> dict:
    """The reckoned serving peak of ``cfg`` at batch B x (prefix + S) +
    ``new``: the bf16 weights, the KV cache, and the largest transient of
    a prefill layer over its B (P + S) positions: the MLP's (2 d_ff) bf16
    product with its gate in f32 and the gate's SiLU in f32 (12 bytes a
    position and d_ff column), beside the residual stream and the norm's
    f32 temporaries (8 bytes a position and d_model column)."""
    T = B * (cfg.prefix_len + S)
    parts = {"weights": cfg.n_params * 2,
             "kv_cache": cfg.n_layers * B * (cfg.prefix_len + S + new)
             * cfg.n_kv * cfg.d_head * 2 * 2,
             "mlp_transient": T * cfg.d_ff * 12,
             "stream": T * cfg.d_model * 8}
    out = {k: v / 1e9 for k, v in parts.items()}
    out["total"] = sum(out.values())
    return out


def vlm_bf16_checks(params, cfg, tokens, embeds) -> dict:
    """At the served depth in bf16, printed and not held: the "flash"
    prefill against "xla" over the prefix and the whole prompt; only
    finite logits are held.  The tight checks run in f32
    (``vlm_f32_checks``)."""
    import dataclasses

    import torch
    from repro_torch.models import prefill
    P, S = embeds.shape[1], tokens.shape[1]
    lf = prefill(params, cfg, tokens, P + S, embeds=embeds)[0]
    lx = prefill(params, dataclasses.replace(cfg, attn_impl="xla"), tokens,
                 P + S, embeds=embeds)[0]
    out = {"flash_vs_xla_logit_rel_err": rel_err(lf[..., :cfg.vocab],
                                                 lx[..., :cfg.vocab])}
    finite = bool(lf.isfinite().all() and lx.isfinite().all())
    del lf, lx
    torch.cuda.empty_cache()
    print(f"{cfg.name} in bf16 at {cfg.n_layers} layers, batch "
          f"{tokens.shape[0]} x ({P} + {S}) (printed, not held): {out}",
          flush=True)
    if not finite:
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return out


def vlm_f32_checks(arch, tokens, device) -> dict:
    """``arch``'s published config in f32 cut to VLM_F32_LAYERS layers
    (weights from seed 0) at batch SSM_F32_BATCH with its patch embeddings
    (``lm_embeds``): the "flash" prefill (the f32 flash form) against
    "xla" over the prefix and VLM_F32_SEQ tokens, and teacher-forced decode
    after that prefill against ``forward`` over the prefix and
    VLM_TF_FORWARD tokens at the same positions, within SSM_F32_TOL."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, prefill
    cfg = dataclasses.replace(get_config(arch), dtype="float32",
                              n_layers=VLM_F32_LAYERS)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    embeds = lm_embeds(cfg, SSM_F32_BATCH, device)
    P = cfg.prefix_len
    short = tokens[:SSM_F32_BATCH, :VLM_F32_SEQ]
    with torch.inference_mode():
        lf = prefill(params, cfg, short, P + VLM_F32_SEQ, embeds=embeds)[0]
        lx = prefill(params, dataclasses.replace(cfg, attn_impl="xla"),
                     short, P + VLM_F32_SEQ, embeds=embeds)[0]
        out = {"f32_layers": VLM_F32_LAYERS,
               "f32_flash_vs_xla_logit_rel_err": rel_err(
                   lf[..., :cfg.vocab], lx[..., :cfg.vocab])}
        del lf, lx
        out["f32_teacher_forced_logit_rel_err"] = teacher_forced_vs_forward(
            params, cfg, tokens[:SSM_F32_BATCH], VLM_F32_SEQ,
            VLM_TF_FORWARD, embeds=embeds)
    del params, embeds
    torch.cuda.empty_cache()
    print(f"{arch} in f32 at full width, {VLM_F32_LAYERS} layers, batch "
          f"{SSM_F32_BATCH} x ({P} + {VLM_F32_SEQ}): {out}", flush=True)
    worst = max([out["f32_flash_vs_xla_logit_rel_err"]]
                + out["f32_teacher_forced_logit_rel_err"])
    if worst > SSM_F32_TOL:
        raise AssertionError(f"{arch} in f32: logits differ beyond "
                             f"{SSM_F32_TOL}")
    return out


def _lm_batches(cfg, n: int, device) -> list:
    """``n`` synthetic batches (seed 0) of qwen3-1.7b's training cell:
    TRAIN_BATCH x TRAIN_SEQ tokens on the card."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.train import device_batch
    data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH, seed=0))
    return [device_batch(data.batch_at(s), device) for s in range(n)]


def _timed_steps(step, params, state, batches, mb: int, cfg) -> dict:
    """``step`` over ``batches`` from the launch counts at 0 and the peak
    reset: each step's loss, gradient norm and host seconds (ending in a
    synchronize), launches (forward, dQ, dK/dV) a step, held to ``2 L mb``,
    ``L mb``, ``L mb``, and the peak memory."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, norms, secs, per_step, metrics = [], [], [], [], []
    for batch in batches:
        c0, t0 = _launch_counts(), time.perf_counter()
        params, state, m = step(params, state, batch)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(tuple(b - a for a, b in zip(c0, _launch_counts())))
        metrics.append(m)
    L = cfg.causal_attentions
    want = [(2 * L * mb, L * mb, L * mb)] * len(batches)
    if per_step != want:
        raise AssertionError(f"launches per step {per_step}, expected "
                             f"{want}")
    return {"params": params, "state": state, "losses": losses,
            "grad_norms": norms, "seconds": secs,
            "launches_per_step": per_step, "metrics": metrics,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def remat_dots_vs_full(device) -> dict:
    """(c) qwen3-1.7b at full width under ``remat_policy="dots"`` against
    ``"full"``: DOTS_STEPS steps of TRAIN_BATCH x TRAIN_SEQ in two
    microbatches each, from the same weights (seed 0) and batches.  The
    first step's loss must equal "full"'s bit for bit (the forward is the
    same); the later losses and the gradient norms are printed with
    whether they agree bit for bit (the backward's atomics may order sums
    differently from run to run), with each policy's step ms and peak,
    and a profiled third step's device busy ms, idle share and device
    ops."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    base = get_config(LM_ARCH)
    batches = _lm_batches(base, DOTS_STEPS, device)
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=DOTS_STEPS)
    runs = {}
    for policy in ("full", "dots"):
        cfg = dataclasses.replace(base, remat_policy=policy)
        torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator(device=device).manual_seed(
            0), device)
        step = make_train_step(cfg, ocfg, 2)
        run = _timed_steps(step, params, adamw_init(params), batches, 2,
                           cfg)
        prof = device_profile(lambda: step(run["params"], run["state"],
                                           batches[0]), None)
        run.update(device_busy_ms=prof["device_busy_ms"],
                   device_idle_share=prof["device_idle_share"],
                   device_ops=prof["device_ops"])
        del params, run["params"], run["state"], run["metrics"]
        runs[policy] = run
    del batches
    torch.cuda.empty_cache()
    full, dots = runs["full"], runs["dots"]
    out = {"steps": DOTS_STEPS, "microbatches": 2,
           "first_loss_equal": dots["losses"][0] == full["losses"][0],
           "losses_equal": dots["losses"] == full["losses"],
           "grad_norms_equal": dots["grad_norms"] == full["grad_norms"],
           **{f"{p}_{k}": runs[p][k] for p in runs
              for k in ("losses", "grad_norms", "seconds",
                        "launches_per_step", "peak_memory_gb",
                        "device_busy_ms", "device_idle_share",
                        "device_ops")},
           "full_step_ms": full["seconds"][-1] * 1e3,
           "dots_step_ms": dots["seconds"][-1] * 1e3}
    print(f"{LM_ARCH} remat 'dots' against 'full' at {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, 2 microbatches: losses {dots['losses']} | "
          f"{full['losses']}, gradient norms {dots['grad_norms']} | "
          f"{full['grad_norms']} (bit for bit: losses "
          f"{out['losses_equal']}, norms {out['grad_norms_equal']}); warm "
          f"step {out['dots_step_ms']:.3f} | {out['full_step_ms']:.3f} ms; "
          f"peak {dots['peak_memory_gb']:.3f} | {full['peak_memory_gb']:.3f}"
          f" GB; launches a step {dots['launches_per_step']}; a profiled "
          f"step's device busy {dots['device_busy_ms']:.3f} | "
          f"{full['device_busy_ms']:.3f} ms, idle "
          f"{dots['device_idle_share']:.4f} | "
          f"{full['device_idle_share']:.4f}, device ops "
          f"{dots['device_ops']} | {full['device_ops']}", flush=True)
    if not out["first_loss_equal"] or not all(
            math.isfinite(x) for x in dots["losses"]):
        raise AssertionError("remat 'dots' changed the forward's loss")
    return out


def compression_checks(grads, ef, out, keep: float, quantize: bool) -> dict:
    """One ``ef_compress_update`` on the card: on every leaf ``kept +
    residual`` against ``g + e`` (the residual is taken before ``kept`` is
    rounded to the gradient's dtype: equal bit for bit for f32 gradients,
    within that rounding, 2**-8 of |kept|, and the f32 sum's 2**-23 of |g +
    e| for bf16 ones), and on COMPRESS_CPU_LEAF the mask, the kept values
    and the residual against the CPU's from the same gradient, bit for
    bit."""
    import torch
    from repro_torch.optim import compression as C
    kept, res, _ = out
    worst, n_leaves = 0.0, 0
    # the four trees share their key order
    for g, e, k, r in zip(*map(_leaves, (grads, ef, kept, res)),
                          strict=True):
        gf = g.float() + e
        kf = k.float()
        diff = (kf + r - gf).abs()
        if g.dtype == torch.float32:
            if bool((diff != 0).any()):
                raise AssertionError(f"leaf {n_leaves}: kept + residual != "
                                     f"g + e")
        else:
            bound = 2.0 ** -8 * kf.abs() + 2.0 ** -23 * gf.abs()
            ratio = (diff / bound.clamp_min(1e-45)).max().item()
            worst = max(worst, ratio)
        n_leaves += 1
        del gf, kf, diff
    a, b, c = COMPRESS_CPU_LEAF
    g, e = grads[a][b][c], ef[a][b][c]
    cpu = C._one(g.cpu(), e.cpu(), keep, quantize)
    mask_card = C._topk_mask(g.float() + e, keep).cpu()
    mask_cpu = C._topk_mask(g.cpu().float() + e.cpu(), keep)
    same = {"mask": torch.equal(mask_card, mask_cpu),
            "kept": torch.equal(kept[a][b][c].cpu(), cpu[0]),
            "residual": torch.equal(res[a][b][c].cpu(), cpu[1])}
    out = {"leaves": n_leaves, "bf16_sum_bound_ratio": worst,
           "cpu_leaf": "/".join(COMPRESS_CPU_LEAF),
           "cpu_leaf_elements": g.numel(),
           "cpu_leaf_kept": int(mask_cpu.sum().item()),
           "cpu_leaf_equal": same}
    print(f"compression on the card: kept + residual against g + e on "
          f"{n_leaves} leaves (bf16 leaves within {worst:.3f} of the bound); "
          f"{out['cpu_leaf']} ({g.numel()} elements, {out['cpu_leaf_kept']} "
          f"kept) against the CPU: {same}", flush=True)
    if worst > 1 or not all(same.values()):
        raise AssertionError(f"compression on the card: {out}")
    return out


def compressed_steps(device) -> dict:
    """(d) qwen3-1.7b at full width through ``make_compressed_train_step``
    (keep COMPRESS_KEEP, int8): COMPRESS_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ against two exact steps of ``make_train_step`` from the same
    weights (seed 0) on the same batches.  Finite losses, the first equal
    to the exact step's bit for bit; the first step's compression held by
    ``compression_checks``; step ms of both, the compression's own ms
    (synchronized around each call), wire bytes (and the share of
    elements kept they imply: 1 + 4/8 bytes an element with int8) and
    peak memory, the checks' own temporaries left out of it, split into
    each step's peak before its compression (the update of the step
    before, the forward and backward) and the compression's own."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import (make_compressed_train_step,
                                   make_train_step)
    from repro_torch.train import steps as STEPS
    cfg = get_config(LM_ARCH)
    batches = _lm_batches(cfg, COMPRESS_STEPS, device)
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=COMPRESS_STEPS)
    torch.cuda.empty_cache()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    exact = _timed_steps(make_train_step(cfg, ocfg), params,
                         adamw_init(params), batches[:2], 1, cfg)
    del params, exact["params"], exact["state"], exact["metrics"]
    torch.cuda.empty_cache()
    real = STEPS.ef_compress_update
    seen = {"ms": [], "checks": None, "before": [], "own": []}

    def spy(grads, ef_state, keep_ratio, quantize):
        torch.cuda.synchronize()
        seen["before"].append(torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real(grads, ef_state, keep_ratio=keep_ratio,
                   quantize=quantize)
        torch.cuda.synchronize()
        seen["ms"].append((time.perf_counter() - t0) * 1e3)
        seen["own"].append(torch.cuda.max_memory_allocated() / 1e9)
        if seen["checks"] is None:
            seen["checks"] = compression_checks(grads, ef_state, out,
                                                keep_ratio, quantize)
        # the next count leaves the checks out
        torch.cuda.reset_peak_memory_stats()
        return out
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    step = make_compressed_train_step(cfg, ocfg, keep_ratio=COMPRESS_KEEP)
    STEPS.ef_compress_update = spy
    try:
        # no name here holds the first residual past the first step
        comp = _timed_steps(step, params, (adamw_init(params),
                                           step.init_extra(params)),
                            batches, 1, cfg)
    finally:
        STEPS.ef_compress_update = real
    wire = [m["compressed_wire_bytes"].item() for m in comp["metrics"]]
    peak_gb = max(seen["before"] + seen["own"]
                  + [torch.cuda.max_memory_allocated() / 1e9])
    del params, comp["params"], comp["state"], comp["metrics"]
    del batches
    torch.cuda.empty_cache()
    n_par = cfg.n_params
    out = {"keep_ratio": COMPRESS_KEEP, "steps": COMPRESS_STEPS,
           "losses": comp["losses"], "exact_losses": exact["losses"],
           "grad_norms": comp["grad_norms"],
           "seconds": comp["seconds"], "exact_seconds": exact["seconds"],
           "step_ms": statistics.median(comp["seconds"][1:]) * 1e3,
           "exact_step_ms": exact["seconds"][-1] * 1e3,
           "compression_ms": seen["ms"],
           "wire_bytes": wire, "dense_f32_bytes": 4 * n_par,
           "kept_share_from_wire": [w / 1.5 / n_par for w in wire],
           "peak_memory_gb": peak_gb,
           "peak_before_compression_gb": seen["before"],
           "peak_in_compression_gb": seen["own"],
           "exact_peak_memory_gb": exact["peak_memory_gb"],
           "launches_per_step": comp["launches_per_step"],
           "checks": seen["checks"]}
    print(f"{LM_ARCH} compressed (keep {COMPRESS_KEEP}, int8) at "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}: losses {comp['losses']} (exact "
          f"{exact['losses']}); warm step {out['step_ms']:.3f} ms against "
          f"the exact step's {out['exact_step_ms']:.3f} ms; compression "
          f"{[round(t, 3) for t in seen['ms']]} ms; wire bytes {wire} "
          f"(dense f32 {4 * n_par}; about "
          f"{[round(k, 4) for k in out['kept_share_from_wire']]} of the "
          f"elements kept); peak {peak_gb:.3f} GB (exact "
          f"{exact['peak_memory_gb']:.3f}; a step's before its compression "
          f"{[round(g, 3) for g in seen['before']]}, in it "
          f"{[round(g, 3) for g in seen['own']]})", flush=True)
    if comp["losses"][0] != exact["losses"][0] or not all(
            math.isfinite(x) for x in comp["losses"]):
        raise AssertionError(f"compressed losses {comp['losses']}, the "
                             f"exact step's first {exact['losses'][0]}")
    return out


def a16gh_phase(device, peaks) -> list:
    """(a) internvl2-76b (the VLM family: the dense blocks at 64 heads on 8
    KV heads, head dim 128, with 1024 positions of patch embeddings in
    front of the tokens) served at full width in bf16, cut to the deepest
    of VLM_DEPTHS whose reckoned peak stays under VLM_PEAK_LIMIT_GB
    (``serve_arch`` with ``extras``: batch 8 x (1024 + 4096) + 16 new; a
    flash launch a layer in prefill, none in decode; layer 0's flash
    output against its plain version beside SDPA and the bound at S 5120;
    the flash and GEMM shares of a prefill; "flash" against "xla" printed
    in bf16, and in f32 on 2 layers with teacher-forced decode, held to
    1e-3) with a peak under the card's 80 GB; (b) trained cut to
    VLM_TRAIN_LAYERS layers at 2 x (1024 + 4096) for 3 AdamW steps (4/2/2
    launches a step, both backward kernels against their plain version on
    layer 0, the first loss equal to the batch's loss without autograd);
    (c) qwen3-1.7b trained at full width under "dots" against "full"
    (``remat_dots_vs_full``); (d) with gradient compression
    (``compressed_steps``); (e) internvl2-76b's SMOKE config (a 60-token
    prompt after its 4-position prefix) and qwen3-1.7b's under "dots" and
    with compression served and trained on the card against the CPU
    (``smoke_run``)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config, smoke_config
    t0 = time.perf_counter()
    full = get_config(VLM_ARCH)
    print(f"A16g: {VLM_ARCH} ({full.family}: {full.n_layers} layers, H "
          f"{full.n_heads} on Hkv {full.n_kv}, d_head {full.d_head}, ff "
          f"{full.d_ff}, a {full.prefix_len}-position prefix; "
          f"{full.n_params} parameters by the reference's formula, "
          f"{full.n_params * 2 / 1e9:.2f} GB in bf16)", flush=True)
    cut = None
    for depth in VLM_DEPTHS:
        cfg = dataclasses.replace(full, n_layers=depth)
        peak = vlm_serve_peak_gb(cfg, LM_BATCH, LM_PROMPT, LM_NEW)
        fits = peak["total"] < VLM_PEAK_LIMIT_GB
        parts = {k: round(v, 2) for k, v in peak.items() if k != "total"}
        print(f"cut: {VLM_ARCH} at {depth} layers reckons a serving peak of "
              f"{peak['total']:.2f} GB (GB: {parts}) at batch {LM_BATCH} x "
              f"({full.prefix_len} + {LM_PROMPT}) + {LM_NEW}: "
              f"{'under' if fits else 'not under'} {VLM_PEAK_LIMIT_GB} GB",
              flush=True)
        if fits:
            cut = cfg
            break
    if cut is None:
        raise AssertionError(f"no depth of {VLM_DEPTHS} fits")
    print(f"served {VLM_ARCH} at full width with {cut.n_layers} of its "
          f"{full.n_layers} layers ({cut.n_params} parameters, "
          f"{cut.n_params * 2 / 1e9:.2f} GB)", flush=True)
    serve = serve_arch(VLM_ARCH, device, peaks, extras=True, cfg=cut)
    if serve["serve_peak_memory_gb"] >= CARD_GB:
        raise AssertionError(f"{VLM_ARCH}'s serving peak "
                             f"{serve['serve_peak_memory_gb']} GB")
    serve["serve_layers"] = cut.n_layers
    torch.cuda.empty_cache()
    tcut = dataclasses.replace(full, n_layers=VLM_TRAIN_LAYERS)
    print(f"cut: {VLM_ARCH}'s weights, gradient and AdamW state take about "
          f"{full.n_params * 16 / 1e9:.0f} GB (16 bytes a parameter), "
          f"{dataclasses.replace(full, n_layers=4).n_params * 16 / 1e9:.1f}"
          f" GB at 4 layers; trained at full width with "
          f"{tcut.n_layers} layers ({tcut.n_params} parameters, about "
          f"{tcut.n_params * 16 / 1e9:.1f} GB)", flush=True)
    train = train_arch(VLM_ARCH, device, peaks, VLM_TRAIN_BATCH,
                       [1] * VLM_TRAIN_STEPS, cfg=tcut)
    e2e = train["e2e"]
    first, no_grad = e2e["train_losses"][0], e2e["train_loss_no_grad"]
    print(f"{VLM_ARCH} at {tcut.n_layers} layers: first step's loss {first} "
          f"against the batch's loss without autograd {no_grad}; "
          f"{VLM_TRAIN_BATCH * (full.prefix_len + TRAIN_SEQ)} positions a "
          f"step", flush=True)
    if not all(math.isfinite(x) for x in e2e["train_losses"]) \
            or first != no_grad:
        raise AssertionError(f"{VLM_ARCH}'s training losses "
                             f"{e2e['train_losses']}, the batch's loss "
                             f"without autograd {no_grad}")
    serve["train_launches_per_step"] = train.pop("fwd_per_step")
    serve["train_layers"] = tcut.n_layers
    torch.cuda.empty_cache()
    serve["remat_dots"] = remat_dots_vs_full(device)
    torch.cuda.empty_cache()
    serve["compressed"] = compressed_steps(device)
    torch.cuda.empty_cache()
    small = smoke_config(LM_ARCH)
    serve["smoke_runs"] = [
        smoke_run(VLM_ARCH, smoke_config(VLM_ARCH), device),
        smoke_run(f"{LM_ARCH} dots", dataclasses.replace(
            small, remat_policy="dots"), device),
        smoke_run(f"{LM_ARCH} compress {COMPRESS_KEEP}", small, device,
                  compress=COMPRESS_KEEP)]
    print(f"A16g/h phase: {time.perf_counter() - t0:.3f} s", flush=True)
    return [serve] + train["kernels"]


#: the multi-device cases: (label, program, mesh shape, mesh axes, axis_map)
#: — four logical shards on one card along the stream, 2×2 over the
#: stream and the first blocked axis, the periodic wave on a 4-shard ring
DIST_CASES = (
    ("diffusion2d", "diffusion2d", (4,), ("d",), (("d",), None)),
    ("hotspot3d", "hotspot3d", (2, 2), ("a", "b"), (("a",), ("b",), None)),
    ("wave2d", "wave2d", (4,), ("d",), (("d",), None)),
)


# --- A16i: LM serving on a mesh --------------------------------------------

#: (a) qwen3-moe-30b-a3b on a (1, 4) mesh of logical shards of the card:
#: prefill through the all-to-all route (4 expert shards), decode through
#: the broadcast route; (b) qwen3-1.7b on (2, 2): two data shards and the
#: KV cache split on its sequence
A16I_MOE_MESH, A16I_DENSE_MESH = (1, 4), (2, 2)
#: (a) layer 0's route with real activations, held on the card against the
#: CPU in f32 on the first A16I_ROUTE_ROWS rows of A16I_ROUTE_SEQ positions
#: (the same inputs, a shortened batch), within A16I_TOL relative L2
A16I_ROUTE_ROWS, A16I_ROUTE_SEQ, A16I_TOL = 1, 2048, 1e-3
#: (b) the f32 hold: qwen3-1.7b at full width cut to A16I_F32_LAYERS layers,
#: batch SSM_F32_BATCH x A16I_F32_SEQ + A16I_F32_NEW, on the mesh against
#: no mesh, within A16I_TOL
A16I_F32_LAYERS, A16I_F32_SEQ, A16I_F32_NEW = 2, 512, 8
#: (a) the launchers' default mesh on a one-card machine, (1, 1): one
#: expert shard, the all-to-all route in prefill, decode and training;
#: the capacity reckoning (``capacity_reckoning``) of a prefill is printed
#: in full at layers 0 and A16I_DEEP_LAYER
A16I_ONE_MESH, A16I_DEEP_LAYER = (1, 1), 35
#: (a) training under the launchers' default mesh: qwen3-moe-30b-a3b at
#: full width cut to A16C_TRAIN_LAYERS layers, A16C_TRAIN_BATCH x
#: TRAIN_SEQ, A16I_TRAIN_STEPS AdamW steps
A16I_TRAIN_STEPS = 2
#: the A16i-train phase.  (a) qwen3-1.7b at full width (bf16) trained
#: through the launcher's setup on an A16I_DP_MESH mesh of logical shards
#: of the card (two data shards of TRAIN_BATCH / 2 rows at TRAIN_SEQ),
#: A16I_DP_STEPS AdamW steps, against the same steps with no mesh; then cut
#: to A16I_F32_LAYERS layers in f32 at A16I_DP_F32_BATCH x A16I_DP_F32_SEQ,
#: held within A16I_TOL of no mesh (losses, gradient norms, parameters).
#: (b) with two or more cards: A16I_CARDS_ARCH at full width and depth on
#: (n, 1) over the n cards, A16I_CARDS_STEPS steps at TRAIN_BATCH x
#: TRAIN_SEQ
A16I_DP_MESH, A16I_DP_STEPS = (2, 2), 3
A16I_DP_F32_BATCH, A16I_DP_F32_SEQ = 4, 1024
A16I_CARDS_ARCH, A16I_CARDS_STEPS = "granite-3-8b", 2


def capacity_reckoning(calls, log, cfg, n_ep: int) -> dict:
    """Hold each all-to-all call's kept (token, pick) pairs
    (``moe.DROP_LOG``) to what the capacity rule alone keeps, reckoned by
    counts from the expert ids each of its shards routed (``RouteLog``:
    a call's ``n_dp * n_ep`` route calls come together, shards row-major;
    a call's ``T`` is a shard's routed rows, ``n_dp`` its pairs over
    ``n_ep T k``; route calls of no all-to-all call, the broadcast
    route's, come after the last): a shard's send buffer for expert shard
    ``j`` keeps its pairs for ``j``'s experts in ascending expert order
    (the stable sort's) until ``C_s`` are kept, and expert shard ``j``
    keeps each local expert's first ``C_e`` of what its senders kept.
    ``C_s`` and ``C_e`` come from the rule's formula, written out here.
    Returns per-call rows (pairs, kept, dropped at the send and at the
    expert, ``C_s``, ``C_e``, the most pairs a shard sent one expert
    shard, the most an expert received, the experts past ``C_e``, the
    busiest expert's load over the mean); raises where a call kept
    another number of pairs."""
    import torch
    E, k = cfg.n_experts, cfg.top_k
    e_loc = E // n_ep
    rows, bad, at = [], [], 0
    for n, entry in enumerate(log):
        T = calls[at].shape[0]
        n_dp = entry["pairs"] // (n_ep * T * k)
        ids = calls[at:at + n_dp * n_ep]
        at += n_dp * n_ep
        c_s = max(8, -(-(T * k * int(8 * cfg.moe_capacity)) // (8 * n_ep)))
        c_s = -(-c_s // 8) * 8
        c_e = max(8, -(-(n_ep * c_s) // e_loc))
        kept1 = kept2 = max_send = max_recv = over = 0
        load = torch.zeros(E, dtype=torch.long)
        for d in range(n_dp):
            recv = torch.zeros(E, dtype=torch.long)
            for m in range(n_ep):
                cnt = torch.bincount(ids[d * n_ep + m].reshape(-1).cpu(),
                                     minlength=E)
                load += cnt
                c = cnt.view(n_ep, e_loc)
                before = c.cumsum(1) - c
                recv += torch.minimum(c, (c_s - before).clamp(min=0)) \
                    .reshape(-1)
                max_send = max(max_send, int(c.sum(1).max()))
            max_recv = max(max_recv, int(recv.max()))
            over += int((recv > c_e).sum())
            kept1 += int(recv.sum())
            kept2 += int(recv.clamp(max=c_e).sum())
        pairs = sum(x.numel() for x in ids)
        if entry["pairs"] != pairs or int(entry["processed"]) != kept2 \
                or any(x.shape[0] != T for x in ids):
            bad.append(n)
        rows.append({"call": n, "pairs": pairs,
                     "kept": int(entry["processed"]), "rule_kept": kept2,
                     "dropped_at_send": pairs - kept1,
                     "dropped_at_expert": kept1 - kept2,
                     "c_s": c_s, "c_e": c_e,
                     "max_sent_to_a_shard": max_send,
                     "max_received_by_an_expert": max_recv,
                     "experts_past_c_e": over,
                     "max_load_over_mean": float(load.max()) * E / pairs})
    if bad:
        raise AssertionError(f"all-to-all calls kept other pairs than the "
                             f"capacity rule: {[rows[i] for i in bad]}")
    return rows


def capacity_summary(rows) -> dict:
    """``capacity_reckoning``'s rows of one pass over the layers, for the
    kernels line: the capacities, the drops at each stage, the busiest
    expert's load a layer, and layers 0 and A16I_DEEP_LAYER in full."""
    return {"c_s": rows[0]["c_s"], "c_e": rows[0]["c_e"],
            "pairs": sum(r["pairs"] for r in rows),
            "dropped_at_send": sum(r["dropped_at_send"] for r in rows),
            "dropped_at_expert": sum(r["dropped_at_expert"] for r in rows),
            "max_load_over_mean": [r["max_load_over_mean"] for r in rows],
            "layer0": rows[0],
            "deep_layer": rows[min(A16I_DEEP_LAYER, len(rows) - 1)]}


def _mesh_run(label, cfg, params, tokens, new, mesh, smi, drops=False,
              reckon=False):
    """One ``generate`` (``mesh`` ``None``: one device) with the launch
    counts at 0 just before and read just after: its times, launches,
    peak memory and, with ``drops``, the (token, pick) pairs that the
    all-to-all route dropped a layer (``moe.DROP_LOG``); with ``reckon``
    also the prefill's drops held to the capacity rule
    (``capacity_reckoning``, its routes read by ``RouteLog``)."""
    import contextlib

    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import moe as MOE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    MOE.DROP_LOG = [] if drops else None
    with (RouteLog() if reckon else contextlib.nullcontext()) as routes:
        out = generate(cfg, params, tokens, new, mesh=mesh)
    log, MOE.DROP_LOG = MOE.DROP_LOG, None
    B, S = tokens.shape
    res = {"prefill_ms": out.prefill_s * 1e3,
           "prefill_tok_per_s": B * S / out.prefill_s,
           "decode_ms_per_step": out.decode_s * 1e3 / (new - 1),
           "prefill_launches": out.prefill_launches,
           "decode_launches": out.decode_launches,
           "launches": _launch_counts()[0],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if log is not None:
        # the prefill's calls come first, one a layer on one data shard;
        # on one expert shard decode takes the all-to-all route too
        pre = log[:cfg.n_layers]
        per = [(e["pairs"] - int(e["processed"])) / e["pairs"] for e in pre]
        res["a2a_calls"] = len(log)
        res["dropped_share_per_layer"] = per
        res["dropped_share"] = sum(e["pairs"] - int(e["processed"])
                                   for e in pre) / max(
                                       1, sum(e["pairs"] for e in pre))
        res["dropped_all_calls"] = sum(e["pairs"] - int(e["processed"])
                                       for e in log)
    print(f"  {label}: prefill {res['prefill_ms']:.3f} ms "
          f"({res['prefill_tok_per_s']:.1f} tok/s), decode "
          f"{res['decode_ms_per_step']:.3f} ms/step; flash launches "
          f"{out.prefill_launches} + {out.decode_launches}; peak "
          f"{res['peak_memory_gb']:.3f} GB"
          + (f"; the prefill dropped {res['dropped_share']:.5f} of (token, "
             f"pick) pairs, per layer {[round(x, 5) for x in per]}; "
             f"{res['dropped_all_calls']} pairs dropped over all "
             f"{len(log)} all-to-all calls" if log is not None else "")
          + f" [{smi}]", flush=True)
    if reckon:
        rows = capacity_reckoning(routes.calls, log, cfg,
                                  mesh.shape["model"])
        pre = rows[:cfg.n_layers]       # the prefill's calls, a layer each
        res["capacity"] = capacity_summary(pre)
        print(f"  {label}: each of {len(rows)} all-to-all calls kept the "
              f"pairs the capacity rule keeps; in prefill (C_s "
              f"{pre[0]['c_s']}, C_e {pre[0]['c_e']}) dropped at the send "
              f"{sum(r['dropped_at_send'] for r in pre)}, at the expert "
              f"{sum(r['dropped_at_expert'] for r in pre)} of "
              f"{sum(r['pairs'] for r in pre)} pairs; busiest expert's load "
              f"over the mean a layer "
              f"{[round(r['max_load_over_mean'], 2) for r in pre]}",
              flush=True)
        for r in (pre[0], pre[min(A16I_DEEP_LAYER, len(pre) - 1)]):
            print(f"    layer {r['call']}: {r}", flush=True)
    return out, res


def _at_rest(cfg, params, mesh, B, S_max):
    """Bytes each mesh position holds at rest: the parameters placed by
    ``param_axes`` and the KV cache by ``cache_axes`` (as a device of the
    mesh would hold them; on one card the pieces are views)."""
    import math

    import torch
    from repro_torch.models.transformer import cache_axes, param_axes
    from repro_torch.parallel.sharding import (bytes_by_position,
                                               default_rules, resolve_spec,
                                               shard_tree)
    rules = default_rules()
    placed = shard_tree(params, param_axes(cfg), mesh, rules)
    per = bytes_by_position(placed, mesh)
    kv_shape = (cfg.causal_attentions, B, S_max, cfg.n_kv, cfg.d_head)
    spec = resolve_spec(kv_shape, cache_axes(cfg)["k"], mesh, rules)
    split = math.prod(math.prod(mesh.shape[a] for a in
                                ((v,) if isinstance(v, str) else v))
                      for v in spec if v is not None)
    kv = 2 * math.prod(kv_shape) * torch.empty((), dtype=cfg.tdtype) \
        .element_size() // split
    return {"params_gb": [per[p] / 1e9 for p in sorted(per)],
            "kv_cache_gb": kv / 1e9, "kv_spec": [str(v) for v in spec]}


def _layer0_moe_input(params, cfg, tokens):
    """Layer 0's MoE input (its normed residual after attention) for
    ``tokens``, and layer 0's MoE weights."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models.attention import self_attention
    from repro_torch.models.transformer import _embed, _unstack
    bp = _unstack(params["blocks"], cfg.n_layers)[0]
    x = _embed(params, cfg, tokens, None)
    pos = torch.arange(x.shape[1], device=x.device)
    x = x + self_attention(L.rms_norm(x, bp["ln1"], cfg.norm_eps),
                           bp["attn"], cfg, pos)
    return L.rms_norm(x, bp["ln2"], cfg.norm_eps), bp["moe"]


def a16i_route_check(params, cfg, tokens, device, smi) -> dict:
    """Layer 0's all-to-all route on the (1, 4) mesh with real
    activations (layer 0's MoE input over the first A16I_ROUTE_ROWS x
    A16I_ROUTE_SEQ tokens): on the card in f32 against the CPU in f32
    (the same inputs and weights, cast), held within A16I_TOL; the card's
    bf16 route against the CPU's f32 printed; the dropped pairs of each."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.parallel.sharding import default_rules
    rules = default_rules()
    with torch.inference_mode():
        xn, p = _layer0_moe_input(params, cfg, tokens[:A16I_ROUTE_ROWS,
                                                       :A16I_ROUTE_SEQ])
        outs = {}
        for label, where, dt in (("card_bf16", device, None),
                                 ("card_f32", device, torch.float32),
                                 ("cpu_f32", torch.device("cpu"),
                                  torch.float32)):
            mesh = make_mesh(A16I_MOE_MESH, ("data", "model"),
                             [where] * int(np.prod(A16I_MOE_MESH)))
            x = xn.to(where, dt or xn.dtype)
            q = {k: v.to(where, torch.float32 if k == "router" else
                         (dt or v.dtype)) for k, v in p.items()}
            MOE.DROP_LOG = []
            out, aux = MOE.ep_a2a_path(x, q, cfg, mesh, rules)
            log, MOE.DROP_LOG = MOE.DROP_LOG, None
            outs[label] = (out.float().cpu(), float(aux),
                           log[0]["pairs"] - int(log[0]["processed"]))
            del x, q, out
    want = outs["cpu_f32"][0]
    res = {"route_f32_rel_err": rel_err(outs["card_f32"][0], want),
           "route_bf16_rel_err": rel_err(outs["card_bf16"][0], want),
           "route_dropped": {k: v[2] for k, v in outs.items()},
           "route_aux": {k: v[1] for k, v in outs.items()},
           "route_tokens": A16I_ROUTE_ROWS * A16I_ROUTE_SEQ}
    print(f"  layer 0's all-to-all route ({A16I_ROUTE_ROWS} x "
          f"{A16I_ROUTE_SEQ} tokens of real activations, mesh "
          f"{A16I_MOE_MESH}): card f32 against CPU f32 rel L2 "
          f"{res['route_f32_rel_err']:.3g}, card bf16 against CPU f32 "
          f"{res['route_bf16_rel_err']:.3g}; pairs dropped "
          f"{res['route_dropped']}; aux {res['route_aux']} [{smi}]",
          flush=True)
    if res["route_f32_rel_err"] > A16I_TOL:
        raise AssertionError(f"layer 0's route on the card differs from "
                             f"the CPU's beyond {A16I_TOL}")
    return res


def a16i_phase(device, peaks, smi) -> dict:
    """(a) qwen3-moe-30b-a3b at full width (bf16) served by ``generate`` at
    batch LM_BATCH x LM_PROMPT + LM_NEW on a (1, 4) mesh of logical shards
    of the card (prefill: the all-to-all route, 4 expert shards, capacity
    1.25; decode: the broadcast route) and with no mesh in the same run:
    prefill ms, decode ms a step (each path run cold, then warm: the warm
    run's), pairs dropped a layer and in all, held layer by layer to the
    capacity rule (``capacity_reckoning``), flash launches (48 + 0
    both), bytes at rest a shard, peak memory; once more on the
    launchers' default one-card mesh (1, 1); layer 0's route held on the
    card against the CPU in f32 (``a16i_route_check``); trained cut in
    depth on (1, 1) (``a16i_train_check``) and both launchers at the
    smoke width with their default mesh (``a16i_launcher_check``).
    (b) qwen3-1.7b at full width on a (2, 2) mesh (two data shards, the KV
    cache split on its sequence over ``model``) against no mesh: 56 + 0
    flash launches (28 a data shard), the bf16 greedy tokens and each
    pick's logits printed (``_against_no_mesh``); the same at 2 layers in
    f32 held within A16I_TOL with the tokens equal.  Returns each arch's
    figures for its flash entry."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    t0 = time.perf_counter()
    out = {}
    B, S, new = LM_BATCH, LM_PROMPT, LM_NEW
    for arch, shape in ((A16C_ARCH, A16I_MOE_MESH),
                        (LM_ARCH, A16I_DENSE_MESH)):
        cfg = get_config(arch)
        mesh = make_mesh(shape, ("data", "model"),
                         [device] * int(np.prod(shape)))
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            1, cfg.vocab, (B, S), dtype=np.int32)).long().to(device)
        torch.cuda.empty_cache()
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
        rest = _at_rest(cfg, params, mesh, B, S + new)
        print(f"A16i: {arch} on a {shape} mesh of logical shards of the "
              f"card, batch {B} x {S} + {new}: parameters at rest a shard "
              f"{[round(x, 3) for x in rest['params_gb']]} GB, KV cache a "
              f"shard {rest['kv_cache_gb']:.3f} GB (spec {rest['kv_spec']}) "
              f"[{smi}]", flush=True)
        moe = cfg.family == "moe"
        _mesh_run(f"{arch} no mesh (cold)", cfg, params, toks, new, None,
                  smi)
        plain, one = _mesh_run(f"{arch} no mesh (warm)", cfg, params, toks,
                               new, None, smi)
        _, cold = _mesh_run(f"{arch} mesh {shape} (cold)", cfg, params,
                            toks, new, mesh, smi, drops=moe, reckon=moe)
        meshed, res = _mesh_run(f"{arch} mesh {shape} (warm)", cfg, params,
                                toks, new, mesh, smi, drops=moe)
        if moe:
            res["capacity"] = cold["capacity"]
        n_data = shape[0]
        want = (cfg.causal_attentions * n_data, 0)
        for label, r in (("no mesh", one), ("mesh", res)):
            got = (r["prefill_launches"], r["decode_launches"])
            w = want if label == "mesh" else (cfg.causal_attentions, 0)
            if got != w or r["launches"] != w[0]:
                raise AssertionError(f"{arch} {label}: flash launches {got}, "
                                     f"{r['launches']} in all; expected {w}")
        if not bool(meshed.logits.isfinite().all()) or not bool(
                ((meshed.tokens >= 0) & (meshed.tokens < cfg.vocab)).all()):
            raise AssertionError(f"{arch} on the mesh: non-finite logits or "
                                 f"tokens outside the vocab")
        res.update({"mesh": list(shape), "at_rest": rest, "no_mesh": one,
                    **_against_no_mesh(f"{arch} bf16, mesh {shape}",
                                       meshed, plain, cfg.vocab, smi)})
        del meshed
        if moe:
            torch.cuda.empty_cache()
            ones = make_mesh(A16I_ONE_MESH, ("data", "model"), [device])
            single, res["one_mesh"] = _mesh_run(
                f"{arch} mesh {A16I_ONE_MESH}, the launchers' default on "
                f"one card (one run)", cfg, params, toks, new, ones, smi,
                drops=True, reckon=True)
            res["one_mesh"].update(_against_no_mesh(
                f"{arch} bf16, mesh {A16I_ONE_MESH}", single, plain,
                cfg.vocab, smi))
            del single
        del plain
        if moe:
            res.update(a16i_route_check(params, cfg, toks, device, smi))
        del params
        torch.cuda.empty_cache()
        if moe:
            res["one_mesh_train"] = a16i_train_check(device, smi)
            res["launchers"] = a16i_launcher_check(device, smi)
        else:
            res.update(a16i_f32_check(cfg, mesh, toks, device, smi))
        out[arch] = res
    print(f"A16i phase: {time.perf_counter() - t0:.3f} s [{smi}]",
          flush=True)
    return out


def _against_no_mesh(label, meshed, plain, V, smi) -> dict:
    """A meshed ``generate`` against the one-device one on the same
    inputs: each pick's logits' relative L2 (pick 0 the prefill's, the
    rest decode steps', which read different contexts once a token
    differs), whether the prefill's are bit for bit, and the share of
    greedy tokens equal."""
    import torch
    per = [rel_err(meshed.logits[:, i, :V], plain.logits[:, i, :V])
           for i in range(meshed.logits.shape[1])]
    res = {"first_logits_rel_err": per[0],
           "first_logits_bit_equal": bool(torch.equal(
               meshed.logits[:, 0], plain.logits[:, 0])),
           "logits_rel_err_per_pick": per,
           "decode_logits_rel_err_max": max(per[1:], default=0.0),
           "tokens_equal": float((meshed.tokens == plain.tokens).float()
                                 .mean()),
           "first_pick_equal": float((meshed.tokens[:, 0] ==
                                      plain.tokens[:, 0]).float().mean())}
    print(f"  {label} against no mesh: prefill logits bit for bit "
          f"{res['first_logits_bit_equal']}, rel L2 {per[0]:.4g}; decode "
          f"picks' logits rel L2 {[float(f'{x:.4g}') for x in per[1:]]}; "
          f"first picks equal {res['first_pick_equal']:.3f}, all greedy "
          f"tokens equal {res['tokens_equal']:.3f} [{smi}]", flush=True)
    return res


def a16i_train_check(device, smi) -> dict:
    """Training under the launchers' default mesh on one card
    (``launch.train.training_mesh`` of no shape: (1, 1) on a one-card
    machine): qwen3-moe-30b-a3b at full width cut to A16C_TRAIN_LAYERS
    layers, A16I_TRAIN_STEPS AdamW steps at A16C_TRAIN_BATCH x TRAIN_SEQ
    under its rules, so each MoE layer's forward and backward take the
    all-to-all route under autograd: (2c, c, c) flash launches a step,
    finite losses, the first bit for bit the batch's loss under the same
    rules without autograd, whose all-to-all calls keep the capacity
    rule's pairs (``capacity_reckoning``); the pairs it dropped, the
    busiest expert's load, the commonest token's share of the batch (the
    pipeline's tokens are Zipf-distributed) and the distance from the
    grouped route's loss printed."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.train import device_batch, training_mesh
    from repro_torch.models import init_params, lm_loss
    from repro_torch.models import moe as MOE
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import use_sharding_rules
    from repro_torch.train import make_train_step
    cut = dataclasses.replace(get_config(A16C_ARCH),
                              n_layers=A16C_TRAIN_LAYERS)
    mesh, rules = training_mesh(None, device, cut)
    params = init_params(cut, torch.Generator(device=device).manual_seed(0),
                         device)
    opt = adamw_init(params)
    data = SyntheticLMDataset(DataConfig(vocab=cut.vocab, seq_len=TRAIN_SEQ,
                                         global_batch=A16C_TRAIN_BATCH,
                                         seed=0))
    batches = [device_batch(data.batch_at(s), device)
               for s in range(A16I_TRAIN_STEPS)]
    step = make_train_step(cut, AdamWConfig(lr=1e-4, warmup_steps=2,
                                            total_steps=A16I_TRAIN_STEPS))
    with torch.no_grad():
        grouped = lm_loss(params, cut, batches[0]).item()
        MOE.DROP_LOG = []
        with use_sharding_rules(mesh, rules), RouteLog() as routes:
            loss0 = lm_loss(params, cut, batches[0]).item()
        log, MOE.DROP_LOG = MOE.DROP_LOG, None
    rows = capacity_reckoning(routes.calls, log, cut, mesh.shape["model"])
    dropped = sum(e["pairs"] - int(e["processed"]) for e in log) / sum(
        e["pairs"] for e in log)
    tokens = batches[0]["tokens"]
    top = torch.bincount(tokens.reshape(-1)).max().item() / tokens.numel()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    losses, secs = [], []
    with use_sharding_rules(mesh, rules):
        for batch in batches:
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            losses.append(metrics["loss"].item())
            secs.append(time.perf_counter() - t0)
    launches = _launch_counts()
    L = cut.causal_attentions
    res = {"mesh": dict(mesh.shape), "layers": cut.n_layers,
           "batch": [A16C_TRAIN_BATCH, TRAIN_SEQ], "losses": losses,
           "loss_no_grad": loss0, "grouped_loss_no_grad": grouped,
           "dropped_share": dropped, "a2a_calls_no_grad": len(log),
           "capacity": capacity_summary(rows), "top_token_share": top,
           "step_s": secs, "launches": list(launches),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, opt
    torch.cuda.empty_cache()
    print(f"  {A16C_ARCH} at {cut.n_layers} layers trained on {mesh} (the "
          f"launchers' default on one card), {A16C_TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: losses {losses}, the batch's loss without "
          f"autograd under the rules {loss0} (grouped route {grouped}; "
          f"{dropped:.5f} of pairs dropped over {len(log)} all-to-all "
          f"calls, each the capacity rule's count: C_e {rows[0]['c_e']}, "
          f"busiest expert's load over the mean a layer "
          f"{[round(r['max_load_over_mean'], 2) for r in rows]}, the "
          f"commonest token {top:.3f} of the batch's); seconds a step "
          f"{secs}; launches {launches}; peak "
          f"{res['peak_memory_gb']:.3f} GB [{smi}]", flush=True)
    want = tuple(n * A16I_TRAIN_STEPS for n in (2 * L, L, L))
    if launches != want or not all(math.isfinite(x) for x in losses) \
            or losses[0] != loss0 or not log:
        raise AssertionError(f"training on the launchers' default mesh: "
                             f"{res}; launches expected {want}")
    return res


def a16i_launcher_check(device, smi) -> dict:
    """``launch.serve.main`` and ``launch.train.main`` on
    qwen3-moe-30b-a3b's smoke config as a user calls them on a one-card
    machine (no ``--mesh-shape``, no ``--device``: the default mesh,
    (1, 1) over the card), so prefill, decode (one expert shard divides a
    step's one token) and training take the all-to-all route: its calls
    (``moe.DROP_LOG``, one a layer a step) and the flash launches counted,
    the tokens and losses finite."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe as MOE
    cfg = smoke_config(A16C_ARCH)
    flags = [] if torch.cuda.device_count() == 1 else ["--device",
                                                       str(device)]
    _zero_launch_counts()
    MOE.DROP_LOG = []
    gen = launch_serve.main(["--arch", A16C_ARCH, "--smoke", "--max-new",
                             "4", *flags])
    serve_calls, MOE.DROP_LOG = len(MOE.DROP_LOG), []
    serve_launches = _launch_counts()
    events = launch_train.main(["--arch", A16C_ARCH, "--smoke", "--steps",
                                "3", "--batch", "4", "--seq", "64", *flags])
    train_calls, MOE.DROP_LOG = len(MOE.DROP_LOG), None
    train_launches = tuple(b - a for a, b in zip(serve_launches,
                                                 _launch_counts()))
    res = {"serve_a2a_calls": serve_calls, "serve_launches":
           [gen.prefill_launches, gen.decode_launches],
           "train_a2a_calls": train_calls,
           "train_launches": list(train_launches),
           "train_losses": events["losses"]}
    print(f"  launchers on {A16C_ARCH}'s smoke config, default mesh: serve "
          f"{serve_calls} all-to-all calls, flash {gen.prefill_launches} + "
          f"{gen.decode_launches}; train losses {events['losses']}, "
          f"{train_calls} all-to-all calls, launches {train_launches} "
          f"[{smi}]", flush=True)
    L = cfg.causal_attentions
    if serve_calls != 4 * cfg.n_layers or (gen.prefill_launches,
                                       gen.decode_launches) != (L, 0) \
            or train_calls < 3 * cfg.n_layers or not all(train_launches) \
            or not all(math.isfinite(x) for x in events["losses"]) \
            or not bool(((gen.tokens >= 0) & (gen.tokens < cfg.vocab))
                        .all()):
        raise AssertionError(f"the launchers' default mesh: {res}")
    return res


def a16i_f32_check(cfg, mesh, tokens, device, smi) -> dict:
    """``cfg`` in f32 cut to A16I_F32_LAYERS layers (seed 0), greedy
    ``generate`` of SSM_F32_BATCH x A16I_F32_SEQ + A16I_F32_NEW on
    ``mesh`` against no mesh: every pick's logits within A16I_TOL
    relative L2 and the tokens equal."""
    import dataclasses

    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import init_params
    cut = dataclasses.replace(cfg, n_layers=A16I_F32_LAYERS,
                              dtype="float32")
    params = init_params(cut, torch.Generator(device=device).manual_seed(0),
                         device)
    toks = tokens[:SSM_F32_BATCH, :A16I_F32_SEQ]
    plain = generate(cut, params, toks, A16I_F32_NEW)
    meshed = generate(cut, params, toks, A16I_F32_NEW, mesh=mesh)
    V = cut.vocab
    res = {"f32_layers": A16I_F32_LAYERS,
           "f32_logits_rel_err": rel_err(meshed.logits[..., :V],
                                         plain.logits[..., :V]),
           "f32_tokens_equal": bool(torch.equal(meshed.tokens,
                                                plain.tokens))}
    del params
    torch.cuda.empty_cache()
    print(f"  {cfg.name} f32 at {A16I_F32_LAYERS} layers, batch "
          f"{SSM_F32_BATCH} x {A16I_F32_SEQ} + {A16I_F32_NEW}, mesh against "
          f"no mesh: logits rel L2 {res['f32_logits_rel_err']:.3g}, tokens "
          f"equal {res['f32_tokens_equal']} [{smi}]", flush=True)
    if res["f32_logits_rel_err"] > A16I_TOL or not res["f32_tokens_equal"]:
        raise AssertionError(f"{cfg.name} in f32 on the mesh: {res}")
    return res


def _sync_all() -> None:
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _mesh_train_run(label, cfg, mesh, batches, smi) -> dict:
    """``cfg`` trained from seed 0 through ``launch.train``'s setup, one
    step a host batch: on ``mesh`` (``init_state``: the parameters, AdamW's
    state placed by ``param_axes``; ``placed_batch``; under the rules) or,
    with ``mesh`` None, whole on the card with no rules.  The first
    batch's loss without autograd (``step_loss``), then, the launch counts
    at 0 and each card's peak reset, the steps: the losses, gradient
    norms, seconds a step (each ending in a synchronize of every card),
    flash launches a step held to ``(2 L d, L d, L d)`` for ``d`` data
    shards, each card's bytes at rest and peak, the parameters after the
    steps."""
    import contextlib

    import torch
    from repro_torch.launch.train import (device_batch, init_state,
                                          placed_batch, state_tree,
                                          training_mesh)
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.parallel.sharding import (bytes_by_device,
                                               use_sharding_rules)
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import data_shards, step_loss
    device = torch.device("cuda", 0)
    ocfg = AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=len(batches))
    if mesh is None:
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
        state, step = adamw_init(params), make_train_step(cfg, ocfg)
        rules, n_data = None, 1
        batches = [device_batch(h, device) for h in batches]
    else:
        _, rules = training_mesh((1, 1), device, cfg)
        params, state, step = init_state(cfg, mesh, rules, 0, ocfg)
        n_data = len(data_shards(mesh, rules,
                                 batches[0]["tokens"].shape[0]))
        batches = [placed_batch(h, mesh, rules) for h in batches]
    rest = bytes_by_device(state_tree(params, state))
    cards = sorted({d for d in rest if d.type == "cuda"}, key=str)
    losses, norms, secs, per_step = [], [], [], []
    ctx = (use_sharding_rules(mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    with ctx:
        with torch.no_grad():
            loss0 = step_loss(params, cfg, batches[0]).item()
        _sync_all()
        for dev in cards:
            torch.cuda.reset_peak_memory_stats(dev)
        _zero_launch_counts()
        for batch in batches:
            c0, t0 = _launch_counts(), time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(m["loss"].item())
            norms.append(m["grad_norm"].item())
            _sync_all()
            secs.append(time.perf_counter() - t0)
            per_step.append(tuple(b - a for a, b in zip(c0,
                                                        _launch_counts())))
    L = cfg.causal_attentions
    want = [(2 * L * n_data, L * n_data, L * n_data)] * len(batches)
    res = {"mesh": None if mesh is None else dict(mesh.shape),
           "data_shards": n_data, "loss_no_grad": loss0, "losses": losses,
           "grad_norms": norms,
           "step_s": secs, "launches_per_step": [list(x) for x in per_step],
           "at_rest_gb": {str(d): rest[d] / 1e9 for d in cards},
           "peak_gb": {str(d): torch.cuda.max_memory_allocated(d) / 1e9
                       for d in cards}}
    print(f"  {label}: the first batch's loss without autograd {loss0}; "
          f"losses {losses}, grad norms "
          f"{[round(x, 4) for x in norms]}; seconds a step "
          f"{[round(x, 3) for x in secs]}; flash launches a step "
          f"{per_step[0]} ({n_data} data shard(s)); state at rest "
          f"{ {k: round(v, 3) for k, v in res['at_rest_gb'].items()} } GB, "
          f"peak { {k: round(v, 3) for k, v in res['peak_gb'].items()} } GB "
          f"[{smi}]", flush=True)
    if per_step != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label}: {res}; launches expected {want}")
    res["params"] = params
    return res


def _params_rel_err(got, want) -> float:
    """The largest relative L2 distance of a leaf of ``got`` (placed or
    whole) from ``want``'s."""
    from repro_torch.parallel.sharding import Sharded
    worst = 0.0
    for a, b in zip(_sorted_leaves(got), _sorted_leaves(want)):
        if isinstance(a, Sharded):
            a = a.gather(b.device)
        worst = max(worst, rel_err(a, b))
    return worst


def _sorted_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k])
    elif tree is not None:
        yield tree


def a16i_train_phase(smi) -> dict:
    """(a) qwen3-1.7b at full width (bf16) trained on an A16I_DP_MESH mesh
    of logical shards of the card, A16I_DP_STEPS steps at TRAIN_BATCH x
    TRAIN_SEQ, against the same steps with no mesh: losses, bytes at rest
    a shard, peak memory, step time and flash launches a step (two data
    shards: twice the no-mesh count, ``(4L, 2L, 2L)``); then the same
    model cut to A16I_F32_LAYERS layers in f32, held within A16I_TOL of no
    mesh.  (b) ``a16i_cards_check`` when two or more cards are visible.
    Returns the figures for qwen3-1.7b's flash entry."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    mesh = make_mesh(A16I_DP_MESH, ("data", "model"),
                     [device] * int(math.prod(A16I_DP_MESH)))
    out = {}
    for tag, cfg, B, S in (
            ("bf16", get_config(LM_ARCH), TRAIN_BATCH, TRAIN_SEQ),
            ("f32", dataclasses.replace(get_config(LM_ARCH),
                                        n_layers=A16I_F32_LAYERS,
                                        dtype="float32"),
             A16I_DP_F32_BATCH, A16I_DP_F32_SEQ)):
        data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=S,
                                             global_batch=B, seed=0))
        hosts = [data.batch_at(s) for s in range(A16I_DP_STEPS)]
        torch.cuda.empty_cache()
        plain = _mesh_train_run(f"{LM_ARCH} {tag} {cfg.n_layers} L, {B} x "
                                f"{S}, no mesh", cfg, None, hosts, smi)
        want = plain.pop("params")
        torch.cuda.empty_cache()
        meshed = _mesh_train_run(f"{LM_ARCH} {tag} {cfg.n_layers} L, {B} x "
                                 f"{S}, mesh {A16I_DP_MESH}", cfg, mesh,
                                 hosts, smi)
        got = meshed.pop("params")
        for run in (plain, meshed):
            if run["losses"][0] != run["loss_no_grad"]:
                raise AssertionError(f"{LM_ARCH} {tag}: the first loss is "
                                     f"not the no-grad one: {run}")
        loss_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(meshed["losses"], plain["losses"]))
        norm_gap = max(abs(a - b) / abs(b) for a, b in
                       zip(meshed["grad_norms"], plain["grad_norms"]))
        param_gap = _params_rel_err(got, want)
        del got, want
        print(f"  {LM_ARCH} {tag}: mesh against no mesh, losses rel "
              f"{loss_gap:.3g}, grad norms rel {norm_gap:.3g}, parameters "
              f"after {A16I_DP_STEPS} steps rel L2 {param_gap:.3g} "
              f"[{smi}]", flush=True)
        out[tag] = {"mesh": meshed, "no_mesh": plain,
                    "loss_rel_err": loss_gap, "grad_norm_rel_err": norm_gap,
                    "params_rel_err": param_gap}
        if tag == "f32" and max(loss_gap, norm_gap, param_gap) > A16I_TOL:
            raise AssertionError(f"{LM_ARCH} f32 on {A16I_DP_MESH}: "
                                 f"{out[tag]}")
    torch.cuda.empty_cache()
    out["cards"] = a16i_cards_check(smi)
    out["seconds"] = time.perf_counter() - t0
    print(f"A16i-train phase: {out['seconds']:.3f} s [{smi}]", flush=True)
    return out


def a16i_cards_check(smi) -> dict:
    """(b) A16I_CARDS_ARCH at full width and depth on the launcher's
    default mesh, (n, 1) over the n visible cards, when n >= 2: the
    parameters, AdamW's state and the batches placed over the cards,
    A16I_CARDS_STEPS steps at TRAIN_BATCH x TRAIN_SEQ: each card's bytes at
    rest and peak, seconds a step, flash launches a step (``(2L n, L n,
    L n)``), the first loss bit for bit the batch's loss without autograd.
    With one card it prints why it did not run."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.train import training_mesh
    n = torch.cuda.device_count()
    cfg = get_config(A16I_CARDS_ARCH)
    if n < 2:
        print(f"A16i-train (b): not run: {n} card visible; "
              f"{A16I_CARDS_ARCH} at full depth ({cfg.n_params / 1e9:.3f} B "
              f"parameters, 14 B each with AdamW) trains over two or more "
              f"cards [{smi}]", flush=True)
        return {"ran": False, "cards": n}
    t0 = time.perf_counter()
    mesh, _ = training_mesh(None, "cuda", cfg)
    data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH, seed=0))
    res = _mesh_train_run(f"{A16I_CARDS_ARCH} full depth over {n} cards",
                          cfg, mesh, [data.batch_at(s) for s in
                                      range(A16I_CARDS_STEPS)], smi)
    res.pop("params")
    res.update({"ran": True, "cards": n,
                "seconds": time.perf_counter() - t0})
    if res["losses"][0] != res["loss_no_grad"]:
        raise AssertionError(f"{A16I_CARDS_ARCH} over {n} cards: the first "
                             f"loss is not the no-grad one: {res}")
    return res


def engine_phase(device, smi: str) -> tuple:
    """The ``engine`` backend (``core/engine.py``, torch ops, no
    hand-written kernel) on the four Table-2 stencils at the main path's
    sizes, schedules and inputs, ``iters = 2T+3``: no kernel launch (the
    stencil library's count stays 0 over the run), the result within
    ``precision.tolerance`` of the reference backend; run ms and ms a
    super-step (median of 3 after the checked run) beside the ``hopper``
    backend's in the same run.  Returns the rows and the engine's results
    of d2 and h3 (the distributed phase holds its shards against them)."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import precision
    from repro_torch.kernels import builder
    rows, outs = [], {}
    for name in STENCILS:
        nd = int(name[-2])
        dims = FULL_DIMS[nd]
        par_time, bsize = SCHEDULE[nd]
        iters = 2 * par_time + 3
        n_super = math.ceil(iters / par_time)
        g, aux = inputs(name, dims, device, 0)
        prob = StencilProblem(name, dims)
        eng = plan(prob, RunConfig(backend="engine", par_time=par_time,
                                   bsize=bsize, device=device))
        torch.cuda.synchronize()
        builder.LAUNCHES = 0
        out = eng.run(g, iters, aux=aux)
        torch.cuda.synchronize()
        if builder.LAUNCHES:
            raise AssertionError(f"engine {name}: {builder.LAUNCHES} "
                                 "kernel launches; the engine runs none")
        ref = plan(prob, RunConfig(backend="reference",
                                   device=device)).run(g, iters, aux=aux)
        scale = 100 if name.startswith("hotspot") else None
        torch.testing.assert_close(out, ref, **precision.tolerance(
            "float32", iters, scale=scale))
        err = (out - ref).abs().max().item()
        del ref
        run_ms = time_ms(lambda: eng.run(g, iters, aux=aux), 3, 0)
        hop = plan(prob, RunConfig(backend="hopper", par_time=par_time,
                                   bsize=bsize, device=device))
        hop_ms = time_ms(lambda: hop.run(g, iters, aux=aux), 3)
        row = {"name": name, "dims": list(dims), "par_time": par_time,
               "bsize": list(bsize), "iters": iters, "run_ms": run_ms,
               "superstep_ms": float(run_ms) / n_super,
               "hopper_run_ms": hop_ms,
               "hopper_superstep_ms": float(hop_ms) / n_super,
               "engine_over_hopper": float(run_ms) / float(hop_ms),
               "oracle_max_abs_err": err, "launches": 0}
        print(f"engine {name} {dims} T={par_time} bsize={bsize}: run of "
              f"{iters} iters {run_ms} ({row['superstep_ms']:.3f} ms a "
              f"super-step), hopper {hop_ms} "
              f"({row['hopper_superstep_ms']:.3f}), "
              f"{row['engine_over_hopper']:.2f}x; oracle max_abs_err "
              f"{err:.3g}; 0 launches [{smi}]", flush=True)
        rows.append(row)
        if name in ("diffusion2d", "hotspot3d"):
            outs[name] = (g, aux, out, run_ms)
        del g, aux, out, eng, hop
        torch.cuda.empty_cache()
    return rows, outs


def distributed_phase(device, smi: str, engine_outs: dict) -> list:
    """The ``distributed`` backend (``core/distributed.py``) on
    :data:`DIST_CASES`, every shard a logical one on ``device``: d2 and h3
    on the engine phase's inputs and held bit for bit against its
    single-device results, the periodic wave2d (2 x 16384², T=4) against
    the engine run (and timed, median of 3) here; each run's counted
    exchanges (``ceil(iters/T)`` per sharded axis, one a run per axis for
    the aux grid) and their bytes; run ms (median of 3) beside the
    engine's, and one exchange of the state's shards alone timed (median
    of 5) with its bytes a super-step."""
    import torch
    from repro_torch.api import RunConfig, StencilProblem, plan
    from repro_torch.core import distributed
    from repro_torch.kernels import builder
    from repro_torch.launch.mesh import make_mesh
    rows = []
    for label, name, mshape, axes, axis_map in DIST_CASES:
        if name in DAGS:
            nd, bc, par_time, bsize = DAGS[name]
            prob = StencilProblem(dag_program(name), FULL_DIMS[nd],
                                  boundary=bc)
            g, aux = grid_input(prob.state_shape, device, 0), None
            want = None
        else:
            nd = int(name[-2])
            par_time, bsize = SCHEDULE[nd]
            prob = StencilProblem(name, FULL_DIMS[nd])
            g, aux, want, eng_ms = engine_outs[name]
        iters = 2 * par_time + 3
        n_super = math.ceil(iters / par_time)
        if want is None:
            eng = plan(prob, RunConfig(backend="engine", par_time=par_time,
                                       bsize=bsize, device=device))
            want = eng.run(g, iters, aux=aux)
            eng_ms = time_ms(lambda: eng.run(g, iters, aux=aux), 3, 0)
            del eng
        mesh = make_mesh(mshape, axes, [device] * math.prod(mshape))
        p = plan(prob, RunConfig(backend="distributed", par_time=par_time,
                                 bsize=bsize, device=device, mesh=mesh,
                                 axis_map=axis_map))
        torch.cuda.synchronize()
        builder.LAUNCHES = 0
        distributed.reset_exchange_counts()
        out = p.run(g, iters, aux=aux)
        torch.cuda.synchronize()
        counts = dict(distributed.EXCHANGES)
        sharded = sum(1 for a in axis_map if a)
        expect = {"state": n_super * sharded,
                  "aux": sharded if prob.needs_aux else 0}
        if {k: counts[k] for k in expect} != expect or builder.LAUNCHES:
            raise AssertionError(f"distributed {label}: exchanges {counts}, "
                                 f"expected {expect}; {builder.LAUNCHES} "
                                 "kernel launches (the engine runs none)")
        if out.device != g.device or not torch.equal(out, want):
            raise AssertionError(f"distributed {label}: not bit for bit the "
                                 "single-device engine")
        del want
        run_ms = time_ms(lambda: p.run(g, iters, aux=aux), 3, 0)
        layout = distributed.shard_layout(prob.shape, axis_map, mesh)
        lead = int(len(prob.fields) > 1)
        h = distributed.halo_width(prob.stencil, par_time)
        kinds = prob.structural_bc.kinds
        shards = distributed.scatter(g, layout, lead)
        ex_ms = time_ms(lambda: distributed.exchange(shards, layout, h,
                                                     kinds, lead), 5)
        del shards
        row = {"name": label, "dims": list(prob.shape),
               "fields": len(prob.fields), "mesh": dict(mesh.shape),
               "axis_map": [list(a) if a else None for a in axis_map],
               "shards": len(layout.devices), "par_time": par_time,
               "bsize": list(bsize), "iters": iters, "halo": h,
               "run_ms": run_ms, "superstep_ms": float(run_ms) / n_super,
               "engine_run_ms": eng_ms,
               "over_engine": float(run_ms) / float(eng_ms),
               "exchanges": counts["state"], "aux_exchanges": counts["aux"],
               "exchange_ms": ex_ms,
               "exchange_bytes_per_superstep":
                   counts["state_bytes"] // n_super,
               "aux_exchange_bytes": counts["aux_bytes"]}
        print(f"distributed {label} {prob.shape} x{len(prob.fields)} on "
              f"{row['shards']} shards of {device} (mesh {mesh.shape}, "
              f"axis_map {axis_map}) T={par_time}: run of {iters} iters "
              f"{run_ms} ({row['superstep_ms']:.3f} ms a super-step), "
              f"{row['over_engine']:.3f}x the engine's {eng_ms} and bit "
              f"for bit its result; {counts['state']} exchanges of halo "
              f"{h} ({counts['aux']} aux), one exchange {ex_ms}, "
              f"{row['exchange_bytes_per_superstep']} bytes a super-step "
              f"[{smi}]", flush=True)
        rows.append(row)
        del g, aux, out, p
        torch.cuda.empty_cache()
    return rows



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
    t_backends = time.perf_counter()
    engine_rows, engine_outs = engine_phase(device, smi)
    dist_rows = distributed_phase(device, smi, engine_outs)
    del engine_outs
    torch.cuda.empty_cache()
    print(f"engine and distributed phases: "
          f"{time.perf_counter() - t_backends:.3f} s [{smi}]", flush=True)
    tuning = tune_phase(device)
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
    torch.cuda.empty_cache()
    kernels.extend(a16f_phase(device, peaks))
    torch.cuda.empty_cache()
    kernels.extend(a16de_phase(device, peaks))
    torch.cuda.empty_cache()
    kernels.extend(a16c_phase(device, peaks))
    torch.cuda.empty_cache()
    kernels.extend(a16gh_phase(device, peaks))
    torch.cuda.empty_cache()
    a16i = a16i_phase(device, peaks, smi)
    for arch, rows in a16i.items():
        entry = next(k for k in kernels if k["name"] == f"flash_fwd[{arch}]")
        entry["mesh_serve"] = rows
    torch.cuda.empty_cache()
    entry = next(k for k in kernels if k["name"] == f"flash_fwd[{LM_ARCH}]")
    entry["mesh_train"] = a16i_train_phase(smi)
    print(f"chip_smoke: {time.perf_counter() - t_main:.3f} s after the "
          f"build", flush=True)
    print(json.dumps({"tuning": tuning}))
    print(json.dumps({"backends": {
        "engine": [with_spread(r) for r in engine_rows],
        "distributed": [with_spread(r) for r in dist_rows]}, "card": smi}))
    print(json.dumps({"kernels": [with_spread(k) for k in kernels],
                      "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
