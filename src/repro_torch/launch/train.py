"""Training launcher: config -> mesh -> sharding rules -> data pipeline ->
train step -> fault-tolerant loop (checkpoint/restart, straggler
detection, failure retry).

As the reference's launcher does, it builds a mesh (``--mesh-shape``
over the cards ``--device`` names, as ``launch.serve.serving_mesh``
does: default ``(n, 1)`` over the ``n`` visible cards; ``--device
cuda:N`` logical shards of card N, ``--device cpu`` of the CPU), places
the parameters, AdamW's moments and master copies and the compressed
step's residual on it by ``param_axes`` (``parallel.Sharded`` leaves,
each piece allocated on its own device: over ``data`` the ZeRO-3 split of
``wt_fsdp``), places each batch on its data shards, and runs every step
under the reference's sharding rules: each data shard computes its rows
on its device, a layer's weights gathered there inside the layer's remat
region, and the gradients come back in pieces summed over the data
shards (``train/steps.py``); a MoE layer trains through the
expert-parallel all-to-all route and its capacity (``models/moe.py``).
Checkpoints hold the whole arrays, so a run resumes on another mesh
shape.  At the end it prints each device's bytes of state at rest and,
on a card, its peak.

On a CUDA device each causal attention (every dense, decoder or MoE
layer; each application of the hybrid's shared block) runs the flash
kernels (``kernels/csrc/flash_fwd.cu`` forward,
``kernels/csrc/flash_bwd.cu`` backward); the SSM layers' scan and the MoE
layers' routing and expert products are torch ops under autograd, and the
MoE layers' auxiliary loss enters the loss.  ``--smoke``
selects the reduced config of the same family; ``--device cpu`` runs the
kernels' plain versions.  An encoder-decoder arch's batches carry random
frame embeddings for its encoder, a VLM arch's ``prefix_len`` random patch
embeddings in front of ``--seq`` tokens (its first label carries no loss).
``--compress RATIO`` trains through the error-feedback top-k (int8)
gradient compression step, whose residual the checkpoints keep.  The SSM
and hybrid families take a ``--seq`` of whole ``ssd_chunk`` chunks, or one
shorter than a chunk:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --device cpu --steps 20 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch seamless-m4t-large-v2 --smoke --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --smoke --device cpu --steps 4 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
        --smoke --device cpu --steps 4 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-moe-30b-a3b --smoke --device cpu --steps 4 --batch 4 \\
        --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch qwen3-moe-235b-a22b --smoke --device cpu --steps 4 \\
        --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch internvl2-76b --smoke --device cpu --steps 4 --batch 4 \\
        --seq 28
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --device cpu --steps 4 --batch 4 --seq 64 --compress 0.05
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --device cpu --steps 4 --batch 4 --seq 64 --mesh-shape 2,2
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --mesh-shape 4,1 --steps 3 --batch 8 --seq 4096 --ckpt-every 0

Without ``--ckpt-dir`` the checkpoints go to a fresh temporary directory
that is removed at the end; with it, a second launch resumes from the
newest complete step there, on any mesh.  ``--ckpt-every 0`` saves none.
"""
from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch.serve import parse_mesh_shape, serving_mesh
from repro_torch.models import init_params
from repro_torch.models.transformer import require_device
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel.sharding import (bytes_by_device, default_rules,
                                           resolve_spec, shard_leaf,
                                           use_sharding_rules)
from repro_torch.train import (TrainLoopConfig, fault_tolerant_train,
                               make_compressed_train_step, make_train_step)


def device_batch(host: dict, device) -> dict:
    """A pipeline batch (numpy) as tensors on ``device``: token ids as
    int64, the loss mask as f32."""
    return {k: torch.from_numpy(v).to(
        device, torch.long if v.dtype.kind in "iu" else torch.float32)
        for k, v in host.items()}


def data_mode(cfg) -> str:
    """The synthetic pipeline's mode for ``cfg``'s ``input_mode``:
    ``"frames"`` (tokens and an encoder's frame embeddings),
    ``"embeds_prefix"`` (tokens after patch embeddings) or ``"tokens"``."""
    if cfg.input_mode in ("frames", "embeds_prefix"):
        return cfg.input_mode
    return "tokens"


def placed_batch(host: dict, mesh, rules) -> dict:
    """A pipeline batch (numpy) placed as the reference's ``batch_at``
    places it: each leaf split on ``batch`` over the data axes (whole,
    on the mesh's first device, where they do not divide it:
    ``resolve_spec``), token ids as int64, the loss mask as f32."""
    out = {}
    for k, v in device_batch(host, "cpu").items():
        spec = resolve_spec(v.shape, ("batch",) + (None,) * (v.dim() - 1),
                            mesh, rules)
        out[k] = shard_leaf(v, spec, mesh, copy=True)
    return out


def training_mesh(shape, device, cfg):
    """``(mesh, rules)`` of the launcher: ``launch.serve.serving_mesh`` (a
    mesh over several cards, or logical shards of one device) and the
    reference's rules for ``cfg`` (ZeRO-3 over pods past 5e10
    parameters)."""
    mesh = serving_mesh(shape, device)
    rules = default_rules(multi_pod="pod" in mesh.axis_names,
                          fsdp_over_pod=cfg.n_params > 5e10)
    return mesh, rules


def init_state(cfg, mesh, rules, seed: int, ocfg: AdamWConfig,
               microbatches: int = 1, compress=None):
    """``(params, opt_state, step_fn)`` of the launcher: the parameters
    drawn from ``seed`` on the mesh's first device, each layer's draw
    copied into its pieces on ``mesh`` (``param_axes``: no device holds
    the whole model), AdamW's state placed like them and, with
    ``compress`` (a keep ratio), the compressed step, whose residual is
    placed like them too (``opt_state`` is then ``(AdamW state,
    residual)``)."""
    device = mesh.devices.flat[0]
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device, mesh, rules)
    opt_state = adamw_init(params)
    if compress:
        step_fn = make_compressed_train_step(
            cfg, ocfg, microbatches=microbatches, keep_ratio=compress)
        opt_state = (opt_state, step_fn.init_extra(params))
    else:
        step_fn = make_train_step(cfg, ocfg, microbatches=microbatches)
    return params, opt_state, step_fn


def state_tree(params, opt_state) -> dict:
    """The launcher's training state as one dict of trees (parameters,
    AdamW's ``m``, ``v`` and ``master``, the compressed step's residual),
    for ``bytes_by_device``."""
    extra = None
    if isinstance(opt_state, tuple) and not hasattr(opt_state, "_fields"):
        opt_state, extra = opt_state
    return {"params": params, "m": opt_state.m, "v": opt_state.v,
            "master": opt_state.master, "residual": extra}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model or pod,data,model (default n,1 over "
                    "the n visible devices; fewer positions take the first "
                    "devices)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints; 0 saves none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compress", type=float, default=None, metavar="RATIO",
                    help="EF-top-k gradient compression keep-ratio (the "
                    "cross-pod step's); e.g. 0.05")
    ap.add_argument("--attn-impl", default=None, choices=["flash", "xla"],
                    help="attention implementation override (flash = the "
                    "flash kernels on the card, their plain versions on the "
                    "CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    device = require_device(args.device)
    mesh, rules = training_mesh(parse_mesh_shape(args.mesh_shape), device,
                                cfg)
    print(f"arch={cfg.name} params={cfg.n_params / 1e6:.1f}M "
          f"mesh={mesh} attn_impl={cfg.attn_impl}")

    data = SyntheticLMDataset(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, prefix_len=cfg.prefix_len, d_model=cfg.d_model,
        mode=data_mode(cfg)))
    params, opt_state, step_fn = init_state(
        cfg, mesh, rules, args.seed,
        AdamWConfig(lr=args.lr, total_steps=args.steps), args.microbatches,
        args.compress)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(
        prefix=f"repro_torch_{cfg.name}_ckpt_")
    loop_cfg = TrainLoopConfig(total_steps=args.steps,
                               checkpoint_every=args.ckpt_every,
                               checkpoint_dir=ckpt_dir)
    at_rest = bytes_by_device(state_tree(params, opt_state))
    cards = [d for d in mesh.distinct_devices if d.type == "cuda"]
    for dev in cards:
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        t0 = time.time()
        with use_sharding_rules(mesh, rules):
            params, opt_state, events = fault_tolerant_train(
                loop_cfg, step_fn, (params, opt_state), iter(data),
                lambda s: placed_batch(data.batch_at(s), mesh, rules))
        for dev in cards:
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)

    losses = events["losses"]
    if losses:
        k = max(1, len(losses) // 10)
        tok_s = args.batch * args.seq * len(losses) / dt
        print(f"loss {np.mean(losses[:k]):.4f} -> {np.mean(losses[-k:]):.4f}"
              f" over {len(losses)} steps; {tok_s:.0f} tok/s;"
              f" retries={events['retries']}"
              f" stragglers={len(events['stragglers'])}")
        print(f"seconds a step: {[round(x, 3) for x in events['step_s']]}")
    events["state_bytes"] = {str(d): at_rest.get(d, 0)
                             for d in mesh.distinct_devices}
    for dev in mesh.distinct_devices:
        peak = (f"; peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} "
                f"GB" if dev in cards else "")
        print(f"  {dev}: state at rest {at_rest.get(dev, 0) / 1e9:.3f} GB"
              f"{peak}")
    return events


if __name__ == "__main__":
    main()
