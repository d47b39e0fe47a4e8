"""Serving launcher: batched prefill + greedy KV-cache decode on a mesh.

Builds the serving mesh, the model from a seed, places the parameters on
the mesh by ``param_axes`` (and the caches by ``cache_axes`` after
prefill), prefills a batch of random prompts, then decodes tokens in
lockstep, under the reference's sharding rules, as the reference's
launcher does.  ``--mesh-shape`` (``data,model`` or ``pod,data,model``)
defaults to ``(n, 1)`` over the ``n`` visible cards; a shape of fewer
positions takes the first cards, one of more puts consecutive positions
on one card (logical shards).  ``--device cuda:N`` makes a mesh of
logical shards of card N, and ``--device cpu`` one of the CPU.  Each
data shard prefills and decodes its rows on its device, gathering each
layer's weights there for that layer; a MoE layer routes over the
``model`` axis by the reference's expert-parallel routes, which drop the
(token, pick) pairs past ``cfg.moe_capacity`` (``models/moe.py``); a KV
cache split on its sequence is read where it lies.  On a CUDA device
each causal prefill attention (every dense, decoder or MoE layer; each
application of the hybrid's shared block) runs the flash kernel
(``kernels/csrc/flash_fwd.cu``); the SSM layers' scan and the MoE layers'
routing and expert products are torch ops, and the SSM family launches no
kernel.  An encoder-decoder arch also draws random frame embeddings, one
per prompt position, for its encoder; a VLM arch draws ``prefix_len``
random patch embeddings a prompt, which go in front of its tokens (the
cache then holds ``prefix_len + prompt + new`` positions).  The SSM and
hybrid families take a prompt of whole ``ssd_chunk`` chunks, or one
shorter than a chunk:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch seamless-m4t-large-v2 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
        --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-30b-a3b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-235b-a22b --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch internvl2-76b --smoke --device cpu --prompt-len 28
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch qwen3-moe-30b-a3b --smoke --device cpu --mesh-shape 2,2

:func:`generate` without ``mesh`` is one device's function: no rules, the
MoE layers' grouped route, no token dropped.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.kernels import flash_attention
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import ModelConfig, init_params
from repro_torch.models.transformer import (cache_axes, param_axes,
                                            require_device)
from repro_torch.parallel.sharding import (bytes_by_device, default_rules,
                                           shard_tree, use_sharding_rules)
from repro_torch.train import make_decode_fn, make_prefill_fn


@dataclasses.dataclass
class Generation:
    """What :func:`generate` returns."""
    tokens: torch.Tensor       # (B, max_new) int64, greedy picks
    logits: torch.Tensor       # (B, max_new, padded vocab) f32, per pick
    prefill_s: float           # host clock, ends in a device sync
    decode_s: float            # the max_new - 1 decode steps
    prefill_launches: int      # flash kernel launches during prefill
    decode_launches: int       # ... and during decode


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def mesh_axes(shape) -> tuple:
    """The reference launchers' axis names for a mesh shape."""
    if len(shape) not in (2, 3):
        raise ValueError(f"--mesh-shape takes data,model or "
                         f"pod,data,model; got {tuple(shape)}")
    return ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                      "model")


def serving_mesh(shape, device) -> Mesh:
    """The launchers' mesh of ``shape`` over the cards ``device`` names.
    ``cuda`` names every visible card: the default shape is ``(n, 1)``
    over the ``n`` cards, a shape of at most ``n`` positions takes the
    first ``prod(shape)`` of them (as ``jax.make_mesh`` does), and one of
    more positions (a multiple of ``n``) puts ``prod(shape) / n``
    consecutive positions on each card.  ``cuda:N`` names that one card
    and a CPU ``device`` the CPU: the default shape is then ``(1, 1)``
    and every position lies on that device (logical shards).  A card that
    is not visible is refused."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None \
            and device.index >= torch.cuda.device_count():
        raise ValueError(f"{device} is not among the "
                         f"{torch.cuda.device_count()} visible cards")
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
            if device.type == "cuda" and device.index is None else [device])
    shape = tuple(shape) if shape else (len(devs), 1)
    n = math.prod(shape)
    if n < len(devs):
        devs = devs[:n]
    if n % len(devs):
        raise ValueError(f"a mesh of {shape} ({n} positions) over "
                         f"{len(devs)} devices")
    return make_mesh(shape, mesh_axes(shape),
                     [devs[i * len(devs) // n] for i in range(n)])


def parse_mesh_shape(text: Optional[str]):
    return tuple(int(v) for v in text.split(",")) if text else None


@torch.inference_mode()
def generate(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
             max_new: int, max_len: Optional[int] = None,
             frames: Optional[torch.Tensor] = None,
             embeds: Optional[torch.Tensor] = None,
             mesh: Optional[Mesh] = None) -> Generation:
    """Prefill ``tokens`` (B, S) then pick ``max_new`` tokens greedily: the
    first from the prefill logits, the rest by ``max_new - 1`` decode
    steps over a cache of ``max_len`` (default ``P + S + max_new``).  An
    encoder-decoder config takes ``frames`` (B, S_enc, d_model), whose
    encoder memory every decode step attends to; a VLM config takes
    ``embeds`` (B, P, d_model), patch embeddings in front of the prompt
    (P is 0 otherwise; the reference's launcher leaves P out of its
    default and fails there).  The launch counts are the flash forward's:
    0 for the SSM family.

    With ``mesh``, the reference launcher's function on that mesh: the
    parameters are placed by ``param_axes`` (pieces on a device that
    holds them already are views), the caches by ``cache_axes`` after
    prefill, and prefill and decode run under ``default_rules``, each data
    shard on its device; the tokens and logits stay on ``tokens``'
    device."""
    B, S = tokens.shape
    if max_new < 1:
        raise ValueError(f"max_new must be >= 1; got {max_new}")
    P = embeds.shape[1] if embeds is not None and cfg.family == "vlm" \
        else 0
    max_len = max_len or P + S + max_new
    if max_len < P + S + max_new - 1:
        raise ValueError(f"max_len={max_len} cannot hold {P} prefix, {S} "
                         f"prompt and {max_new - 1} decoded tokens")
    prefill_fn = make_prefill_fn(cfg, max_len)
    decode_fn = make_decode_fn(cfg)
    dev = tokens.device
    ctx = contextlib.nullcontext()
    if mesh is not None:
        rules = default_rules(multi_pod="pod" in mesh.axis_names)
        params = shard_tree(params, param_axes(cfg), mesh, rules)
        ctx = use_sharding_rules(mesh, rules)

    _sync(dev)
    n0, t0 = flash_attention.LAUNCHES, time.perf_counter()
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    if embeds is not None:
        batch["embeds"] = embeds
    with ctx:
        logits, caches, memory = prefill_fn(params, batch)
        if mesh is not None:
            # over several devices each piece is a copy, so the prefill's
            # whole caches are freed; on one device the pieces are views
            caches = shard_tree(caches, cache_axes(cfg), mesh, rules,
                                copy=len(mesh.distinct_devices) > 1)
        nxt = logits[:, -1:].argmax(dim=-1)
        _sync(dev)
        n1, t1 = flash_attention.LAUNCHES, time.perf_counter()
        picks, seen = [nxt], [logits[:, -1]]
        for _ in range(max_new - 1):
            logits, caches = decode_fn(params, nxt, caches, memory)
            nxt = logits[:, -1:].argmax(dim=-1)
            picks.append(nxt)
            seen.append(logits[:, -1])
        _sync(dev)
        n2, t2 = flash_attention.LAUNCHES, time.perf_counter()
    return Generation(torch.cat(picks, dim=1), torch.stack(seen, dim=1),
                      t1 - t0, t2 - t1, n1 - n0, n2 - n1)


def main(argv=None) -> Generation:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model or pod,data,model (default n,1 over "
                    "the n visible devices)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = require_device(args.device)
    mesh = serving_mesh(parse_mesh_shape(args.mesh_shape), device)
    device = mesh.devices.flat[0]
    prefix = cfg.prefix_len if cfg.input_mode == "embeds_prefix" else 0
    max_len = args.max_len or prefix + args.prompt_len + args.max_new
    print(f"arch={cfg.name} params={cfg.n_params / 1e6:.1f}M "
          f"batch={args.batch} max_len={max_len} mesh={mesh}")

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    frames = None
    if cfg.input_mode == "frames":
        frames = torch.from_numpy(rng.standard_normal(
            (args.batch, args.prompt_len, cfg.d_model)).astype(
                np.float32)).to(device)
    embeds = None
    if cfg.input_mode == "embeds_prefix":
        embeds = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.prefix_len, cfg.d_model)).astype(
                np.float32)).to(device)
    rules = default_rules(multi_pod="pod" in mesh.axis_names)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device, mesh, rules)
    at_rest = bytes_by_device(params)
    out = generate(cfg, params, torch.from_numpy(prompts).long().to(device),
                   args.max_new, max_len, frames, embeds, mesh=mesh)

    toks = out.tokens.cpu()
    for b in range(min(args.batch, 4)):
        print(f"  seq {b}: {toks[b, :10].tolist()}...")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")
    tok_s = args.batch * (args.max_new - 1) / max(out.decode_s, 1e-9)
    print(f"prefill {out.prefill_s:.3f}s; decode {out.decode_s:.3f}s "
          f"({tok_s:.1f} tok/s on {where}); flash kernel launches: "
          f"{out.prefill_launches} in prefill, {out.decode_launches} in "
          f"decode")
    for dev in mesh.distinct_devices:
        peak = (f"; peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB"
                if dev.type == "cuda" else "")
        print(f"  {dev}: parameters at rest {at_rest.get(dev, 0) / 1e9:.3f} "
              f"GB{peak}")
    return out


if __name__ == "__main__":
    main()
