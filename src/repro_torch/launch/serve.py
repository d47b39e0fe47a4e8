"""Serving launcher: batched prefill + greedy KV-cache decode on one device.

Builds the model from a seed, prefills a batch of random prompts, then
decodes tokens in lockstep.  On a CUDA device each causal prefill attention
(every dense, decoder or MoE layer; each application of the hybrid's
shared block) runs the flash kernel (``kernels/csrc/flash_fwd.cu``); the
SSM layers' scan and the MoE layers' routing and expert products are torch
ops, and the SSM family launches no kernel.  An
encoder-decoder arch also draws random frame embeddings, one per prompt
position, for its encoder; a VLM arch draws ``prefix_len`` random patch
embeddings a prompt, which go in front of its tokens (the cache then
holds ``prefix_len + prompt + new`` positions).  The SSM and hybrid
families take a prompt of whole ``ssd_chunk`` chunks, or one shorter than
a chunk:

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
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.kernels import flash_attention
from repro_torch.models import ModelConfig, init_params
from repro_torch.models.transformer import require_device
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


@torch.inference_mode()
def generate(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
             max_new: int, max_len: Optional[int] = None,
             frames: Optional[torch.Tensor] = None,
             embeds: Optional[torch.Tensor] = None) -> Generation:
    """Prefill ``tokens`` (B, S) then pick ``max_new`` tokens greedily: the
    first from the prefill logits, the rest by ``max_new - 1`` decode
    steps over a cache of ``max_len`` (default ``P + S + max_new``).  An
    encoder-decoder config takes ``frames`` (B, S_enc, d_model), whose
    encoder memory every decode step attends to; a VLM config takes
    ``embeds`` (B, P, d_model), patch embeddings in front of the prompt
    (P is 0 otherwise; the reference's launcher leaves P out of its
    default and fails there).  The launch counts are the flash forward's:
    0 for the SSM family."""
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

    _sync(dev)
    n0, t0 = flash_attention.LAUNCHES, time.perf_counter()
    batch = {"tokens": tokens}
    if frames is not None:
        batch["frames"] = frames
    if embeds is not None:
        batch["embeds"] = embeds
    logits, caches, memory = prefill_fn(params, batch)
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = require_device(args.device)
    prefix = cfg.prefix_len if cfg.input_mode == "embeds_prefix" else 0
    max_len = args.max_len or prefix + args.prompt_len + args.max_new
    print(f"arch={cfg.name} params={cfg.n_params / 1e6:.1f}M "
          f"batch={args.batch} max_len={max_len} device={device}")

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
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, gen, device)
    out = generate(cfg, params, torch.from_numpy(prompts).long().to(device),
                   args.max_new, max_len, frames, embeds)

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
    return out


if __name__ == "__main__":
    main()
