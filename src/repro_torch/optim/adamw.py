"""AdamW + global-norm clipping + cosine schedule, in the reference's
arithmetic.

Moments are f32 whatever the parameter dtype, and a parameter that is not
f32 keeps an f32 master copy in the state (``None`` for f32 parameters).
Unlike the reference, which returns new trees, :func:`adamw_update` updates
the moments, the master copies and the parameters **in place** (a full-width
bf16 model's state is 24 GB; a second copy would not fit beside it) and
returns the same tensors.  The step count, the learning rate and the
gradient norm stay 0-d tensors on the parameters' (first) device, so a
step never waits on the host.

Placed parameters (``parallel.Sharded`` leaves) get moments and masters
placed like them, each piece allocated on its own device; the global norm
adds each piece's square sum once (a replicated leaf has one piece for
the axes its spec leaves out), and the update runs piece by piece where
each piece lies, with the step's scalars copied to each device once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.parallel.sharding import map_pieces, pieces_of, square_sum


class AdamWState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: Any
    v: Any
    master: Any          # f32 master copy (None leaves if params already f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def _map(fn, *trees):
    """``fn`` over the leaves of parameter-shaped nested dicts (``None``
    leaves of the later trees are passed through as ``None``)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree) -> list:
    """The tensors of a nested dict, in key order (``None`` skipped)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves(tree[k])]
    return [] if tree is None else [tree]


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``, f32."""
    s = step.float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def _home(tree) -> torch.device:
    """The device of the first tensor of ``tree`` (a placed leaf's first
    piece's)."""
    return pieces_of(leaves(tree)[0])[0].device


def global_norm(tree) -> torch.Tensor:
    """The f32 norm of every element of ``tree``, each counted once, on
    its first device."""
    home = _home(tree)
    return torch.sqrt(sum(square_sum(x, home) for x in leaves(tree)))


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def master(p):
        return p.float() if p.dtype != torch.float32 else None

    def placed(fn):
        return lambda leaf: map_pieces(fn, leaf)
    return AdamWState(torch.zeros((), dtype=torch.int32,
                                  device=_home(params)),
                      _map(placed(zeros), params), _map(placed(zeros), params),
                      _map(placed(master), params))


#: elements updated at a time (f32 temporaries of 256 MB each)
_PIECE = 1 << 26


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: AdamWState):
    """One AdamW step. Returns (params, state, metrics), the parameters and
    the state updated in place; ``metrics`` holds 0-d ``grad_norm`` and
    ``lr``."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_schedule(cfg, step)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device),
                        step.float())
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device),
                        step.float())

    def upd(p, g, m, v, master, scale, lr, b1c, b2c):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        base = master if master is not None else p.float()
        new = base - lr * (update + cfg.weight_decay * base)
        if master is not None:
            master.copy_(new)
        p.copy_(new)

    scalars = {}

    def upd_in_pieces(*ts):
        # the step's scalars on this piece's device, copied once a device
        dev = ts[0].device
        if dev not in scalars:
            scalars[dev] = [t.to(dev) for t in (scale, lr, b1c, b2c)]
        # elementwise, so slices of the leading axis bound the f32
        # temporaries without changing a value
        n = ts[0].shape[0] if ts[0].dim() else 1
        rows = max(1, _PIECE // max(1, ts[0].numel() // n))
        if rows >= n:
            return upd(*ts, *scalars[dev])
        for i in range(0, n, rows):
            upd(*(None if t is None else t[i:i + rows] for t in ts),
                *scalars[dev])

    def leaf(*ts):
        map_pieces(upd_in_pieces, *ts)
    _map(leaf, params, grads, state.m, state.v, state.master)
    state.step.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
