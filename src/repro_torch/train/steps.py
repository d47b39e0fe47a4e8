"""Step functions: the training step, and serving's prefill and decode.

``make_train_step`` builds the reference's production step: loss (each
layer under ``cfg.remat_policy``) -> gradients (accumulated in f32 over
microbatches when there are more than one) -> global-norm clip -> AdamW ->
metrics.  ``make_compressed_train_step`` is the reference's cross-pod
variant: the same loss and gradients, then error-feedback top-k (int8)
compression of the gradients (``optim/compression.py``) before AdamW.
"""
from __future__ import annotations

import torch

from repro_torch.models import ModelConfig, decode_step, lm_loss, prefill
from repro_torch.optim import (AdamWState, adamw_update, ef_compress_update,
                               init_ef_state)
from repro_torch.optim.adamw import AdamWConfig, leaves


def _shaped_like(tree, values):
    """``tree``'s nested dicts with its leaves taken in order from the
    iterator ``values``.  (A module-level function: a recursive closure
    over the iterator would form a reference cycle that keeps a whole
    step's gradients alive until the garbage collector runs.)"""
    if isinstance(tree, dict):
        return {k: _shaped_like(v, values) for k, v in tree.items()}
    return next(values)


def _loss_and_grads(params, cfg: ModelConfig, batch: dict):
    """``(loss, grads)``: the f32 loss and its gradients in the parameters'
    dtypes, shaped like ``params``."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        loss = lm_loss(params, cfg, batch)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss.detach(), _shaped_like(params, iter(grads))


def _step_grads(params, cfg: ModelConfig, batch: dict, microbatches: int):
    """``(loss, grads)`` of one step: with one microbatch
    :func:`_loss_and_grads`' (the parameters' dtypes); with more, the
    mean of the microbatches' losses and gradients, the gradients
    accumulated in f32."""
    if microbatches == 1:
        return _loss_and_grads(params, cfg, batch)
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"batch {n} does not split into "
                         f"{microbatches} microbatches")
    m = n // microbatches
    loss = torch.zeros((), dtype=torch.float32,
                       device=batch["tokens"].device)
    acc = None
    for i in range(microbatches):
        mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
        mb_loss, g = _loss_and_grads(params, cfg, mb)
        loss = loss + mb_loss
        if acc is None:
            acc = [x.float() for x in leaves(g)]
        else:
            for a, x in zip(acc, leaves(g)):
                a.add_(x)              # into the f32 accumulator
        del g
    loss = loss / microbatches
    grads = _shaped_like(params, (a.div_(microbatches) for a in acc))
    del acc
    return loss, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).  ``batch`` holds ``tokens``, ``labels`` and ``loss_mask``
    tensors on the parameters' device (and a VLM's ``embeds``, an
    encoder-decoder's ``frames``).  The parameters and the optimizer
    state are updated in place (``adamw_update``) and returned; the
    metrics are 0-d tensors (``loss``, ``grad_norm``, ``lr``)."""

    def train_step(params, opt_state: AdamWState, batch: dict):
        loss, grads = _step_grads(params, cfg, batch, microbatches)
        new_params, new_opt, metrics = adamw_update(opt_cfg, params, grads,
                                                    opt_state)
        metrics["loss"] = loss
        return new_params, new_opt, metrics

    return train_step


def make_compressed_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                               microbatches: int = 1,
                               keep_ratio: float = 0.05,
                               quantize: bool = True):
    """:func:`make_train_step` with error-feedback top-k gradient
    compression between the gradients and AdamW (the reference's
    cross-pod step).  Returns train_step(params, (opt_state, ef_state),
    batch) -> (params, (opt_state, ef_state), metrics); the metrics add
    ``compressed_wire_bytes``.  ``train_step.init_extra(params)`` makes
    the f32 zero residual."""

    def train_step(params, state, batch: dict):
        opt_state, ef_state = state
        loss, grads = _step_grads(params, cfg, batch, microbatches)
        grads, ef_state, wire = ef_compress_update(
            grads, ef_state, keep_ratio=keep_ratio, quantize=quantize)
        new_params, new_opt, metrics = adamw_update(opt_cfg, params, grads,
                                                    opt_state)
        metrics["loss"] = loss
        metrics["compressed_wire_bytes"] = wire
        return new_params, (new_opt, ef_state), metrics

    train_step.init_extra = init_ef_state
    return train_step


def make_prefill_fn(cfg: ModelConfig, max_len: int):
    """Returns prefill_fn(params, batch) -> (logits, caches, memory):
    ``batch`` holds ``tokens`` and, for the encoder-decoder family,
    ``frames``, for the VLM family ``embeds``; ``memory`` is ``None`` for
    every family but the encoder-decoder."""
    def prefill_fn(params, batch: dict):
        return prefill(params, cfg, batch["tokens"], max_len,
                       batch.get("frames"), embeds=batch.get("embeds"))
    return prefill_fn


def make_decode_fn(cfg: ModelConfig):
    def decode_fn(params, tokens, caches, memory=None):
        return decode_step(params, cfg, tokens, caches, memory)
    return decode_fn
