"""Step functions: the training step, and serving's prefill and decode.

``make_train_step`` builds the reference's production step: loss (each
layer under ``cfg.remat_policy``) -> gradients (accumulated in f32 over
microbatches when there are more than one) -> global-norm clip -> AdamW ->
metrics.  ``make_compressed_train_step`` is the reference's cross-pod
variant: the same loss and gradients, then error-feedback top-k (int8)
compression of the gradients (``optim/compression.py``) before AdamW.

Under active sharding rules (``parallel.use_sharding_rules``) the prefill
and decode functions run each data shard on its own device: the batch is
split by ``resolve_spec`` of ``"batch"``, each shard runs under the rules
on its data shard's view of the mesh (``parallel.sharding.submesh``: its MoE
layers route over the ``model`` axis), and the logits are gathered on the
tokens' device.  Prefill returns its caches (and an encoder-decoder's
memory) split on the batch, one piece a data shard where it was computed;
decode reads and writes each data shard's part of the caches in place.
The training step runs data parallel under active rules, as the
reference's jitted step does under GSPMD: each microbatch is rows ``i*m``
to ``(i+1)*m`` of the global batch (the reference's reshape), each data
shard takes its rows of it to its device and runs the loss there under
its view of the mesh (its MoE layers route over the ``model`` axis, and
the mean of the data shards' aux losses is the reference's mean over
every (data, model) shard), and the step divides the shards' summed
masked losses by their summed mask counts (``lm_loss_parts``), as the
reference's loss over the whole microbatch does.  One backward runs
through every shard; placed parameters are gathered a layer at a time
inside each layer's remat region, and each gradient comes back in
pieces on its parameter's devices (summed over the data shards there),
accumulated over microbatches in f32 pieces.  The batch may be placed
(``parallel.Sharded`` leaves split on ``batch``) or whole.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import ModelConfig, decode_step, lm_loss, prefill
from repro_torch.models.transformer import cache_axes, lm_loss_parts
from repro_torch.optim import (AdamWState, adamw_update, ef_compress_update,
                               init_ef_state)
from repro_torch.optim.adamw import AdamWConfig, leaves
from repro_torch.parallel.sharding import (P, Sharded, current_rules,
                                           device_at, map_pieces, names_of,
                                           pieces_of, placement,
                                           resolve_spec, submesh, unravel,
                                           use_sharding_rules)


def _shaped_like(tree, values):
    """``tree``'s nested dicts with its leaves taken in order from the
    iterator ``values``: a tensor leaf one value, a :class:`Sharded` leaf
    one a piece (placed as it is).  (A module-level function: a recursive
    closure over the iterator would form a reference cycle that keeps a
    whole step's gradients alive until the garbage collector runs.)"""
    if isinstance(tree, dict):
        return {k: _shaped_like(v, values) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.with_pieces({c: next(values) for c in tree.pieces})
    return next(values)


def step_loss(params, cfg: ModelConfig, batch: dict, rows: slice = None):
    """The f32 loss a training step differentiates, of rows ``rows`` of
    ``batch`` (all of them by default): ``lm_loss`` of them with no active
    rules; under active rules each data shard's part on its device under
    its view of the mesh, the masked sums and mask counts added over the
    shards before the division (the module's docstring), on the mesh's
    first device."""
    if rows is None:
        rows = slice(0, _batch_size(batch))
    mesh, rules = current_rules()
    if mesh is None or rules is None:
        return lm_loss(params, cfg, {k: v[rows] for k, v in batch.items()})
    home = device_at(mesh, {})
    total, count, auxes = 0.0, 0.0, []
    for part, dev, view, _ in data_shards(mesh, rules,
                                          rows.stop - rows.start):
        sl = slice(rows.start + part.start, rows.start + part.stop)
        shard = {k: _rows(v, 0, sl, dev) for k, v in batch.items()}
        with use_sharding_rules(view, rules):
            s, n, aux = lm_loss_parts(params, cfg, shard)
        total = total + s.to(home)
        count = count + n.to(home)
        auxes.append(aux.to(home))
    return total / count.clamp_min(1.0) + 1e-2 * torch.stack(auxes).mean()


def _loss_and_grads(params, cfg: ModelConfig, batch: dict,
                    rows: slice = None):
    """``(loss, grads)``: the f32 loss of ``batch`` (of its rows ``rows``)
    and its gradients in the parameters' dtypes, shaped like ``params``
    (a placed leaf's in pieces placed as its own)."""
    flat = [p for x in leaves(params) for p in pieces_of(x)]
    for p in flat:
        p.requires_grad_(True)
    try:
        loss = step_loss(params, cfg, batch, rows)
        grads = torch.autograd.grad(loss, flat)
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss.detach(), _shaped_like(params, iter(grads))


def _batch_size(batch: dict) -> int:
    return batch["tokens"].shape[0]


def _step_grads(params, cfg: ModelConfig, batch: dict, microbatches: int):
    """``(loss, grads)`` of one step: with one microbatch
    :func:`_loss_and_grads`' (the parameters' dtypes); with more, the
    mean of the microbatches' losses and gradients, the gradients
    accumulated in f32 (in pieces where the parameters are placed)."""
    if microbatches == 1:
        return _loss_and_grads(params, cfg, batch)
    n = _batch_size(batch)
    if n % microbatches:
        raise ValueError(f"batch {n} does not split into "
                         f"{microbatches} microbatches")
    m = n // microbatches
    loss, acc = 0.0, None
    for i in range(microbatches):
        mb_loss, g = _loss_and_grads(params, cfg, batch,
                                     slice(i * m, (i + 1) * m))
        loss = loss + mb_loss
        if acc is None:
            acc = [map_pieces(torch.Tensor.float, x) for x in leaves(g)]
        else:
            for a, x in zip(acc, leaves(g)):
                map_pieces(torch.Tensor.add_, a, x)  # the f32 accumulator
        del g
    loss = loss / microbatches
    grads = _shaped_like(params, (p.div_(microbatches) for a in acc
                                  for p in pieces_of(a)))
    del acc
    return loss, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).  ``batch`` holds ``tokens``, ``labels`` and ``loss_mask``
    (and a VLM's ``embeds``, an encoder-decoder's ``frames``): tensors on
    the parameters' device, or under active rules tensors or leaves
    placed on the mesh (the module's docstring).  The parameters and the
    optimizer state are updated in place (``adamw_update``) and returned;
    the metrics are 0-d tensors (``loss``, ``grad_norm``, ``lr``)."""

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


def data_shards(mesh, rules, B: int) -> list:
    """``[(rows, device, mesh view, at)]`` a data shard: its slice of a
    batch of ``B``, the mesh's first device (row-major) at its ``batch``
    indices ``at``, and :func:`~repro_torch.parallel.sharding.submesh`
    there.  A batch that the ``batch`` axes do not divide is one shard on
    the first device, under the whole mesh (``resolve_spec``'s
    fallback)."""
    names = names_of(resolve_spec((B,), ("batch",), mesh, rules)[0])
    n = math.prod(mesh.shape[a] for a in names)
    out = []
    for d in range(n):
        at = unravel(mesh, names, d)
        out.append((slice(d * B // n, (d + 1) * B // n), device_at(mesh, at),
                    submesh(mesh, at), names))
    return out


def _batch_dims(cfg: ModelConfig) -> dict:
    """Each cache leaf's batch dim (``cache_axes``)."""
    return {k: ax.index("batch") for k, ax in cache_axes(cfg).items()
            if "batch" in ax}


def _rows(x, dim: int, rows: slice, device):
    """Rows ``rows`` along ``dim`` of ``x`` (a tensor, or a :class:`Sharded`
    split there) on ``device``."""
    index = (slice(None),) * dim + (rows,)
    if isinstance(x, Sharded):
        return x.region(index, device)
    return x[index].to(device)


def _part(x, dim: int, d: int, rows: slice):
    """Data shard ``d``'s part of a cache leaf, in place: of a leaf split
    on its batch into the data shards, its piece (the same tensors); else
    a view of its rows."""
    if isinstance(x, Sharded):
        return x.select(dim, d) if x.counts[dim] > 1 else x
    return x[(slice(None),) * dim + (rows,)]


def _split_on_batch(parts: list, dim: int, names, mesh):
    """The data shards' tensors (each on its shard's device) as one
    :class:`Sharded` split on ``dim`` over the ``batch`` axes ``names``."""
    if len(parts) == 1:
        return parts[0]
    shape = list(parts[0].shape)
    shape[dim] *= len(parts)
    spec = P(*[names if i == dim else None for i in range(len(shape))])
    counts, devices = placement(shape, spec, mesh)
    pieces = {tuple(d if i == dim else 0 for i in range(len(shape))): t
              for d, t in enumerate(parts)}
    return Sharded(shape, parts[0].dtype, spec, mesh, counts, pieces,
                   devices)


def make_prefill_fn(cfg: ModelConfig, max_len: int):
    """Returns prefill_fn(params, batch) -> (logits, caches, memory):
    ``batch`` holds ``tokens`` and, for the encoder-decoder family,
    ``frames``, for the VLM family ``embeds``; ``memory`` is ``None`` for
    every family but the encoder-decoder.  Under active rules each data
    shard runs on its device (the module's docstring)."""
    def prefill_fn(params, batch: dict):
        mesh, rules = current_rules()
        if mesh is None or rules is None:
            return prefill(params, cfg, batch["tokens"], max_len,
                           batch.get("frames"), embeds=batch.get("embeds"))
        home = batch["tokens"].device
        outs = []
        shards = data_shards(mesh, rules, batch["tokens"].shape[0])
        for rows, dev, view, _ in shards:
            part = {k: v[rows].to(dev) for k, v in batch.items()}
            with use_sharding_rules(view, rules):
                outs.append(prefill(params, cfg, part["tokens"], max_len,
                                    part.get("frames"),
                                    embeds=part.get("embeds")))
        names = shards[0][3]
        logits = torch.cat([o[0].to(home) for o in outs])
        caches = {k: _split_on_batch([o[1][k] for o in outs], dim, names,
                                     mesh)
                  for k, dim in _batch_dims(cfg).items()}
        caches["length"] = outs[0][1]["length"]
        memory = None if outs[0][2] is None else _split_on_batch(
            [o[2] for o in outs], 0, names, mesh)
        return logits, caches, memory
    return prefill_fn


def make_decode_fn(cfg: ModelConfig):
    """Returns decode_fn(params, tokens, caches, memory=None) -> (logits,
    caches), the caches updated in place.  Under active rules each data
    shard steps its part of the caches on its device."""
    def decode_fn(params, tokens, caches, memory=None):
        mesh, rules = current_rules()
        if mesh is None or rules is None:
            return decode_step(params, cfg, tokens, caches, memory)
        dims = _batch_dims(cfg)
        logits = []
        for d, (rows, dev, view, _) in enumerate(
                data_shards(mesh, rules, tokens.shape[0])):
            part = {k: _part(v, dims[k], d, rows) if k in dims else v
                    for k, v in caches.items()}
            mem = None if memory is None else _rows(memory, 0, rows, dev)
            with use_sharding_rules(view, rules):
                out, _ = decode_step(params, cfg, tokens[rows].to(dev), part,
                                     mem)
            logits.append(out.to(tokens.device))
        return torch.cat(logits), {**caches, "length": caches["length"] + 1}
    return decode_fn
