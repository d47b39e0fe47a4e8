"""Model assembly for the dense decoder-only, encoder-decoder, SSM, hybrid,
MoE and VLM families: config, parameters, forward and loss (training),
prefill and cached decode (serving).

Parameters are a dict shaped like the reference's pytree, with the per-layer
leaves stacked on a leading ``(n_layers, ...)`` axis, so carrying the
reference's parameters across is a copy (``convert.params_from_reference``).
The hybrid's ``groups`` stack two axes, ``(n_groups, hybrid_group - 1,
...)``, and its one ``shared`` attention block is not stacked.
A MoE block is a dense block with its MLP replaced by ``moe``
(:mod:`models.moe`), whose auxiliary loss :func:`forward` sums over the
layers.  The VLM family is the dense stack with ``embeds``, precomputed
patch embeddings, in front of the token embeddings; they carry no loss.
The layer loop is a Python loop over slices of those stacks.
:func:`param_axes` and :func:`cache_axes` are the reference's logical
axes trees, the same structure as the parameters and the decode caches;
``parallel.shard_tree`` places them on a mesh by them.  The functions
here take placed parameters too (``parallel.Sharded`` leaves): each
layer's are gathered on the compute device for that layer only and freed
after it (ZeRO-3), except a MoE layer's expert weights, which its mesh
routes take as pieces; and a decode cache placed on its sequence axis is
read a piece at a time where it lies (``attention.decode_attention``).
Training's :func:`forward` wraps each layer in ``torch.utils.checkpoint``
under ``cfg.remat_policy`` (:func:`_remat`: the reference's
``jax.checkpoint`` and its ``"dots"`` policy), the layer's gather inside
the checkpointed region: the backward gathers the layer again rather than
keeping it, and sends each gradient slice to its piece's device
(``parallel.sharding``), so no device holds the gathered model or its
whole gradient.  :func:`lm_loss_parts` gives the loss's masked sum and
mask count, which a data-parallel step adds over its data shards before
it divides.  Serving runs under ``torch.inference_mode()`` with no
remat.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.attention import (KVCache, attention_axes,
                                          cross_attention, decode_attention,
                                          init_attention, init_cache,
                                          self_attention, update_cache)
from repro_torch.parallel.sharding import (Sharded, as_tensor,
                                           current_rules, pieces_of,
                                           placement, resolve_spec,
                                           shard_tree, use_sharding_rules)

#: the families the port runs
FAMILIES = ("dense", "encdec", "ssm", "hybrid", "moe", "vlm")
#: families of the reference that are not ported yet, and their ROADMAP
#: item: none since the VLM family (A16g)
PENDING_FAMILIES: dict = {}
#: the families whose decoder is a stack of attention blocks, each with a
#: KV cache
ATTN_STACKS = ("dense", "encdec", "moe", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 128
    d_ff: int = 0
    vocab: int = 32000
    act: str = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity: float = 1.25
    # SSM
    d_state: int = 0
    d_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 8
    ssd_chunk: int = 256
    # hybrid (Zamba2): groups of [1 shared attn+MLP block, group_size-1 mamba]
    hybrid_group: int = 6
    # enc-dec
    n_enc_layers: int = 0
    # modality stubs
    input_mode: str = "tokens"     # tokens | embeds_prefix | frames
    prefix_len: int = 0            # vlm: patch positions at seq start
    # perf knobs
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    loss_chunk: int = 1024
    remat_policy: str = "full"     # full | dots | none
    dtype: str = "float32"
    # attention implementation of prefill: "flash" (the flash kernel on
    # the card, its plain version on the CPU) or "xla" (chunked online
    # softmax in torch ops)
    attn_impl: str = "flash"

    def __post_init__(self):
        if self.attn_impl == "stub":
            raise NotImplementedError("attn_impl='stub' is the reference's "
                                      "dry-run billing (ROADMAP A17)")
        if self.attn_impl not in ("flash", "xla"):
            raise ValueError(f"attn_impl must be 'flash' or 'xla'; got "
                             f"{self.attn_impl!r}")

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style); padded logits
        are masked."""
        return -(-self.vocab // 256) * 256

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def hybrid_layout(self) -> Tuple[int, int]:
        """The hybrid's ``(n_groups, tail)``: ``n_groups`` groups of the
        shared attention block and ``hybrid_group - 1`` SSM layers, then
        ``tail`` SSM layers."""
        n_groups = self.n_layers // self.hybrid_group
        return n_groups, self.n_layers - n_groups * self.hybrid_group

    @property
    def causal_attentions(self) -> int:
        """Causal self-attention applications in one forward or prefill:
        the flash kernel's launches there."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.hybrid_layout[0]
        return self.n_layers

    @property
    def tdtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.dtype]

    @property
    def n_params(self) -> int:
        """Analytic parameter count (unpadded vocab)."""
        D, V = self.d_model, self.vocab
        emb = V * D * (1 if self.tie_embeddings else 2)
        att = D * (self.n_heads + 2 * self.n_kv) * self.d_head \
            + self.n_heads * self.d_head * D
        mult = 2 if self.act == "swiglu" else 1
        mlp = D * mult * self.d_ff + self.d_ff * D
        moe = (self.n_experts * (D * mult * self.d_ff + self.d_ff * D)
               + D * self.n_experts) if self.family == "moe" else 0
        H, P, G, N = (self.ssm_heads, self.ssm_head_dim, self.ssm_groups,
                      self.d_state)
        di = H * P
        ssm = (2 * D * di + 2 * D * G * N + D * H + di * D
               + self.d_conv * (di + 2 * G * N) + 3 * H + di)
        if self.family == "dense" or self.family == "vlm":
            return emb + self.n_layers * (att + mlp)
        if self.family == "moe":
            return emb + self.n_layers * (att + moe)
        if self.family == "ssm":
            return emb + self.n_layers * ssm
        if self.family == "hybrid":
            n_groups = self.n_layers // self.hybrid_group
            n_mamba = self.n_layers - n_groups
            return emb + n_mamba * ssm + (att + mlp)
        if self.family == "encdec":
            return emb + self.n_enc_layers * (att + mlp) \
                + self.n_layers * (2 * att + mlp)
        raise ValueError(self.family)


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        item = PENDING_FAMILIES.get(cfg.family)
        if item is None:
            raise ValueError(cfg.family)
        raise NotImplementedError(f"the {cfg.family} family is not ported "
                                  f"yet (ROADMAP {item})")


def require_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run the plain versions")
    return device


# --- init ---------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", mesh=None, rules=None) -> dict:
    """Random parameters: every weight ``normal * scale`` drawn in f32 from
    ``generator`` (on ``device``) and cast, norms ones.  The tree is the
    reference's: ``embed``, ``final_norm`` and the decoder's ``blocks``;
    the encoder-decoder family adds ``enc_blocks`` (dense blocks) and
    ``enc_norm``, and each of its decoder blocks a cross-attention
    (``ln_x``, ``xattn``: no qk-norm).  An SSM block is ``ln`` and ``ssm``
    (:func:`ssm.init_ssm`; its ``A_log``, ``D_skip`` and ``dt_bias`` stay
    f32).  The hybrid has no ``blocks`` but one ``shared`` dense block,
    ``groups`` of SSM blocks stacked ``(n_groups, hybrid_group - 1, ...)``
    and, when ``n_layers % hybrid_group``, a ``tail`` of SSM blocks.  A MoE
    block has ``moe`` (:func:`moe.init_moe`; its ``router`` stays f32) in
    place of ``mlp``.  Each stacked leaf is allocated once and every
    layer's draw is copied into its slice (:func:`_stacked`).

    With ``mesh`` and ``rules``, the same values placed on the mesh by
    :func:`param_axes` (``parallel.Sharded`` leaves): each stacked leaf
    is allocated as its pieces on their devices and each layer's draw (on
    ``device``) copied into them, so no device holds the whole model."""
    _require_ported(cfg)
    device = require_device(device)
    dt, D = cfg.tdtype, cfg.d_model
    axes = param_axes(cfg) if mesh is not None else None

    def stacked(draw, lead, key):
        if axes is None:
            return _stacked(draw, lead)
        return _stacked(draw, lead, lambda layer: _empty_pieces(
            layer, axes[key], lead, mesh, rules))

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def block(kind):
        if kind == "ssm":
            return {"ln": ones(D),
                    "ssm": SSM.init_ssm(cfg, dt, generator, device)}
        p = {"ln1": ones(D),
             "attn": init_attention(D, cfg.n_heads, cfg.n_kv, cfg.d_head,
                                    cfg.qk_norm, dt, generator, device),
             "ln2": ones(D)}
        if kind == "moe":
            p["moe"] = MOE.init_moe(D, cfg.n_experts, cfg.d_ff, cfg.act, dt,
                                    generator, device)
        else:
            p["mlp"] = L.init_mlp(D, cfg.d_ff, cfg.act, dt, generator,
                                  device)
        if kind == "dec":
            p["ln_x"] = ones(D)
            p["xattn"] = init_attention(D, cfg.n_heads, cfg.n_kv, cfg.d_head,
                                        False, dt, generator, device)
        return p

    # the blocks are drawn before the embedding, so a seed gives the dense
    # family the weights it always had
    params = {}
    if cfg.family == "encdec":
        params["enc_blocks"] = stacked(lambda: block("dense"),
                                       (cfg.n_enc_layers,), "enc_blocks")
        params["enc_norm"] = ones(D)
        params["blocks"] = stacked(lambda: block("dec"), (cfg.n_layers,),
                                   "blocks")
    elif cfg.family == "hybrid":
        n_groups, tail = cfg.hybrid_layout
        params["shared"] = block("dense")
        params["groups"] = stacked(lambda: block("ssm"),
                                   (n_groups, cfg.hybrid_group - 1),
                                   "groups")
        if tail:
            params["tail"] = stacked(lambda: block("ssm"), (tail,), "tail")
    else:
        kind = cfg.family if cfg.family in ("ssm", "moe") else "dense"
        params["blocks"] = stacked(lambda: block(kind), (cfg.n_layers,),
                                   "blocks")
    params["embed"] = L.init_embed(cfg.padded_vocab, D, dt,
                                   cfg.tie_embeddings, generator, device)
    params["final_norm"] = ones(D)
    if axes is not None:
        params = shard_tree(params, axes, mesh, rules, copy=True)
    return params


def _stacked(draw, lead: tuple, empty=None) -> dict:
    """``draw()`` called ``prod(lead)`` times in row-major order of the
    leading indices, each call's tree copied into its slice of leaves
    allocated once with the leading dims ``lead`` (by ``empty(first
    draw)`` when given): the tensors that stacking the draws gives, with
    one layer's draw alive beside the stacked leaves, never a second
    stack."""
    out = None
    for index in itertools.product(*map(range, lead)):
        layer = draw()
        if out is None:
            out = empty(layer) if empty is not None else _tree_map(
                lambda t: t.new_empty(lead + tuple(t.shape)), layer)
        _copy_into(out, layer, index)
        del layer       # before the next draw, not after it
    return out


def _empty_pieces(layer, axes, lead: tuple, mesh, rules):
    """Leaves of the leading dims ``lead`` placed on ``mesh`` by ``axes``,
    each an uninitialised :class:`Sharded` of its pieces."""
    if isinstance(layer, dict):
        return {k: _empty_pieces(v, axes[k], lead, mesh, rules)
                for k, v in layer.items()}
    shape = lead + tuple(layer.shape)
    spec = resolve_spec(shape, axes, mesh, rules)
    counts, devices = placement(shape, spec, mesh)
    local = tuple(n // c for n, c in zip(shape, counts))
    return Sharded(shape, layer.dtype, spec, mesh, counts,
                   {c: torch.empty(local, dtype=layer.dtype, device=dev)
                    for c, dev in devices.items()}, devices)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _copy_into(out, layer, index) -> None:
    if isinstance(out, dict):
        for k in out:
            _copy_into(out[k], layer[k], index)
    elif isinstance(out, Sharded):
        out.write(index, layer)
    else:
        out[index].copy_(layer)


# --- logical axes ------------------------------------------------------------

def _block_axes(cfg: ModelConfig, kind: str) -> dict:
    """Logical axes of one block of ``kind`` (``dense``, ``moe``, ``ssm``
    or ``dec``)."""
    if kind == "ssm":
        return {"ln": (None,), "ssm": SSM.ssm_axes()}
    p = {"ln1": (None,), "attn": attention_axes(cfg.qk_norm), "ln2": (None,)}
    if kind == "moe":
        p["moe"] = MOE.moe_axes()
    else:
        p["mlp"] = L.mlp_axes()
    if kind == "dec":
        p["ln_x"] = (None,)
        p["xattn"] = attention_axes(False)
    return p


def _lead(axes, *names):
    return {k: _lead(v, *names) for k, v in axes.items()} \
        if isinstance(axes, dict) else (*names, *axes)


def _stack_axes(cfg: ModelConfig, kind: str) -> dict:
    """A stack of blocks: ``"layers"`` before each block axis."""
    return _lead(_block_axes(cfg, kind), "layers")


def param_axes(cfg: ModelConfig) -> dict:
    """The logical axes of :func:`init_params`' tree, leaf for leaf (the
    reference's ``param_axes``)."""
    _require_ported(cfg)
    axes: dict = {"embed": L.embed_axes(cfg.tie_embeddings),
                  "final_norm": (None,)}
    if cfg.family in ("dense", "vlm"):
        axes["blocks"] = _stack_axes(cfg, "dense")
    elif cfg.family in ("moe", "ssm"):
        axes["blocks"] = _stack_axes(cfg, cfg.family)
    elif cfg.family == "hybrid":
        axes["shared"] = _block_axes(cfg, "dense")
        axes["groups"] = _lead(_stack_axes(cfg, "ssm"), "layers")
        if cfg.n_layers % cfg.hybrid_group:
            axes["tail"] = _stack_axes(cfg, "ssm")
    elif cfg.family == "encdec":
        axes["enc_blocks"] = _stack_axes(cfg, "dense")
        axes["enc_norm"] = (None,)
        axes["blocks"] = _stack_axes(cfg, "dec")
    return axes


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical axes of :func:`make_decode_caches`' tree (the reference's
    ``cache_axes``): a KV cache on ``kv_seq`` (context-parallel decode),
    an SSM state and conv window on ``heads``; ``"length"`` has none."""
    _require_ported(cfg)
    kv = ("layers", "batch", "kv_seq", "kv_heads", None)
    if cfg.family in ATTN_STACKS:
        return {"k": kv, "v": kv, "length": ()}
    if cfg.family == "ssm":
        return {"conv": ("layers", "batch", None, "heads"),
                "state": ("layers", "batch", "heads", None, None),
                "length": ()}
    ax = {"attn_k": kv, "attn_v": kv,
          "conv": ("layers", "stage", "batch", None, "heads"),
          "state": ("layers", "stage", "batch", "heads", None, None),
          "length": ()}
    if cfg.n_layers % cfg.hybrid_group:
        ax["tail_conv"] = ("layers", "batch", None, "heads")
        ax["tail_state"] = ("layers", "batch", "heads", None, None)
    return ax


def _on(tree, device, pieces_ok: bool = False):
    """``tree`` with each :class:`Sharded` leaf gathered on ``device``
    (the ZeRO-3 gather of one layer) and each tensor moved there (a data
    shard's copy of an unplaced leaf; none on its own device), but a MoE
    block's ``w_in`` and ``w_out``, which its mesh routes take as
    pieces."""
    if isinstance(tree, dict):
        return {k: _on(v, device, k == "moe") if isinstance(v, dict)
                else v if pieces_ok and k in ("w_in", "w_out")
                else as_tensor(v, device)
                if isinstance(v, (Sharded, torch.Tensor)) else v
                for k, v in tree.items()}
    return tree


def _placed(tree) -> bool:
    if isinstance(tree, dict):
        return any(_placed(v) for v in tree.values())
    return isinstance(tree, Sharded)


def _unstack(blocks, n: int) -> list:
    """Every layer's parameters (views into the stacked leaves), from one
    ``unbind(0)`` per stacked leaf.
    Under autograd, indexing ``blocks[i]`` once per layer would give each
    layer's backward a zero gradient the size of the whole stack; one
    ``unbind`` has one backward node that stacks the ``n`` slices'
    gradients."""
    if isinstance(blocks, dict):
        parts = {k: _unstack(v, n) for k, v in blocks.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(blocks.unbind(0))


# --- forward / prefill ---------------------------------------------------------

def _ffn(x, bp, cfg: ModelConfig):
    """A block's pre-norm MLP or, in a MoE block, its experts: ``(h, the
    MoE's aux loss or None)``."""
    xn = L.rms_norm(x, bp["ln2"], cfg.norm_eps)
    if "moe" in bp:
        return MOE.apply_moe(xn, bp["moe"], cfg)
    return L.apply_mlp(xn, bp["mlp"], cfg.act), None


def _dense_body(x, bp, cfg: ModelConfig, *, causal: bool = True,
                memory=None, collect: bool = False):
    """One pre-norm block: self-attention, then (a decoder block, with
    ``memory``) cross-attention to it, then the MLP or the experts, each
    with a residual.  Returns ``(x, (k, v) or None, the MoE's aux loss or
    None)``."""
    pos = torch.arange(x.shape[1], device=x.device)
    h = self_attention(L.rms_norm(x, bp["ln1"], cfg.norm_eps), bp["attn"],
                       cfg, pos, causal=causal, return_kv=collect)
    kv = None
    if collect:
        h, kv = h
    x = x + h
    if "xattn" in bp:
        x = x + cross_attention(L.rms_norm(x, bp["ln_x"], cfg.norm_eps),
                                memory, bp["xattn"], cfg)
    h, aux = _ffn(x, bp, cfg)
    return x + h, kv, aux


def _ssm_body(x, bp, cfg: ModelConfig, collect: bool = False):
    """One pre-norm SSM block with its residual.  Returns ``(x, (final
    state, conv tail) or None)``."""
    h, handoff = SSM.apply_ssm(L.rms_norm(x, bp["ln"], cfg.norm_eps),
                               bp["ssm"], cfg)
    return x + h, (handoff if collect else None)


def _layers(params, cfg: ModelConfig, device=None):
    """The decoder's layers in order: ``(kind, block params, cache keys,
    index)`` with ``kind`` ``"attn"`` (a dense or decoder block, its K and
    V at ``caches[keys[0]][index]``, ``caches[keys[1]][index]``) or
    ``"ssm"`` (its conv tail and state there).  The hybrid applies
    ``params["shared"]`` at the head of every group, each application with
    its own KV cache.  Placed parameters are gathered on ``device`` a
    layer at a time, as each is yielded (:func:`_on`)."""
    if device is not None and _placed(params):
        for kind, bp, keys, i in _layers(params, cfg):
            yield kind, _on(bp, device), keys, i
        return
    if cfg.family in ATTN_STACKS:
        for i, bp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            yield "attn", bp, ("k", "v"), (i,)
    elif cfg.family == "ssm":
        for i, bp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            yield "ssm", bp, ("conv", "state"), (i,)
    else:
        n_groups, tail = cfg.hybrid_layout
        for g, gp in enumerate(_unstack(params["groups"], n_groups)):
            yield "attn", params["shared"], ("attn_k", "attn_v"), (g,)
            for j, bp in enumerate(_unstack(gp, cfg.hybrid_group - 1)):
                yield "ssm", bp, ("conv", "state"), (g, j)
        if tail:
            for i, bp in enumerate(_unstack(params["tail"], tail)):
                yield "ssm", bp, ("tail_conv", "tail_state"), (i,)


def _check_length(cfg: ModelConfig, S: int) -> None:
    """A sequence the scan takes: whole SSD chunks in the families that
    have SSM layers."""
    if cfg.family in ("ssm", "hybrid"):
        SSM.check_chunks(S, cfg.ssd_chunk)


def _gathered(args) -> list:
    """``args`` with each dict of parameters gathered (:func:`_on`) on the
    device of the first tensor among them (the activations')."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    return [_on(a, device) if isinstance(a, dict) else a for a in args]


def _remat(fn, policy: str):
    """``fn`` under the reference's remat policy, its dict arguments (a
    block's parameters, placed or not) gathered inside it
    (:func:`_gathered`): ``"full"`` recomputes the whole body, the gather
    included, in the backward (``torch.utils.checkpoint``, not
    reentrant), ``"none"`` keeps every activation, and ``"dots"`` (the
    reference's ``dots_with_no_batch_dims_saveable``) keeps the body's
    weight products and recomputes the rest (:func:`_dots_policy`).
    The recomputation runs under the sharding rules active in the
    forward: autograd runs a CUDA backward on a thread of its own for
    each device, where the thread's rules are unset, and a MoE layer
    recomputed without them would take another route."""
    if policy == "none" or not torch.is_grad_enabled():
        return lambda *args: fn(*_gathered(args))
    if policy not in ("full", "dots"):
        raise ValueError(f"unknown remat_policy {policy!r}")

    def run(*args):
        mesh, rules = current_rules()
        weights: set = set()

        def body(*a):
            with use_sharding_rules(mesh, rules):
                a = _gathered(a)
                if policy == "dots":
                    # this run's gathered weights only: a storage freed
                    # since may hold an activation now
                    weights.clear()
                    weights.update(*(_storages(v) for v in a
                                     if isinstance(v, dict)))
                return fn(*a)
        if policy == "full":
            return checkpoint(body, *args, use_reentrant=False)
        return checkpoint(
            body, *args, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy(weights)))
    return run


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _storages(tree: dict) -> set:
    """The storages (by address) of the tensors of nested dicts (a MoE
    block's expert weights left in pieces: theirs)."""
    return set().union(*(_storages(v) if isinstance(v, dict)
                         else {p.untyped_storage().data_ptr()
                               for p in pieces_of(v)}
                         for v in tree.values()))


def _dots_policy(weights: set):
    """The selective-checkpoint policy of ``"dots"`` for a body whose
    gathered parameters' storages ``weights`` holds: save each product
    with no batch dimension (``aten.mm``, or ``aten.bmm`` over a batch of
    1, as an ``einsum`` may give) of which one operand is a weight, i.e.
    shares its storage with a tensor of the block's parameter dicts;
    recompute every other op.  So the
    projections and the MLP's products are kept, and attention's batched
    score products are recomputed, as the reference's policy does; the
    flash kernels run outside the dispatcher and are recomputed, as the
    reference recomputes its ``pallas_call``."""
    def policy(ctx, op, *a, **kw):
        if op in _PRODUCTS and (op is _PRODUCTS[0] or a[0].shape[0] == 1) \
                and any(t.untyped_storage().data_ptr() in weights
                        for t in a[:2]):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _encode(params, cfg: ModelConfig, frames):
    """The encoder-decoder family's memory: the encoder's bidirectional
    blocks over ``frames`` (B, S_enc, D) cast to the model's dtype, each
    under ``cfg.remat_policy``, then ``enc_norm``."""
    if frames is None:
        raise ValueError(f"{cfg.name} (family encdec) needs frames: "
                         f"(B, S_enc, d_model) frame embeddings")
    body = _remat(lambda x, bp: _dense_body(x, bp, cfg, causal=False)[0],
                  cfg.remat_policy)
    x = frames.to(cfg.tdtype)
    for bp in _unstack(params["enc_blocks"], cfg.n_enc_layers):
        x = body(x, bp)
    return L.rms_norm(x, as_tensor(params["enc_norm"], x.device),
                      cfg.norm_eps)


def _embed(params, cfg: ModelConfig, tokens, embeds):
    """The tokens' embeddings, with a VLM's ``embeds`` (B, P, D), cast to
    the model's dtype, in front of them; ``embeds`` is ignored in the
    other families, as in the reference."""
    x = L.embed_tokens(tokens, {"tok": as_tensor(params["embed"]["tok"],
                                                 tokens.device)},
                       cfg.tdtype)
    if cfg.family == "vlm" and embeds is not None:
        x = torch.cat([embeds.to(cfg.tdtype), x], dim=1)
    return x


def _head(params, cfg: ModelConfig, x):
    """The final norm and the logits (f32) of ``x``."""
    x = L.rms_norm(x, as_tensor(params["final_norm"], x.device),
                   cfg.norm_eps)
    return L.lm_logits(x, _on(params["embed"], x.device), cfg.vocab).float()


def forward(params, cfg: ModelConfig, tokens, frames=None, *, embeds=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (hidden (B,S,D), aux_loss scalar).
    Each layer (each application of the hybrid's shared block too) runs
    under ``cfg.remat_policy`` when autograd records.  ``aux`` is the sum
    of the MoE layers' auxiliary losses (f32; 0 in the other families).
    ``frames``: (B, S_enc, D) encoder-side frame embeddings (encdec);
    ``embeds``: (B, P, D) patch embeddings at the head of the sequence
    (vlm: ``hidden`` is then (B, P + S, D))."""
    _require_ported(cfg)
    _check_length(cfg, tokens.shape[1])
    memory = _encode(params, cfg, frames) if cfg.family == "encdec" \
        else None
    attn = _remat(lambda x, bp, mem: _dense_body(x, bp, cfg,
                                                 memory=mem)[::2],
                  cfg.remat_policy)
    mamba = _remat(lambda x, bp: _ssm_body(x, bp, cfg)[0], cfg.remat_policy)
    x = _embed(params, cfg, tokens, embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, bp, _, _ in _layers(params, cfg):
        if kind == "ssm":
            x = mamba(x, bp)
            continue
        x, a = attn(x, bp, memory)
        if a is not None:
            aux = aux + a
    return L.rms_norm(x, as_tensor(params["final_norm"], x.device),
                      cfg.norm_eps), aux


def _chunk_loss(h, head, labels, mask, pad_mask):
    """Summed masked cross-entropy of one chunk: f32 logits over the
    padded vocab, the padding masked by ``pad_mask``."""
    logits = (h @ head).float() + pad_mask
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    return ((lse - gold) * mask).sum()


def lm_loss(params, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """Chunked softmax cross-entropy, f32 0-d: :func:`lm_loss_parts`'
    masked sum over its mask count (at least 1), plus ``1e-2`` times the
    MoE layers' aux loss, as the reference divides."""
    total, count, aux = lm_loss_parts(params, cfg, batch)
    return total / count.clamp_min(1.0) + 1e-2 * aux


def lm_loss_parts(params, cfg: ModelConfig, batch: dict):
    """``(masked sum, mask count, aux)`` of :func:`lm_loss`, each f32 0-d:
    the cross-entropy summed over the positions the mask keeps, the
    mask's sum (over the positions of whole chunks), and the summed aux
    loss of :func:`forward`.  ``batch`` holds ``tokens``
    and ``labels`` (B, S), optionally ``loss_mask`` (B, S) and, for the
    encoder-decoder family, ``frames`` (B, S_enc, D), for the VLM family
    ``embeds`` (B, P, D), whose P positions carry no loss: their hidden
    rows are dropped before the head.  The loss
    is taken over ``cfg.loss_chunk`` positions at a time, and under
    autograd each chunk is a ``torch.utils.checkpoint`` region, so only one
    chunk's (B, C, padded vocab) logits are alive at a time, backward
    included."""
    embeds = batch.get("embeds")
    hidden, aux = forward(params, cfg, batch["tokens"], batch.get("frames"),
                          embeds=embeds)
    if cfg.family == "vlm" and embeds is not None:
        hidden = hidden[:, embeds.shape[1]:]
    labels = batch["labels"].long()
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=hidden.device)
    B, S, D = hidden.shape
    C = min(cfg.loss_chunk, S)
    nc = S // C
    emb = _on(params["embed"], hidden.device)
    head = emb["head"] if "head" in emb else emb["tok"].T
    cols = torch.arange(cfg.padded_vocab, device=hidden.device)
    pad_mask = torch.where(cols < cfg.vocab, 0.0, -1e30)
    chunk = _remat(_chunk_loss, "full")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nc):
        sl = slice(c * C, (c + 1) * C)
        total = total + chunk(hidden[:, sl], head, labels[:, sl],
                              mask[:, sl], pad_mask)
    return total, mask[:, :nc * C].sum(), aux


def prefill(params, cfg: ModelConfig, tokens, max_len: int, frames=None,
            *, embeds=None
            ) -> Tuple[torch.Tensor, dict, Optional[torch.Tensor]]:
    """Process the prompt and build decode caches padded to ``max_len``.

    Returns (last-position logits (B,1,V) f32, caches, memory): the caches
    are :func:`make_decode_caches`' with the prompt's K and V written at
    positions ``[0, S)`` and each SSM layer's final state and conv tail,
    and ``"length"`` (an int); ``memory`` is the encoder-decoder family's
    encoder output over ``frames`` (B, S_enc, D), which :func:`decode_step`
    attends to, and ``None`` for the other families.  A VLM's ``embeds``
    (B, P, D) go in front of the prompt: S counts its P + S_tok positions,
    which ``max_len`` must hold (the reference pads by a negative width
    there and fails).  A family with SSM layers takes a prompt of whole
    ``ssd_chunk`` chunks, or one shorter than a chunk."""
    _require_ported(cfg)
    B, S_tok = tokens.shape
    _check_length(cfg, S_tok)
    x = _embed(params, cfg, tokens, embeds)
    S = x.shape[1]
    if max_len < S:
        prefix = (f" ({S - S_tok} prefix + {S_tok} token positions)"
                  if S > S_tok else "")
        raise ValueError(f"max_len={max_len} < prompt length {S}{prefix}")
    memory = _encode(params, cfg, frames) if cfg.family == "encdec" \
        else None
    caches = make_decode_caches(cfg, B, max_len, x.device)
    for kind, bp, (a, b), i in _layers(params, cfg, x.device):
        if kind == "attn":
            x, (k, v), _ = _dense_body(x, bp, cfg, memory=memory,
                                       collect=True)
            caches[a][i][:, :S] = k
            caches[b][i][:, :S] = v
        else:
            x, (state, tail) = _ssm_body(x, bp, cfg, collect=True)
            caches[a][i] = tail
            caches[b][i] = state
    caches["length"] = S
    return _head(params, cfg, x[:, -1:]), caches, memory


# --- decode -------------------------------------------------------------------

def make_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device="cuda") -> dict:
    """Zeroed caches in the model's dtype, with ``"length"`` 0: ``k``,
    ``v`` ``(n_layers, B, max_len, n_kv, d_head)`` (dense, encdec, moe,
    vlm);
    ``conv`` ``(n_layers, B, d_conv - 1, d_inner + 2 G N)`` and ``state``
    ``(n_layers, B, H, P, N)`` (ssm); the hybrid's ``attn_k``, ``attn_v``
    ``(n_groups, B, max_len, ...)``, ``conv``, ``state`` ``(n_groups,
    hybrid_group - 1, B, ...)`` and, with a tail, ``tail_conv``,
    ``tail_state`` ``(tail, B, ...)``."""
    _require_ported(cfg)
    device = require_device(device)
    dt = cfg.tdtype
    if cfg.family in ATTN_STACKS:
        cache = init_cache(cfg, batch, max_len, cfg.n_layers, dt, device)
        return {"k": cache.k, "v": cache.v, "length": cache.length}

    def ssm_caches(*lead, prefix=""):
        c = SSM.init_ssm_cache(cfg, batch, dt, device, lead)
        return {prefix + "conv": c.conv, prefix + "state": c.state}
    if cfg.family == "ssm":
        return {**ssm_caches(cfg.n_layers), "length": 0}
    n_groups, tail = cfg.hybrid_layout
    kv = init_cache(cfg, batch, max_len, n_groups, dt, device)
    caches = {"attn_k": kv.k, "attn_v": kv.v,
              **ssm_caches(n_groups, cfg.hybrid_group - 1), "length": 0}
    if tail:
        caches.update(ssm_caches(tail, prefix="tail_"))
    return caches


def _decode_attn_block(x, bp, cfg: ModelConfig, cache: KVCache, memory):
    """One dense, decoder or MoE block for one token, this token's K and V
    written into ``cache`` in place; a MoE block's aux loss is dropped, as
    in the reference's decode."""
    h, (kn, vn) = decode_attention(
        L.rms_norm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, cache)
    x = x + h
    if "xattn" in bp:
        x = x + cross_attention(L.rms_norm(x, bp["ln_x"], cfg.norm_eps),
                                memory, bp["xattn"], cfg)
    h, _ = _ffn(x, bp, cfg)
    update_cache(cache, kn, vn)
    return x + h


def decode_step(params, cfg: ModelConfig, tokens, caches: dict, memory=None
                ) -> Tuple[torch.Tensor, dict]:
    """One decode step: tokens (B,1) -> (logits (B,1,V) f32, caches).

    The caches are updated in place: the returned dict holds the same
    tensors, with this step's K/V written at ``length`` and each SSM
    layer's conv window and state stepped, and ``length + 1``.  A decoder
    block with cross-attention attends to ``memory`` (:func:`prefill`'s),
    re-projecting its K and V in every layer at every step, as the
    reference does."""
    _require_ported(cfg)
    if cfg.family == "encdec" and memory is None:
        raise ValueError(f"{cfg.name} (family encdec) decodes against the "
                         f"encoder memory that prefill returns")
    x = _embed(params, cfg, tokens, None)
    length = caches["length"]
    kv = caches.get("k", caches.get("attn_k"))
    if kv is not None and length >= kv.shape[2]:
        raise ValueError(f"the cache holds {kv.shape[2]} positions, all "
                         f"used")
    for kind, bp, (a, b), i in _layers(params, cfg, x.device):
        if kind == "attn":
            x = _decode_attn_block(x, bp, cfg,
                                   KVCache(caches[a][i], caches[b][i],
                                           length), memory)
        else:
            x = x + _decode_ssm_block(x, bp, cfg, caches[a][i],
                                      caches[b][i])
    return _head(params, cfg, x), {**caches, "length": length + 1}


def _decode_ssm_block(x, bp, cfg: ModelConfig, conv, state):
    """One SSM block's output for one token, its conv window and state
    stepped in place; a placed window or state (split on ``heads``) is
    gathered on ``x``'s device for the step and written back."""
    placed = isinstance(conv, Sharded), isinstance(state, Sharded)
    c = conv.gather(x.device) if placed[0] else conv
    st = state.gather(x.device) if placed[1] else state
    h, _ = SSM.decode_ssm(L.rms_norm(x, bp["ln"], cfg.norm_eps), bp["ssm"],
                          cfg, SSM.SSMCache(c, st))
    if placed[0]:
        conv.write((), c)
    if placed[1]:
        state.write((), st)
    return h
