"""Checks shared by the SSM, hybrid, MoE and VLM family tests
(``tests/test_torch_ssm.py``, ``tests/test_torch_hybrid.py``,
``tests/test_torch_moe.py``, ``tests/test_torch_vlm.py``): a smoke
config of the port against the reference on the CPU, on the same numpy
inputs and the reference's own ``init_params`` carried across.  The
reference runs ``attn_impl="pallas"`` (its flash kernel in interpret mode)
for the hybrid's shared attention.  A VLM's inputs add ``embeds``, patch
embeddings in front of its tokens: it takes ``seq_of(cfg)`` tokens, so
that its prefix and tokens fill the same S positions (the attention takes
whole multiples of the smoke configs' 16-position chunks).  The bounds
are those of ``tests/test_torch_encdec.py``: f32 on both sides, summed in
other orders."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.checkpoint import latest_step
from repro_torch.convert import (caches_from_reference,
                                 opt_state_from_reference,
                                 params_from_reference)
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step
from repro_torch.train.steps import _loss_and_grads

from _torch_conformance import assert_close  # noqa: F401  (sets threads)

#: batch, prompt length (4 chunks of the smoke configs' ssd_chunk 8), tokens
#: generated
B, S, MAX_NEW = 2, 32, 5
#: logits and caches to 2e-4 after prefill, 3e-4 after decode
PREFILL_TOL = 2e-4
DECODE_TOL = 3e-4
#: the loss to 1e-5 of itself, each gradient element (and each state leaf
#: after 3 steps) to 1e-4 of its leaf's largest
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
#: the AdamW steps' eps.  AdamW divides each element's moment by that
#: element's own root mean square, so where a gradient element is near zero
#: a difference within the gradient bound (GRAD_TOL of the leaf's largest)
#: becomes an update difference of up to 2 lr: with the default 1e-8 the
#: hybrid's params differed by 2.7e-4 of a leaf's largest after 3 steps
#: (w_z; its gradients agree to 3e-8).  1e-3, above the gradients' noise,
#: keeps the comparison well-conditioned (measured 1.6e-6)
STEP_EPS = 1e-3
#: bf16, 3 steps: the reference's XLA keeps f32 through fused elementwise
#: chains where torch rounds each op to bf16 (one bf16 ulp is 2**-7), so
#: the gradients differ by up to 3.2% (mamba2) and 7.6% (zamba2) of a
#: leaf's largest after one backward (1.2% for qwen3-1.7b's dense smoke
#: config).  The loss is held to 2e-3 of itself, and the bf16 leaves and
#: their f32 masters to 2e-2 of a leaf's largest (tests/test_torch_train.py's
#: bf16 bounds; measured 0.58%); m, v and the f32 leaves, which are the
#: gradients' own statistics and updates, are not compared in bf16
BF16_LOSS_RTOL, BF16_TOL = 2e-3, 2e-2
#: the leaves that are f32 whatever the model's dtype: an SSM layer's
#: ``A_log``, ``D_skip``, ``dt_bias`` and a MoE layer's ``router``
F32_LEAVES = ("A_log", "D_skip", "dt_bias", "router")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def flat(tree, prefix=""):
    """``{"a/b/c": f32 numpy}`` of a tree's non-None leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = (v.detach().float().numpy()
                                   if isinstance(v, torch.Tensor)
                                   else np.asarray(v, np.float32))
    return out


def dtypes(tree, prefix=""):
    """``{"a/b/c": torch dtype}`` of a tree's tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(dtypes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v.dtype
    return out


def assert_trees_close(got, want, rel):
    """Every leaf within ``rel`` of the largest element of the want leaf."""
    g, w = flat(got), flat(want)
    assert g.keys() == w.keys()
    for key in w:
        scale = max(float(np.abs(w[key]).max()), 1e-30)
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=rel * scale,
                                   err_msg=key)


@functools.lru_cache(maxsize=None)
def model(arch, dtype="float32"):
    """The reference's smoke config (``"pallas"`` attention, ``dtype``)
    and its ``init_params`` from key 0, and the port's config and the same
    parameters carried across."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               attn_impl="pallas", dtype=dtype)
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=dtype)
    jparams = reference_params(jcfg)
    return jcfg, cfg, jparams, params_from_reference(cfg, np_tree(jparams))


def seq_of(cfg, positions=S):
    """The tokens that fill ``positions`` positions: all of them, or a
    VLM's after its ``prefix_len`` patch embeddings."""
    return positions - (cfg.prefix_len if cfg.family == "vlm" else 0)


def prompts(arch, seed, batch=B, seq=None):
    cfg = configs.smoke_config(arch)
    seq = seq_of(cfg) if seq is None else seq
    return np.random.default_rng(seed).integers(1, cfg.vocab, (batch, seq),
                                                dtype=np.int32)


def embeds(arch, seed, batch=B):
    """A VLM's patch embeddings (batch, prefix_len, d_model), f32 standard
    normal from ``seed``; ``None`` for the other families."""
    cfg = configs.smoke_config(arch)
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.prefix_len, cfg.d_model)).astype(np.float32)


def as_tensor(a):
    """A numpy input as the port takes it (``None`` stays ``None``)."""
    return None if a is None else torch.from_numpy(a)


def as_jnp(a):
    return None if a is None else jnp.asarray(a)


@functools.lru_cache(maxsize=None)
def jit_prefill(jcfg, max_len):
    return jax.jit(lambda p, t, e=None: jtf.prefill(p, jcfg, t, max_len,
                                                     embeds=e)[:2])


@functools.lru_cache(maxsize=None)
def jit_decode(jcfg):
    return jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))


@functools.lru_cache(maxsize=None)
def jit_loss(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jtf.lm_loss(p, jcfg, b)))


def data_config(cfg, seed, batch=4, seq=None):
    """The reference's pipeline config for ``cfg``: a VLM's in
    ``"embeds_prefix"`` mode (``embeds`` in its batches, the first label
    masked), ``seq_of(cfg)`` tokens by default."""
    vlm = cfg.family == "vlm"
    return JDataConfig(vocab=cfg.vocab,
                       seq_len=seq_of(cfg) if seq is None else seq,
                       global_batch=batch, seed=seed,
                       prefix_len=cfg.prefix_len, d_model=cfg.d_model,
                       mode="embeds_prefix" if vlm else "tokens")


def host_batch(cfg, seed, batch=4, seq=None):
    return JDataset(data_config(cfg, seed, batch, seq)).batch_at(0)


# --- the checks --------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_params(jcfg):
    """The reference's ``init_params(PRNGKey(0), jcfg)``, jitted."""
    return jax.jit(lambda k: jtf.init_params(k, jcfg))(jax.random.PRNGKey(0))


def check_tree(jcfg, cfg, bf16: bool = True):
    """The port's ``init_params`` tree (keys, shapes) equal to the
    reference's for ``cfg``, and every leaf carried across equal; with
    ``bf16``, in a bf16 tree the ``F32_LEAVES`` (an SSM layer's ``A_log``,
    ``D_skip`` and ``dt_bias``, a MoE layer's ``router``) stay f32 on both
    sides and every other leaf is bf16.  Returns the flat keys."""
    jparams = np_tree(reference_params(jcfg))
    want = flat(jparams)
    got = flat(params_from_reference(cfg, jparams))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ours = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    assert {k: v.shape for k, v in flat(ours).items()} \
        == {k: v.shape for k, v in want.items()}
    if not bf16:
        return got.keys()
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    jbf = reference_params(dataclasses.replace(jcfg, dtype="bfloat16"))
    for tree in (transformer.init_params(bf, torch.Generator().manual_seed(0),
                                         "cpu"),
                 params_from_reference(bf, np_tree(jbf))):
        kinds = dtypes(tree)
        f32 = {k for k, t in kinds.items() if t == torch.float32}
        assert f32 == {k for k in kinds if k.split("/")[-1] in F32_LEAVES}
        assert f32 and all(t == torch.bfloat16 for k, t in kinds.items()
                           if k not in f32)
    jdt = {jax.tree_util.keystr(k): v.dtype for k, v in
           jax.tree_util.tree_flatten_with_path(jbf)[0]}
    assert {k for k, v in jdt.items() if v == jnp.float32} == {
        k for k in jdt if any(f"'{n}'" in k for n in F32_LEAVES)}
    return got.keys()


def check_forward(arch):
    jcfg, cfg, jparams, params = model(arch)
    tokens, emb = prompts(arch, 4), embeds(arch, 6)
    hidden, aux = transformer.forward(params, cfg,
                                      torch.from_numpy(tokens).long(),
                                      embeds=as_tensor(emb))
    jhidden, jaux = jax.jit(lambda p, t, e: jtf.forward(p, jcfg, t,
                                                        embeds=e))(
        jparams, jnp.asarray(tokens), as_jnp(emb))
    assert hidden.shape == (B, S, cfg.d_model)
    close(hidden, jhidden, PREFILL_TOL)
    if cfg.family != "moe":
        assert float(aux) == float(jaux) == 0.0
    else:
        # the MoE layers' load-balance and z-loss terms, summed over layers
        assert float(jaux) > 0
        np.testing.assert_allclose(float(aux), float(jaux), rtol=LOSS_RTOL)


def check_loss_and_grads(arch):
    """``lm_loss`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's; returns the port's gradients (flat)."""
    jcfg, cfg, jparams, params = model(arch)
    host = host_batch(cfg, seed=0)
    want_loss, want_grads = jit_loss(jcfg)(
        jparams, {k: jnp.asarray(v) for k, v in host.items()})
    loss, grads = _loss_and_grads(params, cfg,
                                  launch_train.device_batch(host, "cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    assert_trees_close(grads, np_tree(want_grads), GRAD_TOL)
    assert dtypes(grads) == dtypes(params)
    return flat(grads)


def check_prefill_and_decode(arch, steps=5):
    """Prefill's logits and every cache key, then ``steps`` teacher-forced
    decode steps from the reference's caches carried across, against the
    reference's jitted ``prefill`` and ``decode_step``."""
    jcfg, cfg, jparams, params = model(arch)
    tokens, emb = prompts(arch, 4), embeds(arch, 6)
    max_len = S + steps
    jlogits, jcaches = jit_prefill(jcfg, max_len)(
        jparams, jnp.asarray(tokens), as_jnp(emb))
    logits, caches, memory = transformer.prefill(
        params, cfg, torch.from_numpy(tokens).long(), max_len,
        embeds=as_tensor(emb))
    assert memory is None
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert caches.keys() == jcaches.keys()
    close(logits, jlogits, PREFILL_TOL)
    for key in jcaches:
        if key != "length":
            assert tuple(caches[key].shape) == jcaches[key].shape, key
            close(caches[key], jcaches[key], PREFILL_TOL)
    assert caches["length"] == int(jcaches["length"]) == S
    caches = caches_from_reference(np_tree(jcaches))
    feed = np.random.default_rng(5).integers(1, cfg.vocab, (B, steps),
                                             dtype=np.int32)
    step = jit_decode(jcfg)
    for t in range(steps):
        tok = feed[:, t:t + 1]
        logits, caches = transformer.decode_step(
            params, cfg, torch.from_numpy(tok).long(), caches)
        jlogits, jcaches = step(jparams, jnp.asarray(tok), jcaches)
        close(logits, jlogits, DECODE_TOL)
        assert caches["length"] == int(jcaches["length"]) == S + t + 1
    for key in jcaches:
        if key != "length":
            close(caches[key], jcaches[key], DECODE_TOL)


def check_generate(arch, seed):
    """Greedy tokens equal the reference's prefill-plus-decode loop; the
    reference's top-2 logit margin is above 10x the decode tolerance at
    every step, so equal picks are a check, not luck."""
    jcfg, cfg, jparams, params = model(arch)
    tokens, emb = prompts(arch, seed), embeds(arch, seed + 1)
    jlogits, jcaches = jit_prefill(jcfg, S + MAX_NEW)(
        jparams, jnp.asarray(tokens), as_jnp(emb))
    step = jit_decode(jcfg)
    want, margins = [], []
    for t in range(MAX_NEW):
        if t:
            jlogits, jcaches = step(jparams, nxt, jcaches)
        last = np.asarray(jlogits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        nxt = jnp.asarray(last.argmax(-1)[:, None].astype(np.int32))
        want.append(np.asarray(nxt)[:, 0])
    assert np.min(margins) > 10 * DECODE_TOL, np.min(margins)
    out = serve.generate(cfg, params, torch.from_numpy(tokens).long(),
                         MAX_NEW, embeds=as_tensor(emb))
    np.testing.assert_array_equal(out.tokens.numpy(), np.stack(want, 1))
    assert out.logits.shape == (B, MAX_NEW, cfg.padded_vocab)
    assert out.prefill_launches == out.decode_launches == 0


def check_train_steps(arch, dtype):
    """Three AdamW steps of ``make_train_step`` with two microbatches from
    the same state (``opt_state_from_reference``: in bf16, master copies
    for the bf16 leaves and ``None`` for the f32 ones) against the
    reference's jitted step: in f32 the losses, params, m, v; in bf16 the
    losses, the bf16 leaves and the masters (``BF16_TOL``), and every
    leaf's dtype after the steps."""
    jcfg, cfg, jparams, _ = model(arch, dtype)
    params = params_from_reference(cfg, np_tree(jparams))   # a fresh copy
    kinds = dtypes(params)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=5, eps=STEP_EPS)
    jstep = jax.jit(jmake_train_step(jcfg, jadamw.AdamWConfig(**ocfg), 2))
    step = make_train_step(cfg, AdamWConfig(**ocfg), 2)
    jstate = jadamw.adamw_init(jparams)
    state = opt_state_from_reference(cfg, np_tree(jstate))
    masters = dict(flat_with_none(state.master))
    assert {k for k, m in masters.items() if m is None} == (
        set(masters) if dtype == "float32"
        else {k for k in masters if k.split("/")[-1] in F32_LEAVES})
    data = JDataset(data_config(cfg, seed=2))
    for s in range(3):
        host = data.batch_at(s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v)
                                     for k, v in host.items()})
        params, state, m = step(params, state,
                                launch_train.device_batch(host, "cpu"))
        np.testing.assert_allclose(
            float(m["loss"]), float(jm["loss"]),
            rtol=LOSS_RTOL if dtype == "float32" else BF16_LOSS_RTOL)
    assert dtypes(params) == kinds and int(state.step) == 3
    if dtype == "float32":
        assert_trees_close(params, np_tree(jparams), GRAD_TOL)
        assert_trees_close(state.m, np_tree(jstate.m), GRAD_TOL)
        assert_trees_close(state.v, np_tree(jstate.v), GRAD_TOL)
        return
    got, want = flat(params), flat(np_tree(jparams))
    for key in [k for k in want if k.split("/")[-1] in F32_LEAVES]:
        del got[key], want[key]
    assert_trees_close(got, want, BF16_TOL)
    assert_trees_close(state.master, np_tree(jstate.master), BF16_TOL)


def flat_with_none(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_with_none(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def check_serve_main(arch, capsys):
    cfg = configs.smoke_config(arch)
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len",
                      str(seq_of(cfg, 16)), "--max-new", "3"])
    assert out.tokens.shape == (2, 3)
    assert bool(((out.tokens >= 0) & (out.tokens < cfg.vocab)).all())
    assert bool(out.logits.isfinite().all())
    assert out.prefill_launches == out.decode_launches == 0
    assert "tok/s on the CPU" in capsys.readouterr().out


def check_train_main_and_resume(arch, tmp_path, capsys, extra=()):
    """Three steps with checkpoints, then a second launch to 5 steps that
    resumes from step 2 and whose two losses equal those of an
    uninterrupted 5-step launch bit for bit; ``extra`` arguments go to
    every launch."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", str(seq_of(configs.smoke_config(arch))),
            "--ckpt-every", "1"] + list(extra)
    ck = str(tmp_path / "ck")
    events = launch_train.main(args + ["--steps", "3", "--ckpt-dir", ck])
    out = capsys.readouterr().out
    assert "loss " in out and "over 3 steps" in out and "retries=0" in out
    assert len(events["losses"]) == 3
    assert all(np.isfinite(events["losses"]))
    assert latest_step(ck) == 2
    resumed = launch_train.main(args + ["--steps", "5", "--ckpt-dir", ck])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    whole = launch_train.main(args + ["--steps", "5", "--ckpt-dir",
                                      str(tmp_path / "whole")])
    assert len(resumed["losses"]) == 2
    assert resumed["losses"] == whole["losses"][3:]
    assert whole["losses"][:3] == events["losses"]


def check_refuses_partial_chunks(arch):
    """A sequence of more than one chunk that is not a whole number of
    chunks (12 at ``ssd_chunk`` 8) is refused by ``forward``, ``prefill``
    and ``lm_loss`` with a ``ValueError`` that names ``ssd_chunk``, as the
    reference's scan asserts; one shorter than a chunk (5) is taken."""
    jcfg, cfg, jparams, params = model(arch)
    bad = torch.from_numpy(prompts(arch, 1, seq=12)).long()
    for call in (lambda: transformer.forward(params, cfg, bad),
                 lambda: transformer.prefill(params, cfg, bad, 16),
                 lambda: transformer.lm_loss(params, cfg, {
                     "tokens": bad, "labels": bad})):
        with pytest.raises(ValueError, match="ssd_chunk"):
            call()
    with pytest.raises(AssertionError):
        jtf.forward(jparams, jcfg, jnp.asarray(bad.numpy()))
    short = prompts(arch, 1, seq=5)
    logits, caches, _ = transformer.prefill(
        params, cfg, torch.from_numpy(short).long(), 8)
    jlogits, _ = jit_prefill(jcfg, 8)(jparams, jnp.asarray(short))
    close(logits, jlogits, PREFILL_TOL)
    assert caches["length"] == 5
