"""The port's encoder-decoder family (seamless-m4t-large-v2's smoke config)
against the reference on the CPU: ``cross_attention`` and the encoder's
bidirectional ``self_attention``, ``forward`` and ``lm_loss`` with frames
and every gradient leaf, prefill (logits, caches and the encoder memory),
teacher-forced decode against that memory, greedy ``generate``, three
AdamW steps with two microbatches, and both launchers, on the same numpy
inputs and the reference's own ``init_params`` carried across.  The
reference runs ``attn_impl="pallas"`` (its flash kernel in interpret mode)
for the decoder's causal self-attention; the encoder and the
cross-attention go through its ``chunked_attention`` either way, as the
port's do."""
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
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.checkpoint import latest_step
from repro_torch.convert import (caches_from_reference,
                                 opt_state_from_reference,
                                 params_from_reference)
from repro_torch.kernels import flash_attention as flash
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, init_params, transformer
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step
from repro_torch.train.steps import _loss_and_grads

from _torch_conformance import assert_close  # noqa: F401  (sets threads)

ARCH = "seamless-m4t-large-v2"
#: batch, prompt length, frames (the encoder's length, unlike the prompt's),
#: tokens generated
B, S, S_ENC, MAX_NEW = 2, 32, 24, 5
#: f32 on both sides, summed in other orders (tests/test_torch_lm.py's
#: bounds): logits, caches and memory to 2e-4 after prefill, 3e-4 after
#: decode
PREFILL_TOL = 2e-4
DECODE_TOL = 3e-4
#: tests/test_torch_train.py's bounds: the loss to 1e-5 of itself, each
#: gradient element (and each state leaf after 3 steps) to 1e-4 of its
#: leaf's largest
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
#: one attention call alone (no residual stream), f32 against f32:
#: tests/test_torch_lm.py's bound for ``chunked_attention``
ATTN_TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = (v.detach().float().numpy()
                                   if isinstance(v, torch.Tensor)
                                   else np.asarray(v, np.float32))
    return out


def _assert_trees_close(got, want, rel):
    """Every leaf within ``rel`` of the largest element of the want leaf."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for key in w:
        scale = max(float(np.abs(w[key]).max()), 1e-30)
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=rel * scale,
                                   err_msg=key)


@functools.lru_cache(maxsize=None)
def _model():
    """The reference's smoke config (``"pallas"`` attention) and its
    ``init_params`` from key 0, and the port's config and the same
    parameters carried across."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               attn_impl="pallas")
    cfg = configs.smoke_config(ARCH)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, params_from_reference(cfg, _np(jparams))


def _inputs(seed=4):
    """Prompts and frames; seed 4, the first after tests/test_torch_lm.py's
    3 whose greedy top-2 margins all exceed 10x the decode tolerance (seed
    3's smallest is 3.1e-4)."""
    rng = np.random.default_rng(seed)
    cfg = configs.smoke_config(ARCH)
    tokens = rng.integers(1, cfg.vocab, (B, S), dtype=np.int32)
    frames = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    return tokens, frames


@functools.lru_cache(maxsize=None)
def _jit_prefill(jcfg, max_len):
    return jax.jit(lambda p, t, f: jtf.prefill(p, jcfg, t, max_len,
                                               frames=f))


@functools.lru_cache(maxsize=None)
def _jit_decode(jcfg):
    return jax.jit(lambda p, t, c, m: jtf.decode_step(p, jcfg, t, c,
                                                      memory=m))


@functools.lru_cache(maxsize=None)
def _jit_loss(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jtf.lm_loss(p, jcfg, b)))


def _host_batch(cfg, seed, batch=4, seq=S):
    return JDataset(JDataConfig(vocab=cfg.vocab, seq_len=seq,
                                global_batch=batch, seed=seed,
                                d_model=cfg.d_model,
                                mode="frames")).batch_at(0)


# --- config and parameters ---------------------------------------------------

def test_parameter_tree_matches_reference():
    """The port's ``init_params`` tree equal to the reference's
    (``enc_blocks``, ``enc_norm``, decoder ``blocks`` with ``ln_x`` and
    ``xattn``), which ``params_from_reference`` carries across leaf for
    leaf.  (The config itself is held field for field by
    tests/test_torch_lm.py::test_config_matches_reference.)"""
    assert ARCH in configs.ARCH_IDS and ARCH not in configs.PENDING
    assert configs.get_config(ARCH).n_params == 1_632_006_144
    _, cfg, jparams, params = _model()
    want, got = _flat(_np(jparams)), _flat(params)
    assert got.keys() == want.keys()
    assert {"enc_norm", "enc_blocks/attn/wq", "blocks/ln_x",
            "blocks/xattn/wk"} <= got.keys()
    assert not any(k.startswith("blocks/xattn/q_norm") for k in got)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ours = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: v.shape for k, v in _flat(ours).items()} \
        == {k: v.shape for k, v in want.items()}
    bad = _np(jparams)
    del bad["blocks"]["xattn"]
    with pytest.raises(ValueError, match="xattn"):
        params_from_reference(cfg, bad)


# --- attention ---------------------------------------------------------------

def test_cross_and_bidirectional_attention_match_reference():
    """``cross_attention`` (q from the decoder, K and V from a memory of
    another length; no RoPE) and the encoder's ``self_attention(...,
    causal=False)`` (RoPE on both sides; chunked whatever ``attn_impl``
    says) on decoder layer 0's and encoder layer 0's weights."""
    jcfg, cfg, jparams, params = _model()
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    jx = jax.tree.map(lambda a: a[0], jparams["blocks"]["xattn"])
    tx = {k: v[0] for k, v in params["blocks"]["xattn"].items()}
    got = attention.cross_attention(torch.from_numpy(x),
                                    torch.from_numpy(mem), tx, cfg)
    want = jattn.cross_attention(jnp.asarray(x), jnp.asarray(mem), jx, jcfg)
    assert got.shape == (B, S, cfg.d_model)
    _close(got, want, ATTN_TOL)
    je = jax.tree.map(lambda a: a[0], jparams["enc_blocks"]["attn"])
    te = {k: v[0] for k, v in params["enc_blocks"]["attn"].items()}
    pos = np.arange(S_ENC)
    before = flash.LAUNCHES
    got = attention.self_attention(torch.from_numpy(mem), te, cfg,
                                   torch.from_numpy(pos), causal=False)
    want = jattn.self_attention(jnp.asarray(mem), je, jcfg,
                                jnp.asarray(pos), causal=False)
    assert flash.LAUNCHES == before
    _close(got, want, ATTN_TOL)
    causal = attention.self_attention(
        torch.from_numpy(mem), te, dataclasses.replace(cfg, attn_impl="xla"),
        torch.from_numpy(pos))
    assert not torch.allclose(got, causal)


# --- forward, loss and gradients ---------------------------------------------

def test_forward_with_frames_matches_reference():
    jcfg, cfg, jparams, params = _model()
    tokens, frames = _inputs()
    hidden, aux = transformer.forward(params, cfg,
                                      torch.from_numpy(tokens).long(),
                                      torch.from_numpy(frames))
    jhidden, jaux = jax.jit(lambda p, t, f: jtf.forward(p, jcfg, t,
                                                        frames=f))(
        jparams, jnp.asarray(tokens), jnp.asarray(frames))
    assert hidden.shape == (B, S, cfg.d_model)
    _close(hidden, jhidden, PREFILL_TOL)
    assert float(aux) == float(jaux) == 0.0
    with pytest.raises(ValueError, match="frames"):
        transformer.forward(params, cfg, torch.from_numpy(tokens).long())


def test_lm_loss_and_grads_match_reference():
    """``lm_loss`` of a batch with frames and every gradient leaf (the
    encoder's, the cross-attention's and ``enc_norm``'s included) against
    ``jax.value_and_grad`` of the reference's."""
    jcfg, cfg, jparams, params = _model()
    host = _host_batch(cfg, seed=0)
    assert host["frames"].shape == (4, S, cfg.d_model)
    want_loss, want_grads = _jit_loss(jcfg)(
        jparams, {k: jnp.asarray(v) for k, v in host.items()})
    loss, grads = _loss_and_grads(params, cfg,
                                  launch_train.device_batch(host, "cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    _assert_trees_close(grads, _np(want_grads), GRAD_TOL)
    assert float(np.abs(_flat(grads)["enc_blocks/attn/wq"]).max()) > 0


# --- serving -----------------------------------------------------------------

def test_prefill_and_teacher_forced_decode_match_reference():
    """Prefill's logits, caches and encoder memory, then 5 teacher-forced
    decode steps against that memory, against the reference's jitted
    ``prefill`` and ``decode_step``."""
    jcfg, cfg, jparams, params = _model()
    tokens, frames = _inputs()
    max_len = S + MAX_NEW
    jlogits, jcaches, jmemory = _jit_prefill(jcfg, max_len)(
        jparams, jnp.asarray(tokens), jnp.asarray(frames))
    logits, caches, memory = transformer.prefill(
        params, cfg, torch.from_numpy(tokens).long(), max_len,
        torch.from_numpy(frames))
    assert logits.shape == (B, 1, cfg.padded_vocab)
    assert memory.shape == (B, S_ENC, cfg.d_model)
    _close(logits, jlogits, PREFILL_TOL)
    _close(memory, jmemory, PREFILL_TOL)
    _close(caches["k"], jcaches["k"], PREFILL_TOL)
    _close(caches["v"], jcaches["v"], PREFILL_TOL)
    assert caches["length"] == int(jcaches["length"]) == S
    caches = caches_from_reference(_np(jcaches))
    feed = np.random.default_rng(5).integers(1, cfg.vocab, (B, 5),
                                             dtype=np.int32)
    step = _jit_decode(jcfg)
    for t in range(feed.shape[1]):
        tok = feed[:, t:t + 1]
        logits, caches = transformer.decode_step(
            params, cfg, torch.from_numpy(tok).long(), caches, memory)
        jlogits, jcaches = step(jparams, jnp.asarray(tok), jcaches, jmemory)
        _close(logits, jlogits, DECODE_TOL)
        assert caches["length"] == int(jcaches["length"]) == S + t + 1
    _close(caches["k"], jcaches["k"], DECODE_TOL)
    _close(caches["v"], jcaches["v"], DECODE_TOL)
    with pytest.raises(ValueError, match="memory"):
        transformer.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                caches)


def test_generate_picks_reference_greedy_tokens():
    """Greedy tokens equal the reference's prefill-plus-decode loop; the
    reference's top-2 logit margin is above 10x the decode tolerance at
    every step, so equal picks are a check, not luck."""
    jcfg, cfg, jparams, params = _model()
    tokens, frames = _inputs()
    jlogits, jcaches, jmemory = _jit_prefill(jcfg, S + MAX_NEW)(
        jparams, jnp.asarray(tokens), jnp.asarray(frames))
    step = _jit_decode(jcfg)
    want, margins = [], []
    for t in range(MAX_NEW):
        if t:
            jlogits, jcaches = step(jparams, nxt, jcaches, jmemory)
        last = np.asarray(jlogits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        nxt = jnp.asarray(last.argmax(-1)[:, None].astype(np.int32))
        want.append(np.asarray(nxt)[:, 0])
    assert np.min(margins) > 10 * DECODE_TOL, np.min(margins)
    out = serve.generate(cfg, params, torch.from_numpy(tokens).long(),
                         MAX_NEW, frames=torch.from_numpy(frames))
    np.testing.assert_array_equal(out.tokens.numpy(), np.stack(want, 1))
    assert out.logits.shape == (B, MAX_NEW, cfg.padded_vocab)
    assert out.prefill_launches == out.decode_launches == 0


# --- training ----------------------------------------------------------------

def test_train_steps_with_two_microbatches_match_reference():
    """Three AdamW steps of ``make_train_step`` with two microbatches from
    the same state: losses, params, m and v against the reference's jitted
    step within tests/test_torch_train.py's f32 bounds."""
    jcfg, cfg, jparams, _ = _model()
    params = params_from_reference(cfg, _np(jparams))   # a fresh copy
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=5)
    jstep = jax.jit(jmake_train_step(jcfg, jadamw.AdamWConfig(**ocfg), 2))
    step = make_train_step(cfg, AdamWConfig(**ocfg), 2)
    jstate = jadamw.adamw_init(jparams)
    state = opt_state_from_reference(cfg, _np(jstate))
    data = JDataset(JDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=4,
                                seed=2, d_model=cfg.d_model, mode="frames"))
    for s in range(3):
        host = data.batch_at(s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v)
                                     for k, v in host.items()})
        params, state, m = step(params, state,
                                launch_train.device_batch(host, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    _assert_trees_close(params, _np(jparams), GRAD_TOL)
    _assert_trees_close(state.m, _np(jstate.m), GRAD_TOL)
    _assert_trees_close(state.v, _np(jstate.v), GRAD_TOL)
    assert int(state.step) == 3


# --- the launchers -----------------------------------------------------------

def test_serve_main_on_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--max-new",
                      "3"])
    cfg = configs.smoke_config(ARCH)
    assert out.tokens.shape == (2, 3)
    assert bool(((out.tokens >= 0) & (out.tokens < cfg.vocab)).all())
    assert bool(out.logits.isfinite().all())
    assert out.prefill_launches == out.decode_launches == 0
    assert "tok/s on the CPU" in capsys.readouterr().out


def test_train_main_on_cpu(tmp_path, capsys):
    events = launch_train.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
        "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "loss " in out and "over 3 steps" in out and "retries=0" in out
    assert len(events["losses"]) == 3
    assert all(np.isfinite(events["losses"]))
    assert latest_step(str(tmp_path / "ck")) == 2
