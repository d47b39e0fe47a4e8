"""granite-3-8b, phi4-mini-3.8b and glm4-9b in the port against the
reference on the CPU: their configs, the reference's smoke ``init_params``
carried across (the untied output head of granite and glm4 included),
prefill, teacher-forced decode, greedy ``generate``, ``lm_loss`` and its
gradients, and three AdamW train steps, on the same numpy inputs."""
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
from repro_torch.convert import (caches_from_reference,
                                 opt_state_from_reference,
                                 params_from_reference)
from repro_torch.kernels import flash_attention as flash
from repro_torch.launch import serve
from repro_torch.launch.train import device_batch
from repro_torch.models import init_params, transformer
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step
from repro_torch.train.steps import _loss_and_grads

from _torch_conformance import assert_close  # noqa: F401  (sets threads)

ARCHS = ["granite-3-8b", "phi4-mini-3.8b", "glm4-9b"]
UNTIED = {"granite-3-8b", "glm4-9b"}
B, S, MAX_NEW = 2, 32, 5
#: the prompts' seed per arch: tests/test_torch_lm.py's 3, and for glm4 the
#: first seed after it whose greedy top-2 margins all exceed 10x the decode
#: tolerance (seed 3's smallest is 0.0028)
PROMPT_SEED = {"granite-3-8b": 3, "phi4-mini-3.8b": 3, "glm4-9b": 4}
#: f32 on both sides, summed in other orders (tests/test_torch_lm.py's
#: bounds): logits and caches to 2e-4 after prefill, 3e-4 after decode
PREFILL_TOL = 2e-4
DECODE_TOL = 3e-4
#: tests/test_torch_train.py's bounds: the loss to 1e-5 of itself, each
#: gradient element (and each state leaf after 3 steps) to 1e-4 of its
#: leaf's largest
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


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
def _model(arch):
    """The reference's smoke config (``"xla"`` attention) and its
    ``init_params`` from key 0, and the port's config and the same
    parameters carried across."""
    jcfg = jconfigs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, params_from_reference(cfg, _np(jparams))


@functools.lru_cache(maxsize=None)
def _jit_prefill(jcfg, max_len):
    return jax.jit(lambda p, t: jtf.prefill(p, jcfg, t, max_len)[:2])


@functools.lru_cache(maxsize=None)
def _jit_decode(jcfg):
    return jax.jit(lambda p, t, c: jtf.decode_step(p, jcfg, t, c))


def _tokens(cfg):
    return np.random.default_rng(PROMPT_SEED[cfg.name]).integers(
        1, cfg.vocab, (B, S), dtype=np.int32)


# --- configs and parameters -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_params_and_vocab_match_reference(arch):
    """Every field but ``attn_impl`` (the port's default is "flash"), the
    analytic parameter count and the padded vocab, published and smoke."""
    assert arch in configs.ARCH_IDS and arch not in configs.PENDING
    for get in ("get_config", "smoke_config"):
        cfg = getattr(configs, get)(arch)
        jcfg = getattr(jconfigs, get)(arch)
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        assert mine.pop("attn_impl") == "flash"
        theirs.pop("attn_impl")
        assert mine == theirs
        assert cfg.n_params == jcfg.n_params
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.tie_embeddings == (arch not in UNTIED)
        assert not cfg.qk_norm and cfg.family == "dense"
    assert configs.get_config(arch).tdtype == torch.bfloat16
    assert configs.smoke_config(arch).tdtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_params_are_carried_across(arch):
    """``params_from_reference`` carries every leaf of the reference's
    smoke tree, the untied ``"head"`` where the config has one, and the
    port's own ``init_params`` makes the same tree."""
    _, cfg, jparams, params = _model(arch)
    want = _flat(_np(jparams))
    got = _flat(params)
    assert got.keys() == want.keys()
    assert ("embed/head" in got) == (arch in UNTIED)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    ours = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: v.shape for k, v in _flat(ours).items()} \
        == {k: v.shape for k, v in want.items()}
    if arch in UNTIED:
        bad = _np(jparams)
        del bad["embed"]["head"]
        with pytest.raises(ValueError, match="head"):
            params_from_reference(cfg, bad)


# --- serving -----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and caches, then 4 teacher-forced decode steps,
    against the reference's jitted ``prefill`` and ``decode_step``."""
    jcfg, cfg, jparams, params = _model(arch)
    tokens = _tokens(cfg)
    max_len = S + MAX_NEW
    jlogits, jcaches = _jit_prefill(jcfg, max_len)(jparams,
                                                   jnp.asarray(tokens))
    before = flash.LAUNCHES
    logits, caches, memory = transformer.prefill(
        params, cfg, torch.from_numpy(tokens).long(), max_len)
    assert flash.LAUNCHES == before          # CPU tensors: plain version
    assert memory is None                    # no encoder in the dense family
    assert logits.shape == (B, 1, cfg.padded_vocab)
    _close(logits, jlogits, PREFILL_TOL)
    _close(caches["k"], jcaches["k"], PREFILL_TOL)
    _close(caches["v"], jcaches["v"], PREFILL_TOL)
    caches = caches_from_reference(_np(jcaches))
    feed = np.random.default_rng(5).integers(1, cfg.vocab, (B, 4),
                                             dtype=np.int32)
    step = _jit_decode(jcfg)
    for t in range(feed.shape[1]):
        tok = feed[:, t:t + 1]
        logits, caches = transformer.decode_step(
            params, cfg, torch.from_numpy(tok).long(), caches)
        jlogits, jcaches = step(jparams, jnp.asarray(tok), jcaches)
        _close(logits, jlogits, DECODE_TOL)
    _close(caches["k"], jcaches["k"], DECODE_TOL)
    _close(caches["v"], jcaches["v"], DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_picks_reference_greedy_tokens(arch):
    """Greedy tokens equal the reference's prefill-plus-decode loop; the
    reference's top-2 logit margin is above 10x the decode tolerance at
    every step, so equal picks are a check, not luck."""
    jcfg, cfg, jparams, params = _model(arch)
    tokens = _tokens(cfg)
    jlogits, jcaches = _jit_prefill(jcfg, S + MAX_NEW)(jparams,
                                                       jnp.asarray(tokens))
    step = _jit_decode(jcfg)
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
                         MAX_NEW)
    np.testing.assert_array_equal(out.tokens.numpy(), np.stack(want, 1))
    assert out.logits.shape == (B, MAX_NEW, cfg.padded_vocab)
    assert out.prefill_launches == out.decode_launches == 0


def test_flash_prefill_matches_reference_pallas():
    """phi4-mini (head dim 12): the port's ``"flash"`` prefill against the
    reference's ``"pallas"`` prefill, its flash kernel in interpret
    mode."""
    jcfg, cfg, jparams, params = _model("phi4-mini-3.8b")
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas")
    tokens = _tokens(cfg)
    jlogits, jcaches = _jit_prefill(jcfg, S + MAX_NEW)(jparams,
                                                       jnp.asarray(tokens))
    logits, caches, _ = transformer.prefill(
        params, cfg, torch.from_numpy(tokens).long(), S + MAX_NEW)
    _close(logits, jlogits, PREFILL_TOL)
    _close(caches["k"], jcaches["k"], PREFILL_TOL)
    _close(caches["v"], jcaches["v"], PREFILL_TOL)


# --- training ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jit_loss(jcfg):
    return jax.jit(jax.value_and_grad(lambda p, b: jtf.lm_loss(p, jcfg, b)))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    """``lm_loss`` and every gradient leaf (the untied head's included)
    against ``jax.value_and_grad`` of the reference's, on the reference's
    synthetic batch."""
    jcfg, cfg, jparams, params = _model(arch)
    host = JDataset(JDataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                                seed=0)).batch_at(0)
    want_loss, want_grads = _jit_loss(jcfg)(
        jparams, {k: jnp.asarray(v) for k, v in host.items()})
    loss, grads = _loss_and_grads(params, cfg, device_batch(host, "cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    assert ("head" in grads["embed"]) == (arch in UNTIED)
    _assert_trees_close(grads, _np(want_grads), GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    """Three AdamW steps of ``make_train_step`` from the same state:
    losses, m and v against the reference's jitted step within
    tests/test_torch_train.py's bounds, and params within the same bound
    plus 2 lr for each step where the reference's gradient element lies
    within that bound of 0: there Adam's normalised step m / (sqrt(v) +
    eps), eps 1e-8, is set by the rounding noise of a gradient near eps
    (glm4's w_out[0, 27, 11]: -4.8e-9 against -6.4e-9, both right to 1e-4
    of the leaf's largest, a first step of 0.32 against 0.39 lr)."""
    jcfg, cfg, jparams, params = _model(arch)
    params = params_from_reference(cfg, _np(jparams))   # a fresh copy
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=5)
    jstep = jax.jit(jmake_train_step(jcfg, jadamw.AdamWConfig(**ocfg)))
    step = make_train_step(cfg, AdamWConfig(**ocfg))
    jstate = jadamw.adamw_init(jparams)
    state = opt_state_from_reference(cfg, _np(jstate))
    data = JDataset(JDataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4,
                                seed=2))
    noise = {}
    for s in range(3):
        host = data.batch_at(s)
        jbatch = {k: jnp.asarray(v) for k, v in host.items()}
        _, jgrads = _jit_loss(jcfg)(jparams, jbatch)
        jparams, jstate, jm = jstep(jparams, jstate, jbatch)
        for key, g in _flat(_np(jgrads)).items():
            near0 = np.abs(g) <= GRAD_TOL * np.abs(g).max()
            noise[key] = noise.get(key, 0) + 2 * float(jm["lr"]) * near0
        params, state, m = step(params, state, device_batch(host, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    got, want = _flat(params), _flat(_np(jparams))
    assert got.keys() == want.keys()
    for key in want:
        atol = GRAD_TOL * np.abs(want[key]).max() + noise[key]
        assert (np.abs(got[key] - want[key]) <= atol).all(), key
    _assert_trees_close(state.m, _np(jstate.m), GRAD_TOL)
    _assert_trees_close(state.v, _np(jstate.v), GRAD_TOL)
    assert int(state.step) == 3
