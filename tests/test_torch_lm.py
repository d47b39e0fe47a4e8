"""The port's dense LM serving path against the reference on the CPU: layer
functions, prefill (``"flash"`` against the reference's ``"pallas"`` in
interpret mode, ``"xla"`` against ``"xla"``), teacher-forced decode, and
greedy ``generate``, on the same numpy inputs and the reference's own
``init_params`` carried across."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.convert import caches_from_reference, params_from_reference
from repro_torch.kernels import flash_attention as flash
from repro_torch.launch import serve
from repro_torch.models import attention, layers, transformer

from _torch_conformance import assert_close  # noqa: F401  (sets threads)

ARCH = "qwen3-1.7b"
B, S, MAX_NEW = 2, 32, 5
PREFILL_TOL = 2e-4
DECODE_TOL = 3e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=atol)


@functools.lru_cache(maxsize=None)
def _jit_prefill(cfg, max_len):
    return jax.jit(lambda p, t: jtf.prefill(p, cfg, t, max_len)[:2])


@functools.lru_cache(maxsize=None)
def _jit_decode(cfg):
    return jax.jit(lambda p, t, c: jtf.decode_step(p, cfg, t, c))


@pytest.fixture(scope="module")
def model():
    """The reference's smoke parameters, the same carried across, prompts,
    and the reference's ``"pallas"`` prefill of them."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               attn_impl="pallas")
    cfg = configs.smoke_config(ARCH)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_reference(cfg, _np(jparams))
    rng = np.random.default_rng(3)
    tokens = rng.integers(1, cfg.vocab, (B, S), dtype=np.int32)
    max_len = S + MAX_NEW
    jlogits, jcaches = _jit_prefill(jcfg, max_len)(jparams,
                                                   jnp.asarray(tokens))
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                tokens=tokens, max_len=max_len, jlogits=jlogits,
                jcaches=jcaches)


# --- layer functions ---------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                           1e-5),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    pos = np.arange(40, 47)
    cos, sin = layers.rope_table(torch.from_numpy(pos), 16, 1e6)
    jcos, jsin = jlayers.rope_table(jnp.asarray(pos), 16, 1e6)
    _close(cos, jcos, 1e-6)
    _close(sin, jsin, 1e-6)
    _close(layers.apply_rope(torch.from_numpy(x), cos, sin),
           jlayers.apply_rope(jnp.asarray(x), jcos, jsin), 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(1)
    mult = 2 if act == "swiglu" else 1
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {"w_in": rng.standard_normal((32, mult * 48)).astype(np.float32)
         * 32 ** -0.5,
         "w_out": rng.standard_normal((48, 32)).astype(np.float32)
         * 48 ** -0.5}
    got = layers.apply_mlp(torch.from_numpy(x),
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           act)
    want = jlayers.apply_mlp(jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in p.items()}, act)
    _close(got, want, 1e-5)
    shapes = {k: tuple(v.shape) for k, v in layers.init_mlp(
        32, 48, act, torch.float32, torch.Generator().manual_seed(0),
        "cpu").items()}
    assert shapes == {k: v.shape for k, v in p.items()}


@pytest.mark.parametrize("tie", [True, False])
def test_embed_and_padded_logits_match_reference(tie):
    rng = np.random.default_rng(2)
    p = {"tok": rng.standard_normal((256, 24)).astype(np.float32)}
    if not tie:
        p["head"] = rng.standard_normal((24, 256)).astype(np.float32)
    tokens = rng.integers(0, 250, (3, 4))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = layers.embed_tokens(torch.from_numpy(tokens), tp, torch.float32)
    jx = jlayers.embed_tokens(jnp.asarray(tokens), jp, jnp.float32)
    _close(x, jx, 0)
    got = layers.lm_logits(x, tp, 250)
    want = jlayers.lm_logits(jx, jp, 250)
    _close(got, want, 1e-4)
    assert bool((got[..., 250:] < -1e29).all())


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_reference(causal):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    got = attention.chunked_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        q_chunk=16, kv_chunk=24)
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   causal=causal, q_chunk=16, kv_chunk=24)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_config_matches_reference(arch):
    for get in ("get_config", "smoke_config"):
        cfg = getattr(configs, get)(arch)
        jcfg = getattr(jconfigs, get)(arch)
        mine = dataclasses.asdict(cfg)
        theirs = dataclasses.asdict(jcfg)
        assert mine.pop("attn_impl") == "flash"
        assert theirs.pop("attn_impl") == "xla"
        assert mine == theirs
        assert cfg.padded_vocab == jcfg.padded_vocab
        assert cfg.n_params == jcfg.n_params
    assert configs.get_config(arch).tdtype == torch.bfloat16


def test_unported_archs_and_impls_raise_naming_roadmap():
    assert set(configs.ARCH_IDS) | set(configs.PENDING) \
        == set(jconfigs.ARCH_IDS)
    with pytest.raises(NotImplementedError, match="ROADMAP A16c"):
        configs.get_config("qwen3-moe-30b-a3b")
    with pytest.raises(NotImplementedError, match="ROADMAP A17"):
        dataclasses.replace(configs.smoke_config(ARCH), attn_impl="stub")
    with pytest.raises(ValueError):
        dataclasses.replace(configs.smoke_config(ARCH), attn_impl="pallas")
    moe = dataclasses.replace(configs.smoke_config(ARCH), family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP A16c"):
        transformer.init_params(moe, torch.Generator(), "cpu")


def test_init_params_matches_reference_tree(model):
    ours = transformer.init_params(model["cfg"],
                                   torch.Generator().manual_seed(0), "cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(ours)[0])
    theirs = dict(jax.tree_util.tree_flatten_with_path(
        _np(model["jparams"]))[0])
    assert {k: tuple(v.shape) for k, v in flat.items()} \
        == {k: v.shape for k, v in theirs.items()}
    assert all(v.dtype == torch.float32 for v in flat.values())
    bad = _np(model["jparams"])
    bad["blocks"]["attn"]["wq"] = bad["blocks"]["attn"]["wq"][:, :8]
    with pytest.raises(ValueError, match="wq"):
        params_from_reference(model["cfg"], bad)


# --- prefill, decode, generate ----------------------------------------------

def test_flash_prefill_matches_reference_pallas(model):
    tokens = torch.from_numpy(model["tokens"]).long()
    before = flash.LAUNCHES
    logits, caches = transformer.prefill(
        model["params"], model["cfg"], tokens, model["max_len"])
    assert flash.LAUNCHES == before          # CPU tensors: plain version
    assert logits.dtype == torch.float32
    assert logits.shape == (B, 1, model["cfg"].padded_vocab)
    _close(logits, model["jlogits"], PREFILL_TOL)
    jc = _np(model["jcaches"])
    assert caches["length"] == int(jc["length"]) == S
    _close(caches["k"], jc["k"], PREFILL_TOL)
    _close(caches["v"], jc["v"], PREFILL_TOL)


def test_xla_prefill_matches_reference_xla(model):
    cfg = dataclasses.replace(model["cfg"], attn_impl="xla")
    jcfg = dataclasses.replace(model["jcfg"], attn_impl="xla")
    logits, caches = transformer.prefill(
        model["params"], cfg, torch.from_numpy(model["tokens"]).long(),
        model["max_len"])
    jlogits, jcaches = _jit_prefill(jcfg, model["max_len"])(
        model["jparams"], jnp.asarray(model["tokens"]))
    _close(logits, jlogits, PREFILL_TOL)
    _close(caches["k"], jcaches["k"], PREFILL_TOL)
    _close(caches["v"], jcaches["v"], PREFILL_TOL)
    # and here the reference's two paths agree exactly
    _close(jlogits, model["jlogits"], 0)


def test_forward_matches_reference(model):
    hidden, aux = transformer.forward(
        model["params"], model["cfg"],
        torch.from_numpy(model["tokens"]).long())
    jcfg = dataclasses.replace(model["jcfg"], attn_impl="xla")
    jhidden, jaux = jax.jit(lambda p, t: jtf.forward(p, jcfg, t))(
        model["jparams"], jnp.asarray(model["tokens"]))
    assert hidden.shape == (B, S, model["cfg"].d_model)
    _close(hidden, jhidden, PREFILL_TOL)
    assert float(aux) == float(jaux) == 0.0


def test_teacher_forced_decode_matches_reference(model):
    cfg, jcfg = model["cfg"], model["jcfg"]
    feed = np.random.default_rng(5).integers(1, cfg.vocab, (B, 4),
                                             dtype=np.int32)
    caches = caches_from_reference(_np(model["jcaches"]))
    jcaches = model["jcaches"]
    step = _jit_decode(jcfg)
    for t in range(feed.shape[1]):
        tok = feed[:, t:t + 1]
        logits, caches = transformer.decode_step(
            model["params"], cfg, torch.from_numpy(tok).long(), caches)
        jlogits, jcaches = step(model["jparams"], jnp.asarray(tok), jcaches)
        _close(logits, jlogits, DECODE_TOL)
        assert caches["length"] == int(jcaches["length"]) == S + t + 1
    _close(caches["k"], jcaches["k"], DECODE_TOL)
    _close(caches["v"], jcaches["v"], DECODE_TOL)


def test_generate_picks_reference_greedy_tokens(model):
    """Greedy tokens equal the reference's prefill-plus-decode loop.  The
    prompts are chosen so that the reference's top-2 logit margin is above
    10x the decode tolerance at every step: equal picks are then a check,
    not luck."""
    step = _jit_decode(model["jcfg"])
    jlogits, jcaches = model["jlogits"], model["jcaches"]
    want, margins = [], []
    for t in range(MAX_NEW):
        if t:
            jlogits, jcaches = step(model["jparams"], nxt, jcaches)
        last = np.asarray(jlogits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        nxt = jnp.asarray(last.argmax(-1)[:, None].astype(np.int32))
        want.append(np.asarray(nxt)[:, 0])
    assert np.min(margins) > 10 * DECODE_TOL, np.min(margins)
    out = serve.generate(model["cfg"], model["params"],
                         torch.from_numpy(model["tokens"]).long(), MAX_NEW)
    np.testing.assert_array_equal(out.tokens.numpy(), np.stack(want, 1))
    assert out.logits.shape == (B, MAX_NEW, model["cfg"].padded_vocab)
    assert out.prefill_launches == out.decode_launches == 0


def test_serve_main_on_cpu_and_refuses_cuda_without_a_card(capsys):
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "16", "--max-new",
                      "3"])
    assert out.tokens.shape == (2, 3)
    cfg = configs.smoke_config(ARCH)
    assert bool(((out.tokens >= 0) & (out.tokens < cfg.vocab)).all())
    assert bool(out.logits.isfinite().all())
    assert "tok/s on the CPU" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--arch", ARCH, "--smoke"])
