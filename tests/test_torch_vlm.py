"""The port's VLM family (internvl2-76b's smoke config: 2 dense layers,
head dim 16, a 4-position prefix of patch embeddings) against the
reference on the CPU, on the same numpy inputs and the reference's own
``init_params`` carried across: the config and parameter tree, ``forward``
with ``embeds``, ``lm_loss`` and every gradient leaf (flash and xla; remat
full, none and dots), the prefix's rows carrying no loss, prefill and
teacher-forced decode, greedy ``generate``, three AdamW steps with two
microbatches in f32 and bf16, both launchers with a resume, and the
default cache length of the serve path, which counts the prefix where the
reference's launcher does not.  The smoke config takes 28 tokens after
its 4-position prefix: the attention takes whole multiples of its
16-position chunks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro_torch import configs
from repro_torch.convert import caches_from_reference
from repro_torch.kernels import flash_attention as flash
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer
from repro_torch.train.steps import _loss_and_grads

import _torch_family as fam

ARCH = "internvl2-76b"
#: tokens after the smoke config's 4-position prefix (32 positions)
S_TOK = fam.seq_of(configs.smoke_config(ARCH))


def test_config_and_parameter_tree_match_reference():
    """A dense tree (``blocks`` of ``ln1``, ``attn``, ``ln2``, ``mlp``,
    an untied ``head``); the config itself is held field for field by
    tests/test_torch_lm.py::test_config_matches_reference.  bf16 trees
    are bf16 in every leaf."""
    assert ARCH in configs.ARCH_IDS and not configs.PENDING
    full = configs.get_config(ARCH)
    assert full.family == "vlm" and full.input_mode == "embeds_prefix"
    assert full.prefix_len == 1024 and full.causal_attentions == 80
    assert full.n_params == jconfigs.get_config(ARCH).n_params
    assert S_TOK == 28
    jcfg, cfg, jparams, _ = fam.model(ARCH)
    keys = fam.check_tree(jcfg, cfg, bf16=False)
    assert {"blocks/mlp/w_in", "blocks/attn/wq", "embed/head"} <= keys
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    kinds = fam.dtypes(transformer.init_params(
        bf, torch.Generator().manual_seed(0), "cpu"))
    assert set(kinds.values()) == {torch.bfloat16}
    bad = fam.np_tree(jparams)
    del bad["blocks"]["mlp"]
    with pytest.raises(ValueError, match="blocks"):
        fam.params_from_reference(cfg, bad)


def test_caches_from_reference_take_a_vlm_tree():
    """The reference's prefill caches over prefix and prompt: ``k``, ``v``
    of (L, B, max_len, n_kv, d_head) and ``length`` = P + S."""
    jcfg, cfg, jparams, _ = fam.model(ARCH)
    tokens, emb = fam.prompts(ARCH, 2), fam.embeds(ARCH, 3)
    _, jcaches = fam.jit_prefill(jcfg, fam.S + 3)(
        jparams, jnp.asarray(tokens), jnp.asarray(emb))
    caches = caches_from_reference(fam.np_tree(jcaches))
    assert sorted(caches) == ["k", "length", "v"]
    assert caches["length"] == fam.S
    assert tuple(caches["k"].shape) == (cfg.n_layers, fam.B, fam.S + 3,
                                        cfg.n_kv, cfg.d_head)


def test_forward_matches_reference():
    """The hidden rows of the P + S positions, the prefix's included."""
    fam.check_forward(ARCH)


@pytest.mark.parametrize("remat", ["full", "none", "dots"])
@pytest.mark.parametrize("impl", [("pallas", "flash"), ("xla", "xla")],
                         ids=["flash", "xla"])
def test_lm_loss_and_grads_match_reference(impl, remat):
    """The loss (its first label masked by the pipeline) and every
    gradient leaf against ``jax.value_and_grad`` of the reference's under
    the same remat policy."""
    jcfg, cfg, jparams, params = fam.model(ARCH)
    jcfg = dataclasses.replace(jcfg, attn_impl=impl[0], remat_policy=remat)
    cfg = dataclasses.replace(cfg, attn_impl=impl[1], remat_policy=remat)
    host = fam.host_batch(cfg, seed=0)
    assert host["embeds"].shape == (4, cfg.prefix_len, cfg.d_model)
    assert host["tokens"].shape == (4, S_TOK)
    assert not host["loss_mask"][:, 0].any()
    want_loss, want_grads = fam.jit_loss(jcfg)(
        jparams, {k: jnp.asarray(v) for k, v in host.items()})
    loss, grads = _loss_and_grads(params, cfg,
                                  launch_train.device_batch(host, "cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=fam.LOSS_RTOL)
    fam.assert_trees_close(grads, fam.np_tree(want_grads), fam.GRAD_TOL)


def test_prefix_carries_no_loss():
    """With an all-ones ``loss_mask``, ``lm_loss`` is the mean
    cross-entropy of ``forward``'s hidden rows after the prefix against the
    labels, computed here by hand; the prefix's rows meet no label, and
    changing ``embeds`` changes the loss only through the attention."""
    _, cfg, _, params = fam.model(ARCH)
    host = fam.host_batch(cfg, seed=1)
    batch = launch_train.device_batch(host, "cpu")
    batch["loss_mask"] = torch.ones_like(batch["loss_mask"])
    P = cfg.prefix_len
    with torch.no_grad():
        loss = transformer.lm_loss(params, cfg, batch)
        hidden, _ = transformer.forward(params, cfg, batch["tokens"],
                                        embeds=batch["embeds"])
        assert hidden.shape == (4, P + S_TOK, cfg.d_model)
        logits = (hidden[:, P:] @ params["embed"]["head"]).double()
        logits[..., cfg.vocab:] = -1e30
        ce = torch.logsumexp(logits, -1) - logits.gather(
            -1, batch["labels"][..., None])[..., 0]
        np.testing.assert_allclose(float(loss), float(ce.mean()), rtol=1e-6)
        # the rows in front of the tokens, read against the labels, give
        # another loss: the cut falls after the prefix
        shifted = (hidden[:, :S_TOK] @ params["embed"]["head"]).double()
        shifted[..., cfg.vocab:] = -1e30
        other = torch.logsumexp(shifted, -1) - shifted.gather(
            -1, batch["labels"][..., None])[..., 0]
        assert abs(float(other.mean()) - float(loss)) > 1e-3
        moved = dict(batch, embeds=batch["embeds"] + 1.0)
        assert float(transformer.lm_loss(params, cfg, moved)) != float(loss)
        # without embeds the VLM is the dense stack over its tokens (28
        # positions: chunked attention, which takes a ragged chunk)
        xla = dataclasses.replace(cfg, attn_impl="xla")
        dense = dataclasses.replace(xla, family="dense")
        no_prefix = {k: v for k, v in batch.items() if k != "embeds"}
        assert float(transformer.lm_loss(params, xla, no_prefix)) == float(
            transformer.lm_loss(params, dense, no_prefix))


def test_prefill_and_teacher_forced_decode_match_reference():
    """``k``, ``v`` over the P + S positions and ``length`` = P + S, then
    five decode steps from there; the attention through the flash kernel's
    plain version: no launch on the CPU."""
    before = flash.LAUNCHES
    fam.check_prefill_and_decode(ARCH)
    assert flash.LAUNCHES == before


def test_prefill_refuses_a_cache_without_room_for_the_prefix():
    _, cfg, _, params = fam.model(ARCH)
    tokens = torch.from_numpy(fam.prompts(ARCH, 2)).long()
    emb = torch.from_numpy(fam.embeds(ARCH, 3))
    with pytest.raises(ValueError, match=r"max_len=30 < prompt length 32 "
                       r"\(4 prefix \+ 28 token positions\)"):
        transformer.prefill(params, cfg, tokens, 30, embeds=emb)


def test_generate_picks_reference_greedy_tokens():
    fam.check_generate(ARCH, seed=4)


def test_reference_serve_default_fails_and_port_default_runs():
    """The reference's serve launcher sizes the cache as prompt + new
    tokens (``launch/serve.py:61``), the prefix left out.  With fewer new
    tokens than prefix positions (3 against 4 here; 16 against 1024 at
    full width) its ``prefill`` then pads by a negative width and raises.
    The port's ``generate`` counts the prefix: prefix + prompt + new."""
    jcfg, cfg, jparams, params = fam.model(ARCH)
    tokens, emb = fam.prompts(ARCH, 5), fam.embeds(ARCH, 6)
    new = 3
    with pytest.raises(ValueError, match="negative"):
        jtf.prefill(jparams, jcfg, jnp.asarray(tokens), S_TOK + new,
                    embeds=jnp.asarray(emb))
    seen = []
    real = serve.make_prefill_fn

    def spy(cfg_, max_len):
        seen.append(max_len)
        return real(cfg_, max_len)
    serve.make_prefill_fn = spy
    try:
        out = serve.generate(cfg, params, torch.from_numpy(tokens).long(),
                             new, embeds=torch.from_numpy(emb))
    finally:
        serve.make_prefill_fn = real
    assert seen == [cfg.prefix_len + S_TOK + new]
    assert out.tokens.shape == (fam.B, new)
    assert bool(out.logits.isfinite().all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_with_two_microbatches_match_reference(dtype):
    fam.check_train_steps(ARCH, dtype)


def test_serve_main_on_cpu(capsys):
    fam.check_serve_main(ARCH, capsys)


def test_train_main_on_cpu_resumes(tmp_path, capsys):
    fam.check_train_main_and_resume(ARCH, tmp_path, capsys)
