"""The port's SSM family (mamba2-1.3b's smoke config) against the reference
on the CPU: the parameter tree (f32 ``A_log``, ``D_skip``, ``dt_bias`` in
a bf16 tree), ``ssd_scan`` alone and against ``decode_ssm`` stepped token by
token, ``apply_ssm`` and its (state, conv tail) hand-off, ``forward`` and
``lm_loss`` with every gradient leaf, prefill's logits and caches,
teacher-forced decode, greedy ``generate``, three AdamW steps with two
microbatches in f32 and in bf16, a checkpoint of the mixed-dtype state,
both launchers with a resume, and the refusal of a prompt that is not whole
chunks; and the dense and encoder-decoder families' seed-0 weights, which
the new ``init_params`` branches must leave as they were."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.models import ssm, transformer
from repro_torch.optim import adamw_init

import _torch_family as fam

ARCH = "mamba2-1.3b"
#: one scan or layer alone (no residual stream), f32 against f32: to 1e-5
#: of the output's largest magnitude
SCAN_TOL = 1e-5
#: the chunked scan against the one-token recurrence: other sums in f32
RECURRENCE_TOL = 1e-4


def test_config_and_parameter_tree_match_reference():
    """``blocks`` of ``ln`` and ``ssm`` stacked ``(n_layers, ...)``; the
    config itself is held field for field by
    tests/test_torch_lm.py::test_config_matches_reference."""
    assert ARCH in configs.ARCH_IDS and ARCH not in configs.PENDING
    assert configs.get_config(ARCH).n_params == 1_519_936_512
    jcfg, cfg, jparams, _ = fam.model(ARCH)
    keys = fam.check_tree(jcfg, cfg)
    assert {"blocks/ln", "blocks/ssm/A_log", "blocks/ssm/conv_bc",
            "embed/tok", "final_norm"} <= keys
    assert "embed/head" not in keys                        # tied
    bad = fam.np_tree(jparams)
    del bad["blocks"]["ssm"]["w_dt"]
    with pytest.raises(ValueError, match="w_dt"):
        fam.params_from_reference(cfg, bad)


#: the dense and encoder-decoder smoke configs' seed-0 weights before the
#: SSM and hybrid branches of ``init_params`` (sha256 over each leaf's
#: path and f32 bytes, in key order)
SEED_DIGESTS = {
    "qwen3-1.7b":
        "fa0ca7c290acccf0bd4697d8e1612f9bf37d79926d51d5100c68c12e50abebe7",
    "seamless-m4t-large-v2":
        "67ad538fbadbcb2e980fc41e2e99802aba85e20fcc42b275ac33ec2d8e294a79",
}


@pytest.mark.parametrize("arch", sorted(SEED_DIGESTS))
def test_seed_draws_of_other_families_are_unchanged(arch):
    params = transformer.init_params(configs.smoke_config(arch),
                                     torch.Generator().manual_seed(0), "cpu")
    h = hashlib.sha256()
    for key, leaf in fam.flat_with_none(params):
        h.update(key.encode())
        h.update(leaf.contiguous().numpy().tobytes())
    assert h.hexdigest() == SEED_DIGESTS[arch]


# --- the scan ----------------------------------------------------------------

def _scan_inputs(S, seed=0, Bsz=2, H=4, P=8, N=6):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    Bh = rng.standard_normal((Bsz, S, H, N)).astype(np.float32)
    Ch = rng.standard_normal((Bsz, S, H, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, S, H)) - 2)).astype(
        np.float32)
    A = -np.exp(rng.uniform(-1, 1, H)).astype(np.float32)
    s0 = rng.standard_normal((Bsz, H, P, N)).astype(np.float32)
    return xh, Bh, Ch, dt, A, s0


@pytest.mark.parametrize("S,chunk,init", [(32, 8, False), (32, 8, True),
                                          (5, 8, True), (24, 24, False)],
                         ids=["4-chunks", "4-chunks-init", "short-init",
                              "one-chunk"])
def test_ssd_scan_matches_reference(S, chunk, init):
    xh, Bh, Ch, dt, A, s0 = _scan_inputs(S)
    s0 = s0 if init else None
    y, final = ssm.ssd_scan(*map(torch.from_numpy, (xh, Bh, Ch, dt, A)),
                            chunk, None if s0 is None
                            else torch.from_numpy(s0))
    jy, jfinal = jax.jit(jssm.ssd_scan, static_argnums=5)(
        *map(jnp.asarray, (xh, Bh, Ch, dt, A)), chunk,
        None if s0 is None else jnp.asarray(s0))
    assert y.shape == xh.shape and final.shape == s0_shape(xh, Bh)
    fam.close(y, jy, SCAN_TOL * float(np.abs(np.asarray(jy)).max()))
    fam.close(final, jfinal, SCAN_TOL * float(np.abs(np.asarray(jfinal))
                                              .max()))


def s0_shape(xh, Bh):
    return (xh.shape[0], xh.shape[2], xh.shape[3], Bh.shape[3])


def test_ssd_scan_refuses_partial_chunks():
    xh, Bh, Ch, dt, A, _ = _scan_inputs(12)
    with pytest.raises(ValueError, match="ssd_chunk=8"):
        ssm.ssd_scan(*map(torch.from_numpy, (xh, Bh, Ch, dt, A)), 8)


def test_masked_decay_overflow_gives_the_references_nan_gradients():
    """Where a chunk's cs_i - cs_j above the diagonal passes log(f32 max)
    (here 127: dt 1 and A -1 over a 128-token chunk), ``exp`` gives inf
    there and only the mask hides it: the forward stays finite, and the
    backward's inf * 0 makes NaN gradients in the same elements on both
    sides.  The port keeps the reference's arithmetic (ROADMAP queue C:
    full-width training steps reach this)."""
    xh, Bh, Ch, _, _, _ = _scan_inputs(128, Bsz=1, H=2, P=4, N=4)
    dt = np.ones((1, 128, 2), np.float32)
    A = -np.ones(2, np.float32)
    w = np.random.default_rng(5).standard_normal(xh.shape).astype(np.float32)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (xh, Bh, Ch, dt)]
    y, _ = ssm.ssd_scan(*ins, torch.from_numpy(A), 128)
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), ins)

    def loss(xh, Bh, Ch, dt):
        return (jssm.ssd_scan(xh, Bh, Ch, dt, jnp.asarray(A), 128)[0]
                * jnp.asarray(w)).sum()
    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (xh, Bh, Ch, dt)))
    assert bool(y.isfinite().all())
    for name, g, jg in zip(("xh", "Bh", "Ch", "dt"), grads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_array_equal(g.isnan().numpy(), np.isnan(jg),
                                      err_msg=name)
    assert np.isnan(np.asarray(jgrads[1])).any()


def _layer0(params):
    return {k: v[0] for k, v in params["blocks"]["ssm"].items()}


def test_scan_equals_the_decode_recurrence():
    """``apply_ssm`` over 24 tokens (3 chunks: the chunked scan) against
    ``decode_ssm`` stepped token by token from zeroed caches (the one-token
    recurrence) on layer 0's weights: every output, and the final state and
    conv tail against the caches the steps leave."""
    _, cfg, _, params = fam.model(ARCH)
    p = _layer0(params)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    y, (final, tail) = ssm.apply_ssm(x, p, cfg)
    cache = ssm.init_ssm_cache(cfg, 2, torch.float32, "cpu")
    steps = []
    for t in range(24):
        out, same = ssm.decode_ssm(x[:, t:t + 1], p, cfg, cache)
        assert same is cache
        steps.append(out)
    scale = float(y.abs().max())
    fam.close(torch.cat(steps, dim=1), y, RECURRENCE_TOL * scale)
    fam.close(cache.state, final, RECURRENCE_TOL * float(final.abs().max()))
    fam.close(cache.conv, tail, RECURRENCE_TOL * float(tail.abs().max()))


@pytest.mark.parametrize("S", [24, 2], ids=["3-chunks", "shorter-than-tail"])
def test_apply_ssm_and_handoff_match_reference(S):
    """``apply_ssm``'s output, final state and conv tail (the last
    ``d_conv - 1`` pre-activation inputs in (x | B | C) order, left-padded
    when S < d_conv - 1) against the reference's on layer 0."""
    jcfg, cfg, jparams, params = fam.model(ARCH)
    x = np.random.default_rng(2).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    y, (final, tail) = ssm.apply_ssm(torch.from_numpy(x), _layer0(params),
                                     cfg)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["ssm"])
    jy, (jfinal, jtail) = jax.jit(lambda a, q: jssm.apply_ssm(a, q, jcfg))(
        jnp.asarray(x), jp)
    assert tail.shape == (2, cfg.d_conv - 1,
                          cfg.ssm_heads * cfg.ssm_head_dim
                          + 2 * cfg.ssm_groups * cfg.d_state)
    for got, want in ((y, jy), (final, jfinal), (tail, jtail)):
        fam.close(got, want, SCAN_TOL * max(float(np.abs(np.asarray(want))
                                                  .max()), 1e-30))
    if S < cfg.d_conv - 1:
        assert not tail[:, :cfg.d_conv - 1 - S].any()


# --- the model ---------------------------------------------------------------

def test_forward_matches_reference():
    fam.check_forward(ARCH)


def test_lm_loss_and_grads_match_reference():
    """Every gradient leaf, the f32 ``A_log``, ``D_skip`` and ``dt_bias``
    and the conv taps among them."""
    grads = fam.check_loss_and_grads(ARCH)
    for leaf in ("A_log", "D_skip", "dt_bias", "conv_x", "conv_bc"):
        assert float(np.abs(grads[f"blocks/ssm/{leaf}"]).max()) > 0, leaf


def test_prefill_and_teacher_forced_decode_match_reference():
    fam.check_prefill_and_decode(ARCH)


def test_generate_picks_reference_greedy_tokens():
    fam.check_generate(ARCH, seed=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_with_two_microbatches_match_reference(dtype):
    fam.check_train_steps(ARCH, dtype)


def test_checkpoint_keeps_each_leaf_dtype(tmp_path):
    """A bf16 tree with f32 SSM leaves and its AdamW state (``None``
    masters on those leaves) saved and restored: every leaf bit for bit in
    its own dtype."""
    _, cfg, _, _ = fam.model(ARCH, "bfloat16")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     "cpu")
    tree = {"params": params, "opt": adamw_init(params)}
    assert tree["opt"].master["blocks"]["ssm"]["A_log"] is None
    save_pytree(tree, str(tmp_path), 7)
    template = {"params": transformer.init_params(
        cfg, torch.Generator().manual_seed(4), "cpu")}
    template["opt"] = adamw_init(template["params"])
    got = restore_pytree(template, str(tmp_path), 7)
    for (k, a), (_, b) in zip(fam.flat_with_none(got["params"]),
                              fam.flat_with_none(params)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert got["opt"].master["blocks"]["ssm"]["dt_bias"] is None
    assert torch.equal(got["opt"].master["blocks"]["ssm"]["w_x"],
                       tree["opt"].master["blocks"]["ssm"]["w_x"])


# --- the launchers -----------------------------------------------------------

def test_serve_main_on_cpu(capsys):
    fam.check_serve_main(ARCH, capsys)


def test_train_main_on_cpu_resumes(tmp_path, capsys):
    fam.check_train_main_and_resume(ARCH, tmp_path, capsys)


def test_prompt_of_partial_chunks_is_refused():
    fam.check_refuses_partial_chunks(ARCH)
