"""The port's error-feedback gradient compression (``optim/compression.py``)
and its train step against the reference on the CPU, on the same numpy
inputs: ``ef_compress_update`` leaf by leaf (f32 and bf16 leaves, keep
ratios 0.05, 0.25 and 1.0, int8 quantization on and off, ties at the
threshold), the error-feedback invariants of the reference's own test,
``make_compressed_train_step`` for 3 steps on qwen3-1.7b's smoke config,
and the launcher's ``--compress`` with a checkpoint and a resume."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as jcomp
from repro.optim import adamw as jadamw
from repro.train import make_compressed_train_step as jmake_compressed
from repro_torch import configs
from repro_torch.checkpoint import restore_pytree
from repro_torch.convert import opt_state_from_reference
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params
from repro_torch.optim import (AdamWConfig, AdamWState, adamw_init,
                               ef_compress_update, init_ef_state)
from repro_torch.optim import compression
from repro_torch.train import make_compressed_train_step, make_train_step

import _torch_family as fam

ARCH = "qwen3-1.7b"
#: leaf shapes of the compared trees: a stacked matrix, a vector, a
#: 3D leaf whose size is not a multiple of 8, one element
SHAPES = {"blocks": {"w": (3, 16, 24), "ln": (3, 24)},
          "embed": {"tok": (7, 5, 9)}, "scale": (1,)}


def _tree(rng, dtype, scale=1.0):
    """Numpy f32 leaves shaped by SHAPES (rounded to bf16 for
    ``dtype="bfloat16"``)."""
    def leaf(shape):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        if dtype == "bfloat16":
            a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        return a
    return jax.tree.map(leaf, SHAPES, is_leaf=lambda x: isinstance(x, tuple))


def _torch(tree, dtype):
    return jax.tree.map(lambda a: torch.from_numpy(a).to(getattr(torch,
                                                                 dtype)),
                        tree)


def _bits(t):
    """A tensor's or array's f32 (or bf16) values as their bit patterns."""
    if isinstance(t, torch.Tensor):
        t = t.float().numpy()
    return np.asarray(t, np.float32).view(np.uint32)


def _compare(grads_np, ef_np, dtype, keep, quantize):
    """Both packages' ``ef_compress_update`` on the same leaves: the kept
    values bit for bit, the residual bit for bit (with int8: within the
    reference's fused rounding, see below), the masks equal, the wire
    bytes equal; returns the port's outputs."""
    jg = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)),
                      grads_np)
    je = jax.tree.map(jnp.asarray, ef_np)
    jkept, jres, jwire = jax.jit(
        lambda g, e: jcomp.ef_compress_update(g, e, keep, quantize))(jg, je)
    tg = _torch(grads_np, dtype)
    te = _torch(ef_np, "float32")
    kept, res, wire = ef_compress_update(tg, te, keep, quantize)
    got, want = fam.flat(kept), fam.flat(fam.np_tree(jkept))
    assert got.keys() == want.keys() == fam.flat(res).keys()
    for key in want:
        np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]),
                                      err_msg=key)
    for key, r in fam.flat(fam.np_tree(jres)).items():
        mine = fam.flat(res)[key]
        if not quantize:
            np.testing.assert_array_equal(_bits(mine), _bits(r),
                                          err_msg=key)
            continue
        # with int8, the reference's compiled step (XLA on the CPU) may fuse
        # ``gf - q * scale`` into one multiply-add, rounded once, where the
        # port rounds the product q * scale first: a kept element's residual
        # then differs by about half an ulp of that product (at most 0.49
        # ulp of the kept value over 30 seeded trees of these shapes; held
        # to 2**-22 of it); a dropped element's is gf on both sides, bit
        # for bit
        dropped = want[key] == 0
        np.testing.assert_array_equal(_bits(mine[dropped]),
                                      _bits(r[dropped]), err_msg=key)
        np.testing.assert_array_less(np.abs(mine - r)[~dropped],
                                     2.0 ** -22 * np.abs(want[key])[~dropped]
                                     + 1e-45, err_msg=key)
    assert fam.dtypes(kept) == fam.dtypes(tg)
    assert all(r.dtype == torch.float32 for r in _tensors(res))
    assert wire.dtype == torch.float32 and float(wire) == float(jwire)
    for key, (g, e) in _leaf_pairs(grads_np, ef_np, dtype):
        gf = (jnp.asarray(g, getattr(jnp, dtype)).astype(jnp.float32)
              + jnp.asarray(e))
        tgf = torch.from_numpy(g).to(getattr(torch, dtype)).float() \
            + torch.from_numpy(e)
        np.testing.assert_array_equal(
            compression._topk_mask(tgf, keep).numpy(),
            np.asarray(jcomp._topk_mask(gf, keep)), err_msg=key)
    return kept, res, wire


def _tensors(tree) -> list:
    """The tensors of nested dicts, tuples and NamedTuples, in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return [] if tree is None else [tree]


def _leaf_pairs(a, b, dtype, prefix=""):
    for k in a:
        if isinstance(a[k], dict):
            yield from _leaf_pairs(a[k], b[k], dtype, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", (a[k], b[k])


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("keep", [0.05, 0.25, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_compress_update_matches_reference(dtype, keep, quantize):
    """A residual from an earlier step (standard normal / 10) beside the
    gradients: f32 arithmetic in the reference's order, so the masks and
    kept values are equal bit for bit, and the residual too but where the
    reference's compiler fuses the int8 dequantization into it; in bf16
    the kept values are rounded to bf16 on both sides and the residual is
    taken before that rounding."""
    rng = np.random.default_rng(int(keep * 100) + 7 * quantize)
    grads, ef = _tree(rng, dtype), _tree(rng, "float32", 0.1)
    kept, res, _ = _compare(grads, ef, dtype, keep, quantize)
    n = sum(a.size for a in fam.flat(grads).values())
    nonzero = sum(int((t != 0).sum()) for t in _tensors(kept))
    assert nonzero <= n * keep + len(fam.flat(grads)) * 2
    if keep == 1.0 and not quantize and dtype == "float32":
        assert all(not r.any() for r in _tensors(res))


@pytest.mark.parametrize("quantize", [True, False], ids=["int8", "f32"])
def test_ties_at_the_threshold_keep_more_than_k(quantize):
    """Magnitudes with ties at the k-th largest: ``|x| >= t`` keeps every
    tie, on both sides (16 of 40 elements at keep 0.25, k = 10)."""
    w = np.zeros((4, 10), np.float32)
    w[0] = np.arange(1, 11)                      # 1..10
    w[1, :6] = 7.0                               # 6 more ties at 7
    w[2, :6] = -7.0
    w[3] = 0.5
    grads = {"w": w, "b": np.array([3.0, -3.0, 3.0, 1.0], np.float32)}
    ef = {"w": np.zeros_like(w), "b": np.zeros(4, np.float32)}
    kept, _, wire = _compare(grads, ef, "float32", 0.25, quantize)
    assert int((kept["w"] != 0).sum()) == 4 + 12   # 7..10, twelve 7s
    assert int((kept["b"] != 0).sum()) == 3        # k = 1: the three 3s
    n = 16 + 3
    want = n * (1 if quantize else 4) + 4 * (np.ceil(16 / 8)
                                             + np.ceil(3 / 8))
    assert float(wire) == want


def test_kth_largest_equals_topk():
    """The radix select's threshold against ``torch.topk``'s k-th value:
    random magnitudes, ties, zeros, k = 1 and k = n."""
    rng = np.random.default_rng(3)
    for n, k in ((1, 1), (9, 1), (9, 9), (1000, 50), (4097, 2048),
                 (20000, 1)):
        a = np.abs(rng.standard_normal(n)).astype(np.float32)
        a[: n // 4] = a[n // 2]
        a[n // 4: n // 3] = 0
        t = torch.from_numpy(a)
        want = torch.topk(t, k).values[-1]
        assert compression._kth_largest(t, k) == want, (n, k)


def test_error_feedback_invariants():
    """The reference's ``test_ef_compression_error_feedback`` on the port:
    kept + residual == grads, only the top 4 of 16 kept, and over 16 steps
    delivered + residual == 16 × grads, the delivered mass above 0.7 of
    it."""
    params = {"w": torch.zeros((4, 4))}
    g = {"w": torch.arange(1.0, 17.0).reshape(4, 4)}
    ef = init_ef_state(params)
    kept, ef2, wire = ef_compress_update(g, ef, keep_ratio=0.25,
                                         quantize=False)
    np.testing.assert_allclose((kept["w"].float() + ef2["w"]).numpy(),
                               g["w"].numpy(), rtol=1e-6)
    assert int((kept["w"] != 0).sum()) <= 4
    assert float(wire) == 4 * 4 + 4 * 1
    total = torch.zeros((4, 4))
    ef = init_ef_state(params)
    n = 16
    for _ in range(n):
        kept, ef, _ = ef_compress_update(g, ef, keep_ratio=0.25,
                                         quantize=False)
        total = total + kept["w"]
    np.testing.assert_allclose((total + ef["w"]).numpy(),
                               n * g["w"].numpy(), rtol=1e-5)
    assert float(total.sum()) > 0.7 * n * float(g["w"].sum())


@pytest.mark.parametrize("microbatches", [1, 2])
def test_compressed_train_step_matches_reference(microbatches):
    """Three steps of ``make_compressed_train_step`` (keep 0.05, int8) from
    the same state against the reference's jitted step: the losses to
    ``LOSS_RTOL``; params, m, v and the EF residual within ``GRAD_TOL`` of
    each leaf's largest; the wire bytes equal.  AdamW's eps is
    ``STEP_EPS``: the compressed gradients are sparse, and at an element
    a step leaves at zero the update divides by the moment's own root."""
    jcfg, cfg, jparams, _ = fam.model(ARCH)
    params = fam.params_from_reference(cfg, fam.np_tree(jparams))
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=5, eps=fam.STEP_EPS)
    jstep = jax.jit(jmake_compressed(jcfg, jadamw.AdamWConfig(**ocfg),
                                     microbatches))
    step = make_compressed_train_step(cfg, AdamWConfig(**ocfg),
                                      microbatches)
    jstate = (jadamw.adamw_init(jparams), jcomp.init_ef_state(jparams))
    state = (opt_state_from_reference(cfg, fam.np_tree(jstate[0])),
             step.init_extra(params))
    data = fam.JDataset(fam.data_config(cfg, seed=2))
    for s in range(3):
        host = data.batch_at(s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v)
                                     for k, v in host.items()})
        params, state, m = step(params, state,
                                launch_train.device_batch(host, "cpu"))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=fam.LOSS_RTOL)
        assert float(m["compressed_wire_bytes"]) == float(
            jm["compressed_wire_bytes"])
    opt, ef = state
    assert isinstance(opt, AdamWState) and int(opt.step) == 3
    fam.assert_trees_close(params, fam.np_tree(jparams), fam.GRAD_TOL)
    fam.assert_trees_close(opt.m, fam.np_tree(jstate[0].m), fam.GRAD_TOL)
    fam.assert_trees_close(opt.v, fam.np_tree(jstate[0].v), fam.GRAD_TOL)
    fam.assert_trees_close(ef, fam.np_tree(jstate[1]), fam.GRAD_TOL)


def test_compressed_step_first_loss_equals_exact_step():
    """The compression acts after the gradients: the first step's loss is
    the exact step's on the same weights and batch, bit for bit; the
    updated weights differ."""
    _, cfg, _, _ = fam.model(ARCH)
    batch = launch_train.device_batch(fam.host_batch(cfg, seed=3), "cpu")
    runs = []
    for make in (make_train_step, make_compressed_train_step):
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        step = make(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
        state = adamw_init(params)
        if make is make_compressed_train_step:
            state = (state, step.init_extra(params))
        params, _, m = step(params, state, batch)
        runs.append((float(m["loss"]), params))
    assert runs[0][0] == runs[1][0]
    assert not torch.equal(runs[0][1]["blocks"]["mlp"]["w_in"],
                           runs[1][1]["blocks"]["mlp"]["w_in"])


def test_train_main_compress_resumes_bit_for_bit(tmp_path, capsys):
    """``--compress 0.05`` with a checkpoint every step: a launch of 3
    steps, a second to 5 that resumes from step 2, and an uninterrupted
    5-step launch give the same losses (``check_train_main_and_resume``)
    and, at step 4, the same params, AdamW state and EF residual bit for
    bit: the residual is restored with the rest.  The checkpoint holds the
    state as ``(AdamWState, residual)``."""
    fam.check_train_main_and_resume(ARCH, tmp_path, capsys,
                                    extra=["--compress", "0.05"])
    cfg = configs.smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    template = {"params": params,
                "opt": (adamw_init(params), init_ef_state(params))}
    resumed = restore_pytree(template, str(tmp_path / "ck"), 4)
    whole = restore_pytree(template, str(tmp_path / "whole"), 4)
    opt, ef = resumed["opt"]
    assert isinstance(opt, AdamWState) and int(opt.step) == 5
    assert any(bool(t.any()) for t in _tensors(ef))
    got, want = _tensors(resumed), _tensors(whole)
    assert len(got) == len(want) == 4 * len(_tensors(params)) + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    names = os.listdir(tmp_path / "ck" / "step_00000004")
    assert "MANIFEST.json" in names
