"""The flash-attention backward of the port (its plain version, which CPU
tensors take, and the autograd path through it) against the reference's
Pallas backward in interpret mode, on the same numpy inputs; and the bound
that holds the Hopper backward kernels against the plain version."""
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as flash

from _torch_conformance import assert_close  # noqa: F401  (sets threads)

# tests/test_flash.py's SHAPES: B, Sq, Skv, H, Hkv, D, bq, bkv
SHAPES = [
    (2, 256, 256, 4, 2, 64, 64, 64),
    (1, 128, 128, 2, 2, 32, 128, 64),
    (2, 256, 256, 8, 2, 128, 128, 128),
    (1, 512, 512, 4, 1, 64, 128, 256),   # MQA
]
#: the other head dims of the repo's configs (the smoke configs' 8, 12 and
#: 16, zamba2's 112), MQA among them
HEAD_DIM_SHAPES = [
    (1, 128, 128, 4, 2, 8, 64, 64),
    (2, 64, 64, 4, 2, 12, 32, 32),
    (1, 64, 64, 4, 1, 12, 64, 64),       # MQA
    (1, 128, 128, 4, 1, 16, 64, 128),    # MQA
    (1, 128, 128, 4, 2, 112, 128, 64),
]
#: the bound of the reference's own test_backward_matches_oracle (f32)
F32_TOL = 5e-4


def _inputs(B, Sq, Skv, H, Hkv, D, seed=0):
    """q, k, v and an output gradient, standard normal, f32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Sq, H, D)).astype(np.float32))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.array(a, np.float32)).to(dtype)
            for a in arrays]


@functools.lru_cache(maxsize=None)
def _jit_bwd(causal, bq, bkv):
    return jax.jit(functools.partial(jflash._flash_bwd_pallas, causal=causal,
                                     block_q=bq, block_kv=bkv,
                                     interpret=True))


def _reference_bwd(q, k, v, do, causal, bq, bkv, dtype=jnp.float32):
    """The reference's forward and Pallas backward (interpret mode):
    ``(o, lse, (dq, dk, dv))`` as numpy arrays."""
    jq, jk, jv, jdo = (jnp.asarray(a).astype(dtype) for a in (q, k, v, do))
    o, lse = jflash._flash_fwd_pallas(jq, jk, jv, causal, bq, bkv, True)
    grads = _jit_bwd(causal, bq, bkv)(jq, jk, jv, o, lse, jdo)
    return (np.asarray(o.astype(jnp.float32)), np.asarray(lse),
            [np.asarray(g.astype(jnp.float32)) for g in grads])


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,bq,bkv", SHAPES + HEAD_DIM_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_bwd_matches_pallas_f32(B, Sq, Skv, H, Hkv, D, bq, bkv,
                                      causal):
    """The reference's o and lse go into both backwards, so only the
    backward is compared."""
    q, k, v, do = _inputs(B, Sq, Skv, H, Hkv, D)
    o, lse, want = _reference_bwd(q, k, v, do, causal, bq, bkv)
    got = flash.flash_bwd_plain(*_torch(q, k, v, o, lse, do), causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=F32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[3]], ids=["gqa", "mqa"])
def test_autograd_matches_jax_grad(shape):
    """``torch.autograd.grad`` through the port's ``flash_attention``
    against ``jax.vjp`` through the reference's ``flash_attention``
    custom_vjp, with the same output gradient."""
    B, Sq, Skv, H, Hkv, D, bq, bkv = shape
    q, k, v, do = _inputs(B, Sq, Skv, H, Hkv, D, seed=1)
    _, vjp = jax.vjp(lambda *a: jflash.flash_attention(*a, True, bq, bkv,
                                                       True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [t.requires_grad_(True) for t in _torch(q, k, v)]
    before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    out = flash.flash_attention(*leaves, True, bq, bkv)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == before
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=F32_TOL, err_msg=name)


def test_plain_bwd_matches_pallas_bf16():
    """bf16 in and out on both sides, f32 inside: the two roundings of each
    output to bf16 may differ by one bf16 ulp (2**-7 relative), and values
    that cancel to near 0 by the f32 noise under that (1e-5)."""
    q, k, v, do = _inputs(1, 128, 128, 4, 2, 64, seed=2)
    o, lse, want = _reference_bwd(q, k, v, do, True, 64, 64, jnp.bfloat16)
    bf = _torch(q, k, v, o, do, dtype=torch.bfloat16)
    got = flash.flash_bwd_plain(bf[0], bf[1], bf[2], bf[3],
                                torch.tensor(lse), bf[4], True)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=2 ** -7,
                                   atol=1e-5, err_msg=name)


def test_non_square_causal_backward_is_top_left_aligned():
    """Sq != Skv with causal: the gradients of the reference's
    ``ref_attention`` (query row i sees keys 0..i)."""
    q, k, v, do = _inputs(2, 64, 160, 4, 2, 32, seed=3)
    _, vjp = jax.vjp(lambda *a: jflash.ref_attention(*a, causal=True),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))
    leaves = [t.requires_grad_(True) for t in _torch(q, k, v)]
    got = torch.autograd.grad(flash.flash_attention(*leaves, True, 64, 32),
                              leaves, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=F32_TOL, err_msg=name)


# --- the bound the backward kernels are held to ------------------------------

def _kernel_grads(q, k, v, o, lse, do, fault=None):
    """Causal dq, dk, dv computed as the Hopper kernels compute them.
    bf16: f32 S, P, dP and delta; P rounded to bf16 before P^T dO, dS
    before dS K and dS^T Q; outputs in bf16.  f32: f32 throughout, dQ
    summed over 64-key tiles, dK and dV over 64-row query tiles and the G
    query heads one after another.  ``fault`` plants a kernel bug on the
    rows past the middle: dQ from the other KV head, dQ without the second
    64-key tile, dK without the group's last q-head, or an unwritten dV
    row."""
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    late = slice(S // 2, None)

    def parts(kk, vv, keep=None):
        kr, vr = (t.float().repeat_interleave(G, 2) for t in (kk, vv))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * scale
        visible = torch.ones(S, S, dtype=torch.bool).tril()
        if keep is not None:
            visible &= keep[None, :]
        s = torch.where(visible, s, flash.NEG_INF)
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
        ds = p * (dp - delta)
        if q.dtype == torch.bfloat16:
            ds = ds.to(torch.bfloat16).float()
            p = p.to(torch.bfloat16).float()
            dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
        else:
            dq = sum(torch.einsum("bhqk,bkhd->bqhd", ds[..., n0:n0 + 64],
                                  kr[:, n0:n0 + 64])
                     for n0 in range(0, S, 64)) * scale
        if q.dtype == torch.bfloat16:
            dkh = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
            dvh = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
        else:                                   # 64-row query tiles
            dkh = sum(torch.einsum("bhqk,bqhd->bkhd", ds[:, :, i0:i0 + 64],
                                   q[:, i0:i0 + 64].float())
                      for i0 in range(0, S, 64)) * scale
            dvh = sum(torch.einsum("bhqk,bqhd->bkhd", p[:, :, i0:i0 + 64],
                                   do[:, i0:i0 + 64].float())
                      for i0 in range(0, S, 64))
        return dq, dkh.reshape(B, S, Hkv, G, D), dvh.reshape(B, S, Hkv, G, D)

    dq, dkh, dvh = parts(k, v)
    dk, dv = dkh.sum(3), dvh.sum(3)
    if q.dtype == torch.float32:
        dk, dv = (sum(t[:, :, :, g] for g in range(G)) for t in (dkh, dvh))
    if fault == "dq_other_kv_head":
        dq[:, late] = parts(k.flip(2), v.flip(2))[0][:, late]
    elif fault == "dq_skipped_tile":
        keep = torch.ones(S, dtype=torch.bool)
        keep[64:128] = False
        dq[:, late] = parts(k, v, keep)[0][:, late]
    elif fault == "dk_missing_q_head":
        dk[:, late] = dkh[:, late, :, :G - 1].sum(3)
    elif fault == "dv_unwritten":
        dv[:, -1] = float("nan")
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


@functools.lru_cache(maxsize=None)
def _bwd_case(dtype):
    """q, k, v, dO (B 1, S 256, H 4, Hkv 2, D 128) in ``dtype``, with o and
    lse from the plain forward."""
    q, k, v, do = _torch(*_inputs(1, 256, 256, 4, 2, 128, seed=4),
                         dtype=dtype)
    o, lse = flash.flash_fwd_plain(q, k, v, True)
    return q, k, v, o, lse, do


@pytest.fixture(scope="module")
def bwd_case():
    """The bf16 case of :func:`_bwd_case`."""
    return _bwd_case(torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("fault", [None, "dq_other_kv_head",
                                   "dq_skipped_tile", "dk_missing_q_head"])
def test_bwd_bound_passes_its_rounding_and_rejects_faults(fault, dtype):
    """``check_bwd_against_plain`` (the bound chip_smoke.py and the GPU
    tests hold the kernels to) accepts the kernels' own roundings and
    rejects faults confined to the late rows; in bf16 and in f32."""
    bwd_case = _bwd_case(dtype)
    grads = _kernel_grads(*bwd_case, fault=fault)
    if fault is None:
        got = flash.check_bwd_against_plain(grads, *bwd_case, True)
        for name in ("dq", "dk", "dv"):
            assert got[f"{name}_bound_ratio"] <= 1
            assert got[f"{name}_row_bound_ratio"] <= 1
            assert got[f"{name}_max_abs_err"] > 0   # the rounding shows
    else:
        with pytest.raises(AssertionError, match=fault.split("_")[0]
                           + ".* beyond the bound"):
            flash.check_bwd_against_plain(grads, *bwd_case, True)


def test_bwd_bound_rejects_unwritten_outputs(bwd_case):
    grads = flash.flash_bwd_plain(*bwd_case, True)
    assert flash.check_bwd_against_plain(grads, *bwd_case, True)[
        "dk_max_abs_err"] == 0
    with pytest.raises(AssertionError, match="dv holds values that are not "
                                             "finite"):
        flash.check_bwd_against_plain(
            _kernel_grads(*bwd_case, fault="dv_unwritten"), *bwd_case, True)


def test_bwd_bound_allows_cancelling_dS():
    """Row 0 of causal attention sees only key 0, so dP equals delta and
    the true dS is 0; each side's f32 rounding of dP - delta (not 0) must
    pass."""
    q, k, v, do = _torch(*_inputs(1, 64, 64, 2, 1, 128, seed=5),
                         dtype=torch.bfloat16)
    o, lse = flash.flash_fwd_plain(q, k, v, True)
    grads = list(flash.flash_bwd_plain(q, k, v, o, lse, do, True))
    assert float(grads[0][0, 0].float().abs().max()) < 1e-5
    grads[0] = grads[0].clone()
    # dQ's row 0 is dS_00 K_0 scale: f32 noise of 1e-4 in dP - delta, where
    # the plain version has 0
    grads[0][0, 0] = (1e-4 * k[0, 0, 0].float() * 128 ** -0.5).to(
        torch.bfloat16)
    flash.check_bwd_against_plain(grads, q, k, v, o, lse, do, True)


# --- wrappers, counts, refusals ---------------------------------------------

def test_backward_kernel_counts_at_the_training_shape():
    """At qwen3-1.7b's training shape the bounds are the ones the kernels'
    sources state: 3 and 4 products of 2.749e11 FLOP, 0.834 and 1.112 ms at
    989 TFLOP/s; the bytes bound is far below."""
    B, S, H, Hkv, D = 8, 4096, 16, 8, 128
    dq = flash.flash_bwd_kernel_flops(B, S, S, H, D, True, "dq")
    dkv = flash.flash_bwd_kernel_flops(B, S, S, H, D, True, "dkv")
    assert dq == 3 * 2 * B * H * S * S / 2 * D
    assert abs(dq / 989e12 * 1e3 - 0.834) < 1e-3
    assert abs(dkv / 989e12 * 1e3 - 1.111) < 1e-3
    for kernel, flops in (("dq", dq), ("dkv", dkv)):
        t_bytes = flash.flash_bwd_kernel_bytes(B, S, S, H, Hkv, D, kernel) \
            / 3.35e12 * 1e3
        assert t_bytes < flops / 989e12 * 1e3 / 4
    # with flash_flops' 2 forward and 5 backward products
    assert dq + dkv == flash.flash_flops(B, S, S, H, D, True, True) \
        - flash.flash_flops(B, S, S, H, D, True, False) \
        + 2 * (2 * B * H * S * S / 2 * D)


def test_cuda_backward_without_a_card_raises():
    """The backward kernels' path never falls back to the plain version:
    without a card (or without nvcc) it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, k, v, do = _torch(*_inputs(1, 64, 64, 2, 1, 128), dtype=torch.bfloat16)
    o, lse = flash.flash_fwd_plain(q, k, v, True)
    before = (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash.flash_bwd_dq(q, k, v, o, lse, do, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash.flash_bwd_dkv(q, k, v, do, lse, lse, True)
    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.flash_bwd()
    assert (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == before
