"""The flash-attention forward of the port (its plain version, which CPU
tensors take) against the reference's Pallas kernel in interpret mode, on
the same numpy inputs; and the wrapper's refusals.  The backward is in
``test_torch_flash_bwd.py``."""
import shutil

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


def _qkv(B, Sq, Skv, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,bq,bkv", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_f32(B, Sq, Skv, H, Hkv, D, bq, bkv, causal):
    q, k, v = _qkv(B, Sq, Skv, H, Hkv, D)
    jo, jlse = jflash._flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal, bq, bkv,
                                        True)
    o, lse = flash.flash_attention_lse(*_torch(q, k, v), causal, bq, bkv)
    assert o.shape == (B, Sq, H, D) and lse.shape == (B, H, Sq)
    assert o.dtype == torch.float32 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-4)


def test_plain_matches_pallas_bf16():
    q, k, v = _qkv(1, 128, 128, 2, 2, 64, seed=1)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    jo, jlse = jflash._flash_fwd_pallas(jq, jk, jv, True, 64, 64, True)
    tq, tk, tv = _torch(q, k, v, dtype=torch.bfloat16)
    o = torch.full_like(tq, float("nan"))
    lse = torch.full((1, 2, 128), float("nan"))
    assert flash.flash_attention_lse(tq, tk, tv, True, 64, 64,
                                     out=(o, lse)) == (o, lse)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)), rtol=0,
                               atol=3e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=0,
                               atol=1e-4)


def test_non_square_causal_is_top_left_aligned():
    """Sq != Skv with causal: query row i sees keys 0..i, as in the
    reference's ``ref_attention``."""
    q, k, v = _qkv(2, 64, 160, 4, 2, 32, seed=2)
    want = jflash.ref_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True)
    got = flash.flash_attention(*_torch(q, k, v), True, 64, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(
        flash.ref_attention(*_torch(q, k, v), causal=True).numpy(),
        np.asarray(want), rtol=0, atol=1e-4)


def _kernel_numerics(q, k, v, fault=None):
    """Causal o rounded as the Hopper kernel rounds it: f32 scores and row
    sums, each softmax weight rounded to bf16 before P.V, o to bf16.
    ``fault`` plants a kernel bug on the rows past the middle: a V tile
    read from the tile before it, or the other KV head's V."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kr, vr = (t.float().repeat_interleave(G, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * D ** -0.5, kr)
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s,
                    flash.NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1).permute(0, 2, 1)[..., None]

    def pv(vals):
        return torch.einsum("bhqk,bkhd->bqhd", e.to(torch.bfloat16).float(),
                            vals) / l
    o = pv(vr)
    if fault == "stale_v_tile":
        bad = vr.clone()
        bad[:, 128:192] = vr[:, 64:128]
        o[:, S // 2:] = pv(bad)[:, S // 2:]
    elif fault == "other_kv_head":
        o[:, S // 2:] = pv(v.flip(2).float().repeat_interleave(G, 2))[
            :, S // 2:]
    return o.to(torch.bfloat16)


@pytest.mark.parametrize("fault", [None, "stale_v_tile", "other_kv_head"])
def test_kernel_bound_passes_its_rounding_and_rejects_faults(fault):
    """``check_against_plain`` (the bound chip_smoke.py and the GPU tests
    hold the kernel to) accepts the kernel's own roundings, on diffuse
    attention at its widths, and rejects faults confined to the late rows,
    where |o| is small."""
    q, k, v = _torch(*_qkv(1, 256, 256, 4, 2, 128, seed=3),
                     dtype=torch.bfloat16)
    o = _kernel_numerics(q, k, v, fault)
    if fault is None:
        got = flash.check_against_plain(o, q, k, v, True)
        assert got["bound_ratio"] <= 1 and got["row_rel_err"] <= 2 ** -7
    else:
        with pytest.raises(AssertionError, match="beyond its bound"):
            flash.check_against_plain(o, q, k, v, True)


def test_kernel_bound_rejects_unwritten_outputs():
    q, k, v = _torch(*_qkv(1, 128, 128, 2, 1, 128, seed=4),
                     dtype=torch.bfloat16)
    o, lse = flash.flash_fwd_plain(q, k, v, True)
    assert flash.check_against_plain(o, q, k, v, True, lse=lse)[
        "max_abs_err"] == 0
    o[0, 100] = float("nan")
    with pytest.raises(AssertionError, match="not finite"):
        flash.check_against_plain(o, q, k, v, True)
    lse[0, 0, 5] = float("nan")
    with pytest.raises(AssertionError, match="lse"):
        flash.check_against_plain(o.nan_to_num(), q, k, v, True, lse=lse)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("causal", [True, False])
def test_traffic_and_flops_equal_reference(train, causal):
    for B, Sq, Skv, H, Hkv, D, _, _ in SHAPES + [(8, 4096, 4096, 16, 8, 128,
                                                  0, 0)]:
        assert flash.flash_traffic_bytes(B, Sq, Skv, H, Hkv, D, 2, train) \
            == jflash.flash_traffic_bytes(B, Sq, Skv, H, Hkv, D, 2, train)
        assert flash.flash_flops(B, Sq, Skv, H, D, causal, train) \
            == jflash.flash_flops(B, Sq, Skv, H, D, causal, train)


def test_refuses_shapes_the_blocks_do_not_divide():
    q, k, v = _torch(*_qkv(1, 96, 96, 2, 1, 32))
    with pytest.raises(ValueError, match="multiples"):
        flash.flash_attention(q, k, v, True, 64, 64)


def test_cuda_path_without_a_card_raises():
    """The kernel path never falls back to the plain version: without a
    card (or without nvcc) it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, k, v = _torch(*_qkv(1, 64, 64, 2, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flash._launch(q, k, v, True)
    before = flash.LAUNCHES
    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.flash_fwd()
    assert flash.LAUNCHES == before
