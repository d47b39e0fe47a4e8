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
#: the other head dims of the repo's configs (the smoke configs' 8, 12 and
#: 16, zamba2's 112), MQA among them
HEAD_DIM_SHAPES = [
    (1, 128, 128, 4, 2, 8, 64, 64),
    (2, 64, 64, 4, 2, 12, 32, 32),
    (1, 64, 64, 4, 1, 12, 64, 64),       # MQA
    (1, 128, 128, 4, 1, 16, 64, 128),    # MQA
    (1, 128, 128, 4, 2, 112, 128, 64),
]


def _qkv(B, Sq, Skv, H, Hkv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,bq,bkv", SHAPES + HEAD_DIM_SHAPES)
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
    """Causal o computed as the Hopper kernel computes it.  bf16: f32
    scores and row sums, each softmax weight rounded to bf16 before P.V, o
    to bf16.  f32: f32 throughout, the keys taken in 64-key tiles under the
    online softmax's running max and sum.  ``fault`` plants a kernel bug on
    the rows past the middle: a V tile read from the tile before it, or
    the other KV head's V."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kr, vr = (t.float().repeat_interleave(G, 2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * D ** -0.5, kr)
    s = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), s,
                    flash.NEG_INF)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l = e.sum(-1).permute(0, 2, 1)[..., None]

    def pv(vals):
        if q.dtype == torch.bfloat16:
            return torch.einsum("bhqk,bkhd->bqhd",
                                e.to(torch.bfloat16).float(), vals) / l
        m = torch.full(s.shape[:3], flash.NEG_INF)
        run, acc = torch.zeros(s.shape[:3]), torch.zeros(B, H, S, D)
        for n0 in range(0, S, 64):
            st = s[..., n0:n0 + 64]
            m2 = torch.maximum(m, st.amax(-1))
            corr, p = torch.exp(m - m2), torch.exp(st - m2[..., None])
            run = run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vals[:, n0:n0 + 64])
            m = m2
        return (acc / run[..., None]).permute(0, 2, 1, 3)
    o = pv(vr)
    if fault == "stale_v_tile":
        bad = vr.clone()
        bad[:, 128:192] = vr[:, 64:128]
        o[:, S // 2:] = pv(bad)[:, S // 2:]
    elif fault == "other_kv_head":
        o[:, S // 2:] = pv(v.flip(2).float().repeat_interleave(G, 2))[
            :, S // 2:]
    return o.to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("fault", [None, "stale_v_tile", "other_kv_head"])
def test_kernel_bound_passes_its_rounding_and_rejects_faults(fault, dtype):
    """``check_against_plain`` (the bound chip_smoke.py and the GPU tests
    hold the kernel to) accepts the kernel's own roundings, on diffuse
    attention at its widths, and rejects faults confined to the late rows,
    where |o| is small; in bf16 and in f32."""
    q, k, v = _torch(*_qkv(1, 256, 256, 4, 2, 128, seed=3), dtype=dtype)
    o = _kernel_numerics(q, k, v, fault)
    if fault is None:
        got = flash.check_against_plain(o, q, k, v, True)
        assert got["bound_ratio"] <= 1 and got["row_rel_err"] <= 2 ** -7
        assert got["max_abs_err"] > 0           # the rounding shows
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


def test_form_check_names_b2_rest_without_a_card():
    """``require_form`` (which ``_require_card`` runs first) takes every
    form of ``FORMS`` and refuses the rest by ROADMAP B2-rest, on the
    CPU."""
    assert flash.FORMS == {torch.bfloat16: (64, 112, 128),
                           torch.float32: (8, 12, 16, 64, 112, 128)}
    for dtype, dims in flash.FORMS.items():
        for D in dims:
            flash.require_form(dtype, D)
    for dtype, D in ((torch.float16, 128), (torch.bfloat16, 8),
                     (torch.bfloat16, 16), (torch.float32, 96),
                     (torch.bfloat16, 96), (torch.float64, 64)):
        with pytest.raises(ValueError, match="B2-rest"):
            flash.require_form(dtype, D)
        q, k, v = _torch(*_qkv(1, 8, 8, 2, 1, D), dtype=dtype)
        with pytest.raises(ValueError, match="B2-rest"):
            flash._require_card(q, k, v)
    q, k, v = _torch(*_qkv(1, 8, 8, 2, 1, 12))
    with pytest.raises(ValueError, match="share a dtype"):
        flash._require_card(q, k.to(torch.bfloat16), v)


def test_layout_rule_takes_16_byte_chunks_per_dtype():
    """Strides in multiples of 16 bytes: 4 f32 or 8 bf16 elements (so
    phi4-mini's head dim 12 passes in f32), a contiguous head dim and a
    16-byte aligned start."""
    f32 = torch.zeros(2, 8, 4, 12)
    assert flash._layout_ok(f32)
    assert flash._layout_ok(torch.zeros(2, 8, 6, 12)[:, :, 2:])
    assert not flash._layout_ok(torch.zeros(2, 8, 4, 14)[..., :12])
    assert not flash._layout_ok(f32.transpose(2, 3))
    assert not flash._layout_ok(torch.zeros(2 * 8 * 4 * 12 + 1)[1:].view(
        2, 8, 4, 12))
    bf16 = torch.zeros(2, 8, 4, 12, dtype=torch.bfloat16)
    assert not flash._layout_ok(bf16)
    assert flash._layout_ok(torch.zeros(2, 8, 4, 16, dtype=torch.bfloat16))
    assert flash._layout_ok(torch.zeros(2, 8, 4, 112, dtype=torch.bfloat16))


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
