"""The Hopper flash-attention kernels (forward, and the backward's dQ and
dK/dV) against their plain versions, on the card, in every built (dtype,
head dim) form.  Needs an sm_90 device and ``nvcc``; skipped otherwise.
Run on a card with
``PYTHONPATH=src python -m pytest tests/test_torch_flash_cuda.py -m gpu``.
"""
import itertools
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as flash

pytestmark = pytest.mark.gpu

#: B, Sq, Skv, H, Hkv, D, causal: GQA ratios 1, 2 and 4, ragged lengths
#: (not multiples of the kernels' 64- or 128-row tiles), non-square, full
#: attention; lengths on each side of the bf16 forward's 128-row tiles
#: (127, 128, 129, 255, 257), Skv < 128 < Sq and the reverse, Sq = 1
CASES = [
    (2, 200, 200, 4, 4, 128, True),
    (1, 256, 256, 8, 4, 128, True),
    (2, 130, 130, 8, 2, 128, True),
    (1, 64, 192, 4, 2, 128, True),
    (1, 192, 64, 4, 2, 128, True),
    (2, 200, 200, 4, 1, 128, False),
    (1, 1, 1, 2, 1, 128, True),
    (1, 1024, 1024, 16, 8, 128, True),
    (2, 127, 127, 4, 2, 128, True),
    (1, 128, 128, 4, 2, 128, True),
    (2, 129, 129, 4, 2, 128, True),
    (1, 255, 255, 4, 4, 128, True),
    (1, 257, 257, 4, 1, 128, True),
    (1, 300, 100, 4, 2, 128, True),
    (1, 100, 300, 4, 2, 128, True),
    (2, 257, 129, 4, 2, 128, False),
    (2, 1, 257, 4, 2, 128, True),
    (2, 1, 257, 4, 2, 128, False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernel is built for sm_90a")
    if shutil.which("nvcc") is None and not Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc not found")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(case, device, seed=0):
    B, Sq, Skv, H, Hkv, D, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        device=device, dtype=torch.bfloat16)
        for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernel_matches_plain_version(cuda, case):
    causal = case[-1]
    q, k, v = _qkv(case, cuda)
    o = torch.full_like(q, float("nan"))
    lse = torch.full((q.shape[0], q.shape[2], q.shape[1]), float("nan"),
                     device=cuda)
    before = flash.LAUNCHES
    flash.flash_attention_lse(q, k, v, causal, out=(o, lse))
    torch.cuda.synchronize()
    assert flash.LAUNCHES == before + 1
    # the bounds are check_against_plain's: P rounded to bf16 before P.V,
    # one bf16 ulp of o elementwise, 2**-7 of each row's norm, lse 1e-3
    flash.check_against_plain(o, q, k, v, causal, lse=lse)


#: the bf16 forward at every head dim and GQA group size G = H / Hkv (1, 2,
#: 3, 4, 16), over lengths on each side of its 128-row tiles
BF16_CASES = [(D, G, S, causal)
              for D in (64, 112, 128)
              for G, S, causal in ((1, 127, True), (2, 129, True),
                                   (3, 257, True), (4, 255, False),
                                   (16, 200, True))]


@pytest.mark.parametrize("D,G,S,causal", BF16_CASES,
                         ids=lambda x: str(x))
def test_bf16_forward_reads_fused_qkv_views(cuda, D, G, S, causal):
    """q, k and v as strided views of one fused QKV projection (row stride
    (H + 2 Hkv) D), o and lse pre-filled with NaN: every row written and
    within check_against_plain's bf16 bound."""
    B, Hkv = 2, 2 if G < 16 else 1
    H = G * Hkv
    rng = np.random.default_rng(D + G)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * Hkv, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.split([H, Hkv, Hkv], dim=2)
    o = torch.full_like(q, float("nan"))
    lse = torch.full((B, H, S), float("nan"), device=cuda)
    flash.flash_attention_lse(q, k, v, causal, out=(o, lse))
    torch.cuda.synchronize()
    flash.check_against_plain(o, q, k, v, causal, lse=lse)


@pytest.mark.parametrize("D", [64, 112, 128])
def test_bf16_forward_is_deterministic(cuda, D):
    """Two launches on the same inputs agree bit for bit: the kernel has no
    atomics, so its order of operations is fixed."""
    case = (2, 300, 300, 8, 2, D, True)
    q, k, v = _qkv(case, cuda, seed=D)
    o1, lse1 = flash.flash_attention_lse(q, k, v, True)
    o2, lse2 = flash.flash_attention_lse(q, k, v, True)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_kernel_reads_strided_views(cuda):
    """q, k, v as views of one fused projection, in the (B, S, H, D) layout
    without a copy."""
    B, S, H, Hkv, D = 2, 128, 8, 2, 128
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * Hkv, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.split([H, Hkv, Hkv], dim=2)
    flash.check_against_plain(flash.flash_attention(q, k, v, True), q, k, v)


def test_kernel_refuses_forms_it_was_not_built_for(cuda):
    """float16, and f32 or bf16 at head dim 96, raise naming ROADMAP
    B2-rest before any launch."""
    before = flash.LAUNCHES
    q, k, v = (t.half() for t in _qkv(CASES[0], cuda))
    with pytest.raises(ValueError, match="B2-rest"):
        flash.flash_attention(q, k, v, True)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (t[..., :96].to(dtype) for t in _qkv(CASES[0], cuda))
        with pytest.raises(ValueError, match="B2-rest"):
            flash.flash_attention(q, k, v, True)
    assert flash.LAUNCHES == before


def test_library_forms_equal_the_wrapper_table(cuda):
    from repro_torch.kernels import _build
    fwd, bwd = _build.flash_fwd(), _build.flash_bwd()
    for dtype, code in flash.DTYPE_CODE.items():
        for D in range(1, 257):
            want = D in flash.FORMS[dtype]
            assert bool(fwd.flash_fwd_has_form(code, D)) == want, (dtype, D)
            assert bool(bwd.flash_bwd_has_form(code, D)) == want, (dtype, D)


#: every built (dtype, D) form at a small shape: ragged lengths, GQA 2 and
#: MQA (Hkv 1) in turn, causal and full attention
FORM_CASES = [(dtype, D, case)
              for dtype, dims in ((torch.float32, (8, 12, 16, 64, 112, 128)),
                                  (torch.bfloat16, (64, 112, 128)))
              for i, D in enumerate(dims)
              for case in ([(2, 130, 130, 4, 2 - i % 2, D, True),
                            (1, 64, 100, 4, 1 + i % 2, D, i % 3 == 0)])]


@pytest.mark.parametrize("dtype,D,case", FORM_CASES,
                         ids=lambda x: str(x).removeprefix("torch."))
def test_every_form_matches_plain_version(cuda, dtype, D, case):
    """Forward, dQ and dK/dV of each built form against their plain
    versions (outputs pre-filled with NaN), within check_against_plain's
    and check_bwd_against_plain's bounds for the dtype."""
    causal = case[-1]
    q, k, v = (t.to(dtype) for t in _qkv(case, cuda, seed=D))
    B, Sq, H = q.shape[:3]
    o = torch.full_like(q, float("nan"))
    lse = torch.full((B, H, Sq), float("nan"), device=cuda)
    key = (str(dtype).removeprefix("torch."), D)
    before = {n: flash.FORM_LAUNCHES.get((n, *key), 0)
              for n in ("fwd", "dq", "dkv")}
    flash.flash_attention_lse(q, k, v, causal, out=(o, lse))
    flash.check_against_plain(o, q, k, v, causal, lse=lse)
    do = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(D),
                     device=cuda).to(dtype)
    dq = torch.full_like(q, float("nan"))
    delta = torch.full((B, H, Sq), float("nan"), device=cuda)
    dk = torch.full_like(k, float("nan"))
    dv = torch.full_like(v, float("nan"))
    flash.flash_bwd_dq(q, k, v, o, lse, do, causal, out=(dq, delta))
    flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal, out=(dk, dv))
    torch.cuda.synchronize()
    assert {n: flash.FORM_LAUNCHES[(n, *key)] - before[n]
            for n in before} == {"fwd": 1, "dq": 1, "dkv": 1}
    assert [t.dtype for t in (o, dq, dk, dv)] == [dtype] * 4
    flash.check_bwd_against_plain((dq, dk, dv), q, k, v, o, lse, do, causal)


@pytest.mark.parametrize("dtype,D", [(torch.float32, 12),
                                     (torch.float32, 112),
                                     (torch.bfloat16, 112)],
                         ids=["f32-12", "f32-112", "bf16-112"])
def test_forms_read_strided_views(cuda, dtype, D):
    """q, k, v as views of one fused projection (row stride (H + 2 Hkv) D,
    a multiple of 16 bytes), and dO as a view of a wider tensor."""
    B, S, H, Hkv = 2, 96, 4, 2
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * Hkv, D)).astype(np.float32)).to(cuda, dtype)
    q, k, v = qkv.split([H, Hkv, Hkv], dim=2)
    o, lse = flash.flash_attention_lse(q, k, v, True)
    flash.check_against_plain(o, q, k, v, True, lse=lse)
    wide = torch.from_numpy(rng.standard_normal(
        (B, S, 2 * H, D)).astype(np.float32)).to(cuda, dtype)
    do = wide[:, :, H:]
    assert flash._layout_ok(do)
    grads = flash.flash_bwd(q, k, v, o, lse, do, True)
    flash.check_bwd_against_plain(grads, q, k, v, o, lse, do, True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_glm4_group_of_16_query_heads(cuda, dtype):
    """glm4-9b's GQA: 32 query heads on 2 KV heads (G = 16), summed in the
    dK/dV CTA."""
    case = (1, 192, 192, 32, 2, 128, True)
    q, k, v = (t.to(dtype) for t in _qkv(case, cuda, seed=16))
    o, lse = flash.flash_attention_lse(q, k, v, True)
    flash.check_against_plain(o, q, k, v, True, lse=lse)
    do = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(1),
                     device=cuda).to(dtype)
    grads = flash.flash_bwd(q, k, v, o, lse, do, True)
    flash.check_bwd_against_plain(grads, q, k, v, o, lse, do, True)


def test_autograd_goes_through_the_f32_kernels(cuda):
    """torch.autograd.grad through flash_attention in f32 at head dim 12
    (phi4-mini's smoke config): one launch of each kernel, f32 gradients
    within the f32 bound."""
    case = (2, 96, 96, 4, 2, 12, True)
    q, k, v = (t.float() for t in _qkv(case, cuda, seed=5))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    do = torch.randn(q.shape, generator=torch.Generator(cuda).manual_seed(2),
                     device=cuda)
    before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    out = flash.flash_attention(*leaves, True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert [g.dtype for g in grads] == [torch.float32] * 3
    o, lse = flash.flash_attention_lse(q, k, v, True)
    flash.check_bwd_against_plain(grads, q, k, v, o, lse, do, True)


def _bwd_inputs(case, device, seed=0):
    """q, k, v, the forward's o and lse, and an output gradient."""
    B, Sq, _, H, _, D, causal = case
    q, k, v = _qkv(case, device, seed)
    o, lse = flash.flash_attention_lse(q, k, v, causal)
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal((B, Sq, H, D)).astype(
        np.float32)).to(device=device, dtype=torch.bfloat16)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("case", CASES, ids=str)
def test_backward_kernels_match_plain_version(cuda, case):
    causal = case[-1]
    q, k, v, o, lse, do = _bwd_inputs(case, cuda)
    B, Sq, H = q.shape[:3]
    dq = torch.full_like(q, float("nan"))
    delta = torch.full((B, H, Sq), float("nan"), device=cuda)
    dk = torch.full_like(k, float("nan"))
    dv = torch.full_like(v, float("nan"))
    before = (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    flash.flash_bwd_dq(q, k, v, o, lse, do, causal, out=(dq, delta))
    flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal, out=(dk, dv))
    torch.cuda.synchronize()
    assert (flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == (before[0] + 1,
                                                       before[1] + 1)
    want_delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    torch.testing.assert_close(delta, want_delta, rtol=1e-5, atol=1e-4)
    # the bounds are check_bwd_against_plain's: P and dS rounded to bf16
    # before their products, per element and per row
    flash.check_bwd_against_plain((dq, dk, dv), q, k, v, o, lse, do, causal)


def test_autograd_goes_through_both_kernels(cuda):
    """torch.autograd.grad through flash_attention: one forward launch, one
    launch of each backward kernel, gradients within the bound."""
    case = (2, 320, 320, 8, 2, 128, True)
    q, k, v, o, lse, do = _bwd_inputs(case, cuda, seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES)
    out = flash.flash_attention(*leaves, True)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (flash.LAUNCHES, flash.DQ_LAUNCHES, flash.DKV_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    flash.check_bwd_against_plain(grads, q, k, v, o, lse, do, True)


@pytest.mark.parametrize("D", [64, 112, 128])
def test_bf16_backward_is_deterministic(cuda, D):
    """Two launches of each backward kernel on the same inputs agree bit
    for bit in dq, delta, dk and dv: the kernels have no atomics, so their
    order of operations is fixed."""
    case = (2, 300, 300, 8, 2, D, True)
    q, k, v, o, lse, do = _bwd_inputs(case, cuda, seed=D)
    runs = []
    for _ in range(2):
        dq, delta = flash.flash_bwd_dq(q, k, v, o, lse, do, True)
        dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta, True)
        runs.append((dq, delta, dk, dv))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


#: the bf16 backward on fused-QKV views at every head dim (in turn), GQA
#: group size G = H / Hkv (1, 2, 3, 4, 16) and length on each side of its
#: 64-row ring tiles and 128-row CTAs, causal and full attention
BWD_VIEW_CASES = [((64, 112, 128)[i % 3], G, S, causal)
                  for i, (G, S, causal) in enumerate(itertools.product(
                      (1, 2, 3, 4, 16), (63, 64, 65, 127, 129, 257),
                      (True, False)))]


@pytest.mark.parametrize("D,G,S,causal", BWD_VIEW_CASES,
                         ids=lambda x: str(x))
def test_bf16_backward_reads_fused_qkv_views(cuda, D, G, S, causal):
    """q, k and v as strided views of one fused QKV projection (row stride
    (H + 2 Hkv) D), dq, delta, dk and dv pre-filled with NaN: every row
    written, and within check_bwd_against_plain's bf16 bound."""
    B, Hkv = 2, 2 if G < 16 else 1
    H = G * Hkv
    rng = np.random.default_rng(1000 + D + G + S)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * Hkv, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.split([H, Hkv, Hkv], dim=2)
    o, lse = flash.flash_attention_lse(q, k, v, causal)
    do = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    nan = float("nan")
    dq = torch.full_like(q, nan)
    delta = torch.full((B, H, S), nan, device=cuda)
    dk, dv = torch.full_like(k, nan), torch.full_like(v, nan)
    flash.flash_bwd_dq(q, k, v, o, lse, do, causal, out=(dq, delta))
    flash.flash_bwd_dkv(q, k, v, do, lse, delta, causal, out=(dk, dv))
    torch.cuda.synchronize()
    want_delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    torch.testing.assert_close(delta, want_delta, rtol=1e-5, atol=1e-4)
    flash.check_bwd_against_plain((dq, dk, dv), q, k, v, o, lse, do, causal)
