"""The Hopper flash-attention kernels (forward, and the backward's dQ and
dK/dV) against their plain versions, on the card.  Needs an sm_90 device and ``nvcc``; skipped otherwise.  Run on a
card with
``PYTHONPATH=src python -m pytest tests/test_torch_flash_cuda.py -m gpu``.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as flash

pytestmark = pytest.mark.gpu

#: B, Sq, Skv, H, Hkv, D, causal: GQA ratios 1, 2 and 4, ragged lengths
#: (not multiples of the kernel's 64-row tiles), non-square, full attention
CASES = [
    (2, 200, 200, 4, 4, 128, True),
    (1, 256, 256, 8, 4, 128, True),
    (2, 130, 130, 8, 2, 128, True),
    (1, 64, 192, 4, 2, 128, True),
    (1, 192, 64, 4, 2, 128, True),
    (2, 200, 200, 4, 1, 128, False),
    (1, 1, 1, 2, 1, 128, True),
    (1, 1024, 1024, 16, 8, 128, True),
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


def test_kernel_reads_strided_views(cuda):
    """q, k, v as views of one fused projection, in the (B, S, H, D) layout
    without a copy."""
    B, S, H, Hkv, D = 2, 128, 8, 2, 128
    rng = np.random.default_rng(1)
    qkv = torch.from_numpy(rng.standard_normal(
        (B, S, H + 2 * Hkv, D)).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.split([H, Hkv, Hkv], dim=2)
    flash.check_against_plain(flash.flash_attention(q, k, v, True), q, k, v)


def test_kernel_refuses_f32_and_other_head_dims(cuda):
    q, k, v = (t.float() for t in _qkv(CASES[0], cuda))
    with pytest.raises(ValueError, match="B2-f32"):
        flash.flash_attention(q, k, v, True)
    q, k, v = (t[..., :64] for t in _qkv(CASES[0], cuda))
    with pytest.raises(ValueError, match="head dim 128"):
        flash.flash_attention(q, k, v, True)


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
