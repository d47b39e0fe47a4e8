"""The Hopper flash-attention forward kernel against its plain version, on
the card.  Needs an sm_90 device and ``nvcc``; skipped otherwise.  Run on a
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
