"""The port's hybrid family (zamba2-7b's smoke config: 7 layers in groups of
3, so 2 groups of the shared attention block and 2 SSM layers, then a
1-layer SSM tail) against the reference on the CPU: the parameter tree
(``shared``, ``groups`` stacked ``(n_groups, hybrid_group - 1, ...)``,
``tail``, with and without a tail; f32 SSM leaves in a bf16 tree),
``forward`` and ``lm_loss`` with every gradient leaf (``shared``'s summed
over its applications), prefill's logits and its seven cache keys,
teacher-forced decode, greedy ``generate``, three AdamW steps with two
microbatches in f32 and in bf16, both launchers with a resume, and the
refusal of a prompt that is not whole chunks.  The reference runs
``attn_impl="pallas"`` (its flash kernel in interpret mode) for the shared
attention; the port's ``"flash"`` runs the kernel's plain version on the
CPU."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as flash
from repro_torch.models import transformer

import _torch_family as fam

ARCH = "zamba2-7b"


@pytest.mark.parametrize("n_layers,tail", [(7, 1), (6, 0)],
                         ids=["with-tail", "no-tail"])
def test_config_and_parameter_tree_match_reference(n_layers, tail):
    """The bf16 tree's f32 SSM leaves are checked on the smoke config's
    layout; the config itself is held field for field by
    tests/test_torch_lm.py::test_config_matches_reference."""
    assert ARCH in configs.ARCH_IDS and ARCH not in configs.PENDING
    full = configs.get_config(ARCH)
    assert full.n_params == 5_955_275_072
    assert full.hybrid_layout == (13, 3) and full.causal_attentions == 13
    jcfg, cfg, jparams, _ = fam.model(ARCH)
    jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
    cfg = dataclasses.replace(cfg, n_layers=n_layers)
    assert cfg.hybrid_layout == (2, tail) and cfg.causal_attentions == 2
    keys = fam.check_tree(jcfg, cfg, bf16=bool(tail))
    assert {"shared/attn/wq", "shared/mlp/w_in", "groups/ssm/A_log",
            "groups/ln", "embed/head"} <= keys
    assert not any(k.startswith("blocks/") for k in keys)
    assert any(k.startswith("tail/") for k in keys) == bool(tail)
    ours = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    assert ours["groups"]["ssm"]["w_x"].shape[:2] == (2, 2)
    assert ours["shared"]["attn"]["wq"].shape == (cfg.d_model,
                                                  cfg.n_heads * cfg.d_head)
    if tail:
        assert ours["tail"]["ln"].shape == (1, cfg.d_model)
        bad = fam.np_tree(jparams)
        del bad["tail"]
        with pytest.raises(ValueError, match="tail"):
            fam.params_from_reference(configs.smoke_config(ARCH), bad)


def test_forward_matches_reference():
    fam.check_forward(ARCH)


def test_lm_loss_and_grads_match_reference():
    """Every gradient leaf: ``shared/...`` is the sum over the block's two
    applications, as in the reference, where one leaf feeds both."""
    grads = fam.check_loss_and_grads(ARCH)
    for leaf in ("shared/attn/wq", "shared/mlp/w_out", "groups/ssm/A_log",
                 "tail/ssm/w_x"):
        assert float(np.abs(grads[leaf]).max()) > 0, leaf


def test_prefill_and_teacher_forced_decode_match_reference():
    """``attn_k``, ``attn_v`` (one KV cache a shared application),
    ``conv``, ``state``, ``tail_conv``, ``tail_state`` and ``length``;
    the shared attention's prefill through the flash kernel's plain
    version, the reference's through its Pallas kernel in interpret mode:
    no launch on the CPU."""
    before = flash.LAUNCHES
    fam.check_prefill_and_decode(ARCH)
    assert flash.LAUNCHES == before


def test_generate_picks_reference_greedy_tokens():
    fam.check_generate(ARCH, seed=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_with_two_microbatches_match_reference(dtype):
    fam.check_train_steps(ARCH, dtype)


def test_serve_main_on_cpu(capsys):
    fam.check_serve_main(ARCH, capsys)


def test_train_main_on_cpu_resumes(tmp_path, capsys):
    fam.check_train_main_and_resume(ARCH, tmp_path, capsys)


def test_prompt_of_partial_chunks_is_refused():
    fam.check_refuses_partial_chunks(ARCH)
