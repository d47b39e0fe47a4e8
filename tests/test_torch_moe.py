"""The port's MoE family (qwen3-moe-30b-a3b's smoke config: 2 layers of
4 experts, top-2, head dim 16; qwen3-moe-235b-a22b's has the same fields)
against the reference on the CPU: the router (ids, weights, aux loss), the
plain every-expert route and the grouped route against the reference's
one-device ``apply_moe`` in f32 and bf16, the grouped route against the
plain one when an expert gets no token (outputs and gradients), the
parameter tree (an f32 ``router`` in a bf16 tree), ``forward`` with its
summed aux loss, ``lm_loss`` with every gradient leaf, prefill and
teacher-forced decode, greedy ``generate``, three AdamW steps with two
microbatches in f32 and bf16, both launchers with a resume; and
``init_params``, which now draws each layer into leaves allocated once,
against the per-layer draws stacked afterwards, bit for bit."""
import dataclasses
import hashlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.kernels import flash_attention as flash
from repro_torch.models import moe, transformer

import _torch_family as fam

ARCH = "qwen3-moe-30b-a3b"
BIG = "qwen3-moe-235b-a22b"
#: one MoE layer alone, f32 against f32: to 1e-5 of the output's largest
#: magnitude; the router's weights and aux loss to 1e-6
LAYER_TOL, ROUTE_TOL = 1e-5, 1e-6
#: bf16: the experts' products round to bf16 on both sides, in other
#: orders (``_torch_family.BF16_TOL`` of the output's largest)
BF16_TOL = fam.BF16_TOL


def _layer(seed, T=48, D=16, E=6, ff=8, dtype=np.float32, positive=False):
    """x (2, T/2, D) and a layer's parameters (router f32; w_in, w_out
    rounded to ``dtype``) as numpy f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    if positive:
        x = np.abs(x)
    p = {"router": (rng.standard_normal((D, E)) / np.sqrt(D)).astype(
            np.float32),
         "w_in": (rng.standard_normal((E, D, 2 * ff)) / np.sqrt(D)).astype(
            np.float32),
         "w_out": (rng.standard_normal((E, ff, D)) / np.sqrt(ff)).astype(
            np.float32)}
    if dtype != np.float32:
        x = np.asarray(jnp.asarray(x, dtype), np.float32)
        for k in ("w_in", "w_out"):
            p[k] = np.asarray(jnp.asarray(p[k], dtype), np.float32)
    return x, p


def _cfg(E=6, k=2, ff=8, dtype="float32"):
    return dataclasses.replace(configs.smoke_config(ARCH), n_experts=E,
                               top_k=k, d_ff=ff, d_model=16, dtype=dtype)


def _torch_layer(x, p, dtype):
    t = getattr(torch, dtype)
    return (torch.from_numpy(x).to(t),
            {"router": torch.from_numpy(p["router"]),
             "w_in": torch.from_numpy(p["w_in"]).to(t),
             "w_out": torch.from_numpy(p["w_out"]).to(t)})


def _jax_layer(x, p, dtype):
    t = getattr(jnp, dtype)
    return (jnp.asarray(x, t), {"router": jnp.asarray(p["router"]),
                                "w_in": jnp.asarray(p["w_in"], t),
                                "w_out": jnp.asarray(p["w_out"], t)})


# --- the layer ---------------------------------------------------------------

@pytest.mark.parametrize("E,k", [(4, 2), (6, 3), (16, 8)])
def test_route_matches_reference(E, k):
    x, p = _layer(E, T=64, E=E)
    x2 = torch.from_numpy(x.reshape(64, -1))
    w, ids, aux = moe.route(x2, torch.from_numpy(p["router"]), k)
    jw, jids, jaux = jax.jit(jmoe._route, static_argnums=2)(
        jnp.asarray(x.reshape(64, -1)), jnp.asarray(p["router"]), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    fam.close(w, jw, ROUTE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=ROUTE_TOL)
    assert w.dtype == aux.dtype == torch.float32
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path", ["grouped", "dense"])
def test_paths_match_reference_apply_moe(path, dtype):
    """The reference's ``apply_moe`` with no mesh is its every-expert
    ``_dense_path``; both of the port's routes compute that function."""
    cfg = _cfg(dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH), n_experts=6,
                               top_k=2, d_ff=8, d_model=16, dtype=dtype)
    x, p = _layer(1, dtype=getattr(jnp, dtype))
    tx, tp = _torch_layer(x, p, dtype)
    out, aux = getattr(moe, f"{path}_path")(tx, tp, cfg)
    jout, jaux = jax.jit(lambda a, q: jmoe.apply_moe(a, q, jcfg))(
        *_jax_layer(x, p, dtype))
    assert out.dtype == tx.dtype and out.shape == tx.shape
    want = np.asarray(jout, np.float32)
    tol = LAYER_TOL if dtype == "float32" else BF16_TOL
    fam.close(out.float(), want, tol * np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(jaux), rtol=ROUTE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_equals_dense_when_an_expert_gets_no_token(dtype):
    """Expert 5's router column is -1 on positive inputs, a logit far below
    the others', so no token picks it: the grouped route runs 5 experts and
    gives the plain route's output and aux loss (f32: to 1e-6 of the
    largest, its gradients to 1e-5; bf16: one bf16 rounding), every token
    counted k times (none dropped)."""
    cfg = _cfg(dtype=dtype)
    x, p = _layer(2, positive=True, dtype=getattr(jnp, dtype))
    p["router"][:, 5] = -1.0
    tx, tp = _torch_layer(x, p, dtype)
    w, ids, _ = moe.route(tx.reshape(-1, 16), tp["router"], cfg.top_k)
    order, rows, counts = moe.dispatch(tx.reshape(-1, 16), ids,
                                       cfg.n_experts)
    assert counts[5] == 0 and min(counts[:5]) > 0
    assert sum(counts) == tx.shape[0] * tx.shape[1] * cfg.top_k
    assert torch.equal(ids.reshape(-1)[order],
                       torch.sort(ids.reshape(-1)).values)
    runs = {}
    for path in ("grouped", "dense"):
        leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        xi = tx.clone().requires_grad_(True)
        out, aux = getattr(moe, f"{path}_path")(xi, leaves, cfg)
        (out.float().square().sum() + aux).backward()
        runs[path] = (out.detach().float(), aux.detach(),
                      {"x": xi.grad.float(),
                       **{k: v.grad.float() for k, v in leaves.items()}})
    (out, aux, grads), (dout, daux, dgrads) = runs["grouped"], runs["dense"]
    scale = float(dout.abs().max())
    if dtype == "float32":
        fam.close(out, dout, 1e-6 * scale)
        for key in dgrads:
            fam.close(grads[key], dgrads[key],
                      1e-5 * float(dgrads[key].abs().max()))
    else:
        fam.close(out, dout, 2 ** -8 * scale)
    np.testing.assert_allclose(float(aux), float(daux), rtol=ROUTE_TOL)
    assert float(grads["w_in"][5].abs().max()) == 0.0


def test_init_moe_draws_an_f32_router():
    p = moe.init_moe(16, 6, 8, "swiglu", torch.bfloat16,
                     torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((16, 6), torch.float32),
        "w_in": ((6, 16, 16), torch.bfloat16),
        "w_out": ((6, 8, 16), torch.bfloat16)}
    jp = jmoe.init_moe(jax.random.PRNGKey(0), 16, 6, 8, "swiglu",
                       jnp.bfloat16)
    assert {k: (v.shape, v.dtype) for k, v in jp.items()} == {
        "router": ((16, 6), jnp.float32),
        "w_in": ((6, 16, 16), jnp.bfloat16),
        "w_out": ((6, 8, 16), jnp.bfloat16)}


# --- the family --------------------------------------------------------------

@pytest.mark.parametrize("arch,n_params", [(ARCH, 30_531_911_680),
                                           (BIG, 235_092_836_352)])
def test_config_and_parameter_tree_match_reference(arch, n_params):
    """``blocks`` of ``ln1``, ``attn`` (qk-norm), ``ln2`` and ``moe``
    stacked ``(n_layers, ...)``; the config itself is held field for field
    by tests/test_torch_lm.py::test_config_matches_reference."""
    assert arch in configs.ARCH_IDS and arch not in configs.PENDING
    full = configs.get_config(arch)
    assert full.family == "moe" and full.n_params == n_params
    assert full.causal_attentions == full.n_layers
    jcfg, cfg, jparams, _ = fam.model(arch)
    keys = fam.check_tree(jcfg, cfg)
    assert {"blocks/moe/router", "blocks/moe/w_in", "blocks/moe/w_out",
            "blocks/attn/q_norm", "embed/head"} <= keys
    assert not any(k.startswith("blocks/mlp") for k in keys)
    ours = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    assert ours["blocks"]["moe"]["w_in"].shape == (
        cfg.n_layers, cfg.n_experts, cfg.d_model, 2 * cfg.d_ff)
    bad = fam.np_tree(jparams)
    del bad["blocks"]["moe"]["router"]
    with pytest.raises(ValueError, match="router"):
        fam.params_from_reference(cfg, bad)


@pytest.mark.parametrize("arch", [ARCH, BIG])
def test_forward_matches_reference(arch):
    fam.check_forward(arch)


def test_lm_loss_with_aux_and_grads_match_reference():
    """The loss carries ``1e-2 ×`` the summed aux loss; every gradient
    leaf, the router's (through the weights and the aux loss) too."""
    grads = fam.check_loss_and_grads(ARCH)
    for leaf in ("blocks/moe/router", "blocks/moe/w_in", "blocks/moe/w_out",
                 "blocks/attn/wq"):
        assert float(np.abs(grads[leaf]).max()) > 0, leaf


def test_prefill_and_teacher_forced_decode_match_reference():
    """``k``, ``v`` and ``length``; the attention through the flash
    kernel's plain version, the reference's through its Pallas kernel in
    interpret mode: no launch on the CPU."""
    before = flash.LAUNCHES
    fam.check_prefill_and_decode(ARCH)
    assert flash.LAUNCHES == before


def test_generate_picks_reference_greedy_tokens():
    fam.check_generate(ARCH, seed=4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_with_two_microbatches_match_reference(dtype):
    """In bf16 the f32 router has no master copy and is updated in f32."""
    fam.check_train_steps(ARCH, dtype)


def test_serve_main_on_cpu(capsys):
    fam.check_serve_main(ARCH, capsys)


def test_train_main_on_cpu_resumes(tmp_path, capsys):
    fam.check_train_main_and_resume(ARCH, tmp_path, capsys)


# --- init_params: one stacked copy -------------------------------------------

def _per_layer_stack(draw, lead):
    """The earlier ``init_params``: every layer drawn, then stacked."""
    if not lead:
        return draw()
    layers = [_per_layer_stack(draw, lead[1:]) for _ in range(lead[0])]

    def stack(parts):
        if isinstance(parts[0], dict):
            return {k: stack([p[k] for p in parts]) for k in parts[0]}
        return torch.stack(parts)
    return stack(layers)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-7b",
                                  "seamless-m4t-large-v2", ARCH])
def test_init_params_equals_per_layer_stack(arch, monkeypatch):
    cfg = configs.smoke_config(arch)
    got = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    monkeypatch.setattr(transformer, "_stacked", _per_layer_stack)
    want = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    g, w = dict(fam.flat_with_none(got)), dict(fam.flat_with_none(want))
    assert g.keys() == w.keys()
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        assert torch.equal(g[key], w[key]), key


#: the SSM and hybrid smoke configs' seed-0 weights from the per-layer
#: stacking ``init_params`` (sha256 over each leaf's path and bytes, in key
#: order; tests/test_torch_ssm.py pins the dense and encoder-decoder ones)
SEED_DIGESTS = {
    "mamba2-1.3b":
        "5efbe9b0a0da60e228e38ebf5f025261585a53110ce0247ffb6a5e13096736b8",
    "zamba2-7b":
        "525ce503ea8303cc1eea73db9cf394f801ee0a555fa3b00b7f709bacad017f40",
}


@pytest.mark.parametrize("arch", sorted(SEED_DIGESTS))
def test_seed_draws_of_ssm_families_are_unchanged(arch):
    params = transformer.init_params(configs.smoke_config(arch),
                                     torch.Generator().manual_seed(0), "cpu")
    h = hashlib.sha256()
    for key, leaf in fam.flat_with_none(params):
        h.update(key.encode())
        h.update(leaf.contiguous().numpy().tobytes())
    assert h.hexdigest() == SEED_DIGESTS[arch]


def test_init_params_holds_one_layer_beside_the_stack(monkeypatch):
    """While ``init_params`` draws qwen3-moe-30b-a3b's smoke config (16
    layers here), the bytes alive of the draws (``normal``'s outputs) and
    of the stacked leaves (``_stacked``'s allocations) stay within the
    stacks and one layer's draw beside them, or the embedding's draw
    beside them; stacking drawn layers afterwards holds all 16 layers'
    draws beside the stacks."""
    import weakref

    from repro_torch.models import attention, layers
    cfg = dataclasses.replace(configs.smoke_config(ARCH), n_layers=16)
    alive, peak = [], [0]

    def note(t):
        if not any(r() is t for r in alive):   # _tree_map recurses
            alive.append(weakref.ref(t))
        peak[0] = max(peak[0], sum(r().numel() * r().element_size()
                                   for r in alive if r() is not None))
        return t
    real_normal, real_map = layers.normal, transformer._tree_map

    def normal(*args, **kw):
        return note(real_normal(*args, **kw))

    def tree_map(fn, tree):
        return real_map(lambda t: note(fn(t)), tree)
    for module in (layers, attention, moe):
        monkeypatch.setattr(module, "normal", normal)
    monkeypatch.setattr(transformer, "_tree_map", tree_map)

    def peak_of(stacked):
        alive.clear()
        peak[0] = 0
        monkeypatch.setattr(transformer, "_stacked", stacked)
        return transformer.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), peak[0]
    params, peak_now = peak_of(transformer._stacked)

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for _, t in fam.flat_with_none(tree))
    stack, embed = nbytes(params["blocks"]), nbytes(params["embed"])
    assert peak_now <= stack + max(stack // cfg.n_layers, embed)

    def stacked_after(draw, lead):
        drawn = [draw() for _ in range(math.prod(lead))]
        out = _per_layer_stack(iter(drawn).__next__, lead)
        for _, t in fam.flat_with_none(out):
            note(t)
        return out
    _, peak_before = peak_of(stacked_after)
    assert peak_before >= 1.9 * stack
