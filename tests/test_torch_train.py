"""The port's training path against the reference on the CPU: ``lm_loss``
and its gradients (remat full, none and dots), AdamW, ``make_train_step``
(microbatches 1 and 2, f32 and bf16 with master weights), the data
pipeline, checkpoints, the fault-tolerant loop and the launcher, on the
same numpy inputs and the reference's own ``init_params`` carried
across."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jconfigs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.convert import (opt_state_from_reference,
                                 params_from_reference)
from repro_torch.data import DataConfig, SyntheticLMDataset, prefetch
from repro_torch.kernels import flash_attention as flash
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params, lm_loss
from repro_torch.optim import AdamWConfig, AdamWState, adamw_init
from repro_torch.optim import adamw
from repro_torch.optim.adamw import leaves
from repro_torch.train import (TrainLoopConfig, fault_tolerant_train,
                               make_train_step)
from repro_torch.train.steps import _loss_and_grads

from _torch_conformance import assert_close  # noqa: F401  (sets threads)

ARCH = "qwen3-1.7b"
B, S = 4, 64
#: f32 on both sides, summed in other orders: the loss (about 27 at the
#: smoke config's random weights) to 1e-5 of itself, each gradient element
#: to 1e-4 of its leaf's largest
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{path: numpy array} of a nested dict of tensors or arrays (None
    leaves skipped)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = (v.detach().float().numpy()
                                   if isinstance(v, torch.Tensor)
                                   else np.asarray(v, np.float32))
    return out


def _assert_trees_close(got, want, rel):
    """Every leaf within ``rel`` of the largest element of the want leaf."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for key in w:
        scale = max(float(np.abs(w[key]).max()), 1e-30)
        np.testing.assert_allclose(g[key], w[key], rtol=0, atol=rel * scale,
                                   err_msg=key)


def _batch(cfg, seed=0, batch=B, seq=S):
    return JDataset(JDataConfig(vocab=cfg.vocab, seq_len=seq,
                                global_batch=batch, seed=seed)).batch_at(0)


def _tbatch(host):
    return launch_train.device_batch(host, "cpu")


@functools.lru_cache(maxsize=None)
def _reference(dtype="float32", seed=0):
    """The reference's smoke config (``"pallas"`` attention) and its
    ``init_params``, and the port's config and the same parameters."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               attn_impl="pallas", dtype=dtype)
    cfg = dataclasses.replace(configs.smoke_config(ARCH), dtype=dtype)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jparams


@functools.lru_cache(maxsize=None)
def _jit_loss(jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, b: jtf.lm_loss(p, jcfg, b)))


# --- loss and gradients ------------------------------------------------------

@pytest.mark.parametrize("remat", ["full", "none", "dots"])
@pytest.mark.parametrize("impl", [("pallas", "flash"), ("xla", "xla")],
                         ids=["flash", "xla"])
def test_lm_loss_and_grads_match_reference(impl, remat):
    jcfg, cfg, jparams = _reference()
    jcfg = dataclasses.replace(jcfg, attn_impl=impl[0], remat_policy=remat)
    cfg = dataclasses.replace(cfg, attn_impl=impl[1], remat_policy=remat)
    host = _batch(cfg)
    want_loss, want_grads = _jit_loss(jcfg)(
        jparams, {k: jnp.asarray(v) for k, v in host.items()})
    params = params_from_reference(cfg, _np(jparams))
    loss, grads = _loss_and_grads(params, cfg, _tbatch(host))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    _assert_trees_close(grads, _np(want_grads), GRAD_TOL)
    assert not any(p.requires_grad for p in leaves(params))


def test_lm_loss_value_matches_forward_without_autograd():
    _, cfg, jparams = _reference()
    params = params_from_reference(cfg, _np(jparams))
    batch = _tbatch(_batch(cfg, seed=1))
    with torch.no_grad():
        a = lm_loss(params, cfg, batch)
    b, _ = _loss_and_grads(params, cfg, batch)
    assert float(a) == float(b)


class _Products(TorchDispatchMode):
    """Counts the matrix products (``aten.mm``, ``aten.bmm``) dispatched
    while it is entered, by (op, operand shapes), and among them those with
    an operand that shares a parameter's storage (weight products)."""

    def __init__(self, params):
        super().__init__()
        self.weights = {t.untyped_storage().data_ptr()
                        for t in leaves(params)}
        self.all, self.weight = {}, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            key = (str(func), tuple(args[0].shape), tuple(args[1].shape))
            self.all[key] = self.all.get(key, 0) + 1
            if any(a.untyped_storage().data_ptr() in self.weights
                   for a in args[:2]):
                self.weight[key] = self.weight.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_remat_dots_equals_full_and_none_and_recomputes_no_weight_product(
        impl):
    """Remat never changes a value: ``"dots"``, ``"full"`` and ``"none"``
    give the same loss and gradients bit for bit on the CPU.  In the
    backward, ``"dots"`` dispatches the same weight products as ``"none"``
    (the gradients' own: no forward weight product recomputed) and
    ``"full"`` more (its recomputed forward); ``"dots"`` recomputes only
    batched products (attention's scores and values here)."""
    _, cfg, jparams = _reference()
    params = params_from_reference(cfg, _np(jparams))
    batch = _tbatch(_batch(cfg, seed=4))
    runs = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, attn_impl=impl, remat_policy=remat)
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            loss = lm_loss(params, c, batch)
            with _Products(params) as seen:
                grads = torch.autograd.grad(loss, flat)
        finally:
            for p in flat:
                p.requires_grad_(False)
        runs[remat] = (loss.detach(), grads, seen)
    loss, grads, none = runs["none"]
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], loss), remat
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][1], grads))
    full, dots = runs["full"][2], runs["dots"][2]
    assert dots.weight == none.weight
    recomputed = sum(full.weight.values()) - sum(none.weight.values())
    # q, k, v, o and w_in in each of the 2 layers; not w_out, the body's
    # last product: the recompute stops once it has every tensor the
    # backward saved, and a product's backward needs only its inputs
    assert recomputed == 5 * cfg.n_layers
    extra = {k: n - none.all.get(k, 0) for k, n in dots.all.items()
             if n != none.all.get(k, 0)}
    assert extra and all(k[0] == "aten.bmm.default" and k[1][0] > 1
                         for k in extra)


def test_layer_loop_gives_one_gradient_node_per_stack():
    """The stacked leaves are unbound once per forward: a stack's gradient
    comes from one node that stacks the layers' slices, not from one
    zero-padded stack per layer."""
    _, cfg, jparams = _reference()
    params = params_from_reference(cfg, _np(jparams))
    wq = params["blocks"]["attn"]["wq"].requires_grad_(True)
    loss = lm_loss(params, cfg, _tbatch(_batch(cfg)))
    feeders, seen, todo = [], set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        for nxt, _ in fn.next_functions:
            if getattr(nxt, "variable", None) is wq:
                feeders.append(type(fn).__name__)
            todo.append(nxt)
    wq.requires_grad_(False)
    assert feeders == ["UnbindBackward0"]


# --- AdamW -------------------------------------------------------------------

@pytest.mark.parametrize("piece", [adamw._PIECE, 4], ids=["whole", "rows"])
@pytest.mark.parametrize("clip", [1e-3, 1e3], ids=["clipped", "unclipped"])
def test_adamw_matches_reference_over_warmup_and_cosine(clip, piece,
                                                        monkeypatch):
    """Eight steps through 3 warmup steps and the cosine decay, an f32 and
    a bf16 leaf (its master copy in the state), clipping active or not;
    the update taken whole or a few rows at a time (as full-width leaves
    are)."""
    monkeypatch.setattr(adamw, "_PIECE", piece)
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "b": {"x": (7,)}}
    p32 = rng.standard_normal((6, 5)).astype(np.float32)
    p16 = rng.standard_normal(7).astype(np.float32)
    ocfg = dict(lr=1e-2, warmup_steps=3, total_steps=8, clip_norm=clip)
    jp = {"w": jnp.asarray(p32), "b": {"x": jnp.asarray(p16, jnp.bfloat16)}}
    tp = {"w": torch.from_numpy(p32.copy()),
          "b": {"x": torch.from_numpy(p16).to(torch.bfloat16)}}
    jstate = jadamw.adamw_init(jp)
    state = adamw_init(tp)
    assert state.master["w"] is None and state.master["b"]["x"] is not None
    for step in range(8):
        g32 = rng.standard_normal(shapes["w"]).astype(np.float32)
        g16 = rng.standard_normal(shapes["b"]["x"]).astype(np.float32)
        jg = {"w": jnp.asarray(g32),
              "b": {"x": jnp.asarray(g16, jnp.bfloat16)}}
        tg = {"w": torch.from_numpy(g32),
              "b": {"x": torch.from_numpy(g16).to(torch.bfloat16)}}
        jp, jstate, jm = jadamw.adamw_update(jadamw.AdamWConfig(**ocfg), jp,
                                             jg, jstate)
        tp2, state2, m = adamw.adamw_update(AdamWConfig(**ocfg), tp, tg,
                                            state)
        assert tp2 is tp and state2 is state          # updated in place
        assert int(state.step) == int(jstate.step) == step + 1
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6, err_msg=key)
        # f32 arithmetic in the same order: equal up to an ulp or two
        _assert_trees_close(tp, _np(jp), 1e-6)
        _assert_trees_close(state.m, _np(jstate.m), 1e-6)
        _assert_trees_close(state.v, _np(jstate.v), 1e-6)
        _assert_trees_close(state.master, _np(jstate.master), 1e-6)
    assert tp["b"]["x"].dtype == torch.bfloat16


def test_cosine_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = jadamw.cosine_schedule(jadamw.AdamWConfig(**cfg),
                                      jnp.asarray(step, jnp.int32))
        got = adamw.cosine_schedule(AdamWConfig(**cfg),
                                    torch.tensor(step, dtype=torch.int32))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# --- the train step ----------------------------------------------------------

#: (dtype, microbatches, loss rtol, state bound).  f32: the updated state
#: within GRAD_TOL of each leaf's largest element (measured 7e-6).  bf16:
#: the two frameworks round activations and gradients to bf16 at other
#: places (one bf16 ulp is 2**-7, 0.8%), so after 3 steps params, m, v and
#: master differ by up to about 1% of a leaf's largest (measured 1.07%, v
#: of wk) and the loss by 4e-4 of itself; bounds 2e-2 and 2e-3
STEP_CASES = [("float32", 1, LOSS_RTOL, GRAD_TOL),
              ("float32", 2, LOSS_RTOL, GRAD_TOL),
              ("bfloat16", 1, 2e-3, 2e-2)]


@pytest.mark.parametrize("dtype,microbatches,loss_tol,tol", STEP_CASES,
                         ids=["f32", "f32-mb2", "bf16"])
def test_train_step_matches_reference(dtype, microbatches, loss_tol, tol):
    """Three steps of ``make_train_step`` from the same state: params,
    m, v and (bf16) master against the reference's jitted step."""
    jcfg, cfg, jparams = _reference(dtype)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=5)
    jstep = jax.jit(jmake_train_step(jcfg, jadamw.AdamWConfig(**ocfg),
                                     microbatches))
    step = make_train_step(cfg, AdamWConfig(**ocfg), microbatches)
    jstate = jadamw.adamw_init(jparams)
    params = params_from_reference(cfg, _np(jparams))
    state = opt_state_from_reference(cfg, _np(jstate))
    if dtype == "bfloat16":
        assert state.master["blocks"]["attn"]["wq"].dtype == torch.float32
    else:
        assert state.master["blocks"]["attn"]["wq"] is None
    data = JDataset(JDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                seed=2))
    for s in range(3):
        host = data.batch_at(s)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jnp.asarray(v)
                                     for k, v in host.items()})
        params, state, m = step(params, state, _tbatch(host))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=loss_tol)
    _assert_trees_close(params, _np(jparams), tol)
    _assert_trees_close(state.m, _np(jstate.m), tol)
    _assert_trees_close(state.v, _np(jstate.v), tol)
    if dtype == "bfloat16":
        _assert_trees_close(state.master, _np(jstate.master), tol)
    assert int(state.step) == 3


def test_microbatches_must_divide_the_batch():
    _, cfg, jparams = _reference()
    step = make_train_step(cfg, AdamWConfig(), microbatches=3)
    params = params_from_reference(cfg, _np(jparams))
    with pytest.raises(ValueError, match="microbatches"):
        step(params, adamw_init(params), _tbatch(_batch(cfg)))


# --- data --------------------------------------------------------------------

def test_synthetic_batches_are_bit_identical_to_reference():
    args = dict(vocab=300, seq_len=33, global_batch=6, seed=5)
    for host_id, num_hosts in ((0, 1), (1, 2)):
        ours = SyntheticLMDataset(DataConfig(**args), host_id, num_hosts)
        theirs = JDataset(JDataConfig(**args), host_id, num_hosts)
        for step in (0, 3, 17):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    got = list(prefetch(iter([{"i": i} for i in range(5)]), depth=2))
    assert [g["i"] for g in got] == list(range(5))


# --- checkpoints -------------------------------------------------------------

def _state_tree(dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=g).to(dtype),
              "b": {"x": torch.randn(5, generator=g)}}
    return {"params": params, "opt": adamw_init(params),
            "step": np.asarray(7, np.int32)}


def test_checkpoint_round_trip_is_bit_exact(tmp_path):
    tree = _state_tree()
    d = str(tmp_path / "ck")
    save_pytree(tree, d, 3)
    names = sorted(os.listdir(os.path.join(d, "step_00000003")))
    assert names == ["MANIFEST.json", "shard_00000.npz"]
    template = _state_tree()
    for t in leaves(template["params"]):
        t.zero_()
    got = restore_pytree(template, d, 3)
    assert isinstance(got["opt"], AdamWState)
    assert got["opt"].master["b"]["x"] is None
    w = got["params"]["w"]
    assert w.dtype == torch.bfloat16
    assert torch.equal(w.view(torch.int16),
                       tree["params"]["w"].view(torch.int16))
    assert torch.equal(got["opt"].master["w"], tree["opt"].master["w"])
    assert got["opt"].step.dtype == torch.int32
    assert int(got["step"]) == 7


def test_checkpoint_manager_retention_integrity_and_tmp(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=2)
    for s in (1, 5, 9):
        mgr.save_async(_state_tree(), s)
    mgr.wait()
    assert latest_step(d) == 9
    assert sorted(os.listdir(d)) == ["step_00000005", "step_00000009"]
    os.makedirs(os.path.join(d, "step_00000011.tmp"))
    assert latest_step(d) == 9                  # a crashed save is ignored
    shard = os.path.join(d, "step_00000009", "shard_00000.npz")
    data = dict(np.load(shard))
    data["params/b/x"] = data["params/b/x"] + 1.0
    np.savez(shard, **data)
    with pytest.raises(IOError, match="integrity"):
        restore_pytree(_state_tree(), d, 9)
    with pytest.warns(RuntimeWarning, match="unusable"):
        _, step = mgr.restore_latest(_state_tree())
    assert step == 5


# --- the loop and the launcher -----------------------------------------------

def _smoke_run(tmp_path, name, total, failure_hook=None, ocfg_total=8):
    """``fault_tolerant_train`` of the bf16 smoke config from seed-0
    parameters, checkpoints every 2 steps into ``tmp_path / name``."""
    cfg = dataclasses.replace(configs.smoke_config(ARCH), dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=2,
                                            total_steps=ocfg_total))
    data = SyntheticLMDataset(DataConfig(vocab=cfg.vocab, seq_len=32,
                                         global_batch=2, seed=1))
    loop = TrainLoopConfig(total_steps=total, checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / name),
                           straggler_factor=1e9)
    return fault_tolerant_train(
        loop, step, (params, adamw_init(params)), iter(()),
        lambda s: _tbatch(data.batch_at(s)), failure_hook=failure_hook,
        log=lambda *_: None)[2]


def test_loop_retry_and_restart_repeat_the_uninterrupted_losses(tmp_path):
    """8 steps uninterrupted, against 6 steps with a failure injected at
    step 3 (restored from the step-2 checkpoint) and a restart to 8 that
    resumes from the step-5 checkpoint: the same losses, bit for bit."""
    want = _smoke_run(tmp_path, "a", 8)["losses"]
    boom = {3}

    def failure_hook(s):
        if s in boom:
            boom.remove(s)
            raise RuntimeError("simulated device loss")
    first = _smoke_run(tmp_path, "b", 6, failure_hook)
    assert first["retries"] == 1
    assert latest_step(str(tmp_path / "b")) == 5
    second = _smoke_run(tmp_path, "b", 8)
    assert len(want) == 8 and want[-1] < want[0]
    assert first["losses"] + second["losses"] == want


def test_train_launcher_on_cpu(tmp_path, capsys):
    events = launch_train.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
        "--batch", "4", "--seq", "64", "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "loss " in out and "over 4 steps" in out and "retries=0" in out
    assert len(events["losses"]) == 4
    assert all(np.isfinite(events["losses"]))
    assert latest_step(str(tmp_path / "ck")) == 3
    assert flash.DQ_LAUNCHES == flash.DKV_LAUNCHES == 0 or \
        torch.cuda.is_available()


def test_train_launcher_refusals():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", ARCH, "--smoke", "--steps", "1"])
