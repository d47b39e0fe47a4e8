"""The port's LM side on a mesh against the reference's on 4 devices.

Run in a subprocess (``tests/test_torch_sharding.py``) with 4 fake CPU
devices for the reference, so the main pytest process keeps its
one-device view; the port runs the same cases on CPU meshes of the same
shapes (``[cpu] * n``: logical shards).  The same numpy inputs and the
reference's own weights carried across (``convert``) go through both
packages.  ``python tests/torch_mesh_serve_check.py GROUP`` runs one
group:

  * ``routes``: ``ep_a2a_path`` and ``ep_bcast_path`` (through
    ``apply_moe`` under the rules) against the reference's on meshes
    (1, 1), (1, 4), (2, 2) and (4, 1), f32 and bf16, 8 experts top-2 and
    128 top-8; some cases drop (token, pick) pairs, and the tokens whose
    output moved off the no-mesh route are those the drops touch;
  * ``grads``: the all-to-all route's gradients (x, router, w_in, w_out,
    of ``sum(out**2) + aux``) against ``jax.grad`` of the reference's;
  * ``serve``: smoke-config prefill then three greedy decode steps
    through ``generate(..., mesh=(2, 2))`` against the reference's
    jitted prefill and decode under its rules on a (2, 2) mesh, for
    qwen3-1.7b, qwen3-moe-30b-a3b, mamba2-1.3b, zamba2-7b,
    seamless-m4t-large-v2 and internvl2-76b: logits within the family
    tests' bounds, greedy tokens equal;
  * ``launchers``: qwen3-moe-30b-a3b's launcher paths on the launchers'
    default (1, 1) mesh: ``generate`` and three train steps against the
    reference's prefill, decode and ``make_train_step`` jitted under its
    launchers' mesh and rules (tokens, logits, losses), and the same
    steps with no mesh against them (the fault this repairs: they differ).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.launch.serve import _shard_tree as jshard_tree  # noqa: E402
from repro.models import cache_axes as jcache_axes  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import param_axes as jparam_axes  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.sharding import default_rules as jdefault_rules  # noqa
from repro.parallel.sharding import use_sharding_rules as juse  # noqa: E402
from repro.train import make_decode_fn as jdecode_fn  # noqa: E402
from repro.train import make_prefill_fn as jprefill_fn  # noqa: E402
from repro.train import make_train_step as jtrain_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import device_batch, training_mesh  # noqa
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(1)

MOE = "qwen3-moe-30b-a3b"
MESHES = [(1, 1), (1, 4), (2, 2), (4, 1)]
#: one MoE layer: f32 to 1e-5 of the output's largest magnitude (the
#: one-device route's bound, tests/test_torch_moe.py), bf16 to 2e-2
#: (tests/_torch_family.py's BF16_TOL); the aux loss to 1e-6 of itself
LAYER_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_RTOL = 1e-6
#: the all-to-all route's gradients, f32: to 1e-5 of each leaf's largest
GRAD_TOL = 1e-5
#: the smoke configs' logits, f32: prefill 2e-4, decode 3e-4 (absolute;
#: tests/_torch_family.py's PREFILL_TOL, DECODE_TOL); the loss 1e-5 of
#: itself (its LOSS_RTOL)
PREFILL_TOL, DECODE_TOL, LOSS_RTOL = 2e-4, 3e-4, 1e-5
ARCHS = ["qwen3-1.7b", MOE, "mamba2-1.3b", "zamba2-7b",
         "seamless-m4t-large-v2", "internvl2-76b"]
CPU = torch.device("cpu")


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), [CPU] * int(np.prod(shape)))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def close(got, want, atol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = float(np.abs(got - want).max())
    assert err <= atol, f"{what}: max abs err {err:.3g} > {atol:.3g}"
    return err


# --- the routes --------------------------------------------------------------

def layer(seed, B, S, D, E, ff):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    p = {"router": (rng.standard_normal((D, E)) / np.sqrt(D)).astype(
            np.float32),
         "w_in": (rng.standard_normal((E, D, 2 * ff)) / np.sqrt(D)).astype(
            np.float32),
         "w_out": (rng.standard_normal((E, ff, D)) / np.sqrt(ff)).astype(
            np.float32)}
    return x, p


def moe_cfgs(E, k, D, ff, dtype):
    kw = dict(n_experts=E, top_k=k, d_ff=ff, d_model=D, dtype=dtype)
    return (dataclasses.replace(jconfigs.smoke_config(MOE), **kw),
            dataclasses.replace(configs.smoke_config(MOE), **kw))


def jax_layer(x, p, dtype):
    t = getattr(jnp, dtype)
    return jnp.asarray(x, t), {"router": jnp.asarray(p["router"]),
                               "w_in": jnp.asarray(p["w_in"], t),
                               "w_out": jnp.asarray(p["w_out"], t)}


def torch_layer(x, p, dtype):
    t = getattr(torch, dtype)
    return torch.from_numpy(x).to(t), {
        "router": torch.from_numpy(p["router"]),
        "w_in": torch.from_numpy(p["w_in"]).to(t),
        "w_out": torch.from_numpy(p["w_out"]).to(t)}


def check_routes():
    """Both routes on four meshes, two dtypes, two expert counts; the
    weights placed by ``moe_axes`` for half the cases (pieces), whole for
    the rest (slices)."""
    dropping = 0
    for shape in MESHES:
        jm = jmake_mesh(shape, ("data", "model"))
        m = cpu_mesh(shape)
        rules = sharding.default_rules()
        for dtype in ("float32", "bfloat16"):
            for E, k, D, ff in ((8, 2, 16, 8), (128, 8, 32, 8)):
                for S in (16, 1):
                    jcfg, cfg = moe_cfgs(E, k, D, ff, dtype)
                    x, p = layer(E + S + shape[0], 4, S, D, E, ff)
                    jx, jp = jax_layer(x, p, dtype)
                    with juse(jm, jdefault_rules()):
                        jout, jaux = jax.jit(
                            lambda a, q: jmoe.apply_moe(a, q, jcfg))(jx, jp)
                    tx, tp = torch_layer(x, p, dtype)
                    if S == 16:
                        tp = sharding.shard_tree(tp, moe.moe_axes(), m,
                                                 rules)
                    moe.DROP_LOG = []
                    with sharding.use_sharding_rules(m, rules):
                        out, aux = moe.apply_moe(tx, tp, cfg)
                    log, moe.DROP_LOG = moe.DROP_LOG, None
                    n_ep = shape[1]
                    a2a = S % n_ep == 0
                    assert len(log) == (1 if a2a else 0), (shape, S, log)
                    want = np.asarray(jout, np.float32)
                    label = f"{shape} {dtype} E{E} k{k} S{S}"
                    close(out.float(), want,
                          LAYER_TOL[dtype] * np.abs(want).max(), label)
                    np.testing.assert_allclose(float(aux), float(jaux),
                                               rtol=AUX_RTOL, err_msg=label)
                    dropped = sum(e["pairs"] - int(e["processed"])
                                  for e in log)
                    if dtype == "float32":
                        jone, _ = jax.jit(
                            lambda a, q: jmoe._dense_path(a, q, jcfg))(jx,
                                                                       jp)
                        moved = int((np.abs(np.asarray(jone) - want).max(-1)
                                     > 1e-5).sum())
                        assert (moved > 0) == (dropped > 0), (label, moved,
                                                              dropped)
                    dropping += dropped > 0
                    print(f"  {label}: {'a2a' if a2a else 'bcast'}, "
                          f"dropped {dropped} pairs", flush=True)
    assert dropping >= 4, dropping
    print(f"routes: {dropping} cases dropped pairs")


#: a seed a mesh whose layer (its input times 3: peakier routing) drops
#: pairs at a capacity
GRAD_SEEDS = {(1, 1): 40, (1, 4): 100, (2, 2): 40, (4, 1): 40}


def check_grads():
    """The all-to-all route's gradients against ``jax.grad`` of the
    reference's, f32, on (1, 1), (1, 4), (2, 2) and (4, 1), each case
    dropping pairs (a dropped pair's token gets no gradient from it)."""
    for shape in MESHES:
        jm = jmake_mesh(shape, ("data", "model"))
        m = cpu_mesh(shape)
        jcfg, cfg = moe_cfgs(8, 2, 16, 8, "float32")
        x, p = layer(GRAD_SEEDS[shape], 4, 16, 16, 8, 8)
        x = x * 3
        jx, jp = jax_layer(x, p, "float32")

        def jloss(a, q):
            out, aux = jmoe.apply_moe(a, q, jcfg)
            return jnp.sum(out ** 2) + aux
        with juse(jm, jdefault_rules()):
            jl, (jgx, jgp) = jax.jit(jax.value_and_grad(
                jloss, argnums=(0, 1)))(jx, jp)
        tx, tp = torch_layer(x, p, "float32")
        leaves = [tx, tp["router"], tp["w_in"], tp["w_out"]]
        for t in leaves:
            t.requires_grad_(True)
        moe.DROP_LOG = []
        with sharding.use_sharding_rules(m, sharding.default_rules()):
            out, aux = moe.apply_moe(tx, tp, cfg)
        log, moe.DROP_LOG = moe.DROP_LOG, None
        loss = (out ** 2).sum() + aux
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
        for g, jg, name in zip(grads, [jgx, jgp["router"], jgp["w_in"],
                                       jgp["w_out"]],
                               ("x", "router", "w_in", "w_out")):
            jg = np.asarray(jg)
            close(g, jg, GRAD_TOL * np.abs(jg).max(), f"{shape} d{name}")
        dropped = sum(e["pairs"] - int(e["processed"]) for e in log)
        assert dropped > 0, shape
        print(f"  grads {shape}: loss {loss.item():.6f}, dropped {dropped}",
              flush=True)
    print("grads: ok")


# --- the models --------------------------------------------------------------

def smoke(arch):
    jcfg = jconfigs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    jparams = jax.jit(lambda k: jtf.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_reference(cfg, np_tree(jparams))


def inputs(cfg, seed, B=4, S=32):
    rng = np.random.default_rng(seed)
    P = cfg.prefix_len if cfg.family == "vlm" else 0
    tokens = rng.integers(1, cfg.vocab, (B, S - P), dtype=np.int32)
    out = {"tokens": tokens}
    if cfg.input_mode == "frames":
        out["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.input_mode == "embeds_prefix":
        out["embeds"] = rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return out


def reference_generate(jcfg, jparams, host, max_new, shape):
    """The reference launcher's loop (``repro.launch.serve.main``) under
    its rules on a mesh of ``shape``: greedy picks and each pick's
    logits."""
    jm = jmake_mesh(shape, ("data", "model"))
    rules = jdefault_rules()
    P = jcfg.prefix_len if jcfg.input_mode == "embeds_prefix" else 0
    max_len = P + host["tokens"].shape[1] + max_new
    with juse(jm, rules):
        params = jshard_tree(jparams, jparam_axes(jcfg), jm, rules)
        batch = {k: jnp.asarray(v) for k, v in host.items()}
        logits, caches, memory = jax.jit(jprefill_fn(jcfg, max_len))(
            params, batch)
        caches = jshard_tree(caches, jcache_axes(jcfg), jm, rules)
        decode = jax.jit(jdecode_fn(jcfg))
        nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        picks, seen = [np.asarray(nxt)[:, 0]], [np.asarray(logits[:, -1])]
        for _ in range(max_new - 1):
            logits, caches = decode(params, nxt, caches, memory)
            nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            picks.append(np.asarray(nxt)[:, 0])
            seen.append(np.asarray(logits[:, -1]))
    return np.stack(picks, 1), np.stack(seen, 1)


def check_generation(arch, shape, seed, max_new=4):
    """Greedy ``generate`` on a CPU mesh of ``shape`` against the
    reference launcher's loop on the same inputs and weights; the
    reference's top-2 margin at each pick is above 10x the decode bound,
    so equal picks are a check, not luck."""
    jcfg, cfg, jparams, params = smoke(arch)
    host = inputs(cfg, seed)
    want_tok, want_logits = reference_generate(jcfg, jparams, host, max_new,
                                               shape)
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    margin = float((top2[..., 1] - top2[..., 0]).min())
    t = {k: torch.from_numpy(v) for k, v in host.items()}
    out = serve.generate(cfg, params, t["tokens"].long(), max_new,
                         frames=t.get("frames"), embeds=t.get("embeds"),
                         mesh=cpu_mesh(shape))
    close(out.logits[:, :1], want_logits[:, :1], PREFILL_TOL,
          f"{arch} prefill")
    close(out.logits[:, 1:], want_logits[:, 1:], DECODE_TOL,
          f"{arch} decode")
    assert margin > 10 * DECODE_TOL, (arch, margin)
    np.testing.assert_array_equal(out.tokens.numpy(), want_tok)
    return out, want_logits


def check_serve():
    for arch in ARCHS:
        out, _ = check_generation(arch, (2, 2), seed=ARCHS.index(arch))
        print(f"  serve {arch} (2, 2): tokens {out.tokens[0].tolist()}",
              flush=True)
    print("serve: ok")


def check_launchers():
    """qwen3-moe-30b-a3b on the launchers' default mesh (1, 1) of one
    device: the port's ``generate`` and three train steps under the mesh
    and rules against the reference's launcher paths; the same port paths
    with no mesh (the grouped route) against them, where the capacity
    drops pairs, differ."""
    jcfg, cfg, jparams, params = smoke(MOE)
    assert serve.serving_mesh(None, "cpu").shape == {"data": 1, "model": 1}
    out, want = check_generation(MOE, (1, 1), seed=11)
    t = torch.from_numpy(inputs(cfg, 11)["tokens"]).long()
    plain = serve.generate(cfg, params, t, 4)
    apart = float(np.abs(plain.logits[:, 0].numpy() - want[:, 0]).max())
    print(f"  launchers: generate on (1, 1) within bounds; with no mesh "
          f"the prefill logits differ by {apart:.3g}", flush=True)
    assert apart > 10 * PREFILL_TOL, apart
    # three train steps: repro's launcher step under its mesh and rules
    steps, B, S = 3, 4, 32
    data = JDataset(JDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                seed=0))
    jm = jmake_mesh((1, 1), ("data", "model"))
    rules = jdefault_rules(fsdp_over_pod=jcfg.n_params > 5e10)
    ocfg = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    with juse(jm, rules):
        jp = jshard_tree(jparams, jparam_axes(jcfg), jm, rules)
        jstate = jadamw.adamw_init(jp)
        step = jax.jit(jtrain_step(jcfg, ocfg))
        jlosses = []
        for s in range(steps):
            jp, jstate, metrics = step(
                jp, jstate, {k: jnp.asarray(v)
                             for k, v in data.batch_at(s).items()})
            jlosses.append(float(metrics["loss"]))
    tcfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    losses = {}
    mesh, trules = training_mesh(None, "cpu", cfg)
    assert mesh.shape == {"data": 1, "model": 1}
    for label, mesh in (("mesh", mesh), ("none", None)):
        p = params_from_reference(cfg, np_tree(jparams))
        state = opt_state_from_reference(
            cfg, np_tree(jadamw.adamw_init(jparams)))
        tstep = make_train_step(cfg, tcfg)
        got = []
        for s in range(steps):
            batch = device_batch(data.batch_at(s), "cpu")
            if mesh is None:
                p, state, metrics = tstep(p, state, batch)
            else:
                with sharding.use_sharding_rules(mesh, trules):
                    p, state, metrics = tstep(p, state, batch)
            got.append(float(metrics["loss"]))
        losses[label] = got
    np.testing.assert_allclose(losses["mesh"], jlosses, rtol=LOSS_RTOL)
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses["none"], jlosses))
    print(f"  launchers: losses {losses['mesh']} against the reference's "
          f"{jlosses}; with no mesh {losses['none']} (rel {gap:.3g})",
          flush=True)
    assert gap > 10 * LOSS_RTOL, gap
    print("launchers: ok")


GROUPS = {"routes": check_routes, "grads": check_grads,
          "serve": check_serve, "launchers": check_launchers}

if __name__ == "__main__":
    assert len(jax.devices()) == 4, jax.devices()
    for name in sys.argv[1:] or list(GROUPS):
        GROUPS[name]()
    print("ALL OK")
