"""The port's training on a mesh against the reference's on 4 devices.

Run in a subprocess (``tests/test_torch_mesh_train.py``) with 4 fake CPU
devices for the reference, so the main pytest process keeps its
one-device view; the port runs the same cases on CPU meshes of the same
shapes (``[cpu] * n``: logical shards).  The reference's own weights and
AdamW state go through ``convert`` onto the port's mesh, placed as the
reference's launcher places them (``param_axes``); the same numpy
batches go to both, the reference's placed on ``batch`` as its
``batch_at`` places them, the port's by ``launch.train.placed_batch``.
The reference's step is ``make_train_step`` (or the compressed one)
jitted under its rules with its state placed by its launcher's
``_shard_tree``.  ``python tests/torch_mesh_train_check.py GROUP`` runs
one group:

  * ``steps_dense``: 3 steps of qwen3-1.7b's smoke config on (2, 2),
    (4, 1) and (1, 4), and of mamba2-1.3b's on (2, 2);
  * ``steps_mixed``: 3 steps on (2, 2) of qwen3-moe-30b-a3b (its layers
    on the expert-parallel all-to-all route, dropping pairs at a
    capacity), zamba2-7b, seamless-m4t-large-v2 and internvl2-76b;
  * ``micro``: 2 microbatches whose loss masks differ across the data
    shards, on (2, 2): the loss divides the masked sum by the whole
    microbatch's mask count, as the reference does, and the mean of the
    data shards' own means (another function) is shown apart from it;
  * ``compress``: the compressed step (keep 0.05, int8) on (2, 2): the
    wire bytes equal, the parameters and the residual within bounds;
  * ``restart``: 3 steps of the loop on (2, 2) with checkpoints, then a
    resume to 5 steps on (4, 1) and one with no mesh, each from the (2,
    2) files, against the reference's 3 steps on (2, 2) and 2 on (4, 1).

Bounds (``tests/_torch_family.py``'s, to which the family tests hold a
one-device step): the losses and ``grad_norm`` to ``LOSS_RTOL`` (1e-5)
of themselves; the parameters, ``m``, ``v`` and the residual after the
steps to ``GRAD_TOL`` (1e-4) of each leaf's largest element, with
AdamW's eps ``STEP_EPS`` (1e-3) as the family tests take it; the wire
bytes exactly.
"""
import os
import shutil
import sys
import tempfile

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.launch.train import _shard_tree as jshard_tree  # noqa: E402
from repro.models import param_axes as jparam_axes  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.parallel.sharding import default_rules as jdefault_rules  # noqa
from repro.parallel.sharding import use_sharding_rules as juse  # noqa: E402
from repro.train import make_compressed_train_step as jcompressed  # noqa
from repro.train import make_train_step as jtrain_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import data_mode, placed_batch  # noqa: E402
from repro_torch.models.transformer import lm_loss  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import (TrainLoopConfig,  # noqa: E402
                               fault_tolerant_train,
                               make_compressed_train_step, make_train_step)
from repro_torch.train.steps import data_shards  # noqa: E402

torch.set_num_threads(1)

LOSS_RTOL, GRAD_TOL, STEP_EPS = 1e-5, 1e-4, 1e-3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=5, eps=STEP_EPS)
B = 8
CPU = torch.device("cpu")


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), [CPU] * int(np.prod(shape)))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree, prefix=""):
    """``{"a/b": f32 numpy}`` of a tree's leaves (placed ones gathered)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif isinstance(v, sharding.Sharded):
            out[f"{prefix}{k}"] = v.gather(CPU).float().numpy()
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v.float().numpy()
        elif v is not None:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def trees_close(got, want, what, skip=None):
    """Every leaf within ``GRAD_TOL`` of the want leaf's largest element,
    but the elements ``skip`` names ({key: bool mask}); returns the
    largest such relative error."""
    g, w = flat(got), flat(np_tree(want))
    assert g.keys() == w.keys(), (what, sorted(g.keys() ^ w.keys()))
    worst = 0.0
    for key in w:
        scale = max(float(np.abs(w[key]).max()), 1e-30)
        diff = np.abs(g[key] - w[key])
        if skip and key in skip:
            diff = np.where(skip[key], 0.0, diff)
        err = float(diff.max()) / scale
        assert err <= GRAD_TOL, f"{what} {key}: {err:.3g} of the largest"
        worst = max(worst, err)
    return worst


def model(arch):
    jcfg = jconfigs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    jparams = jax.jit(lambda k: jtf.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    return jcfg, cfg, jparams


def batches(cfg, n, seed=2):
    S = 28 if cfg.family == "vlm" else 32
    data = JDataset(JDataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                                seed=seed, prefix_len=cfg.prefix_len,
                                d_model=cfg.d_model, mode=data_mode(cfg)))
    return [data.batch_at(s) for s in range(n)]


# --- the reference -----------------------------------------------------------

class Reference:
    """The reference launcher's state on a mesh of ``shape`` and its jitted
    step (``make_train_step``, or the compressed step with ``keep``)."""

    def __init__(self, jcfg, jparams, shape, microbatches=1, keep=None):
        self.jcfg = jcfg
        self.mesh = jmake_mesh(shape, ("data", "model"))
        self.rules = jdefault_rules(fsdp_over_pod=jcfg.n_params > 5e10)
        ocfg = jadamw.AdamWConfig(**OPT)
        with juse(self.mesh, self.rules):
            self.params = self.place(jparams)
            state = jadamw.adamw_init(self.params)
            state = jadamw.AdamWState(step=state.step,
                                      m=self.place(state.m),
                                      v=self.place(state.v),
                                      master=self.place(state.master))
            if keep is None:
                self.state = state
                self.fn = jax.jit(jtrain_step(jcfg, ocfg, microbatches))
            else:
                step = jcompressed(jcfg, ocfg, microbatches, keep_ratio=keep)
                self.state = (state, step.init_extra(self.params))
                self.fn = jax.jit(step)

    def place(self, tree):
        return jshard_tree(tree, jparam_axes(self.jcfg), self.mesh,
                           self.rules)

    def step(self, host):
        with juse(self.mesh, self.rules):
            batch = {k: jax.device_put(v, NamedSharding(
                self.mesh, self.rules.spec(("batch",)
                                           + (None,) * (v.ndim - 1))))
                     for k, v in host.items()}
            self.params, self.state, m = self.fn(self.params, self.state,
                                                 batch)
        return {k: float(v) for k, v in m.items()}

    def remesh(self, shape, microbatches=1):
        """The state placed on a mesh of ``shape`` (an elastic restart)
        and the step jitted there."""
        self.mesh = jmake_mesh(shape, ("data", "model"))
        with juse(self.mesh, self.rules):
            self.params = self.place(self.params)
            s = self.state
            self.state = jadamw.AdamWState(step=s.step, m=self.place(s.m),
                                           v=self.place(s.v),
                                           master=self.place(s.master))
            self.fn = jax.jit(jtrain_step(self.jcfg,
                                          jadamw.AdamWConfig(**OPT),
                                          microbatches))


# --- the port ----------------------------------------------------------------

def port_state(cfg, jparams, mesh, keep=None):
    """The reference's weights and a fresh AdamW state carried onto
    ``mesh`` (or whole, with ``mesh`` None), and the step."""
    rules = None if mesh is None else sharding.default_rules(
        fsdp_over_pod=cfg.n_params > 5e10)
    params = params_from_reference(cfg, np_tree(jparams), mesh=mesh,
                                   rules=rules)
    state = opt_state_from_reference(
        cfg, np_tree(jadamw.adamw_init(jparams)), mesh=mesh, rules=rules)
    return params, state, rules


def port_run(cfg, jparams, shape, hosts, microbatches=1, keep=None):
    """The port's steps on a CPU mesh of ``shape``: ``(params, state,
    metrics a step)``."""
    mesh = cpu_mesh(shape)
    params, state, rules = port_state(cfg, jparams, mesh)
    if keep is None:
        step = make_train_step(cfg, AdamWConfig(**OPT), microbatches)
    else:
        step = make_compressed_train_step(cfg, AdamWConfig(**OPT),
                                          microbatches, keep_ratio=keep)
        state = (state, step.init_extra(params))
    metrics = []
    for host in hosts:
        with sharding.use_sharding_rules(mesh, rules):
            params, state, m = step(params, state,
                                    placed_batch(host, mesh, rules))
        metrics.append({k: float(v) for k, v in m.items()})
    return params, state, metrics


def compare_steps(arch, shape, microbatches=1, hosts=None, n=3):
    jcfg, cfg, jparams = model(arch)
    hosts = hosts or batches(cfg, n)
    ref = Reference(jcfg, jparams, shape, microbatches)
    want = [ref.step(h) for h in hosts]
    params, state, got = port_run(cfg, jparams, shape, hosts, microbatches)
    for s, (g, w) in enumerate(zip(got, want)):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=LOSS_RTOL,
                                       err_msg=f"{arch} {shape} step {s} "
                                       f"{key}")
    errs = [trees_close(params, ref.params, f"{arch} {shape} params"),
            trees_close(state.m, ref.state.m, f"{arch} {shape} m"),
            trees_close(state.v, ref.state.v, f"{arch} {shape} v")]
    assert int(state.step) == n
    print(f"  {arch} {shape}: losses {[round(g['loss'], 6) for g in got]}, "
          f"the reference's {[round(w['loss'], 6) for w in want]}; "
          f"params, m, v within {max(errs):.3g} of a leaf's largest",
          flush=True)
    return cfg, jparams, params, state


def check_steps_dense():
    for arch, shape in (("qwen3-1.7b", (2, 2)), ("qwen3-1.7b", (4, 1)),
                        ("qwen3-1.7b", (1, 4)), ("mamba2-1.3b", (2, 2))):
        _, _, params, state = compare_steps(arch, shape)
        # the state stays in its pieces, placed like the parameters
        for p, m in zip(flat_leaves(params), flat_leaves(state.m)):
            assert isinstance(p, sharding.Sharded) and m.counts == p.counts
    print("steps_dense: ok")


def check_steps_mixed():
    for arch in ("qwen3-moe-30b-a3b", "zamba2-7b", "seamless-m4t-large-v2",
                 "internvl2-76b"):
        compare_steps(arch, (2, 2))
    print("steps_mixed: ok")


def flat_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_leaves(tree[k])]
    return [] if tree is None else [tree]


def masked(hosts):
    """``hosts`` with each row's loss mask cut to a prefix of its own
    length (row r keeps 32 - 3r positions): the data shards of a
    microbatch then count different numbers of positions."""
    out = []
    for h in hosts:
        h = dict(h)
        mask = h["loss_mask"].copy()
        for r in range(mask.shape[0]):
            mask[r, mask.shape[1] - 3 * r:] = 0.0
        h["loss_mask"] = mask
        out.append(h)
    return out


def check_micro():
    """Two microbatches of 4 rows on (2, 2): rows 0-3 and 4-7, each data
    shard 2 rows of a microbatch, the masks' counts differing."""
    arch, shape = "qwen3-1.7b", (2, 2)
    jcfg, cfg, jparams = model(arch)
    hosts = masked(batches(cfg, 3))
    compare_steps(arch, shape, microbatches=2, hosts=hosts)
    # the mean of the data shards' own means is another function: show it
    # apart from the reference's loss of the first microbatch
    params, _, _ = port_state(cfg, jparams, None)
    mb = {k: torch.from_numpy(v[:4]) for k, v in hosts[0].items()}
    mb["tokens"], mb["labels"] = mb["tokens"].long(), mb["labels"].long()
    whole = float(lm_loss(params, cfg, mb))
    rules = sharding.default_rules()
    shards = data_shards(cpu_mesh(shape), rules, 4)
    per = np.mean([float(lm_loss(params, cfg, {k: v[rows]
                                               for k, v in mb.items()}))
                   for rows, _, _, _ in shards])
    jwhole = float(jax.jit(lambda p, b: jtf.lm_loss(p, jcfg, b))(
        jparams, {k: jnp.asarray(v[:4]) for k, v in hosts[0].items()}))
    np.testing.assert_allclose(whole, jwhole, rtol=LOSS_RTOL)
    gap = abs(per - jwhole) / abs(jwhole)
    print(f"  micro: the first microbatch's loss {whole:.6f} (the "
          f"reference's {jwhole:.6f}); the mean of the data shards' means "
          f"{per:.6f} (rel {gap:.3g})", flush=True)
    assert gap > 10 * LOSS_RTOL, gap
    print("micro: ok")


#: kept values that may round to the other int8 level over the 3 steps
MAX_FLIPS = 2


def midpoint_flips(ef, want) -> dict:
    """{leaf: bool mask} of the residual's elements that differ from the
    reference's by more than ``GRAD_TOL`` of the leaf's largest, each of
    which must be a kept value on an int8 rounding midpoint that rounded
    the other way: the gradients reach the compression summed over the
    data shards in another order than the reference's (a last-bit
    difference), so ``x / scale`` on either side of ``k + 1/2`` takes
    level ``k`` in one and ``k + 1`` in the other, and the two residuals
    are ``r`` and ``r - scale`` with ``r`` about ``scale / 2``: equal and
    opposite.  Those elements' moments then differ by that step's share
    of one level, which the comparison leaves out."""
    g, w = flat(ef), flat(np_tree(want))
    out = {}
    for key in w:
        scale = max(float(np.abs(w[key]).max()), 1e-30)
        bad = np.abs(g[key] - w[key]) > GRAD_TOL * scale
        if bad.any():
            np.testing.assert_allclose(g[key][bad], -w[key][bad], rtol=1e-3,
                                       err_msg=key)
            out[key] = bad
    return out


def check_compress():
    arch, shape, keep = "qwen3-1.7b", (2, 2), 0.05
    jcfg, cfg, jparams = model(arch)
    hosts = batches(cfg, 3)
    ref = Reference(jcfg, jparams, shape, keep=keep)
    want = [ref.step(h) for h in hosts]
    params, (state, ef), got = port_run(cfg, jparams, shape, hosts,
                                        keep=keep)
    for s, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        assert g["compressed_wire_bytes"] == w["compressed_wire_bytes"], (
            s, g, w)
    flips = midpoint_flips(ef, ref.state[1])
    errs = [trees_close(params, ref.params, "params"),
            trees_close(state.m, ref.state[0].m, "m", flips),
            trees_close(state.v, ref.state[0].v, "v", flips),
            trees_close(ef, ref.state[1], "residual", flips)]
    assert all(isinstance(x, sharding.Sharded) for x in flat_leaves(ef))
    n_flips = sum(int(f.sum()) for f in flips.values())
    print(f"  compress {shape}: wire bytes "
          f"{[g['compressed_wire_bytes'] for g in got]} (the reference's "
          f"equal); params, m, v, residual within {max(errs):.3g}; "
          f"{n_flips} kept value(s) on an int8 rounding midpoint took the "
          f"other level", flush=True)
    assert n_flips <= MAX_FLIPS, flips
    print("compress: ok")


def check_restart():
    """The loop on (2, 2) saves after each of 3 steps; a resume to 5 steps
    from those files on (4, 1), and one with no mesh, against the
    reference's 3 steps on (2, 2) and 2 more after its elastic restart on
    (4, 1)."""
    arch = "qwen3-1.7b"
    jcfg, cfg, jparams = model(arch)
    hosts = batches(cfg, 5)
    ref = Reference(jcfg, jparams, (2, 2))
    want = [ref.step(h) for h in hosts[:3]]
    ref.remesh((4, 1))
    want += [ref.step(h) for h in hosts[3:]]
    step = make_train_step(cfg, AdamWConfig(**OPT))
    with tempfile.TemporaryDirectory() as ck:
        losses = {}
        for label, shape, total in (("(2, 2)", (2, 2), 3),
                                    ("(4, 1)", (4, 1), 5),
                                    ("no mesh", None, 5)):
            mesh = None if shape is None else cpu_mesh(shape)
            params, state, rules = port_state(cfg, jparams, mesh)
            loop = TrainLoopConfig(total_steps=total, checkpoint_every=1,
                                   checkpoint_dir=ck)
            if mesh is None:
                _, _, events = fault_tolerant_train(
                    loop, step, (params, state), iter(hosts),
                    lambda s: {k: torch.from_numpy(v).to(
                        torch.long if v.dtype.kind in "iu" else
                        torch.float32) for k, v in hosts[s].items()},
                    log=lambda _: None)
            else:
                with sharding.use_sharding_rules(mesh, rules):
                    _, _, events = fault_tolerant_train(
                        loop, step, (params, state), iter(hosts),
                        lambda s: placed_batch(hosts[s], mesh, rules),
                        log=lambda _: None)
            losses[label] = events["losses"]
            if label != "(2, 2)":
                # the resumed runs start where the first stopped, and leave
                # its step-2 files for the next
                for s in (3, 4):
                    shutil.rmtree(os.path.join(ck, f"step_{s:08d}"))
    np.testing.assert_allclose(losses["(2, 2)"], [w["loss"] for w in
                                                   want[:3]], rtol=LOSS_RTOL)
    for label in ("(4, 1)", "no mesh"):
        assert len(losses[label]) == 2, (label, losses[label])
        np.testing.assert_allclose(losses[label],
                                   [w["loss"] for w in want[3:]],
                                   rtol=LOSS_RTOL, err_msg=label)
    print(f"  restart: {losses}; the reference's "
          f"{[round(w['loss'], 6) for w in want]}", flush=True)
    print("restart: ok")


GROUPS = {"steps_dense": check_steps_dense, "steps_mixed": check_steps_mixed,
          "micro": check_micro, "compress": check_compress,
          "restart": check_restart}

if __name__ == "__main__":
    assert len(jax.devices()) == 4, jax.devices()
    for name in sys.argv[1:] or list(GROUPS):
        GROUPS[name]()
    print("ALL OK")
