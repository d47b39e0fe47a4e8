"""Training on a mesh (``repro_torch.launch.train`` with ``--mesh-shape``):
the parameters, AdamW's state, the gradients, the batches, the compressed
step's residual and the checkpoints placed by the reference's rules.

``tests/torch_mesh_train_check.py`` runs in a subprocess a group against
the reference on 4 fake JAX devices (six families' steps on (2, 2),
qwen3-1.7b's on (4, 1) and (1, 4), microbatches with masks that differ
across data shards, the compressed step, a restart on another mesh);
``tests/torch_fake_cards_check.py`` places full-width state over four
fake devices (no storage) and shows what a device holds.  The tests here
run on CPU meshes: a mesh of ``cpu:0`` to ``cpu:3`` (distinct device
names whose tensors all lie on the CPU) keeps each piece's device apart
for the byte counts, and ``[cpu] * n`` meshes are logical shards."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import restore_pytree, save_pytree
from repro_torch.checkpoint.checkpoint import latest_step
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_params
from repro_torch.models.transformer import lm_loss, param_axes
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim import compression
from repro_torch.optim.adamw import global_norm, leaves
from repro_torch.parallel import sharding
from repro_torch.train import make_train_step
from repro_torch.train.steps import _loss_and_grads

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: tests/_torch_family.py's bounds: the loss to 1e-5 of itself, a leaf to
#: 1e-4 of its largest element
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def named_mesh(shape):
    """A mesh of distinct CPU device names (``cpu:0`` ...), one a
    position."""
    n = int(np.prod(shape))
    return make_mesh(shape, ("data", "model"),
                     [torch.device("cpu", i) for i in range(n)])


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), [CPU] * int(np.prod(shape)))


def run_check(script, group):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tests", script),
                          group], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "ALL OK" in out.stdout


@pytest.mark.parametrize("group", ["steps_dense", "steps_mixed", "micro",
                                   "compress", "restart"])
def test_matches_reference_on_four_devices(group):
    """``tests/torch_mesh_train_check.py GROUP``: the port's steps on CPU
    meshes against the reference's ``make_train_step`` jitted under its
    rules on 4 fake devices, its state placed by its launcher."""
    run_check("torch_mesh_train_check.py", group)


@pytest.mark.parametrize("group", ["placement", "forward", "backward"])
def test_places_full_width_state_over_four_fake_cards(group):
    """``tests/torch_fake_cards_check.py GROUP``: granite-3-8b's and
    zamba2-7b's full-width state after the launcher's setup, each
    device's bytes those ``resolve_spec`` gives it; no gathered model
    alive after the forward; a gather's backward on the pieces' devices."""
    run_check("torch_fake_cards_check.py", group)


def smoke_state(arch, mesh=None, seed=0):
    cfg = configs.smoke_config(arch)
    rules = None if mesh is None else sharding.default_rules()
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu",
                         mesh, rules)
    return cfg, rules, params


def batch(cfg, B=8, S=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (B, S))
    return {"tokens": tokens.astype(np.int32),
            "labels": np.roll(tokens, -1, 1).astype(np.int32),
            "loss_mask": np.ones((B, S), np.float32)}


# --- the pieces --------------------------------------------------------------

def test_global_norm_counts_each_element_once():
    """A leaf whose spec names only ``data`` on a (2, 2) mesh has one piece
    a data shard, for both model positions: the global norm over the
    pieces equals the whole tree's (each element once), not the norm over
    every mesh position's copy."""
    mesh = named_mesh((2, 2))
    g = torch.Generator().manual_seed(3)
    whole = {"a": torch.randn(8, 6, generator=g),
             "b": {"c": torch.randn(4, generator=g),
                   "d": torch.randn(6, 8, generator=g)}}
    specs = {"a": sharding.P("data"), "b": {"c": sharding.P(),
                                            "d": sharding.P("model", "data")}}
    placed = {"a": sharding.shard_leaf(whole["a"], specs["a"], mesh),
              "b": {k: sharding.shard_leaf(whole["b"][k], specs["b"][k],
                                           mesh)
                    for k in ("c", "d")}}
    assert len(placed["a"].pieces) == 2 and len(placed["b"]["c"].pieces) == 1
    want = float(torch.sqrt(sum(x.double().square().sum()
                                for x in leaves(whole))))
    got = float(global_norm(placed))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    every_position = float(torch.sqrt(sum(
        x.double().square().sum() * (4 / len(p.pieces))
        for x, p in zip(leaves(whole), leaves(placed)))))
    assert abs(every_position - want) > 0.1 * want
    assert float(global_norm(whole)) == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("quantize", [False, True])
def test_compression_over_pieces_equals_the_whole_leaf(quantize):
    """The top-k threshold of a leaf in (2, 2) pieces is the whole leaf's
    k-th largest magnitude (``top_k``'s), and the compression of the
    pieces gives the whole leaf's kept values, residual and wire bytes bit
    for bit; the residual is placed like the gradient."""
    mesh = named_mesh((2, 2))
    g = torch.Generator().manual_seed(5)
    grad = torch.randn(16, 12, generator=g)
    ef = 0.1 * torch.randn(16, 12, generator=g)
    spec = sharding.P("data", "model")
    pg, pe = (sharding.shard_leaf(x, spec, mesh) for x in (grad, ef))
    mags = [p.abs().reshape(-1) for p in sharding.pieces_of(pg)]
    for k in (1, 7, 96, 192):
        want = torch.topk(grad.abs().reshape(-1), k)[0][-1]
        assert float(compression._kth_largest(mags, k)) == float(want)
        assert float(compression._kth_largest(grad.abs().reshape(-1),
                                              k)) == float(want)
    kept, res, wire = compression.ef_compress_update(
        {"w": grad}, {"w": ef}, keep_ratio=0.1, quantize=quantize)
    pkept, pres, pwire = compression.ef_compress_update(
        {"w": pg}, {"w": pe}, keep_ratio=0.1, quantize=quantize)
    assert isinstance(pres["w"], sharding.Sharded)
    assert pres["w"].devices == pg.devices
    assert torch.equal(pkept["w"].gather(CPU), kept["w"])
    assert torch.equal(pres["w"].gather(CPU), res["w"])
    assert float(pwire) == float(wire)


def test_unbind_and_map_pieces_keep_the_placement():
    """``Sharded.unbind`` gives each layer as views of the pieces (one
    ``unbind`` a piece), ``map_pieces`` builds a leaf placed like its
    input and ``with_pieces`` one of other pieces placed so."""
    mesh = named_mesh((2, 2))
    whole = torch.arange(3 * 4 * 6, dtype=torch.float32).reshape(3, 4, 6)
    leaf = sharding.shard_leaf(whole, sharding.P(None, "data", "model"),
                               mesh)
    layers = leaf.unbind(0)
    assert len(layers) == 3
    for i, layer in enumerate(layers):
        assert torch.equal(layer.gather(CPU), whole[i])
        assert layer.devices == {c[1:]: d for c, d in leaf.devices.items()}
    doubled = sharding.map_pieces(lambda p: 2 * p, leaf)
    assert doubled.devices == leaf.devices
    assert torch.equal(doubled.gather(CPU), 2 * whole)
    back = leaf.with_pieces({c: p.double() for c, p in leaf.pieces.items()})
    assert back.dtype == torch.float64 and back.devices == leaf.devices
    assert torch.equal(back.gather(CPU), whole.double())
    with pytest.raises(ValueError, match="split leading dim"):
        sharding.shard_leaf(whole[0], sharding.P("data"), mesh).unbind(0)


def test_gradients_come_back_in_pieces_placed_like_the_parameters():
    """One backward over two data shards on a (2, 2) mesh: each gradient is
    a ``Sharded`` placed as its parameter (its pieces' devices, spec and
    shapes), each device holds the gradients' bytes of its parameters'
    pieces, and the gathered gradients equal the one-device ones."""
    mesh = named_mesh((2, 2))
    cfg, rules, params = smoke_state("qwen3-1.7b", mesh)
    _, _, whole = smoke_state("qwen3-1.7b")
    b = launch_train.device_batch(batch(cfg), "cpu")
    with sharding.use_sharding_rules(mesh, rules):
        loss, grads = _loss_and_grads(
            params, cfg, launch_train.placed_batch(batch(cfg), mesh, rules))
    want_loss, want = _loss_and_grads(whole, cfg, b)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert sharding.bytes_by_device(grads) == sharding.bytes_by_device(
        params)
    assert len(sharding.bytes_by_device(grads)) == 4
    for key, g in flat_items(grads):
        p = dict(flat_items(params))[key]
        assert isinstance(g, sharding.Sharded), key
        assert (g.devices, g.spec, g.counts) == (p.devices, p.spec, p.counts)
        w = dict(flat_items(want))[key]
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.gather(CPU) - w).abs().max()) <= GRAD_TOL * scale, key


def flat_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_items(tree[k],
                                                           f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_steps_on_a_mesh_equal_the_one_device_steps(arch):
    """Three steps with two microbatches on a (2, 2) mesh of logical shards
    and with no mesh, from the same weights (families with no capacity to
    drop at, so one function): the losses and ``grad_norm`` to
    ``LOSS_RTOL``, the parameters after the steps to ``GRAD_TOL`` of each
    leaf's largest."""
    mesh = cpu_mesh((2, 2))
    cfg, rules, placed = smoke_state(arch, mesh)
    _, _, whole = smoke_state(arch)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1,
                                            eps=1e-3), microbatches=2)
    state_p, state_w = adamw_init(placed), adamw_init(whole)
    data = launch_train.SyntheticLMDataset(launch_train.DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=8, seed=1,
        d_model=cfg.d_model, mode=launch_train.data_mode(cfg)))
    for s in range(3):
        host = data.batch_at(s)
        with sharding.use_sharding_rules(mesh, rules):
            placed, state_p, mp = step(
                placed, state_p, launch_train.placed_batch(host, mesh, rules))
        whole, state_w, mw = step(whole, state_w,
                                  launch_train.device_batch(host, "cpu"))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(mp[key]), float(mw[key]),
                                       rtol=LOSS_RTOL, err_msg=key)
    want = dict(flat_items(whole))
    for key, p in flat_items(placed):
        w = want[key]
        scale = max(float(w.abs().max()), 1e-30)
        assert float((p.gather(CPU) - w).abs().max()) <= GRAD_TOL * scale, key


# --- the launcher and checkpoints --------------------------------------------

def test_placed_batch_splits_each_leaf_on_its_data_shards():
    """``placed_batch`` splits every leaf on ``batch`` over the data axes
    (a (2, 2) mesh: two pieces, at positions (0, 0) and (1, 0)); a batch
    that they do not divide stays whole on the first device."""
    mesh = named_mesh((2, 2))
    rules = sharding.default_rules()
    cfg = configs.smoke_config("qwen3-1.7b")
    b = launch_train.placed_batch(batch(cfg), mesh, rules)
    for k, v in b.items():
        assert v.counts[0] == 2 and len(v.pieces) == 2, k
        assert [v.devices[c] for c in sorted(v.pieces)] == [
            torch.device("cpu", 0), torch.device("cpu", 2)]
    assert b["tokens"].dtype == torch.long
    odd = launch_train.placed_batch(batch(cfg, B=3), mesh, rules)
    assert len(odd["tokens"].pieces) == 1


def test_placed_checkpoints_write_the_same_files_and_restore_anywhere(
        tmp_path):
    """State placed on (2, 2) saves the files the same state saves whole
    (the manifest's shapes, dtypes and checksum equal), each leaf's pieces
    copied to the host; a file restores into a (4, 1) template's
    placement, into (2, 2)'s and whole, bit for bit."""
    cfg, rules, placed = smoke_state("qwen3-1.7b", named_mesh((2, 2)))
    _, _, whole = smoke_state("qwen3-1.7b")
    trees = {}
    for label, params in (("placed", placed), ("whole", whole)):
        state = adamw_init(params)
        trees[label] = {"params": params, "opt": state}
        save_pytree(trees[label], str(tmp_path / label), 0)
    manifests = [(tmp_path / label / "step_00000000" / "MANIFEST.json")
                 .read_text() for label in ("placed", "whole")]
    assert manifests[0] == manifests[1]
    _, _, other = smoke_state("qwen3-1.7b", named_mesh((4, 1)), seed=1)
    template = {"params": other, "opt": adamw_init(other)}
    restored = restore_pytree(template, str(tmp_path / "placed"), 0)
    for key, leaf in flat_items(restored["params"]):
        t = dict(flat_items(other))[key]
        assert (leaf.devices, leaf.spec) == (t.devices, t.spec), key
        assert torch.equal(leaf.gather(CPU), dict(flat_items(whole))[key])
    back = restore_pytree({"params": whole, "opt": adamw_init(whole)},
                          str(tmp_path / "placed"), 0)
    for key, leaf in flat_items(back["params"]):
        assert isinstance(leaf, torch.Tensor)
        assert torch.equal(leaf, dict(flat_items(whole))[key])


def test_a_checkpoint_of_whole_tensors_restores_onto_a_mesh(tmp_path):
    """A checkpoint written by a run on one device (whole tensors: the
    files every checkpoint had before state was placed) restores onto a
    (2, 2) mesh: each leaf placed by ``param_axes``, its values the
    saved ones, AdamW's step carried."""
    cfg, _, whole = smoke_state("qwen3-1.7b", seed=4)
    state = adamw_init(whole)
    state.step.fill_(7)
    state.m["final_norm"].fill_(0.5)
    save_pytree({"params": whole, "opt": state}, str(tmp_path), 7)
    mesh = named_mesh((2, 2))
    _, rules, placed = smoke_state("qwen3-1.7b", mesh)
    got = restore_pytree({"params": placed, "opt": adamw_init(placed)},
                         str(tmp_path), 7)
    assert int(got["opt"].step) == 7
    axes = param_axes(cfg)
    for key, leaf in flat_items(got["params"]):
        assert isinstance(leaf, sharding.Sharded)
        assert torch.equal(leaf.gather(CPU), dict(flat_items(whole))[key])
    norm = got["opt"].m["final_norm"]
    assert isinstance(norm, sharding.Sharded)
    assert torch.equal(norm.gather(CPU), torch.full_like(
        whole["final_norm"], 0.5))
    spec = sharding.resolve_spec(whole["embed"]["tok"].shape,
                                 axes["embed"]["tok"], mesh, rules)
    assert got["params"]["embed"]["tok"].spec == spec


def test_train_main_on_a_mesh_resumes_on_another_shape(tmp_path, capsys):
    """``launch.train.main`` on a (2, 2) mesh of logical CPU shards saves
    after each of 3 steps; relaunched to 5 steps on (4, 1) it resumes from
    step 2, and its two losses equal, to ``LOSS_RTOL``, those of an
    uninterrupted 5-step run on (2, 2); ``--ckpt-every 0`` saves none."""
    args = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--batch",
            "8", "--seq", "32", "--ckpt-every", "1"]
    ck = str(tmp_path / "ck")
    first = launch_train.main(args + ["--steps", "3", "--ckpt-dir", ck,
                                      "--mesh-shape", "2,2"])
    out = capsys.readouterr().out
    assert "'data': 2, 'model': 2" in out and "state at rest" in out
    assert latest_step(ck) == 2 and len(first["losses"]) == 3
    resumed = launch_train.main(args + ["--steps", "5", "--ckpt-dir", ck,
                                        "--mesh-shape", "4,1"])
    assert "resumed from checkpoint step 2" in capsys.readouterr().out
    whole = launch_train.main(args + ["--steps", "5", "--mesh-shape", "2,2",
                                      "--ckpt-dir", str(tmp_path / "w")])
    assert whole["losses"][:3] == first["losses"]
    np.testing.assert_allclose(resumed["losses"], whole["losses"][3:],
                               rtol=LOSS_RTOL)
    none = launch_train.main(args[:-1] + ["0", "--steps", "2", "--ckpt-dir",
                                          str(tmp_path / "none")])
    assert len(none["losses"]) == 2 and latest_step(
        str(tmp_path / "none")) is None


def test_loss_parts_divide_as_the_reference_over_data_shards():
    """``lm_loss`` is the masked sum over the mask count plus the aux term,
    from ``lm_loss_parts``; over two data shards whose masks count
    differently, the shards' summed parts divide to the whole batch's
    loss, which the mean of the shards' own losses is not."""
    from repro_torch.models.transformer import lm_loss_parts
    cfg, _, params = smoke_state("qwen3-1.7b")
    b = launch_train.device_batch(batch(cfg, B=4), "cpu")
    b["loss_mask"][2:, 20:] = 0.0
    whole = float(lm_loss(params, cfg, b))
    parts = [lm_loss_parts(params, cfg, {k: v[rows] for k, v in b.items()})
             for rows in (slice(0, 2), slice(2, 4))]
    summed = float(sum(p[0] for p in parts) / sum(p[1] for p in parts))
    np.testing.assert_allclose(summed, whole, rtol=1e-6)
    mean = np.mean([float(p[0] / p[1]) for p in parts])
    assert abs(mean - whole) > 1e-4 * whole
