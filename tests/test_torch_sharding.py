"""The port's sharding (``repro_torch.parallel``) against the reference's
``repro.parallel.sharding`` and the LM side on a mesh.

The rules, ``logical_spec`` and ``resolve_spec`` equal the reference's
over a table of shapes, axes and mesh shapes (the reference's
``resolve_spec`` reads only ``mesh.shape``, so it takes the port's mesh);
``param_axes`` and ``cache_axes`` equal the reference's for every
architecture and have the rank of the port's leaves; ``shard_tree`` then
``gather_tree`` is the input bit for bit, and pieces on the source's
device are views of it; ``reshard_for_mesh`` from (4, 1) to (2, 2) is bit
for bit; ``logical_shard`` is the identity; ``generate`` on meshes of
logical CPU shards against itself with no mesh (a dense model computes
the same function on a mesh) and the launchers' mesh flags.
``tests/test_torch_mesh_serve.py`` runs ``tests/torch_mesh_serve_check.py``
(the mesh routes and six families against the reference on 4 fake
devices) in subprocesses."""
import dataclasses
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import cache_axes as jcache_axes
from repro.models import param_axes as jparam_axes
from repro.parallel import sharding as jsharding
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.models import init_params, make_decode_caches, prefill
from repro_torch.models.transformer import cache_axes, param_axes
from repro_torch.parallel import sharding
from repro_torch.train.loop import reshard_for_mesh

torch.set_num_threads(1)

CPU = torch.device("cpu")


def cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, [CPU] * int(np.prod(shape)))


def jspec(spec):
    return tuple(spec)


# --- the rules ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"multi_pod": True},
                                {"multi_pod": True, "fsdp_over_pod": True},
                                {"seq_parallel": True}])
def test_default_rules_and_logical_spec_match_reference(kw):
    rules, jrules = sharding.default_rules(**kw), jsharding.default_rules(**kw)
    assert dict(rules) == dict(jrules)
    axes = ("batch", "seq", "heads", None, "wt_fsdp", "kv_seq")
    with sharding.use_sharding_rules(cpu_mesh((1, 1)), rules):
        got = sharding.logical_spec(*axes)
    assert tuple(got) == tuple(jrules.spec(axes))
    assert sharding.logical_spec(*axes) is None
    assert sharding.current_rules() == (None, None)


#: (shape, logical axes, mesh shape, axis names): the GQA fallback (2 KV
#: heads on a 4-way model axis), "first dim wins" (kv_seq and kv_heads
#: both on model), joint pod x data axes, a dim that no axis divides,
#: vocab, experts with a ZeRO-3 ff, and scalars
SPEC_CASES = [
    ((4, 64, 2, 16), ("batch", "kv_seq", "kv_heads", None), (2, 2)),
    ((4, 64, 8, 16), ("batch", "kv_seq", "kv_heads", None), (2, 4)),
    ((4, 62, 8, 16), ("batch", "kv_seq", "kv_heads", None), (2, 4)),
    ((4, 62, 2, 16), ("batch", "kv_seq", "kv_heads", None), (1, 4)),
    ((3, 64, 8, 16), ("batch", "kv_seq", "kv_heads", None), (2, 2)),
    ((64, 128), ("wt_fsdp", "heads"), (4, 1)),
    ((64, 32), ("wt_fsdp", "kv_heads"), (2, 16)),
    ((28, 64, 128), ("layers", "wt_fsdp", "ff"), (2, 2)),
    ((256, 64), ("vocab", "wt_fsdp"), (1, 4)),
    ((8, 64, 48), ("experts", None, "wt_fsdp"), (2, 4)),
    ((6, 64, 48), ("experts", None, "wt_fsdp"), (2, 4)),
    ((16, 4, 128), ("batch", None, "heads"), (2, 2, 2)),
    ((12, 4, 128), ("batch", None, "heads"), (2, 2, 2)),
    ((2, 3, 4, 8, 16, 4), ("layers", "stage", "batch", "heads", None, None),
     (2, 4)),
    ((), (), (2, 2)),
    ((5,), (None,), (2, 2)),
]


@pytest.mark.parametrize(
    "shape,axes,mesh_shape,multi_pod",
    [c + (False,) for c in SPEC_CASES]
    + [c + (True,) for c in SPEC_CASES if len(c[2]) == 3])
def test_resolve_spec_matches_reference(shape, axes, mesh_shape, multi_pod):
    names = (("pod", "data", "model") if len(mesh_shape) == 3
             else ("data", "model"))
    mesh = cpu_mesh(mesh_shape, names)
    kw = dict(multi_pod=multi_pod, fsdp_over_pod=multi_pod)
    got = sharding.resolve_spec(shape, axes, mesh, sharding.default_rules(
        **kw))
    want = jsharding.resolve_spec(shape, axes, mesh,
                                  jsharding.default_rules(**kw))
    assert tuple(got) == jspec(want)


def test_resolve_spec_fallbacks():
    """GQA: 2 KV heads on a 4-way model axis replicate; the sequence takes
    the model axis first and the heads are then replicated even where they
    divide; a 62-position cache leaves the model axis to the heads."""
    rules = sharding.default_rules()
    m = cpu_mesh((2, 4))
    kv = ("batch", "kv_seq", "kv_heads", None)
    assert tuple(sharding.resolve_spec((4, 64, 2, 16), kv, m, rules)) == (
        "data", "model", None, None)
    assert tuple(sharding.resolve_spec((4, 64, 8, 16), kv, m, rules)) == (
        "data", "model", None, None)
    assert tuple(sharding.resolve_spec((4, 62, 8, 16), kv, m, rules)) == (
        "data", None, "model", None)
    assert tuple(sharding.resolve_spec((4, 62, 2, 16), kv, m, rules)) == (
        "data", None, None, None)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def _axes_flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _axes_flat(v, f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_and_cache_axes_match_reference_and_leaf_ranks(arch):
    """For the published and the smoke config: the axes trees equal the
    reference's leaf for leaf; each has the rank of the port's leaf (the
    published tree made on the meta device); each leaf's spec on three
    meshes equals the reference's."""
    for cfg, jcfg in ((configs.get_config(arch), jconfigs.get_config(arch)),
                      (configs.smoke_config(arch),
                       jconfigs.smoke_config(arch))):
        axes, jaxes = param_axes(cfg), jparam_axes(jcfg)
        caxes, jcaxes = cache_axes(cfg), jcache_axes(jcfg)
        assert dict(_axes_flat(axes)) == dict(_axes_flat(jaxes))
        assert dict(_axes_flat(caxes)) == dict(_axes_flat(jcaxes))
        params = dict(_flat(init_params(cfg, torch.Generator(), "meta")))
        caches = dict(_flat(make_decode_caches(cfg, 4, 64, "meta")))
        for tree, leaves in ((axes, params), (caxes, caches)):
            ax = dict(_axes_flat(tree))
            assert sorted(ax) == sorted(leaves)
            for path, leaf in leaves.items():
                shape = tuple(getattr(leaf, "shape", ()))
                assert len(ax[path]) == len(shape), (path, ax[path], shape)
                for ms in ((2, 2), (1, 4), (4, 1)):
                    m = cpu_mesh(ms)
                    assert tuple(sharding.resolve_spec(
                        shape, ax[path], m, sharding.default_rules())) == \
                        jspec(jsharding.resolve_spec(
                            shape, ax[path], m, jsharding.default_rules()))


# --- placement ---------------------------------------------------------------

def _smoke_params(arch, dtype="float32"):
    cfg = dataclasses.replace(configs.smoke_config(arch), dtype=dtype)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (4, 1), (1, 4),
                                   (2, 2, 2)])
@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_shard_then_gather_is_bit_for_bit_and_pieces_are_views(arch, shape):
    cfg, params = _smoke_params(arch, "bfloat16")
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                             "model")
    mesh = cpu_mesh(shape, names)
    rules = sharding.default_rules(multi_pod=len(shape) == 3)
    placed = sharding.shard_tree(params, param_axes(cfg), mesh, rules)
    back, placed_at = dict(_flat(sharding.gather_tree(placed))), dict(
        _flat(placed))
    split = 0
    for path, a in _flat(params):
        b, p = back[path], placed_at[path]
        assert isinstance(p, sharding.Sharded), path
        assert b.dtype == a.dtype and torch.equal(a, b), path
        base = a.untyped_storage().data_ptr()
        for piece in p.pieces.values():
            assert piece.untyped_storage().data_ptr() == base, path
        split += len(p.pieces) > 1
        assert sum(t.numel() for t in p.pieces.values()) == a.numel()
    assert split > 0 or shape == (1, 1)
    held = sharding.bytes_by_device(placed)
    assert held == {CPU: sum(t.numel() * t.element_size()
                             for _, t in _flat(params))}


@pytest.mark.parametrize("arch,shape", [("qwen3-moe-30b-a3b", (2, 2)),
                                        ("zamba2-7b", (1, 4)),
                                        ("seamless-m4t-large-v2", (4, 1))])
def test_placed_init_equals_init_then_shard(arch, shape):
    """``init_params(..., mesh, rules)`` allocates each stacked leaf as its
    pieces and copies every layer's draw into them: the values of
    ``init_params`` then ``shard_tree`` bit for bit, with the same
    specs, and no piece a view of a whole leaf."""
    cfg = configs.smoke_config(arch)
    mesh, rules = cpu_mesh(shape), sharding.default_rules()
    whole = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    placed = init_params(cfg, torch.Generator().manual_seed(0), "cpu", mesh,
                         rules)
    want = dict(_flat(sharding.shard_tree(whole, param_axes(cfg), mesh,
                                          rules)))
    for path, p in _flat(placed):
        assert isinstance(p, sharding.Sharded), path
        assert p.spec == want[path].spec, path
        assert torch.equal(p.gather(CPU), want[path].gather(CPU)), path
        for piece in p.pieces.values():
            assert piece.numel() == piece.untyped_storage().nbytes() \
                // piece.element_size(), path


def test_sharded_region_write_select_and_layers():
    """A (3, 8, 12) leaf on (2, 2) split on dims 1 and 2: a region across
    pieces, a layer view, ``write`` into two pieces, ``select`` of one
    data shard's part sharing its pieces, a placed leaf placed again
    unchanged, and a replicated axis held once."""
    x = torch.arange(3 * 8 * 12, dtype=torch.float32).reshape(3, 8, 12)
    mesh = cpu_mesh((2, 2))
    s = sharding.shard_leaf(x, sharding.P(None, "data", "model"), mesh)
    assert len(s.pieces) == 4 and s.local == (3, 4, 6)
    assert torch.equal(s.region((slice(None), slice(2, 7), slice(4, 9)),
                                CPU), x[:, 2:7, 4:9])
    assert torch.equal(s.region((1, 5), CPU), x[1, 5])
    layer = s[2]
    assert tuple(layer.shape) == (8, 12)
    assert torch.equal(layer.gather(CPU), x[2])
    s.write((slice(None), 3), torch.full((3, 12), -1.0))
    assert bool((x[:, 3] == -1).all())       # the pieces are views of x
    part = s.select(1, 1)
    assert tuple(part.shape) == (3, 4, 12)
    assert torch.equal(part.gather(CPU), x[:, 4:])
    assert all(any(p is q for q in s.pieces.values())
               for p in part.pieces.values())
    assert sharding.shard_leaf(s, s.spec, mesh) is s
    rep = sharding.shard_leaf(x, sharding.P(None, None, "model"), mesh)
    assert len(rep.pieces) == 2            # data replicates: held once
    assert sharding.bytes_by_position(
        {"a": rep}, mesh) == {pos: 3 * 8 * 6 * 4 for pos in
                              np.ndindex(2, 2)}


def test_reshard_for_mesh_from_4x1_to_2x2_is_bit_for_bit():
    cfg, params = _smoke_params("qwen3-moe-30b-a3b", "bfloat16")
    rules = sharding.default_rules()
    old, new = cpu_mesh((4, 1)), cpu_mesh((2, 2))
    on_old = sharding.shard_tree(params, param_axes(cfg), old, rules)

    def specs(axes, tree):
        if isinstance(axes, dict):
            return {k: specs(axes[k], tree[k]) for k in axes}
        return sharding.resolve_spec(tree.shape, axes, new, rules)
    spec_tree = specs(param_axes(cfg), params)
    on_new = reshard_for_mesh(on_old, new, spec_tree)
    moved = dict(_flat(on_new))
    for path, a in _flat(params):
        b = moved[path]
        assert b.mesh is new and b.spec == spec_tree_at(spec_tree, path)
        assert torch.equal(b.gather(CPU), a), path
    w_in = on_new["blocks"]["moe"]["w_in"]
    assert tuple(w_in.spec) == (None, "model", None, "data")
    assert len(w_in.pieces) == 4


def spec_tree_at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("rules_on", [False, True])
def test_logical_shard_is_the_identity(rules_on):
    x = torch.randn(4, 8, 16)
    if rules_on:
        with sharding.use_sharding_rules(cpu_mesh((2, 2)),
                                         sharding.default_rules()):
            assert sharding.logical_shard(x, "batch", "seq", "d_model") is x
    else:
        assert sharding.logical_shard(x, "batch", "seq", "d_model") is x


def test_submesh_is_one_data_shards_view():
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    view = sharding.submesh(mesh, {"data": 1})
    assert view.shape == {"data": 1, "model": 2}
    assert isinstance(view, Mesh) and view.axis_names == mesh.axis_names
    devs = [torch.device("cuda", i) for i in range(4)]
    mesh = make_mesh((2, 2), ("data", "model"), devs)
    assert sharding.unravel(mesh, ("data", "model"), 3) == {"data": 1,
                                                            "model": 1}
    assert sharding.device_at(mesh, {"data": 1}) == devs[2]
    assert list(sharding.submesh(mesh, {"data": 1}).devices.flat) \
        == devs[2:]


# --- the LM side on a mesh ---------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 1), (1, 4)])
def test_dense_generate_on_a_mesh_equals_no_mesh(shape):
    """A dense model is the same function on a mesh: the batch split over
    data shards, each layer's weights gathered, the KV cache read a piece
    at a time (split on its sequence over ``model`` where it divides,
    else on its heads); tokens equal and logits within 1e-5 of their
    largest magnitude (the data shards' smaller products sum in other
    orders)."""
    cfg, params = _smoke_params("qwen3-1.7b")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        1, cfg.vocab, (4, 32))).long()
    plain = serve.generate(cfg, params, tokens, 4)
    mesh = cpu_mesh(shape)
    out = serve.generate(cfg, params, tokens, 4, mesh=mesh)
    assert torch.equal(out.tokens, plain.tokens)
    want = plain.logits.numpy()
    np.testing.assert_allclose(out.logits.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_kv_cache_is_split_on_its_sequence_and_written_in_its_piece():
    cfg, params = _smoke_params("qwen3-1.7b")
    mesh = cpu_mesh((2, 2))
    rules = sharding.default_rules()
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab, (4, 16))).long()
    from repro_torch.train import make_decode_fn, make_prefill_fn
    with sharding.use_sharding_rules(mesh, rules):
        placed = sharding.shard_tree(params, param_axes(cfg), mesh, rules)
        logits, caches, _ = make_prefill_fn(cfg, 20)(placed,
                                                     {"tokens": tokens})
        assert caches["k"].counts == (1, 2, 1, 1, 1)    # the data shards
        caches = sharding.shard_tree(caches, cache_axes(cfg), mesh, rules)
        assert caches["k"].counts == (1, 2, 2, 1, 1)    # + kv_seq
        nxt = logits.argmax(-1)
        _, caches = make_decode_fn(cfg)(placed, nxt, caches)
    k = caches["k"]
    assert caches["length"] == 17
    _, plain, _ = prefill(params, dataclasses.replace(cfg, attn_impl="xla"),
                          torch.cat([tokens, nxt], 1), 20)
    np.testing.assert_allclose(k.gather(CPU)[:, :, :17].numpy(),
                               plain["k"][:, :, :17].numpy(), atol=1e-5)
    # position 16 lies in the second sequence piece of every data shard
    assert bool((k.pieces[(0, 0, 1, 0, 0)][:, :, 6] != 0).any())
    assert bool((k.pieces[(0, 0, 1, 0, 0)][:, :, 7:] == 0).all())


def test_serve_main_takes_a_mesh_shape(capsys):
    out = serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--device",
                      "cpu", "--batch", "4", "--prompt-len", "16",
                      "--max-new", "3", "--mesh-shape", "2,2"])
    assert out.tokens.shape == (4, 3)
    assert "'data': 2, 'model': 2" in capsys.readouterr().out
    with pytest.raises(ValueError, match="data,model"):
        serve.serving_mesh((4,), "cpu")


def test_train_main_takes_logical_shards_and_refuses_cards(monkeypatch,
                                                          capsys):
    """The launcher trains on a (2, 2) mesh of logical CPU shards; on a
    mesh over two devices (two CPU device names standing in for two
    cards) it places the parameters and AdamW's state over both, each
    device printing its bytes at rest; a card that is not there is
    refused, not run as logical shards of another."""
    events = launch_train.main(["--arch", "qwen3-moe-30b-a3b", "--smoke",
                                "--device", "cpu", "--steps", "2",
                                "--batch", "4", "--seq", "32",
                                "--mesh-shape", "2,2"])
    assert len(events["losses"]) == 2 and all(np.isfinite(events["losses"]))
    assert "'data': 2, 'model': 2" in capsys.readouterr().out
    two = make_mesh((2, 1), ("data", "model"),
                    [torch.device("cpu", 0), torch.device("cpu", 1)])
    monkeypatch.setattr(launch_train, "serving_mesh", lambda *a: two)
    events = launch_train.main(["--arch", "qwen3-1.7b", "--smoke",
                                "--device", "cpu", "--steps", "2",
                                "--batch", "4", "--seq", "32"])
    assert len(events["losses"]) == 2 and all(np.isfinite(events["losses"]))
    rest = events["state_bytes"]
    assert set(rest) == {"cpu:0", "cpu:1"} and all(rest.values())
    out = capsys.readouterr().out
    assert "cpu:0: state at rest" in out and "cpu:1: state at rest" in out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="cuda:4 .* 4 visible"):
        serve.serving_mesh(None, "cuda:4")


def test_launcher_meshes_on_a_host_of_four_cards(monkeypatch):
    """A host of four cards (the count faked; no card is touched): the
    default shape spans them; a shape of fewer positions takes the first
    cards and one of more puts consecutive positions on each; ``cuda:N``
    names one card, whose logical shards take every shape; training takes
    the same meshes: one card, or all four."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]

    def devs(mesh):
        return list(mesh.devices.flat)

    assert serve.serving_mesh(None, "cuda").shape == {"data": 4, "model": 1}
    assert devs(serve.serving_mesh(None, "cuda")) == cards
    assert devs(serve.serving_mesh((1, 1), "cuda")) == cards[:1]
    assert devs(serve.serving_mesh((1, 2), "cuda")) == cards[:2]
    assert devs(serve.serving_mesh((2, 4), "cuda")) == [c for c in cards
                                                         for _ in (0, 1)]
    assert devs(serve.serving_mesh((1, 1), "cuda:1")) == [cards[1]]
    assert devs(serve.serving_mesh((2, 2), "cuda:1")) == [cards[1]] * 4
    assert serve.serving_mesh(None, "cuda:1").shape == {"data": 1,
                                                        "model": 1}
    with pytest.raises(ValueError, match="over 4 devices"):
        serve.serving_mesh((3, 2), "cuda")
    cfg = configs.smoke_config("qwen3-moe-30b-a3b")
    mesh, rules = launch_train.training_mesh((1, 1), "cuda", cfg)
    assert devs(mesh) == cards[:1]
    assert dict(rules) == dict(sharding.default_rules())
    mesh, _ = launch_train.training_mesh((2, 2), "cuda:3", cfg)
    assert mesh.distinct_devices == (cards[3],)
    mesh, _ = launch_train.training_mesh(None, "cuda", cfg)
    assert devs(mesh) == cards and mesh.shape == {"data": 4, "model": 1}


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recomputes_under_the_forwards_rules_on_another_thread(policy):
    """Autograd runs a CUDA backward on a thread of its own, where the
    thread-local rules are unset: the recomputed MoE layers must take the
    forward's all-to-all route there too.  The backward runs here on a
    second thread while the first still holds the rules; its gradients
    equal those of a backward on the first thread bit for bit."""
    import threading

    from repro_torch.models import lm_loss
    cfg = dataclasses.replace(configs.smoke_config("qwen3-moe-30b-a3b"),
                              remat_policy=policy)
    mesh, rules = launch_train.training_mesh(None, "cpu", cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 33))).long()
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    grads = []
    for other_thread in (False, True):
        params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
        leaves = [v for v in _leaves(params) if v.is_floating_point()]
        for v in leaves:
            v.requires_grad_(True)
        errors = []
        with sharding.use_sharding_rules(mesh, rules):
            loss = lm_loss(params, cfg, batch)
            if other_thread:
                def backward():
                    try:
                        loss.backward()
                    except Exception as e:   # reported on the first thread
                        errors.append(e)
                t = threading.Thread(target=backward)
                t.start()
                t.join()
            else:
                loss.backward()
        assert not errors, errors
        grads.append([v.grad for v in leaves])
    for a, b in zip(*grads, strict=True):
        assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree
