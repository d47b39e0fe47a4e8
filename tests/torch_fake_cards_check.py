"""The training launcher's placement over four cards, without a card.

Run in a subprocess (``tests/test_torch_mesh_train.py``): the tensors are
``FakeTensorMode``'s (shapes, dtypes and devices, no storage), so a
full-width model costs no memory, on four devices of a stand-in device
type, ``card:0`` to ``card:3``: this CPU build of torch cannot index a
fake ``cuda`` tensor (its indexing takes CUDA's device guard), while a
Python backend registered under another name takes every op the port
runs here.  Registering it renames torch's one extra backend for the
whole process, hence the subprocess.  ``python
tests/torch_fake_cards_check.py GROUP`` runs one group:

  * ``placement``: granite-3-8b at full width on (4, 1) and (2, 2) and
    zamba2-7b on (4, 1), with the compressed step's residual: after
    ``launch.train.init_state`` each device holds, of the parameters,
    AdamW's ``m``, ``v`` and ``master`` and the residual, exactly the
    bytes ``resolve_spec`` gives its shards; every leaf split by its spec
    is in pieces on distinct devices, none whole on one, and the state's
    leaves are placed as the parameters are;
  * ``forward``: granite-3-8b's loss on (4, 1) under autograd, batch 8 x
    256: once it is computed, of the layers' weights gathered on each
    data shard's device (``Sharded.region``) only the LM head is alive
    there (the loss chunks' remat regions take it as an argument), not
    the gathered model; each layer's gather lies inside its remat region;
  * ``backward``: a gather's backward (``sharding._Gather``) sends each
    piece its slice of the gradient on the piece's own device, zeros
    where the gathered region leaves part of the piece out.
"""
import dataclasses
import sys
import weakref
from types import SimpleNamespace

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.backend_registration import \
    _setup_privateuseone_for_python_backend

from repro_torch import configs
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.transformer import param_axes
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import leaves
from repro_torch.parallel import sharding
from repro_torch.train import steps

_setup_privateuseone_for_python_backend("card")
CARDS = [torch.device("card", i) for i in range(4)]
_Generator = torch.Generator


class _HostGenerator(_Generator):
    """A CPU generator whatever device it is asked for (the stand-in
    device has no generator of its own; fake draws take any)."""

    def __new__(cls, device=None):
        return _Generator.__new__(cls)

    def __init__(self, device=None):
        super().__init__()


def card_mesh(shape):
    return make_mesh(shape, ("data", "model"), CARDS[:int(np.prod(shape))])


def expected_bytes(shape, spec, mesh, dtype) -> dict:
    """{device: bytes} of one leaf placed by ``spec``: each distinct shard
    coordinate once, on the first mesh position (row-major) that holds
    it; a shard is the leaf's size over the shard count of its dims."""
    size = torch.empty((), dtype=dtype).element_size()
    local = int(np.prod(shape)) // int(np.prod(
        [sharding.axis_size(mesh, v) for v in spec]))
    seen, out = set(), {}
    for pos in np.ndindex(mesh.devices.shape):
        at = dict(zip(mesh.axis_names, pos))
        coord = tuple(tuple(at[a] for a in sharding.names_of(v))
                      for v in spec)
        if coord not in seen:
            seen.add(coord)
            dev = mesh.devices[pos]
            out[dev] = out.get(dev, 0) + local * size
    return out


def axes_leaves(axes, tree):
    """``(axes, leaf)`` pairs of a parameter-shaped tree."""
    if isinstance(axes, dict):
        return [x for k in sorted(axes) for x in axes_leaves(axes[k],
                                                             tree[k])]
    return [] if tree is None else [(axes, tree)]


def placed_alike(params, other) -> None:
    """Each leaf of ``other`` (a parameter-shaped tree; ``None`` where a
    parameter has none) placed as its parameter is."""
    if isinstance(params, dict):
        for k in params:
            placed_alike(params[k], other[k])
    elif other is not None:
        assert (other.devices, other.counts, other.spec) == (
            params.devices, params.counts, params.spec), (params, other)


def check_placement():
    torch.Generator = _HostGenerator
    for arch, shape in (("granite-3-8b", (4, 1)), ("granite-3-8b", (2, 2)),
                        ("zamba2-7b", (4, 1))):
        cfg = configs.get_config(arch)
        mesh, rules = card_mesh(shape), sharding.default_rules()
        with FakeTensorMode():
            params, state, _ = launch_train.init_state(
                cfg, mesh, rules, 0, AdamWConfig(), compress=0.05)
        opt, residual = state
        tree = launch_train.state_tree(params, state)
        got = sharding.bytes_by_device(tree)
        want: dict = {}
        axes = param_axes(cfg)
        for name in ("params", "m", "v", "master", "residual"):
            for ax, leaf in axes_leaves(axes, tree[name]):
                spec = sharding.resolve_spec(leaf.shape, ax, mesh, rules)
                for dev, n in expected_bytes(leaf.shape, spec, mesh,
                                             leaf.dtype).items():
                    want[dev] = want.get(dev, 0) + n
                assert isinstance(leaf, sharding.Sharded), (arch, name)
                assert leaf.spec == spec, (arch, name, leaf.spec, spec)
                split = int(np.prod(leaf.counts))
                assert len(leaf.pieces) == split, (arch, name, leaf)
                # a split leaf is in pieces on distinct devices
                assert len({leaf.devices[c] for c in leaf.pieces}) == split
                for piece in leaf.pieces.values():
                    assert tuple(piece.shape) == leaf.local
                    assert piece.device in CARDS
        assert got == want, (arch, shape, got, want)
        for name in ("m", "v", "master", "residual"):
            placed_alike(params, tree[name])
        total = sum(got.values())
        print(f"  {arch} {shape}: state at rest a device "
              f"{[round(got[d] / 1e9, 3) for d in mesh.distinct_devices]} "
              f"GB of {total / 1e9:.3f}", flush=True)
        if shape == (4, 1):
            # the whole state is 14 B a parameter (bf16 weights, f32 m, v,
            # master) plus the f32 residual; a device holds a quarter of
            # the split leaves and the unsplit norms
            assert max(got.values()) < 0.26 * total, got
    print("placement: ok")


def check_forward():
    torch.Generator = _HostGenerator
    cfg = dataclasses.replace(configs.get_config("granite-3-8b"),
                              attn_impl="xla")
    mesh, rules = card_mesh((4, 1)), sharding.default_rules()
    alive = []
    gather = sharding._Gather.forward

    def recorded(ctx, meta, *pieces):
        out = gather(ctx, meta, *pieces)
        alive.append(weakref.ref(out))
        return out
    sharding._Gather.forward = staticmethod(recorded)
    with FakeTensorMode():
        params, _, _ = launch_train.init_state(cfg, mesh, rules, 0,
                                               AdamWConfig())
        for x in leaves(params):
            for p in sharding.pieces_of(x):
                p.requires_grad_(True)
        host = {"tokens": np.ones((8, 256), np.int32),
                "labels": np.ones((8, 256), np.int32),
                "loss_mask": np.ones((8, 256), np.float32)}
        batch = launch_train.placed_batch(host, mesh, rules)
        with sharding.use_sharding_rules(mesh, rules):
            loss = steps.step_loss(params, cfg, batch)
    sharding._Gather.forward = staticmethod(gather)
    assert loss.requires_grad and loss.device == CARDS[0]
    live: dict = {}
    for ref in alive:
        t = ref()
        if t is not None:
            live[t.device] = live.get(t.device, 0) + t.numel() \
                * t.element_size()
    head = cfg.padded_vocab * cfg.d_model * 2
    model = sum(p.numel() * p.element_size() for x in leaves(params)
                for p in sharding.pieces_of(x))
    print(f"  granite-3-8b (4, 1), batch 8 x 256: {len(alive)} gathers; "
          f"alive after the forward a device "
          f"{[round(live.get(d, 0) / 1e9, 3) for d in CARDS]} GB (the LM "
          f"head {head / 1e9:.3f} GB; the model {model / 1e9:.3f} GB)",
          flush=True)
    assert len(alive) >= 4 * cfg.n_layers, len(alive)
    assert all(live.get(d, 0) <= head for d in CARDS), live
    print("forward: ok")


def check_backward():
    mesh = card_mesh((2, 2))
    with FakeTensorMode():
        whole = torch.empty((8, 6), device=CARDS[0])
        leaf = sharding.shard_leaf(whole, sharding.P("data", "model"), mesh)
        region, _ = leaf._region((slice(2, 7),))
        parts = list(leaf._parts(region))
        ctx = SimpleNamespace(
            parts=[(src, dst) for _, src, dst in parts],
            pieces=[(leaf.pieces[c].shape, leaf.pieces[c].device)
                    for c, _, _ in parts],
            needs_input_grad=(False,) + (True,) * len(parts))
        grads = sharding._Gather.backward(
            ctx, torch.empty((5, 6), device=CARDS[3]))
    assert grads[0] is None and len(grads) == len(parts) + 1
    for (coord, _, _), g in zip(parts, grads[1:]):
        assert g.device == leaf.devices[coord], (coord, g.device)
        assert g.shape == leaf.pieces[coord].shape
    print(f"  a region over {len(parts)} of {len(leaf.pieces)} pieces: "
          f"each slice on its piece's device "
          f"{[str(g.device) for g in grads[1:]]}")
    print("backward: ok")


GROUPS = {"placement": check_placement, "forward": check_forward,
          "backward": check_backward}

if __name__ == "__main__":
    for name in sys.argv[1:] or list(GROUPS):
        GROUPS[name]()
    print("ALL OK")
