"""Atomic, async checkpointing of trees of tensors (restart-safety
substrate), in the reference's on-disk layout.

Layout:  <dir>/step_<N>/shard_<host>.npz  +  <dir>/step_<N>/MANIFEST.json

  * **Atomicity**: the shard and the manifest are written to
    ``step_N.tmp/`` and the directory is renamed only after both land, so a
    crashed save never shadows the previous good step (restart picks the
    latest *complete* one).
  * **Integrity**: the manifest records each leaf's tree path, shape and
    dtype and a content checksum; restore validates before handing the tree
    back.
  * **Async**: ``CheckpointManager.save_async`` copies the tree to host
    memory, then hands it to a writer thread, so the train loop only blocks
    for the device-to-host copy.

A tree is nested dicts, NamedTuples (``AdamWState``), tuples and lists of
tensors, numpy arrays or Python scalars; ``None`` leaves are skipped, as
the reference's pytrees skip them.  Leaf keys are the reference's: dict
keys in sorted order, NamedTuple fields as ``.name``, sequence items by
index, joined by ``/``.  npz has no bf16: a bf16 leaf is stored through a
same-width integer view and its logical dtype recorded in the manifest.
Restore returns the template's structure with each leaf on the template
leaf's device (tensors) or as numpy (other leaves).

A leaf placed on a mesh (``parallel.Sharded``) is stored as the whole
array it stands for, under the same key, in the same files: its pieces
are copied to the host one at a time, so no device ever holds the whole
leaf.  Restore places a stored array as the template's leaf is placed, so
a checkpoint written on one mesh (or on one device, before leaves were
placed) restores on another mesh or on one device.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.parallel.sharding import Sharded, shard_leaf
from repro_torch.resilience.faults import fault_point, register_point

#: fires after the shard+manifest land in ``step_N.tmp`` but BEFORE the
#: atomic rename publishes them — an injected crash here is exactly the
#: kill-mid-save the atomicity guarantee is about (the .tmp never shadows
#: the previous good step)
FP_SAVE = register_point(
    "checkpoint.save", "before the step_N.tmp -> step_N atomic publish")
FP_RESTORE = register_point(
    "checkpoint.restore", "at the start of one step's restore (a firing "
    "models a corrupt/unreadable step; restore_latest_valid falls back)")

#: torch dtypes numpy lacks -> (the name in the manifest, the storage view)
_STORAGE_VIEW = {torch.bfloat16: ("bfloat16", torch.int16, np.uint16)}
_FROM_NAME = {name: (dt, view) for dt, (name, view, _) in
              _STORAGE_VIEW.items()}


def _items(tree, prefix: str = ""):
    """``(key, leaf)`` of every non-None leaf, in the reference's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), f"{prefix}.{name}/")
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _items(x, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaf_fn, prefix: str = ""):
    """``tree``'s structure with every non-None leaf ``leaf_fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, f"{prefix}{k}/")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), leaf_fn,
                                     f"{prefix}.{n}/")
                            for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, leaf_fn, f"{prefix}{i}/")
                          for i, x in enumerate(tree))
    return leaf_fn(prefix[:-1], tree)


def _host(leaf) -> tuple:
    """``(numpy array to store, logical dtype name)``; a :class:`Sharded`
    leaf's whole array, assembled on the host piece by piece."""
    if isinstance(leaf, Sharded):
        with torch.no_grad():
            leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in _STORAGE_VIEW:
            name, view, np_view = _STORAGE_VIEW[t.dtype]
            return t.view(view).numpy().view(np_view), name
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def host_tree(tree):
    """The tree as ``(key, numpy array, dtype name)`` triples, copied off
    the device."""
    return [(key, *_host(leaf)) for key, leaf in _items(tree)]


def _write(flat, directory: str, step: int, host_id: int,
           num_hosts: int) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    arrays = {key: arr for key, arr, _ in flat}
    shard_path = os.path.join(tmp, f"shard_{host_id:05d}.npz")
    np.savez(shard_path, **arrays)
    digest = hashlib.sha256()
    for k in sorted(arrays):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(arrays[k]).tobytes())
    manifest = {
        "step": step, "num_hosts": num_hosts,
        "leaves": {key: {"shape": list(arr.shape), "dtype": dtype}
                   for key, arr, dtype in flat},
        "checksum": {f"shard_{host_id:05d}": digest.hexdigest()},
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    fault_point(FP_SAVE, {"step": step, "directory": directory})
    if host_id == 0:
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    return final


def save_pytree(tree: Any, directory: str, step: int, host_id: int = 0,
                num_hosts: int = 1) -> str:
    return _write(host_tree(tree), directory, step, host_id, num_hosts)


def complete_steps(directory: str) -> list:
    """Published (non-``.tmp``, manifest-bearing) step numbers, ascending.
    "Published" is necessary but not sufficient — a step can still fail
    integrity at restore; :func:`restore_latest_valid` handles that."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "MANIFEST.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def _logical(arr: np.ndarray, dtype_name: str, like):
    """The stored array as the template leaf's kind: a tensor on ``like``'s
    device, a :class:`Sharded` placed as ``like`` is, else numpy."""
    if dtype_name in _FROM_NAME:
        dtype, view = _FROM_NAME[dtype_name]
        t = torch.from_numpy(np.ascontiguousarray(arr)).view(view).view(
            dtype)
    elif isinstance(like, (torch.Tensor, Sharded)):
        t = torch.from_numpy(np.ascontiguousarray(arr))
    else:
        return arr
    if isinstance(like, Sharded):
        return shard_leaf(t, like.spec, like.mesh, copy=True)
    if isinstance(like, torch.Tensor):
        return t.to(like.device)
    return t


def restore_pytree(template: Any, directory: str, step: int,
                   host_id: int = 0) -> Any:
    path = os.path.join(directory, f"step_{step:08d}")
    fault_point(FP_RESTORE, {"step": step, "directory": directory})
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, f"shard_{host_id:05d}.npz"))
    digest = hashlib.sha256()
    for k in sorted(data.files):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(data[k]).tobytes())
    want = manifest["checksum"].get(f"shard_{host_id:05d}")
    if want is not None and want != digest.hexdigest():
        raise IOError(f"checkpoint {path} failed integrity check")

    def leaf(key, like):
        arr = data[key]
        info = manifest["leaves"][key]
        if list(arr.shape) != info["shape"]:
            raise IOError(f"shape mismatch for {key}")
        return _logical(arr, info["dtype"], like)
    return _rebuild(template, leaf)


def restore_latest_valid(template: Any, directory: str, host_id: int = 0):
    """Restore the newest step that actually restores: a corrupt manifest,
    truncated/mangled shard, failed checksum, or missing leaf **falls back
    to the previous complete step** (with a warning) instead of crashing the
    restart — the resume path's contract.  Returns ``(tree, step)`` or
    ``(None, None)`` when no step in the directory is restorable."""
    for step in reversed(complete_steps(directory)):
        try:
            return restore_pytree(template, directory, step, host_id), step
        except Exception as e:      # noqa: BLE001 — any broken step: skip it
            warnings.warn(
                f"checkpoint step {step} in {directory!r} is unusable "
                f"({type(e).__name__}: {e}); falling back to the previous "
                f"complete step", RuntimeWarning, stacklevel=2)
    return None, None


class CheckpointManager:
    """Async save + retention + restart discovery."""

    def __init__(self, directory: str, keep: int = 3, host_id: int = 0,
                 num_hosts: int = 1):
        self.directory = directory
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, tree: Any, step: int):
        self.wait()
        flat = host_tree(tree)      # device -> host, blocking

        def work():
            _write(flat, self.directory, step, self.host_id, self.num_hosts)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template: Any):
        """Newest *restorable* step (corrupt/truncated steps fall back to
        the previous complete one — see :func:`restore_latest_valid`)."""
        return restore_latest_valid(template, self.directory, self.host_id)
