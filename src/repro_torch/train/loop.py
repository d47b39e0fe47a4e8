"""Fault-tolerant training loop: checkpoint/restart, straggler detection,
failure retry.

  * **Restart**: on startup, restore the latest complete checkpoint (params
    + optimizer + step); the data pipeline is stateless-addressable, so the
    stream resumes bit-exactly at that step.
  * **Failure handling**: a step that raises (device loss, preemption —
    simulated in tests via an injection hook) is retried from the last
    snapshot rather than crashing the job; repeated failures back off.
  * **Straggler mitigation**: per-step wall times feed a rolling median; a
    step slower than ``straggler_factor``× median is recorded and triggers
    an early checkpoint so a replacement can join with minimal lost work.
  * **Elastic re-mesh**: :func:`reshard_for_mesh` places a tree (whole
    tensors, or pieces on another mesh) onto a new mesh by a spec tree.
    A checkpoint saved from state placed on a mesh (``parallel.Sharded``
    leaves) restores into the placement of the state the loop is started
    with (``checkpoint``), so a run saved on a (2, 2) mesh resumes on
    (4, 1), or on one device, from the same files.

``checkpoint_every=0`` saves no checkpoint at all (a measuring run of a
full-width model, whose every save would copy its whole state to disk).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.parallel.sharding import PartitionSpec, shard_leaf


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_every: int = 50      # 0: no checkpoint
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    keep_checkpoints: int = 3
    straggler_factor: float = 3.0
    straggler_window: int = 20
    max_retries: int = 3


def fault_tolerant_train(loop_cfg: TrainLoopConfig, train_step: Callable,
                         init_state: tuple, batches: Iterator[dict],
                         batch_at: Callable[[int], dict],
                         failure_hook: Optional[Callable[[int], None]] = None,
                         log: Callable[[str], None] = print):
    """Run the loop. ``init_state`` = (params, opt_state). ``batch_at(step)``
    regenerates the batch for any step (restart-safe addressing).

    Returns (params, opt_state, history dict): its ``losses`` and
    ``step_s`` (each step's host seconds, the loss read back included)
    a completed step, ``retries``, ``stragglers``.
    """
    mgr = CheckpointManager(loop_cfg.checkpoint_dir,
                            keep=loop_cfg.keep_checkpoints)
    params, opt_state = init_state
    start_step = 0
    restored, step = mgr.restore_latest({"params": params, "opt": opt_state})
    if restored is not None:
        params, opt_state = restored["params"], restored["opt"]
        start_step = step + 1
        log(f"[restart] resumed from checkpoint step {step}")

    saving = loop_cfg.checkpoint_every > 0
    times: list = []
    events = {"stragglers": [], "retries": 0, "losses": [], "step_s": times}
    s = start_step
    retries = 0
    while s < loop_cfg.total_steps:
        batch = batch_at(s)
        t0 = time.perf_counter()
        try:
            if failure_hook is not None:
                failure_hook(s)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
        except Exception as e:      # noqa: BLE001 — device loss/preemption
            retries += 1
            events["retries"] += 1
            if retries > loop_cfg.max_retries:
                raise
            log(f"[failure] step {s}: {e!r}; restoring last checkpoint "
                f"(retry {retries}/{loop_cfg.max_retries})")
            mgr.wait()
            restored, ck = mgr.restore_latest({"params": params,
                                               "opt": opt_state})
            if restored is not None:
                params, opt_state = restored["params"], restored["opt"]
                s = ck + 1
            continue
        retries = 0
        dt = time.perf_counter() - t0
        times.append(dt)
        events["losses"].append(loss)
        window = times[-loop_cfg.straggler_window:]
        med = float(np.median(window))
        if len(window) >= 5 and dt > loop_cfg.straggler_factor * med:
            events["stragglers"].append((s, dt, med))
            log(f"[straggler] step {s}: {dt:.3f}s vs median {med:.3f}s "
                f"-> early checkpoint")
            if saving:
                mgr.save_async({"params": params, "opt": opt_state}, s)
        if saving and (s % loop_cfg.checkpoint_every == 0
                       or s == loop_cfg.total_steps - 1):
            mgr.save_async({"params": params, "opt": opt_state}, s)
        s += 1
    mgr.wait()
    return params, opt_state, events


def reshard_for_mesh(tree, mesh, spec_tree):
    """Elastic re-mesh: each leaf of ``tree`` (a tensor, or a
    ``parallel.Sharded`` on any mesh) placed on ``mesh`` by the
    ``PartitionSpec`` at its place in ``spec_tree`` (e.g.
    ``resolve_spec`` of ``param_axes``), as the reference's
    ``device_put`` does: every piece of the new layout is taken from the
    pieces of the old one that hold it, so the values are the tree's bit
    for bit.  ``None`` leaves stay ``None``."""
    if isinstance(spec_tree, dict):
        return {k: reshard_for_mesh(tree[k], mesh, spec_tree[k])
                for k in spec_tree}
    if tree is None:
        return None
    if not isinstance(spec_tree, PartitionSpec):
        raise ValueError(f"not a PartitionSpec: {spec_tree!r}")
    return shard_leaf(tree, spec_tree, mesh)
