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

The reference's elastic re-mesh (``reshard_for_mesh``) waits for the
port's sharding (ROADMAP A16i).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Iterator, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_every: int = 50
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

    Returns (params, opt_state, history dict).
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

    times: list = []
    events = {"stragglers": [], "retries": 0, "losses": []}
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
            mgr.save_async({"params": params, "opt": opt_state}, s)
        if s % loop_cfg.checkpoint_every == 0 or s == loop_cfg.total_steps - 1:
            mgr.save_async({"params": params, "opt": opt_state}, s)
        s += 1
    mgr.wait()
    return params, opt_state, events
