"""Checkpointed long runs: chunked ``plan.run`` over the atomic checkpoint
substrate, resumable after a kill.

A long stencil integration must not restart from iteration 0 because the
host died.  :func:`run_checkpointed` advances the plan in chunks of
``checkpoint_every`` iterations and persists ``{grid, step}`` after each
chunk through ``repro_torch.checkpoint`` (the reference's on-disk layout),
whose atomic ``step_N.tmp -> step_N`` rename guarantees that a kill
mid-save leaves the previous complete step intact.  On start it restores
the newest *valid* step in the directory (corrupt manifests and truncated
shards fall back to the previous complete step) and continues from there.

Bit-identity: the chunk length is aligned up to a multiple of the plan's
``par_time``, so chunk boundaries coincide with super-step boundaries and
the chunked run applies the same super-steps as one ``run(iters)`` call: a
resumed run's final grid is bit-identical to a never-killed one.
(Geometry-less reference plans iterate one step at a time, so any chunking
is exact there.)

The directory is stamped with a ``meta.json`` identity (program
fingerprint, state shape, dtype, total iters): resuming a different
computation from the same directory raises
:class:`~repro_torch.resilience.health.CheckpointMismatch`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any

import torch

from repro_torch.resilience.health import CheckpointMismatch, HealthPolicy

# repro_torch.checkpoint registers its fault points with
# repro_torch.resilience.faults, so it is imported inside run_checkpointed:
# a module-level import would close an import cycle through this package.

META_NAME = "meta.json"


@dataclasses.dataclass
class CheckpointedRun:
    """Outcome of one :func:`run_checkpointed` call."""
    grid: Any
    #: iteration count the run resumed from (0 = fresh start)
    resumed_from: int
    #: chunks executed by THIS call (0 when the directory was already final)
    chunks_run: int
    #: checkpoint steps this call saved
    steps_saved: tuple
    #: the chunk length actually used (par_time-aligned)
    checkpoint_every: int


def _aligned_every(plan, checkpoint_every: int) -> int:
    """Round the chunk length up to a super-step multiple so chunk seams
    coincide with super-step seams (the bit-identity condition)."""
    every = int(checkpoint_every)
    if every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got "
                         f"{checkpoint_every}")
    if plan.geometry is not None:
        pt = plan.geometry.par_time
        every = ((every + pt - 1) // pt) * pt
    return every


def _identity(plan, iters: int) -> dict:
    from repro_torch.api.schedule_cache import stencil_fingerprint
    return {
        "fingerprint": stencil_fingerprint(plan.problem.stencil),
        "state_shape": list(plan.problem.state_shape),
        "dtype": plan.problem.dtype,
        "iters": int(iters),
    }


def _check_meta(directory: str, ident: dict) -> None:
    """Stamp a fresh directory; refuse one stamped for another
    computation (a different fingerprint, shape, dtype or iters)."""
    path = os.path.join(directory, META_NAME)
    if os.path.exists(path):
        try:
            with open(path) as f:
                have = json.load(f)
        except (OSError, ValueError):
            have = None
        if have != ident:
            raise CheckpointMismatch(
                f"checkpoint dir {directory!r} holds a different "
                f"computation: {have} != {ident} — point "
                f"checkpoint_dir somewhere else (or delete it)")
        return
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(ident, f)
    os.replace(tmp, path)


def _gc_steps(directory: str, keep: int) -> None:
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def run_checkpointed(plan, grid, iters: int, coeffs=None, *, aux=None,
                     checkpoint_every: int, checkpoint_dir: str,
                     health=None, keep: int = 3) -> CheckpointedRun:
    """Advance ``grid`` by ``iters`` iterations with a checkpoint every
    (par_time-aligned) ``checkpoint_every`` iterations, resuming from the
    newest valid checkpoint in ``checkpoint_dir`` when one exists.

    ``health`` (a :class:`HealthPolicy` spec) is checked on the device at
    every chunk boundary *before* the chunk is persisted: a NaN'd grid
    raises :class:`~repro_torch.resilience.health.NumericalFault` and is
    never checkpointed, so the directory only ever holds healthy state."""
    from repro_torch.checkpoint import restore_latest_valid, save_pytree
    iters = int(iters)
    if iters < 0:
        raise ValueError(f"iters must be >= 0, got {iters}")
    every = _aligned_every(plan, checkpoint_every)
    policy = HealthPolicy.make(health) if health is not None else None
    _check_meta(checkpoint_dir, _identity(plan, iters))

    template = {"grid": torch.zeros(plan.problem.state_shape,
                                    dtype=plan.problem.torch_dtype,
                                    device=plan.device)}
    restored, step = restore_latest_valid(template, checkpoint_dir)
    done = 0
    if restored is not None and step is not None:
        if step > iters:
            raise CheckpointMismatch(
                f"checkpoint step {step} exceeds requested iters {iters} "
                f"in {checkpoint_dir!r}")
        grid, done = restored["grid"], int(step)

    chunks, saved = 0, []
    while done < iters:
        chunk = min(every, iters - done)
        grid = plan.run(grid, chunk, coeffs, aux=aux)
        done += chunk
        chunks += 1
        if policy is not None:
            fault = policy.fault_of(grid, where=f"iteration {done}")
            if fault is not None:
                raise fault
        save_pytree({"grid": grid}, checkpoint_dir, done)
        saved.append(done)
        _gc_steps(checkpoint_dir, keep)
    if not chunks:                  # the restored state, on the plan's device
        grid = torch.as_tensor(grid, dtype=plan.problem.torch_dtype,
                               device=plan.device)
    return CheckpointedRun(grid=grid, resumed_from=(int(step) if restored
                                                    is not None else 0),
                           chunks_run=chunks, steps_saved=tuple(saved),
                           checkpoint_every=every)
