"""Persistent schedule cache — measured-tuning winners, paid for once (the
reference's ``api/schedule_cache.py``).

The measured tuner (``api/tuner.py``) is the expensive half of
``plan(..., RunConfig(autotune="measure"))``: it builds and times several
schedules on the backend.  A serving process cannot pay that at every
boot, so winners are kept in a small JSON file keyed by everything that
decides the optimum:

    (stencil, shape, dtype, boundary, cell_bytes, backend, torch and CUDA
     versions, the card's name or ``cpu``, the model's device, n_chips /
     chip_grid, pinned par_time/bsize/par_vec, limits, code-version salt)

The *code-version salt* hashes the port's sources that decide a
schedule's speed (blocking, stencils, ops, builder, programs, codegen and
the kernel's CUDA sources): editing one of them invalidates every cached
schedule, with no version to bump by hand.  The card's name in the key
keeps a winner timed on the CPU's plain versions from serving the card.

Cache resolution (``RunConfig.cache``): ``None``/``True`` is the
``REPRO_TORCH_SCHEDULE_CACHE`` variable, else
``~/.cache/repro_torch/schedules.json`` (under ``XDG_CACHE_HOME`` when
set), never the reference's file; a path is that file; ``False`` is no
cache.  The file is JSON; deleting it, or an entry, is always safe: the
cost is a re-tune at the next miss.

:func:`stencil_fingerprint` gives the reference's digest for the same
stencil or program, so bucket keys agree across the packages.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import tempfile
import time
import warnings
from pathlib import Path
from typing import Optional, Sequence, Union

from repro_torch.resilience.faults import fault_point, register_point

try:
    import fcntl
except ImportError:          # non-POSIX: writes merge just before replacing
    fcntl = None

#: inside ``_load``'s degradation envelope: an injected ``OSError`` here
#: behaves as a flaky filesystem — the cache treats it as a miss (re-tune),
#: never a crash
FP_LOAD = register_point(
    "schedule_cache.get", "on every schedule-cache file read (inject "
    "exc=OSError to model a real filesystem failure)")
FP_PUT = register_point(
    "schedule_cache.put", "before a measured winner is persisted")

#: bumped when the on-disk entry layout changes (code changes are covered
#: by the salt)
CACHE_FORMAT_VERSION = 1

#: the sources the salt hashes, relative to the package
SALTED_SOURCES = ("core/blocking.py", "core/stencils.py", "kernels/ops.py",
                  "kernels/builder.py", "programs.py", "kernels/codegen.py",
                  "kernels/csrc/stencil_stream.cu",
                  "kernels/csrc/hopper.cuh")

_salt_cache: Optional[str] = None


def salt_of(root: Union[str, Path],
            sources: Sequence[str] = SALTED_SOURCES) -> str:
    """Content hash of ``sources`` (by default :data:`SALTED_SOURCES`)
    under the package root ``root``."""
    h = hashlib.sha1()
    for rel in sources:
        h.update((Path(root) / rel).read_bytes())
    return h.hexdigest()[:12]


def code_version_salt() -> str:
    """Content hash of the sources that decide a schedule's speed
    (:data:`SALTED_SOURCES` of this package)."""
    global _salt_cache
    if _salt_cache is None:
        _salt_cache = salt_of(Path(__file__).resolve().parents[1])
    return _salt_cache


def default_cache_path() -> Path:
    env = os.environ.get("REPRO_TORCH_SCHEDULE_CACHE")
    if env:
        return Path(env)
    base = os.environ.get("XDG_CACHE_HOME") or (Path.home() / ".cache")
    return Path(base) / "repro_torch" / "schedules.json"


def stencil_fingerprint(st) -> str:
    """Hash of what makes a stencil *itself*: name alone is not identity for
    user-defined stencils, whose ``apply`` can change under the same name.

    A multi-stage :class:`~repro_torch.programs.StencilProgram`
    fingerprints as the ordered chain of its stages: each stage's stencil
    fingerprint plus its static coefficient overrides and per-stage BC;
    DAG wiring (explicit ``inputs=``, extra ``fields=``, ``updates=``) folds
    in only when present.  The same stencil or program gives the
    reference's hex digest, so bucket keys agree across the packages."""
    if hasattr(st, "stages"):    # StencilProgram
        h = hashlib.sha1()
        for s in st.stages:
            btok = (s.boundary.token() if hasattr(s.boundary, "token")
                    else repr(s.boundary))
            h.update(stencil_fingerprint(s.stencil).encode())
            h.update(repr((s.name, s.coeffs, btok)).encode())
            if s.inputs is not None:
                h.update(repr(("inputs", s.inputs)).encode())
        if st.fields != ("u",) or st.updates is not None:
            h.update(repr(("state", st.fields, st.updates)).encode())
        return h.hexdigest()[:8]
    h = hashlib.sha1()
    h.update(repr((st.ndim, st.radius, st.flop_pcu, st.num_read,
                   st.num_write, st.has_aux, st.coeff_names,
                   st.offsets)).encode())
    if getattr(st, "arity", 1) != 1:
        h.update(repr(("arity", st.arity)).encode())
    code = getattr(st.apply, "__code__", None)
    if code is not None:
        h.update(code.co_code)
        # nested code objects repr with process-dependent addresses: skip
        h.update(repr([c for c in code.co_consts
                       if not hasattr(c, "co_code")]).encode())
    return h.hexdigest()[:8]


def host_label(device) -> str:
    """Where the stopwatch runs: the torch and CUDA versions and the card's
    name (``cpu`` for the plain versions), so a winner timed on one never
    serves another."""
    import torch
    name = ("cpu" if device.type != "cuda"
            else torch.cuda.get_device_name(device.index or 0))
    return f"torch {torch.__version__}/cuda {torch.version.cuda}/{name}"


def schedule_key(problem, config, perf_device, n_chips: int = 1,
                 chip_grid=None, salt: Optional[str] = None) -> str:
    """Stable, readable cache key of one tuning context.

    ``iters_hint`` is left out: winners are ranked by seconds an iteration
    (``api/tuner.py``), which no run length changes.  Whatever constrains
    the sweep (pinned ``par_time``/``bsize``/``par_vec``, ``par_time_max``,
    ``tune_top_k``) is in it, so a winner found under a tight constraint
    never serves (or breaks) a looser search."""
    shape = "x".join(str(d) for d in problem.shape)
    grid = "x".join(str(c) for c in chip_grid) if chip_grid else "-"
    pin_bs = config.normalized_bsize(problem.ndim)
    pin = (f"{config.par_time if config.par_time is not None else '-'}"
           f",{'x'.join(str(b) for b in pin_bs) if pin_bs else '-'}"
           f",{config.par_vec if config.par_vec is not None else '-'}")
    return "|".join([
        problem.stencil.name, f"st={stencil_fingerprint(problem.stencil)}",
        f"shape={shape}", f"dtype={problem.dtype}",
        f"bc={problem.bc.token()}",
        f"cb={config.resolved_cell_bytes(problem.dtype)}",
        f"backend={config.backend}",
        f"host={host_label(config.device)}",
        f"device={perf_device.name}", f"chips={n_chips}", f"grid={grid}",
        f"pin={pin}",
        f"lim={config.par_time_max}/{config.tune_top_k}",
        f"salt={salt or code_version_salt()}",
    ])


class ScheduleCache:
    """A JSON file of measured-tuning winners, safe to share and to delete.

    Writes are atomic (tempfile + ``os.replace``) and re-read the file under
    an exclusive ``flock`` on a sidecar ``.lock`` file first, so concurrent
    tuners keep every entry, never lose the file."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)

    @classmethod
    def resolve(cls, cache: Union[None, bool, str, Path]
                ) -> Optional["ScheduleCache"]:
        """``RunConfig.cache`` -> a cache, or None when disabled."""
        if cache is False:
            return None
        if cache is None or cache is True:
            return cls(default_cache_path())
        return cls(cache)

    def _load(self) -> dict:
        try:
            fault_point(FP_LOAD, {"path": str(self.path)})
            with open(self.path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        if (not isinstance(data, dict)
                or data.get("version") != CACHE_FORMAT_VERSION
                or not isinstance(data.get("entries"), dict)):
            return {}    # unknown layout: treat as empty, overwrite on put
        return data["entries"]

    def get(self, key: str) -> Optional[dict]:
        entry = self._load().get(key)
        return dict(entry) if isinstance(entry, dict) else None

    @contextlib.contextmanager
    def _write_lock(self):
        """Exclusive advisory lock over the writers' load-merge-replace:
        ``flock`` on a sidecar ``.lock`` file (``os.replace`` swaps the
        cache's own inode).  Without ``fcntl`` the merge happens just
        before the replace, which narrows the window but does not close
        it."""
        if fcntl is None:
            yield
            return
        lock_path = self.path.with_name(self.path.name + ".lock")
        with open(lock_path, "a") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    def put(self, key: str, entry: dict) -> None:
        """Persist ``entry``; an unwritable path is a warning, not an
        error: the cache saves time, and a failed write must not throw
        away the winner just measured.  The file is re-read and merged
        under the lock, so concurrent writers keep each other's entries."""
        tmp = None
        try:
            fault_point(FP_PUT, {"path": str(self.path), "key": key})
            self.path.parent.mkdir(parents=True, exist_ok=True)
            with self._write_lock():
                entries = self._load()
                entries[key] = dict(entry, saved_at=time.time())
                fd, tmp = tempfile.mkstemp(dir=self.path.parent,
                                           prefix=self.path.name,
                                           suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    json.dump({"version": CACHE_FORMAT_VERSION,
                               "entries": entries}, f, indent=1,
                              sort_keys=True)
                os.replace(tmp, self.path)
        except OSError as e:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            warnings.warn(f"schedule cache not persisted to {self.path}: {e}",
                          RuntimeWarning, stacklevel=2)

    def __len__(self) -> int:
        return len(self._load())
