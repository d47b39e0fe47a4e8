"""Builds and loads the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` at first use into ``build/repro_torch/`` at the root of the
checkout, under a name that carries a hash of the source, the ``csrc/``
headers it includes (``hopper.cuh``, shared by the flash sources) and the
flags, and loaded with ``ctypes``; ``stencil_stream.cu`` gives one library
per storage type for single grids and one for batches
(:data:`LIBRARIES`), and one library per program with custom stencils
(:func:`custom_stencil_stream`: the source, with the generated header of
``kernels/codegen.py`` and only the kernel the program runs), named by a
hash of the generated text, the source and the flags.  Only the sources
in the repository are used.  Nothing here runs at import time: this
module imports on machines without ``nvcc`` or a card.  A build holds a
lock per library (the stencil service launches from worker threads) and
renames its output into place atomically; a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: library stem -> (source, its own nvcc flags).  The streaming kernel is
#: built once per storage type, so that the halves of its kernels compile
#: in parallel (57 per library): one library of 72 took 22 s on an H100
#: machine
#: (nvcc's --split-compile took 12 s but changed the code, and slowed the
#: one-row form of hotspot2d by 8-10%); and once more per type with the
#: batch members' offsets (``STENCIL_BATCH``), which cost single-grid
#: launches up to 11% on an H100 when compiled into every kernel
LIBRARIES = {"stencil_f32": ("stencil_stream.cu", ("-DSTENCIL_BF16=0",)),
             "stencil_bf16": ("stencil_stream.cu", ("-DSTENCIL_BF16=1",)),
             "stencil_f32_batch": ("stencil_stream.cu",
                                   ("-DSTENCIL_BF16=0", "-DSTENCIL_BATCH=1")),
             "stencil_bf16_batch": ("stencil_stream.cu",
                                    ("-DSTENCIL_BF16=1", "-DSTENCIL_BATCH=1")),
             "flash_fwd": ("flash_fwd.cu", ()),
             "flash_bwd": ("flash_bwd.cu", ())}


#: batch members of one ``stencil_stream.cu`` launch (its ``kMaxBatch``:
#: the members run along ``gridDim.z``, at most 65535 blocks)
MAX_BATCH = 65535
#: capacities of ``stencil_stream.cu``'s ``Program`` table (its ``kMax*``),
#: the one passed as a kernel parameter: unrolled entries, stages, taps,
#: coefficients, field streams of a DAG and inputs of one entry (a program
#: past any of them takes the large-table route, :func:`program_type`)
MAX_ENTRIES, MAX_STAGES, MAX_TAPS, MAX_COEFFS = 64, 16, 128, 192
MAX_FIELDS, MAX_INPUTS = 4, 4
#: the largest lag, ring slot and tap offset the parameter table's 16-bit
#: and 8-bit fields hold (a program past them takes the large-table route,
#: whose fields are 32-bit)
SHORT_MAX, BYTE_MAX = 2 ** 15 - 1, 2 ** 7 - 1
#: sizes of ``stencil_stream.cu``'s ``Program`` and of the per-entry records
#: its chain body (``Rec``, ``TickRec``) and DAG body (``DagRec``,
#: ``DagTick``; ``BigDagRec``, ``BigDagTick`` in the large-table route) keep
#: in shared memory, which its ``static_assert``s hold to these numbers
PROGRAM_BYTES = 3616
REC_BYTES, TICKREC_BYTES = 96, 32
DAGREC_BYTES, DAGTICK_BYTES = 112, 48
BIG_DAGREC_BYTES, BIG_DAGTICK_BYTES = 96, 16
#: static shared memory of each table-driven body of ``stencil_stream.cu``:
#: its records per entry, taps and coefficients (the main-path body has
#: none)
TABLE_SMEM = {"chain": ((REC_BYTES + TICKREC_BYTES) * MAX_ENTRIES
                        + 4 * MAX_TAPS + 4 * MAX_COEFFS),
              "dag": ((DAGREC_BYTES + DAGTICK_BYTES) * MAX_ENTRIES
                      + 4 * MAX_TAPS + 4 * MAX_COEFFS)}


def big_table_bytes(body: str, n_entries: int, n_taps: int, n_coeffs: int,
                    n_inputs: int = 0) -> int:
    """Dynamic shared memory in front of the rings in the large-table
    route (``stencil_stream.cu``'s ``table_bytes``): per entry the body's
    record and tick record, then, for a DAG, each input's ring (8 bytes)
    and its offset at the tick (4), and the taps (16 bytes) and
    coefficients, rounded up to 16 bytes."""
    rec, per_input = ((REC_BYTES + TICKREC_BYTES, 0) if body == "chain"
                      else (BIG_DAGREC_BYTES + BIG_DAGTICK_BYTES, 12))
    return -(-(n_entries * rec + per_input * n_inputs + 16 * n_taps
               + 4 * n_coeffs) // 16) * 16


class Params(ctypes.Structure):
    """``struct Params`` of ``stencil_stream.cu``, passed by value; the
    launcher fills ``vt`` and ``rows`` (``builder.cta_shape``); ``seg``,
    ``warm``, ``nby`` and ``look`` are the stream split and the copies
    ahead of the main path's register form and the chain body's
    one-barrier form (``builder.StreamSplit``); ``win`` runs a DAG (1) or
    a chain (1 + the entries it unrolls, ``builder.chain_unroll``) in a
    one-barrier form (``builder.win_form``), whose taps need not clip
    ``rad`` (the largest stage radius) cells inside the block and the
    stream."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "ns", "dom", "V", "ticks", "py", "px", "by", "bx", "cy", "cx", "dy",
        "dx", "hy", "hx", "steps", "n_entries", "n_fields", "vt", "rows",
        "seg", "warm", "nby", "look", "win", "rad")]


class Entry(ctypes.Structure):
    """``struct Entry`` of ``stencil_stream.cu``: one unrolled entry."""
    _fields_ = ([(name, ctypes.c_short) for name in (
        "lag", "stage", "iteration", "field", "out_base", "out_slots",
        "n_in", "pad")]
                + [("in_base", ctypes.c_short * MAX_INPUTS),
                   ("in_slots", ctypes.c_short * MAX_INPUTS)])


class Stage(ctypes.Structure):
    """``struct Stage`` of ``stencil_stream.cu``: one stage's op, its
    boundary kind per axis (stream, blocked y, blocked x) and its constant
    fill."""
    _fields_ = ([(name, ctypes.c_short) for name in (
        "op", "coeff_lo", "tap_lo", "tap_n")]
                + [(name, ctypes.c_byte) for name in ("ks", "ky", "kx",
                                                      "pad")]
                + [("fill", ctypes.c_float)])


class Tap(ctypes.Structure):
    """``struct Tap`` of ``stencil_stream.cu``: one offset and its
    stage-local coefficient index."""
    _fields_ = [("ds", ctypes.c_byte), ("dy", ctypes.c_byte),
                ("dx", ctypes.c_byte), ("ci", ctypes.c_ubyte)]


class Stream(ctypes.Structure):
    """``struct Stream`` of ``stencil_stream.cu``: one field stream of a
    DAG, its ring and whether it is written out unchanged."""
    _fields_ = [(name, ctypes.c_short) for name in (
        "base", "slots", "out", "pad")]


class Program(ctypes.Structure):
    """``struct Program`` of ``stencil_stream.cu``: the chain's or DAG's
    tables, passed to the kernel by value."""
    _fields_ = [("e", Entry * MAX_ENTRIES), ("s", Stage * MAX_STAGES),
                ("taps", Tap * MAX_TAPS), ("c", ctypes.c_float * MAX_COEFFS),
                ("f", Stream * MAX_FIELDS)]


assert ctypes.sizeof(Program) == PROGRAM_BYTES, "Program mirror drifted"


class BigEntry(ctypes.Structure):
    """``struct BigEntry`` of ``stencil_stream.cu``: one unrolled entry of
    the large-table route, its ``n_in`` inputs from ``in_lo`` on in the
    table's ``ins``."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "lag", "stage", "iteration", "field", "out_base", "out_slots",
        "n_in", "in_lo")]


class Input(ctypes.Structure):
    """``struct Input`` of ``stencil_stream.cu``: an input's ring (first
    slot and depth, in slabs) in the large-table route."""
    _fields_ = [("base", ctypes.c_int), ("slots", ctypes.c_int)]


class BigTap(ctypes.Structure):
    """``struct BigTap`` of ``stencil_stream.cu``: :class:`Tap` of the
    large-table route."""
    _fields_ = [(name, ctypes.c_int) for name in ("ds", "dy", "dx", "ci")]


class BigStream(ctypes.Structure):
    """``struct BigStream`` of ``stencil_stream.cu``: :class:`Stream` of
    the large-table route."""
    _fields_ = [(name, ctypes.c_int) for name in ("base", "slots", "out",
                                                   "pad")]


@functools.cache
def program_type(n_entries: int, n_stages: int, n_taps: int, n_coeffs: int,
                 n_fields: int, n_inputs: int) -> type:
    """The large-table route's table (for a program past a capacity of
    ``Program``): entries, stages, taps, coefficients, field streams and
    the entries' inputs, of these lengths and back to back, the device
    buffer ``stencil_stream_launch_big`` reads."""
    return type("ProgramOf", (ctypes.Structure,), {"_fields_": [
        ("e", BigEntry * n_entries), ("s", Stage * n_stages),
        ("taps", BigTap * n_taps), ("c", ctypes.c_float * n_coeffs),
        ("f", BigStream * n_fields), ("ins", Input * n_inputs)]})


class FlashParams(ctypes.Structure):
    """``struct FlashParams`` of ``flash_fwd.cu``, passed by value."""
    _fields_ = ([(name, ctypes.c_void_p) for name in ("q", "k", "v", "o",
                                                      "lse")]
                + [(f"{t}_s{d}", ctypes.c_longlong) for t in "qkvo"
                   for d in "bsh"]
                + [(name, ctypes.c_int) for name in ("B", "H", "Hkv", "Sq",
                                                     "Skv", "D", "causal",
                                                     "dtype")]
                + [("scale", ctypes.c_float), ("scale_log2", ctypes.c_float)])


class FlashBwdParams(ctypes.Structure):
    """``struct FlashBwdParams`` of ``flash_bwd.cu``, passed by value."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "o", "dout", "lse", "delta", "dq", "dk", "dv")]
                + [(f"{t}_s{d}", ctypes.c_longlong)
                   for t in ("q", "k", "v", "o", "do", "dq", "dk", "dv")
                   for d in "bsh"]
                + [(name, ctypes.c_int) for name in ("B", "H", "Hkv", "Sq",
                                                     "Skv", "D", "causal",
                                                     "dtype")]
                + [("scale", ctypes.c_float), ("scale_log2", ctypes.c_float)])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME or "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def _digest(*parts: bytes) -> str:
    return hashlib.sha256(b"".join(parts)).hexdigest()[:16]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_files(source: str) -> list:
    """``csrc/<source>`` and every header of ``csrc/`` it includes, directly
    or through another, in the order first included."""
    files, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in files or not (CSRC / name).is_file():
            continue
        files.append(name)
        todo += [m.decode() for m in
                 _INCLUDE.findall((CSRC / name).read_bytes())]
    return files


def library_path(stem: str) -> Path:
    """Where the library ``stem`` of :data:`LIBRARIES` lives: its name
    carries a hash of the source text, of the ``csrc/`` headers it includes
    and of the compiler flags."""
    source, flags = LIBRARIES[stem]
    digest = _digest(*((CSRC / name).read_bytes()
                       for name in _source_files(source)),
                     " ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"lib{stem}_{digest}.so"


_LOCKS: dict = {}
_LOCKS_LOCK = threading.Lock()


def _lock(lib: Path) -> threading.Lock:
    with _LOCKS_LOCK:
        return _LOCKS.setdefault(lib, threading.Lock())


def _write(path: Path, text: str) -> None:
    """Write ``path`` atomically."""
    fd, tmp = tempfile.mkstemp(dir=path.parent)
    with os.fdopen(fd, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def _compile(lib: Path, source: str, flags: tuple,
             header: Optional[str] = None) -> Path:
    """Compile ``csrc/<source>`` with ``flags`` into ``lib`` unless it
    exists, under ``lib``'s lock; ``header``, the generated
    ``stencil_custom.cuh``, goes into a directory beside ``lib`` on the
    include path.  The compiler's report (``-Xptxas -v``: registers, shared
    memory, spills) is kept in a ``.log`` beside the library."""
    with _lock(lib):
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if header is not None:
            inc = lib.with_suffix("")
            inc.mkdir(exist_ok=True)
            _write(inc / "stencil_custom.cuh", header)
            flags = flags + ("-I", str(inc))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, *flags, "-o", tmp,
                 str(CSRC / source)],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stderr}")
            lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)  # atomic: other processes never race
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return lib


def build(stem: str) -> Path:
    """Compile the library ``stem`` of :data:`LIBRARIES` unless it
    exists."""
    source, flags = LIBRARIES[stem]
    return _compile(library_path(stem), source, flags)


def custom_flags(bf16: bool, batch: bool, body: int, form: int, bcs: bool,
                 big: bool, unroll: int = 0) -> tuple:
    """The ``nvcc`` defines of a custom library: its storage type and batch
    offsets, and the one kernel it instantiates (``stencil_stream.cu``'s
    body id, ``Form`` or ``kWinForm`` for a one-barrier form, boundary
    work, large-table route, and the entries the chain body's one-barrier
    form unrolls, ``builder.chain_unroll``)."""
    return (f"-DSTENCIL_BF16={int(bf16)}", f"-DSTENCIL_BATCH={int(batch)}",
            "-DSTENCIL_CUSTOM=1", f"-DCUSTOM_BODY={body}",
            f"-DCUSTOM_FORM={form}", f"-DCUSTOM_BC={int(bcs)}",
            f"-DCUSTOM_BIG={int(big)}", f"-DCUSTOM_KT={int(unroll)}")


def custom_library_path(header: str, flags: tuple) -> Path:
    """Where the library of a program with custom stencils lives: named by
    a hash of the generated ``header``, ``stencil_stream.cu`` and the
    flags (never by a stencil's name: two stencils may share one)."""
    digest = _digest(header.encode(),
                     *((CSRC / name).read_bytes()
                       for name in _source_files("stencil_stream.cu")),
                     " ".join(NVCC_FLAGS + flags).encode())
    return BUILD_DIR / f"libstencil_custom_{digest}.so"


def build_custom(header: str, flags: tuple) -> Path:
    """Compile ``stencil_stream.cu`` with ``flags`` (:func:`custom_flags`)
    and the generated ``header`` unless the library exists."""
    return _compile(custom_library_path(header, flags), "stencil_stream.cu",
                    flags, header)


def _bind_stencil(dll: ctypes.CDLL) -> ctypes.CDLL:
    """``dll`` (a ``stencil_stream.cu`` library) with the signatures of its
    launchers."""
    dll.stencil_stream_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, Params,
        ctypes.POINTER(Program), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_size_t, ctypes.c_void_p]
    dll.stencil_stream_launch.restype = ctypes.c_int
    dll.stencil_stream_launch_big.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, Params, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_size_t, ctypes.c_void_p]
    dll.stencil_stream_launch_big.restype = ctypes.c_int
    dll.stencil_stream_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int, Params, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_size_t]
    dll.stencil_stream_occupancy.restype = ctypes.c_int
    dll.stencil_stream_error_string.argtypes = [ctypes.c_int]
    dll.stencil_stream_error_string.restype = ctypes.c_char_p
    return dll


@functools.cache
def stencil_stream(bf16: bool = False, batch: bool = False) -> ctypes.CDLL:
    """The loaded ``stencil_stream.cu`` library of float32 or (``bf16``)
    bfloat16 storage, for single grids or (``batch``) batches of two or
    more, built at first use."""
    stem = ("stencil_bf16" if bf16 else "stencil_f32") + (
        "_batch" if batch else "")
    return _bind_stencil(ctypes.CDLL(str(build(stem))))


@functools.cache
def custom_stencil_stream(header: str, flags: tuple) -> ctypes.CDLL:
    """The loaded library of a program with custom stencils
    (:func:`build_custom`), built at first use."""
    return _bind_stencil(ctypes.CDLL(str(build_custom(header, flags))))


@functools.cache
def flash_fwd() -> ctypes.CDLL:
    """The loaded ``flash_fwd.cu`` library, built at first use."""
    dll = ctypes.CDLL(str(build("flash_fwd")))
    dll.flash_fwd_launch.argtypes = [FlashParams, ctypes.c_void_p]
    dll.flash_fwd_launch.restype = ctypes.c_int
    dll.flash_fwd_has_form.argtypes = [ctypes.c_int, ctypes.c_int]
    dll.flash_fwd_has_form.restype = ctypes.c_int
    dll.flash_fwd_error_string.argtypes = [ctypes.c_int]
    dll.flash_fwd_error_string.restype = ctypes.c_char_p
    return dll


@functools.cache
def flash_bwd() -> ctypes.CDLL:
    """The loaded ``flash_bwd.cu`` library, built at first use."""
    dll = ctypes.CDLL(str(build("flash_bwd")))
    for fn in (dll.flash_bwd_dq_launch, dll.flash_bwd_dkv_launch):
        fn.argtypes = [FlashBwdParams, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    dll.flash_bwd_has_form.argtypes = [ctypes.c_int, ctypes.c_int]
    dll.flash_bwd_has_form.restype = ctypes.c_int
    dll.flash_bwd_error_string.argtypes = [ctypes.c_int]
    dll.flash_bwd_error_string.restype = ctypes.c_char_p
    return dll


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\w+)'")


def _kernel_label(mangled: str, all_args: bool = False) -> str:
    """``name<D>`` of a kernel's mangled name: the last of its
    length-prefixed name components (after any namespaces, the unnamed
    one included) and its first int template argument, if it has one
    (``all_args``: ``name<a,b,...>``, all its int and bool arguments); the
    mangled name where it has no components."""
    at = 3 if mangled.startswith("_ZN") else 2
    name = None
    while at < len(mangled) and mangled[at].isdigit():
        digits = re.match(r"\d+", mangled[at:]).group()
        at += len(digits)
        name = mangled[at:at + int(digits)]
        at += int(digits)
    if name is None:
        return mangled
    if all_args:
        args = re.findall(r"L[ib](-?\d+|n\d+)E", mangled[at:])
        return f"{name}<{','.join(a.replace('n', '-') for a in args)}>"
    arg = re.match(r"ILi(\d+)E", mangled[at:])
    return f"{name}<{arg.group(1)}>" if arg else name


def ptxas_report(lib: Path, all_args: bool = False) -> list:
    """``(kernel, report)`` for each kernel of ``lib``'s build log
    (``-Xptxas -v``): the kernel as :func:`_kernel_label` names it (with
    ``all_args``, by all its int and bool template arguments), and its
    stack, spill and register lines joined."""
    out, name, lines = [], None, []
    for line in lib.with_suffix(".log").read_text().splitlines():
        entry = _PTXAS_ENTRY.search(line)
        if entry:
            if name is not None:
                out.append((name, "; ".join(lines)))
            name, lines = _kernel_label(entry.group(1), all_args), []
        elif name is not None and ("registers" in line or "spill" in line):
            lines.append(line.replace("ptxas info    :", "").strip())
    if name is not None:
        out.append((name, "; ".join(lines)))
    return out
