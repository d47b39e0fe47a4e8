"""Builds and loads the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` at first use into ``build/repro_torch/`` at the root of the
checkout, under a name that carries a hash of the source and the flags, and
loaded with ``ctypes``.  Only the sources in the repository are used.
Nothing here runs at import time: this module imports on machines without
``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


class Coeffs(ctypes.Structure):
    """``struct Coeffs`` of ``stencil_stream.cu``, passed by value."""
    _fields_ = [("c", ctypes.c_float * 8)]


class Params(ctypes.Structure):
    """``struct Params`` of ``stencil_stream.cu``, passed by value."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "ns", "ticks", "py", "px", "by", "bx", "cy", "cx", "dy", "dx",
        "hy", "hx", "par_time", "steps")]


class FlashParams(ctypes.Structure):
    """``struct FlashParams`` of ``flash_fwd.cu``, passed by value."""
    _fields_ = ([(name, ctypes.c_void_p) for name in ("q", "k", "v", "o",
                                                      "lse")]
                + [(f"{t}_s{d}", ctypes.c_longlong) for t in "qkvo"
                   for d in "bsh"]
                + [(name, ctypes.c_int) for name in ("B", "H", "Hkv", "Sq",
                                                     "Skv", "D", "causal")]
                + [("scale_log2", ctypes.c_float)])


class FlashBwdParams(ctypes.Structure):
    """``struct FlashBwdParams`` of ``flash_bwd.cu``, passed by value."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "o", "dout", "lse", "delta", "dq", "dk", "dv")]
                + [(f"{t}_s{d}", ctypes.c_longlong)
                   for t in ("q", "k", "v", "o", "do", "dq", "dk", "dv")
                   for d in "bsh"]
                + [(name, ctypes.c_int) for name in ("B", "H", "Hkv", "Sq",
                                                     "Skv", "D", "causal")]
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


def library_path(source: str, stem: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: its name
    carries a hash of the source text and the compiler flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}_{digest[:16]}.so"


def build(source: str, stem: str) -> Path:
    """Compile ``csrc/<source>`` unless its library exists.  The compiler's
    report (``-Xptxas -v``: registers, shared memory, spills) is kept in a
    ``.log`` beside the library."""
    lib = library_path(source, stem)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)      # atomic: concurrent builders never race
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def stencil_stream() -> ctypes.CDLL:
    """The loaded ``stencil_stream.cu`` library, built at first use."""
    dll = ctypes.CDLL(str(build("stencil_stream.cu", "stencil")))
    dll.stencil_stream_launch.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        Params, Coeffs, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
        ctypes.c_void_p]
    dll.stencil_stream_launch.restype = ctypes.c_int
    dll.stencil_stream_error_string.argtypes = [ctypes.c_int]
    dll.stencil_stream_error_string.restype = ctypes.c_char_p
    return dll


@functools.cache
def flash_fwd() -> ctypes.CDLL:
    """The loaded ``flash_fwd.cu`` library, built at first use."""
    dll = ctypes.CDLL(str(build("flash_fwd.cu", "flash_fwd")))
    dll.flash_fwd_launch.argtypes = [FlashParams, ctypes.c_void_p]
    dll.flash_fwd_launch.restype = ctypes.c_int
    dll.flash_fwd_error_string.argtypes = [ctypes.c_int]
    dll.flash_fwd_error_string.restype = ctypes.c_char_p
    return dll


@functools.cache
def flash_bwd() -> ctypes.CDLL:
    """The loaded ``flash_bwd.cu`` library, built at first use."""
    dll = ctypes.CDLL(str(build("flash_bwd.cu", "flash_bwd")))
    for fn in (dll.flash_bwd_dq_launch, dll.flash_bwd_dkv_launch):
        fn.argtypes = [FlashBwdParams, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    dll.flash_bwd_error_string.argtypes = [ctypes.c_int]
    dll.flash_bwd_error_string.restype = ctypes.c_char_p
    return dll
