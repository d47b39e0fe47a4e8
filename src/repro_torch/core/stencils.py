"""Stencil zoo — the four paper benchmarks (Table 2) plus generic shapes.

A stencil is described by its neighbourhood (radius and offsets), an
``apply`` function written against an abstract neighbour *getter* (so the
oracle, the plain super-step and the CUDA kernel's arithmetic share one
definition of the operation order), and the Table 2 bookkeeping constants.

``apply`` works on torch tensors: the getter maps an offset tuple
``(ds, dx)`` / ``(ds, dy, dx)`` (stream axis first) to the shifted tensor of
that neighbour for every updated cell, and coefficients are float32 0-d
tensors.  The operation order of each builtin is the order of the reference
package's stencils, and ``kernels/csrc/stencil_stream.cu`` repeats it op for
op.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Mapping, Sequence

import torch

Getter = Callable[[Sequence[int]], torch.Tensor]

TEMP_AMB = 80.0  # Hotspot ambient temperature (paper §5.1)


def _star_offsets(ndim: int, radius: int) -> tuple:
    """Axis-aligned (star) neighbourhood: centre + ±1..radius on each axis."""
    offs = []
    for axis in range(ndim):
        for d in range(-radius, radius + 1):
            off = [0] * ndim
            off[axis] = d
            offs.append(tuple(off))
    return tuple(dict.fromkeys(offs))


@dataclasses.dataclass(frozen=True)
class Stencil:
    name: str
    ndim: int                     # 1, 2 or 3
    radius: int
    flop_pcu: int                 # FLOPs per cell update      (Table 2)
    num_read: int                 # external reads per update  (Table 2)
    num_write: int                # external writes per update (Table 2)
    has_aux: bool                 # second input stream (Hotspot `power`)
    coeff_names: tuple            # scalar coefficients, passed at run time
    apply: Callable               # (get, coeffs, aux_center) -> new center
    #: neighbour offsets ``apply`` touches (default: the star of ``radius``)
    offsets: tuple = ()
    #: number of input grids ``apply`` reads (a tuple of getters if > 1)
    arity: int = 1

    def __post_init__(self):
        if self.arity < 1:
            raise ValueError(f"{self.name}: arity must be >= 1")
        offs = self.offsets or _star_offsets(self.ndim, self.radius)
        object.__setattr__(self, "offsets",
                           tuple(tuple(int(d) for d in o) for o in offs))
        if any(len(o) != self.ndim for o in self.offsets):
            raise ValueError(f"{self.name}: offsets must be {self.ndim}-D")
        span = max((abs(d) for o in self.offsets for d in o), default=0)
        if span > self.radius:
            raise ValueError(
                f"{self.name}: offset span {span} exceeds radius "
                f"{self.radius} — halo sizing (rad*par_time) would be wrong")


def _diffusion2d(get: Getter, c: Mapping[str, torch.Tensor], aux=None):
    # c_c*val_c + c_w*val_w + c_e*val_e + c_s*val_s + c_n*val_n  (9 FLOPs)
    return (c["cc"] * get((0, 0)) + c["cw"] * get((0, -1))
            + c["ce"] * get((0, 1)) + c["cs"] * get((1, 0))
            + c["cn"] * get((-1, 0)))


def _diffusion3d(get: Getter, c: Mapping[str, torch.Tensor], aux=None):
    # 7-point star (13 FLOPs); b(elow)/a(bove) are the stream neighbours
    return (c["cc"] * get((0, 0, 0))
            + c["cw"] * get((0, 0, -1)) + c["ce"] * get((0, 0, 1))
            + c["cs"] * get((0, 1, 0)) + c["cn"] * get((0, -1, 0))
            + c["cb"] * get((-1, 0, 0)) + c["ca"] * get((1, 0, 0)))


def _hotspot2d(get: Getter, c: Mapping[str, torch.Tensor], aux=None):
    # val_c + sdc*(power_c + (n+s-2c)*Ry1 + (e+w-2c)*Rx1 + (AMB-c)*Rz1)
    v = get((0, 0))
    return v + c["sdc"] * (
        aux
        + (get((-1, 0)) + get((1, 0)) - 2.0 * v) * c["ry1"]
        + (get((0, 1)) + get((0, -1)) - 2.0 * v) * c["rx1"]
        + (TEMP_AMB - v) * c["rz1"])


def _hotspot3d(get: Getter, c: Mapping[str, torch.Tensor], aux=None):
    # c*cc + n*cn + s*cs + e*ce + w*cw + a*ca + b*cb + sdc*power + ca*AMB
    return (get((0, 0, 0)) * c["cc"]
            + get((0, -1, 0)) * c["cn"] + get((0, 1, 0)) * c["cs"]
            + get((0, 0, 1)) * c["ce"] + get((0, 0, -1)) * c["cw"]
            + get((1, 0, 0)) * c["ca"] + get((-1, 0, 0)) * c["cb"]
            + c["sdc"] * aux + c["ca"] * TEMP_AMB)


DIFFUSION2D = Stencil("diffusion2d", 2, 1, 9, 1, 1, False,
                      ("cc", "cw", "ce", "cs", "cn"), _diffusion2d)
DIFFUSION3D = Stencil("diffusion3d", 3, 1, 13, 1, 1, False,
                      ("cc", "cw", "ce", "cs", "cn", "cb", "ca"), _diffusion3d)
HOTSPOT2D = Stencil("hotspot2d", 2, 1, 15, 2, 1, True,
                    ("sdc", "rx1", "ry1", "rz1"), _hotspot2d)
HOTSPOT3D = Stencil("hotspot3d", 3, 1, 17, 2, 1, True,
                    ("cc", "cn", "cs", "ce", "cw", "ca", "cb", "sdc"),
                    _hotspot3d)

STENCILS = {s.name: s for s in (DIFFUSION2D, DIFFUSION3D, HOTSPOT2D,
                                HOTSPOT3D)}


def make_combine(ndim: int, arity: int) -> Stencil:
    """Radius-0 elementwise combine ``w0*x0 + ... + w_{n-1}*x_{n-1}`` — the
    fan-in node of a program DAG; ``apply`` receives one getter per input."""
    if arity < 2:
        raise ValueError("make_combine needs arity >= 2 (use make_star(nd, 0)"
                         " for a single-input scale)")
    names = tuple(f"w{i}" for i in range(arity))
    center = tuple([0] * ndim)

    def _apply(gets, c, aux=None):
        out = c["w0"] * gets[0](center)
        for i in range(1, arity):
            out = out + c[f"w{i}"] * gets[i](center)
        return out

    return Stencil(f"combine{ndim}d_x{arity}", ndim, 0, 2 * arity - 1,
                   arity, 1, False, names, _apply, offsets=(center,),
                   arity=arity)


def make_star(ndim: int, radius: int) -> Stencil:
    """Generic star stencil of any radius:
    ``u' = c0*u + sum_{axis, d != 0} c_{axis}_{d} * u[d on axis]``."""
    names = ["c0"]
    offs = []
    for axis in range(ndim):
        for d in range(-radius, radius + 1):
            if d == 0:
                continue
            names.append(f"c_{axis}_{d}")
            off = [0] * ndim
            off[axis] = d
            offs.append((f"c_{axis}_{d}", tuple(off)))
    flops = 2 * (len(offs) + 1) - 1

    def _apply(get, c, aux=None, _offs=tuple(offs)):
        out = c["c0"] * get(tuple([0] * ndim))
        for cname, off in _offs:
            out = out + c[cname] * get(off)
        return out

    return Stencil(f"star{ndim}d_r{radius}", ndim, radius, flops, 1, 1, False,
                   tuple(names), _apply,
                   offsets=(tuple([0] * ndim),) + tuple(o for _, o in offs))


STAR1D_R1 = make_star(1, 1)
STAR1D_R2 = make_star(1, 2)
STENCILS[STAR1D_R1.name] = STAR1D_R1
STENCILS[STAR1D_R2.name] = STAR1D_R2


def make_box(ndim: int, radius: int) -> Stencil:
    """Generic box stencil: every cell of the L-inf ball of ``radius``
    contributes; coefficients are named ``b_{offsets joined by _}``."""
    names = []
    offs = []
    for off in itertools.product(range(-radius, radius + 1), repeat=ndim):
        name = "b_" + "_".join(str(d) for d in off)
        names.append(name)
        offs.append((name, tuple(off)))
    flops = 2 * len(offs) - 1

    def _apply(get, c, aux=None, _offs=tuple(offs)):
        first, rest = _offs[0], _offs[1:]
        out = c[first[0]] * get(first[1])
        for cname, off in rest:
            out = out + c[cname] * get(off)
        return out

    return Stencil(f"box{ndim}d_r{radius}", ndim, radius, flops, 1, 1, False,
                   tuple(names), _apply, offsets=tuple(o for _, o in offs))


def _default_values(stencil: Stencil) -> dict:
    """Physically plausible coefficients as Python floats."""
    if stencil.name == "diffusion2d":
        k = 0.125
        return {"cc": 1 - 4 * k, "cw": k, "ce": k, "cs": k, "cn": k}
    if stencil.name == "diffusion3d":
        k = 0.0833
        return {"cc": 1 - 6 * k, "cw": k, "ce": k, "cs": k, "cn": k,
                "cb": k, "ca": k}
    if stencil.name == "hotspot2d":
        return {"sdc": 0.054, "rx1": 0.1, "ry1": 0.1, "rz1": 0.0137}
    if stencil.name == "hotspot3d":
        k = 0.07
        return {"cc": 1 - 6 * k - 0.01, "cn": k, "cs": k, "ce": k, "cw": k,
                "ca": k, "cb": k, "sdc": 0.054}
    if stencil.name.startswith(("combine", "box")):
        # uniform convex combination (stable: weights sum to 1)
        n = len(stencil.coeff_names)
        return {name: 1.0 / n for name in stencil.coeff_names}
    # generic star: diffusion-like, stable
    n = len(stencil.coeff_names) - 1
    k = 0.5 / max(n, 1)
    return {"c0": 0.5, **{name: k for name in stencil.coeff_names[1:]}}


def default_coeffs(stencil: Stencil, dtype=torch.float32,
                   device="cpu") -> dict:
    """Default coefficients as 0-d tensors of ``dtype`` on ``device``."""
    return {name: torch.tensor(v, dtype=dtype, device=device)
            for name, v in _default_values(stencil).items()}
