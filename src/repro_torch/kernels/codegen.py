"""Stencils with a custom ``apply``, traced and written out as CUDA.

``repro`` needs no counterpart of this module: Pallas traces whatever
``apply`` computes in ``jnp`` into the TPU kernel (``repro/kernels/
builder.py``'s ``_dag_kernel`` calls ``entry.stencil.apply``).  The
streaming kernel's bodies are compiled ahead of the program, so a stencil
that is neither a Table-2 stencil, a tap sum nor a combine is run by a
device function written from its own ``apply``:

* :func:`trace` calls ``apply`` once with symbolic getters (one per input),
  symbolic coefficients (``c[name]`` stands for the stage's coefficient of
  that index) and a symbolic ``aux``, and records every torch call it makes,
  in the order it makes them (:class:`Trace`).  The symbols implement ``+
  - * /``, unary ``-``, ``abs``, ``**`` with the exponents of
  :data:`POWERS`, comparisons, Python number constants, and, through
  ``__torch_function__`` or as methods, the functions of :data:`FUNCTIONS`.
  A taps' offsets must lie within the stencil's radius, and the result must
  be one float32 value per cell.  Anything else is refused by name
  (:data:`ITEM`): branching on a value (``__bool__``), an op outside the
  list, a tap outside the radius, another result.
* :func:`evaluate` replays a trace with the same torch calls on real
  tensors; it equals ``apply`` bit for bit, which the tests hold.
* :func:`program_header` writes the device functions of a program's custom
  stencils into the header that ``csrc/stencil_stream.cu`` includes when it
  is built with ``-DSTENCIL_CUSTOM=1``: ``custom::custom_apply(fn, g, c,
  aux)``, a switch over them.  ``g(z, ds, dy, dx)`` is input ``z``'s widened
  tap at that stream, y and x offset, ``c`` the stage's coefficients and
  ``aux()`` the widened aux value.

The CUDA text computes what torch's own CUDA kernels compute on the plain
version's operands, so that the kernel and its plain version agree bit for
bit on the card: every ``+ - * /`` is one IEEE rounding
(``__fadd_rn``/``__fsub_rn``/``__fmul_rn``/``__fdiv_rn``, which nvcc never
contracts into FMAs), in the traced order; ``x ** 2`` and ``x ** 3`` are
products, ``x ** -1`` and ``x ** -2`` a division of 1 (as torch's pow
kernels specialise them); a per-cell value divided by a scalar (a
coefficient, a constant, or a value of those only, which the plain version
holds as a CPU scalar) is multiplied by the scalar's reciprocal, as torch's
CUDA division does for a CPU scalar divisor; ``maximum``/``minimum`` return
a NaN operand.  Constants are rounded to float32 as torch rounds a Python
number for a float32 tensor.  The transcendentals call CUDA's ``expf``,
``logf``, ... which agree with torch's CUDA kernels to within an ulp or
two (PyTorch's CPU kernels use other approximations).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from collections.abc import Mapping
from typing import NamedTuple, Tuple

import numpy as np
import torch

#: the ROADMAP item that names what cannot be lowered
ITEM = "ROADMAP B1i-ops"
#: the exponents ``x ** e`` lowers (torch's pow kernels specialise them)
POWERS = (0, 1, 2, 3, -1, -2)
#: unary functions -> their CUDA call
UNARY_CUDA = {"exp": "expf", "log": "logf", "sqrt": "sqrtf", "tanh": "tanhf",
              "sin": "sinf", "cos": "cosf", "abs": "fabsf"}
#: the functions a symbol takes through ``__torch_function__`` or as a
#: method, besides the operators
FUNCTIONS = ("where", "maximum", "minimum", "clamp") + tuple(UNARY_CUDA)
_COMPARE = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==",
            "ne": "!="}
_ARITH = {"add": "__fadd_rn", "sub": "__fsub_rn", "mul": "__fmul_rn"}
#: a torch function's or Tensor method's name -> the op it records
_TORCH_OPS = {"add": "add", "radd": "add", "sub": "sub", "rsub": "rsub",
              "mul": "mul", "rmul": "mul", "div": "div", "truediv": "div",
              "true_divide": "div", "rtruediv": "rtruediv",
              "rdiv": "rtruediv", "neg": "neg", "negative": "neg",
              "pow": "pow", **{f: f for f in FUNCTIONS}}


def refuse(what: str) -> ValueError:
    return ValueError(f"{what} ({ITEM})")


class Node(NamedTuple):
    """One value of a trace.  ``op``: ``tap`` (``attr = (input, offset)``),
    ``aux``, ``coef`` (``attr = (index,)``), ``const`` (``attr =
    (float32 value,)``), ``recip``, ``pow`` (``attr = (exponent,)``),
    ``clamp`` (``attr = (has min, has max)``), or a function of
    :data:`FUNCTIONS`, ``add``/``sub``/``mul``/``div``, ``neg`` or a
    comparison; ``args`` the operands' node indices.  ``cell``: a value per
    cell (it depends on a tap or the aux); ``boolean``: a comparison."""
    op: str
    args: Tuple[int, ...] = ()
    attr: tuple = ()
    cell: bool = False
    boolean: bool = False


@dataclasses.dataclass(frozen=True)
class Trace:
    """The torch calls one ``apply`` makes, in order; ``out`` its
    result."""
    name: str
    ndim: int
    radius: int
    arity: int
    coeff_names: tuple
    nodes: Tuple[Node, ...]
    out: int


class _Coeffs(Mapping):
    def __init__(self, tr, names):
        self._tr, self._names, self._read = tr, names, {}

    def __getitem__(self, name):
        if name not in self._names:
            raise refuse(f"{self._tr.name}: apply reads coefficient "
                         f"{name!r}, not one of {list(self._names)}")
        if name not in self._read:
            self._read[name] = self._tr.node(
                "coef", (), (self._names.index(name),))
        return self._read[name]

    def __iter__(self):
        return iter(self._names)

    def __len__(self):
        return len(self._names)


def _f32(x) -> float:
    return float(np.float32(x))


class _Sym:
    """A traced value."""
    __slots__ = ("tr", "i")

    def __init__(self, tr, i):
        self.tr, self.i = tr, i

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", str(func)).strip("_")
        tr = next(a.tr for a in list(args) + list((kwargs or {}).values())
                  if isinstance(a, _Sym))
        return tr.call(name, args, kwargs or {})

    def __bool__(self):
        raise refuse(f"{self.tr.name}: apply branches on a traced value; "
                     f"write the choice as torch.where(cond, a, b)")

    def __add__(self, o):
        return self.tr.binary("add", self, o)

    def __radd__(self, o):
        return self.tr.binary("add", self, o)

    def __sub__(self, o):
        return self.tr.binary("sub", self, o)

    def __rsub__(self, o):
        return self.tr.binary("sub", o, self)

    def __mul__(self, o):
        return self.tr.binary("mul", self, o)

    def __rmul__(self, o):
        return self.tr.binary("mul", self, o)

    def __truediv__(self, o):
        return self.tr.binary("div", self, o)

    def __rtruediv__(self, o):
        return self.tr.call("rtruediv", (self, o), {})

    def __pow__(self, e):
        if isinstance(e, bool) or not isinstance(e, (int, float)) or (
                e not in POWERS):
            raise refuse(f"{self.tr.name}: x ** {e!r}; the exponents "
                         f"lowered are {POWERS}")
        return self.tr.unary("pow", self, (int(e),))

    def __neg__(self):
        return self.tr.unary("neg", self)

    def __pos__(self):
        return self

    def __abs__(self):
        return self.tr.unary("abs", self)

    def __lt__(self, o):
        return self.tr.binary("lt", self, o)

    def __le__(self, o):
        return self.tr.binary("le", self, o)

    def __gt__(self, o):
        return self.tr.binary("gt", self, o)

    def __ge__(self, o):
        return self.tr.binary("ge", self, o)

    def __eq__(self, o):
        return self.tr.binary("eq", self, o)

    def __ne__(self, o):
        return self.tr.binary("ne", self, o)

    __hash__ = None

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        if name in FUNCTIONS:
            return lambda *a, **kw: self.tr.call(name, (self,) + a, kw)
        raise refuse(f"{self.tr.name}: apply uses .{name}, which the "
                     f"tracer does not lower (it lowers + - * /, unary -, "
                     f"abs, ** {POWERS}, comparisons and {FUNCTIONS})")


class _Tracer:
    def __init__(self, stencil):
        self.name, self.ndim, self.radius = (stencil.name, stencil.ndim,
                                             stencil.radius)
        self.nodes, self.taps = [], {}

    def node(self, op, args=(), attr=(), boolean=False) -> _Sym:
        cell = op in ("tap", "aux") or any(self.nodes[a].cell for a in args)
        self.nodes.append(Node(op, tuple(args), tuple(attr), cell, boolean))
        return _Sym(self, len(self.nodes) - 1)

    def operand(self, x, what) -> int:
        """A node index for ``x``: a symbol of this trace or a Python
        number (a constant)."""
        if isinstance(x, _Sym):
            return x.i
        if isinstance(x, (int, float)) and not isinstance(x, bool):
            return self.node("const", (), (_f32(x),)).i
        raise refuse(f"{self.name}: {what} takes {type(x).__name__}; the "
                     f"tracer lowers float32 values and Python numbers")

    def value(self, i, what) -> int:
        if self.nodes[i].boolean:
            raise refuse(f"{self.name}: {what} takes a comparison; only "
                         f"torch.where takes one")
        return i

    def unary(self, op, x, attr=()) -> _Sym:
        return self.node(op, (self.value(self.operand(x, op), op),), attr)

    def binary(self, op, a, b) -> _Sym:
        args = tuple(self.value(self.operand(x, op), op) for x in (a, b))
        return self.node(op, args, boolean=op in _COMPARE)

    def call(self, name, args, kwargs) -> _Sym:
        """A torch function (or Tensor method) applied to symbols."""
        op = _TORCH_OPS.get(name)
        allowed = {"clamp": {"min", "max"}}.get(op, set())
        if op is None or set(kwargs) - allowed:
            kw = f"({', '.join(kwargs)}=...)" if kwargs else ""
            raise refuse(f"{self.name}: apply calls {name}{kw}, which the "
                         f"tracer does not lower (it lowers + - * /, unary "
                         f"-, abs, ** {POWERS}, comparisons and "
                         f"{FUNCTIONS})")
        if op == "clamp":
            lo, hi = (list(args[1:]) + [None, None])[:2]
            lo, hi = kwargs.get("min", lo), kwargs.get("max", hi)
            if lo is None and hi is None:
                raise refuse(f"{self.name}: torch.clamp without a bound")
            x = self.value(self.operand(args[0], "clamp"), "clamp")
            bounds = [self.value(self.operand(b, "clamp"), "clamp")
                      for b in (lo, hi) if b is not None]
            return self.node("clamp", (x, *bounds),
                             (lo is not None, hi is not None))
        if op == "where":
            cond, a, b = args
            if not (isinstance(cond, _Sym) and self.nodes[cond.i].boolean):
                raise refuse(f"{self.name}: torch.where's condition must be "
                             f"a comparison of traced values")
            if not isinstance(a, _Sym) and not isinstance(b, _Sym):
                raise refuse(f"{self.name}: torch.where of two constants is "
                             f"not a float32 value per cell")
            vals = [self.value(self.operand(x, "where"), "where")
                    for x in (a, b)]
            return self.node("where", (cond.i, *vals))
        if op in ("maximum", "minimum"):
            if not all(isinstance(x, _Sym) for x in args):
                raise refuse(f"{self.name}: torch.{op} takes two tensors")
            return self.binary(op, *args)
        if op == "rsub":
            return self.binary("sub", args[1], args[0])
        if op == "rtruediv":
            # torch's Tensor.__rtruediv__: self.reciprocal() * other
            return self.binary("mul", self.unary("recip", args[0]), args[1])
        if op == "pow":
            if not isinstance(args[0], _Sym):
                raise refuse(f"{self.name}: a number ** a traced value")
            return args[0] ** args[1]
        if op in ("add", "sub", "mul", "div"):
            return self.binary(op, *args)
        return self.unary(op, args[0])

    def getter(self, z: int):
        def get(off):
            try:
                key = tuple(int(d) for d in off)
                if any(k != d for k, d in zip(key, off)):
                    raise TypeError
            except TypeError:
                raise refuse(f"{self.name}: a tap at {off!r}; an offset is "
                             f"a tuple of {self.ndim} ints") from None
            if len(key) != self.ndim:
                raise refuse(f"{self.name}: a tap at {key} on a "
                             f"{self.ndim}D stencil")
            if max(map(abs, key), default=0) > self.radius:
                raise refuse(f"{self.name}: a tap at {key} is outside its "
                             f"radius {self.radius}")
            if (z, key) not in self.taps:
                self.taps[z, key] = self.node("tap", (), (z, key))
            return self.taps[z, key]
        return get


@functools.lru_cache(maxsize=None)
def trace(stencil) -> Trace:
    """The :class:`Trace` of ``stencil.apply``; raises ``ValueError``
    naming :data:`ITEM` for what cannot be lowered."""
    tr = _Tracer(stencil)
    gets = tuple(tr.getter(z) for z in range(stencil.arity))
    aux = tr.node("aux") if stencil.has_aux else None
    try:
        out = stencil.apply(gets if stencil.arity > 1 else gets[0],
                            _Coeffs(tr, tuple(stencil.coeff_names)), aux)
    except ValueError as e:
        if ITEM in str(e):
            raise
        raise refuse(f"{stencil.name}: apply raised {e!r} under the "
                     f"tracer") from e
    except Exception as e:
        raise refuse(f"{stencil.name}: apply raised {e!r} under the tracer "
                     f"(it lowers + - * /, unary -, abs, ** {POWERS}, "
                     f"comparisons and {FUNCTIONS})") from e
    if not isinstance(out, _Sym) or out.tr is not tr:
        raise refuse(f"{stencil.name}: apply returns "
                     f"{type(out).__name__}, not one float32 value per cell")
    node = tr.nodes[out.i]
    if node.boolean or not node.cell:
        what = ("a comparison" if node.boolean
                else "a value of the coefficients only")
        raise refuse(f"{stencil.name}: apply returns {what}, not one float32 "
                     f"value per cell")
    return Trace(stencil.name, stencil.ndim, stencil.radius, stencil.arity,
                 tuple(stencil.coeff_names), tuple(tr.nodes), out.i)


def evaluate(tr: Trace, get_or_gets, coeffs, aux=None):
    """``tr`` replayed with torch on real operands, as ``apply`` takes them
    (a getter, or a tuple of them when the arity is above 1; the
    coefficient mapping; the aux tensor): the same torch calls in the same
    order, so the result equals ``apply``'s bit for bit."""
    gets = get_or_gets if tr.arity > 1 else (get_or_gets,)
    v = []
    for nd in tr.nodes:
        a = [v[i] for i in nd.args]
        op = nd.op
        if op == "tap":
            x = gets[nd.attr[0]](nd.attr[1])
        elif op == "aux":
            x = aux
        elif op == "coef":
            x = coeffs[tr.coeff_names[nd.attr[0]]]
        elif op == "const":
            x = nd.attr[0]
        elif op in ("add", "sub", "mul", "div"):
            x = {"add": lambda p, q: p + q, "sub": lambda p, q: p - q,
                 "mul": lambda p, q: p * q,
                 "div": lambda p, q: p / q}[op](*a)
        elif op in _COMPARE:
            x = {"lt": lambda p, q: p < q, "le": lambda p, q: p <= q,
                 "gt": lambda p, q: p > q, "ge": lambda p, q: p >= q,
                 "eq": lambda p, q: p == q,
                 "ne": lambda p, q: p != q}[op](*a)
        elif op == "recip":
            x = torch.reciprocal(a[0])
        elif op == "neg":
            x = -a[0]
        elif op == "pow":
            x = a[0] ** nd.attr[0]
        elif op == "clamp":
            bounds = iter(a[1:])
            x = torch.clamp(a[0], min=next(bounds) if nd.attr[0] else None,
                            max=next(bounds) if nd.attr[1] else None)
        elif op == "where":
            x = torch.where(*a)
        else:                       # maximum, minimum and the unary ones
            x = getattr(torch, op)(*a)
        v.append(x)
    return v[tr.out]


# --- CUDA --------------------------------------------------------------------

def _literal(x: float) -> str:
    if math.isnan(x) or math.isinf(x):
        bits = int(np.array(x, np.float32).view(np.uint32))
        return f"__int_as_float(0x{bits:08x})"
    return f"{x.hex()}f"


def _live(tr: Trace) -> list:
    """Which nodes the result depends on."""
    live = [False] * len(tr.nodes)
    live[tr.out] = True
    for i in range(tr.out, -1, -1):
        if live[i]:
            for a in tr.nodes[i].args:
                live[a] = True
    return live


def _expr(tr: Trace, nd: Node, name) -> str:
    a = [name(i) for i in nd.args]
    op = nd.op
    if op == "tap":
        z, off = nd.attr
        ds, dy, dx = ((off[0], 0, 0) if tr.ndim == 1 else
                      (off[0], 0, off[1]) if tr.ndim == 2 else off)
        return f"g({z}, {ds}, {dy}, {dx})"
    if op == "aux":
        return "aux()"
    if op == "coef":
        return f"c[{nd.attr[0]}]"
    if op == "const":
        return _literal(nd.attr[0])
    if op in _ARITH:
        return f"{_ARITH[op]}({a[0]}, {a[1]})"
    if op == "div":
        # torch's CUDA division by a CPU scalar multiplies by its reciprocal
        if tr.nodes[nd.args[0]].cell and not tr.nodes[nd.args[1]].cell:
            return f"__fmul_rn({a[0]}, __fdiv_rn(1.0f, {a[1]}))"
        return f"__fdiv_rn({a[0]}, {a[1]})"
    if op == "recip":
        return f"__fdiv_rn(1.0f, {a[0]})"
    if op == "neg":
        return f"-{a[0]}"
    if op == "pow":
        x = a[0]
        return {0: "1.0f", 1: x, 2: f"__fmul_rn({x}, {x})",
                3: f"__fmul_rn(__fmul_rn({x}, {x}), {x})",
                -1: f"__fdiv_rn(1.0f, {x})",
                -2: f"__fdiv_rn(1.0f, __fmul_rn({x}, {x}))"}[nd.attr[0]]
    if op in _COMPARE:
        return f"{a[0]} {_COMPARE[op]} {a[1]}"
    if op == "where":
        return f"{a[0]} ? {a[1]} : {a[2]}"
    if op in ("maximum", "minimum"):
        return f"{'tmax' if op == 'maximum' else 'tmin'}({a[0]}, {a[1]})"
    if op == "clamp":
        x, rest = a[0], iter(a[1:])
        if nd.attr[0]:
            x = f"tmax({x}, {next(rest)})"
        if nd.attr[1]:
            x = f"tmin({x}, {next(rest)})"
        return x
    return f"{UNARY_CUDA[op]}({a[0]})"


def device_function(tr: Trace, fn: int) -> str:
    """The CUDA device function ``fn<fn>(g, c, aux)`` of ``tr``: one
    ``const`` per value the result depends on, in the traced order."""
    live = _live(tr)
    lines = [f"// {tr.name}: {tr.ndim}D, radius {tr.radius}, arity "
             f"{tr.arity}, coefficients {', '.join(tr.coeff_names) or '-'}",
             "template <class G, class A>",
             f"__device__ __forceinline__ float fn{fn}(const G& g, "
             f"const float* c, const A& aux) {{"]
    for i, nd in enumerate(tr.nodes):
        if live[i]:
            kind = "bool" if nd.boolean else "float"
            lines.append(f"  const {kind} v{i} = "
                         f"{_expr(tr, nd, lambda k: f'v{k}')};")
    lines += [f"  return v{tr.out};", "}"]
    return "\n".join(lines)


_HEADER = """\
// Generated by repro_torch/kernels/codegen.py from the `apply` of the custom
// stencils of one program; csrc/stencil_stream.cu includes it when built
// with -DSTENCIL_CUSTOM=1.  g(z, ds, dy, dx): input z's tap at that stream, y
// and x offset, widened to float; c: the stage's coefficients; aux(): the
// widened aux value.
#pragma once

namespace custom {

// torch.maximum / torch.minimum: a NaN operand is returned
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
"""


def program_header(traces) -> str:
    """The header of a program whose custom stencils are ``traces`` (the
    function index is the position): their device functions and
    ``custom_apply(fn, g, c, aux)``, which switches over them."""
    cases = [f"    case {k}:\n      return fn{k}(g, c, aux);"
             for k in range(len(traces) - 1)]
    cases.append(f"    default:\n      return fn{len(traces) - 1}(g, c, "
                 f"aux);")
    return (_HEADER + "".join(f"\n{device_function(tr, k)}\n"
                              for k, tr in enumerate(traces))
            + "\ntemplate <class G, class A>\n"
            "__device__ __forceinline__ float custom_apply(int fn, const G& "
            "g, const float* c,\n"
            "                                              const A& aux) {\n"
            "  switch (fn) {\n" + "\n".join(cases) + "\n  }\n}\n\n"
            "}  // namespace custom\n")
