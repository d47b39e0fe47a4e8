"""The DAG bodies' one-barrier form of ``csrc/stencil_stream.cu`` and their
stream split, in their pure-Python parts: ``kernels/builder.win_layout``
replayed tick by tick over seeded random DAGs (no thread reads another
thread's cell in a row written in the same tick, no ring slot or register
carry is overwritten while it is still read, and the per-entry-barrier
forms' ``programs.dag_layout`` holds the same at V 1, 2 and 4),
``programs.dag_layout`` unchanged against ``repro``'s, the values the
layout re-imposes equal to those the plain version re-imposes, and which
form ``builder.win_form`` picks for the chip's DAG cells and why it
refuses the others."""
import math
import random

import pytest

from repro import programs as jprograms
from repro.core import stencils as jstencils
from repro_torch import programs
from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.core import blocking, stencils
from repro_torch.kernels import builder

PKGS = {"repro": (jprograms.StencilStage, jprograms.StencilProgram,
                  jstencils),
        "port": (StencilStage, StencilProgram, stencils)}


def _custom(nd, rng):
    """A custom stencil of one or two inputs that taps a few random offsets
    of each within radius 1 (its ``apply`` a sum of products)."""
    arity = rng.choice([1, 2])
    taps = [[tuple(rng.randint(-1, 1) for _ in range(nd))
             for _ in range(rng.randint(1, 3))] for _ in range(arity)]
    radius = max(abs(d) for t in taps for o in t for d in o)

    def apply(gets, c, aux=None):
        gets = gets if arity > 1 else (gets,)
        acc = 0.0
        for g, offs in zip(gets, taps):
            for o in offs:
                acc = acc + c["a"] * g(o)
        return acc
    return stencils.Stencil(f"rand{nd}d_{rng.random():.6f}", nd, radius, 4,
                            arity, 1, False, ("a",), apply, arity=arity)


def _draw(rng, nd, S, P, st, custom=True):
    """A random valid DAG of 1-3 stages over 1-2 fields (stars of radius 0
    to 2, a radius-1 box, 2- and 3-way combines, custom stencils), every
    stage feeding something, every field updating: ``tests/
    test_torch_dag.py``'s draw with more stage kinds."""
    n_fields = rng.choice([1, 2])
    fields = tuple(f"f{i}" for i in range(n_fields))
    stages, names = [], []
    for i in range(rng.randint(1, 3)):
        pool = list(fields) + names
        kind = rng.choice(["star", "star", "box", "combine"]
                          + (["custom"] if custom else []))
        if kind == "star":
            stc = st.make_star(nd, rng.choice([0, 1, 2]))
        elif kind == "box":
            stc = st.make_box(nd, 1)
        elif kind == "combine":
            stc = st.make_combine(nd, rng.choice([2, 3]))
        else:
            stc = _custom(nd, rng)
        ins = tuple(rng.choice(pool) for _ in range(stc.arity))
        names.append(f"s{i}")
        stages.append(S(stc, name=f"s{i}", inputs=ins))
    consumed = {n for s in stages if s.inputs for n in s.inputs}
    tail = [n for n in names if n not in consumed] + [fields[0]]
    if len(tail) == 1:
        stages.append(S(st.make_star(nd, 1), name="out", inputs=(tail[0],)))
    else:
        stages.append(S(st.make_combine(nd, len(tail)), name="out",
                        inputs=tuple(tail)))
    updates = {fields[0]: "out"}
    for k in range(1, n_fields):
        updates[fields[k]] = (fields[k - 1] if rng.random() < 0.7
                              else fields[k])
    return P(tuple(stages), fields=fields, updates=updates)


def _slab_taps(e, V):
    """Per input of entry ``e``, the taps the per-entry-barrier forms read
    in slabs of ``V`` rows: every input to ``ceil(radius / V)`` slabs
    (``programs.dag_layout``'s radius), in any column."""
    r = 0 if e.stencil is None else -(-e.stencil.radius // V)
    return tuple(((r, True),) for _ in e.inputs)


def replay(plan, lags, wins, regs, taps, nslabs, steps, one_barrier,
           alias=None):
    """Run the tick schedule of a layout over a stream of ``nslabs``
    slabs, as the kernel does: the field streams pushed at their lag 0,
    entry ``i`` computing slab ``t - lags[i]`` in entry order.  With
    ``alias`` (the one-barrier layout; by default with ``one_barrier``) a
    state node's readers read the value it selects by ``steps``, and a
    state node only drains to its output; a value with a register carry
    keeps it there.  With ``one_barrier`` a read of another thread's cell
    (``cross``) must find its slab written at an earlier tick in a slot no
    write of the same tick touches; a read of the thread's own cell, and
    every read of the per-entry-barrier forms, finds its slab written
    before it.  Reads
    cover every slab a tap can reach, ``[j - ds, j + ds]`` within the
    stream (clipped and mirrored rows lie there).  Raises AssertionError
    naming the first hazard."""
    F = plan.n_streams
    n = len(plan.entries)
    drains = {o for o in plan.outputs if o >= F}
    alias = one_barrier if alias is None else alias

    def sel(v):
        while v >= F and plan.entries[v - F].stencil is None:
            e = plan.entries[v - F]
            v = e.inputs[0] if e.iteration < steps else e.inputs[1]
        return v
    ring = {v: {} for v in range(F + n) if wins[v]}   # slot -> (slab, tick)
    carry = {}                                         # slot -> (value, slab)
    out_lag = max(lags[o] for o in plan.outputs)
    for t in range(nslabs + out_lag):
        start = {v: dict(r) for v, r in ring.items()}
        writes = set()
        cross_reads = []
        for f in range(F):
            if t < nslabs and wins[f]:
                ring[f][t % wins[f]] = (t, t)
                writes.add((f, t % wins[f]))
        for i, e in enumerate(plan.entries):
            v = F + i
            j = t - lags[v]
            if not 0 <= j < nslabs:
                continue
            if e.stencil is not None and e.iteration >= steps:
                continue
            state = e.stencil is None
            if state and alias and v not in drains:
                continue                    # an alias only
            ins = list(e.inputs)
            if state:
                ins = [sel(v)] if alias else [
                    e.inputs[0] if e.iteration < steps else e.inputs[1]]
                tp = (((0, False),),)
            else:
                tp = taps[i]
                if alias:
                    ins = [sel(p) for p in ins]
            for z, p in enumerate(ins):
                for ds, cross in tp[z]:
                    if regs[p] >= 0:
                        assert not cross and ds == 0, (i, p, "carry tap")
                        assert carry.get(regs[p]) == (p, j), (
                            i, p, j, t, "carry overwritten or late")
                        continue
                    assert wins[p], (i, p, "read without a ring")
                    for r in range(max(j - ds, 0), min(j + ds, nslabs - 1)
                                   + 1):
                        s = r % wins[p]
                        if one_barrier and cross:
                            assert start[p].get(s, (None,))[0] == r, (
                                i, p, r, t, "cross read of a slab not "
                                "written before the tick")
                            cross_reads.append((p, s, i, r))
                        else:
                            assert ring[p].get(s, (None,))[0] == r, (
                                i, p, r, t, "slab overwritten or not yet "
                                "written")
            if regs[v] >= 0:
                carry[regs[v]] = (v, j)
            elif wins[v]:
                ring[v][j % wins[v]] = (j, t)
                writes.add((v, j % wins[v]))
        for p, s, i, r in cross_reads:
            assert (p, s) not in writes, (i, p, r, t, "slot written in the "
                                          "tick it is read across threads")


def _random_dags(seed, count):
    for k in range(count):
        rng = random.Random(seed * 1000 + k)
        nd = rng.choice([2, 3])
        prog = _draw(rng, nd, *PKGS["port"])
        yield nd, prog.dag, rng.randint(1, 4), rng.choice([1, 2, 4])


def _check_layouts(dag, T, V, nslabs=11):
    plan_ = programs.unroll_dag(dag, T)
    if V == 1:
        for mixed in (False, True):
            lay = builder.win_layout(dag, T, mixed)
            taps = [builder.entry_taps(e) for e in plan_.entries]
            for steps in range(T + 1):
                replay(plan_, lay.lags, lay.wins, lay.regs, taps, nslabs,
                       steps, True)
                # the grid-edge CTAs of the mixed body read rings only,
                # a barrier an entry
                if mixed:
                    replay(plan_, lay.lags, lay.wins, [-1] * len(lay.wins),
                           taps, nslabs, steps, False, alias=True)
    ref = programs.dag_layout(plan_, V)
    taps = [_slab_taps(e, V) for e in plan_.entries]
    for steps in range(T + 1):
        replay(plan_, ref.lags, ref.wins, [-1] * len(ref.wins), taps,
               nslabs, steps, False)


@pytest.mark.parametrize("chunk", range(8))
def test_random_dags_replay_without_hazards(chunk):
    """25 seeded random DAGs a chunk (200 in all: 1-3 stages, fan-in,
    state nodes, stars, boxes, combines and custom taps; 2D and 3D; T 1 to
    4; V 1, 2 and 4): the one-barrier layout at V = 1 in both DAG bodies,
    and ``dag_layout`` as the per-entry-barrier forms run it, replay every
    ``steps`` from 0 to T without a hazard."""
    for nd, dag, T, V in _random_dags(chunk, 25):
        _check_layouts(dag, T, V)


def test_the_replay_catches_a_short_ring_and_a_short_lag():
    """The replay is not vacuous: one slot less on any ring, or one tick
    less of lag on an entry that reads another thread's cell, is caught
    as a hazard at some ``steps`` on the wave equation's layout."""
    dag = _wave(2).dag
    T = 3
    plan_ = programs.unroll_dag(dag, T)
    lay = builder.win_layout(dag, T, False)
    taps = [builder.entry_taps(e) for e in plan_.entries]

    def hazard(lags, wins):
        for steps in range(T + 1):
            try:
                replay(plan_, lags, wins, lay.regs, taps, 11, steps, True)
            except AssertionError:
                return True
        return False
    assert not hazard(lay.lags, lay.wins)
    for v, w in enumerate(lay.wins):
        if w:
            wins = list(lay.wins)
            wins[v] -= 1
            assert hazard(lay.lags, wins), v
    F = plan_.n_streams
    for i, e in enumerate(plan_.entries):
        if e.stencil is not None and not e.stencil.combine:
            lags = list(lay.lags)
            lags[F + i] -= 1
            assert hazard(lags, lay.wins), i


def _wave(nd, pkg="port"):
    S, P, st = PKGS[pkg]
    lap = {"c0": -2.0 * nd}
    lap.update({f"c_{a}_{d}": 1.0 for a in range(nd) for d in (-1, 1)})
    return P((S(st.make_star(nd, 1), coeffs=lap, name="lapu",
                inputs=("u",)),
              S(st.make_combine(nd, 3), name="unext",
                inputs=("u", "u_prev", "lapu"),
                coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.16})),
             fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _diamond(pkg="port"):
    S, P, st = PKGS[pkg]
    s = st.make_star(2, 1)
    return P((S(s, name="a", inputs=("u",)),
              S(s, name="b", inputs=("u",),
                coeffs={"c0": 0.5, "c_0_1": 0.2}),
              S(st.make_combine(2, 2), name="m", inputs=("a", "b"),
                coeffs={"w0": 0.6, "w1": 0.4})))


@pytest.mark.parametrize("seed", range(4))
def test_dag_layout_unchanged_against_repro(seed):
    """``programs.dag_layout``, which prices the rings (``smem_bytes``,
    ``traffic_report``) and lays out the per-entry-barrier forms, equals
    ``repro``'s on the same random DAGs (stars, boxes, combines) at V 1,
    2 and 4, and on the wave and diamond cells."""
    cases = []
    for k in range(20):
        rng = [random.Random(seed * 100 + k) for _ in range(2)]
        nd = rng[0].choice([2, 3])
        rng[1].choice([2, 3])
        progs = [_draw(r, nd, *PKGS[pkg], custom=False)
                 for r, pkg in zip(rng, ("port", "repro"))]
        cases.append((progs, rng[0].randint(1, 4)))
    cases.append(([_wave(2), _wave(2, "repro")], 4))
    cases.append(([_diamond(), _diamond("repro")], 2))
    for (mine, theirs), T in cases:
        for V in (1, 2, 4):
            a = programs.dag_layout(programs.unroll_dag(mine.dag, T), V)
            b = jprograms.dag_layout(jprograms.unroll_dag(theirs.dag, T), V)
            assert (a.radii, a.lags, a.wins, a.out_lag, a.aux_depth) == (
                b.radii, b.lags, b.wins, b.out_lag, b.aux_depth)


@pytest.mark.parametrize("chunk", range(2))
def test_the_one_barrier_layout_re_imposes_what_the_plain_version_does(
        chunk):
    """A stage value the single-boundary body computes at its re-imposed
    position (it has a ring or a register carry in ``win_layout``) is one
    ``dag_layout`` gives a ring, which the plain version re-imposes; and
    every lag is at least ``dag_layout``'s."""
    for nd, dag, T, _ in _random_dags(100 + chunk, 25):
        plan_ = programs.unroll_dag(dag, T)
        F = plan_.n_streams
        ref = programs.dag_layout(plan_, 1)
        lay = builder.win_layout(dag, T, False)
        for i, e in enumerate(plan_.entries):
            v = F + i
            assert lay.lags[v] >= ref.lags[v]
            if e.stencil is None:
                assert lay.wins[v] == 0 and lay.regs[v] < 0
                continue
            assert (lay.wins[v] > 0 or lay.regs[v] >= 0) == (ref.wins[v] > 0)


CELLS = [  # (id, program, dims, boundary, par_time, bsize, par_vec, dtype,
    # the form win_form picks: None or the start of its reason)
    ("wave2d", lambda: _wave(2), (16384, 16384), "periodic", 4, (256,), 1,
     "float32", None),
    ("diamond2d", _diamond, (16384, 16384), "clamp", 2, (256,), 1,
     "float32", None),
    ("wave3d", lambda: _wave(3), (448, 448, 448), "clamp", 2, (32, 32), 1,
     "float32", None),
    ("wave2d_bf16", lambda: _wave(2), (16384, 16384), "periodic", 4, (256,),
     1, "bfloat16", None),
    ("diamond2d_reflect", _diamond, (16384, 16384), "reflect", 2, (256,), 1,
     "float32", "reflect maps"),
    ("diamond2d_reflect_inside", _diamond, (16384, 16380), "reflect", 2,
     (256,), 1, "float32", None),
    ("wave2d_v4", lambda: _wave(2), (16384, 16384), "periodic", 4, (256,), 4,
     "float32", "par_vec"),
    ("wave2d_wide", lambda: _wave(2), (64, 2500), "periodic", 2, (1100,), 1,
     "float32", "a plane"),
    ("wave2d_t20", lambda: _wave(2), (64, 400), "clamp", 20, (96,), 1,
     "float32", "the large-table"),
]


@pytest.mark.parametrize("case", CELLS, ids=lambda c: c[0])
def test_win_form_of_the_chip_cells(case):
    """The chip's DAG cells at full size take the one-barrier form; a
    single-boundary reflect DAG whose last block mirrors past the grid,
    ``par_vec > 1``, a wide plane and the large-table route take the
    per-entry-barrier forms, and say why; the one-barrier form's rings
    and tables fit a CTA."""
    _, build, dims, bc, T, bsize, V, dtype, why = case
    problem = StencilProblem(build(), dims, boundary=bc, dtype=dtype)
    geom = plan(problem, RunConfig(backend="hopper", par_time=T,
                                   bsize=bsize, par_vec=V,
                                   device="cpu")).geometry
    dag = problem.exec_dag
    cell = 2 if dtype == "bfloat16" else 4
    got = builder.win_form(dag, geom, cell)
    if why is None:
        assert got is None
        lay = builder.win_layout(dag, T, builder.mixes_boundaries(dag, 2))
        smem = builder.win_smem(dag, geom, cell)
        assert smem >= lay.slots * math.prod(geom.bsize) * cell
        assert smem + builder.WIN_TABLE_SMEM <= blocking.SMEM_LIMIT
    else:
        assert got is not None and got.startswith(why), got
    assert builder.kernel_limits(geom, dag, cell) is None


@pytest.mark.parametrize("case", CELLS[:4], ids=lambda c: c[0])
def test_the_win_table_encodes_the_layout(case):
    """``builder._win_table`` (the ``Program`` the one-barrier form reads)
    holds ``win_layout``'s lags, rings and carries per entry, each input
    as a value id, and per field stream its ring; resolving an input as
    the kernel does (a state node's new or previous value by ``steps``)
    reaches the value ``replay`` reads."""
    _, build, dims, bc, T, bsize, V, dtype, _ = case
    small = tuple(min(d, 40) for d in dims[:1]) + tuple(
        min(d, 3 * b) for d, b in zip(dims[1:], bsize))
    problem = StencilProblem(build(), small, boundary=bc, dtype=dtype)
    geom = plan(problem, RunConfig(backend="hopper", par_time=T,
                                   bsize=bsize, device="cpu")).geometry
    dag = problem.exec_dag
    from repro_torch.kernels import ops
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    k, out_lag, n, slots = builder._win_table(dag, geom, c)
    plan_ = programs.unroll_dag(dag, T)
    lay = builder.win_layout(dag, T, builder.mixes_boundaries(dag, 2))
    F = plan_.n_streams
    base = builder._ring_bases(lay.wins)
    assert (out_lag, n, slots) == (lay.out_lag, len(plan_.entries),
                                   lay.slots)
    for f in range(F):
        assert (k.f[f].base, k.f[f].slots) == (base.get(f, 0), lay.wins[f])
    for i, e in enumerate(plan_.entries):
        en = k.e[i]
        assert (en.lag, en.out_slots, en.pad, en.n_in) == (
            lay.lags[F + i], lay.wins[F + i], lay.regs[F + i],
            len(e.inputs))
        assert tuple(en.in_base)[:en.n_in] == e.inputs
    for steps in range(T + 1):
        def resolve(v):
            while v >= F and k.e[v - F].stage < 0:
                v = k.e[v - F].in_base[
                    0 if k.e[v - F].iteration < steps else 1]
            return v
        for i, e in enumerate(plan_.entries):
            for p in e.inputs:
                v = resolve(p)
                assert v == (builder._new_value(plan_, p)
                             if e.stencil is not None
                             and e.iteration < steps else v)
                assert lay.wins[v] or lay.regs[v] >= 0
