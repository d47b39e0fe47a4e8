"""The chain body's one-barrier form of ``csrc/stencil_stream.cu`` in its
pure-Python parts: ``kernels/builder.chain_layout`` (the chain as a path
graph through ``win_layout``) replayed tick by tick over seeded random
chains (1D, 2D and 3D; Table-2 stencils, stars and boxes of radius 0 to 3,
custom taps; T 1 to 8; boundaries mixed per stage): no thread reads
another thread's cell in a row written in the same tick, no ring slot is
overwritten while it is still read, the field stream's copies run
``look`` rows ahead into slots nobody reads, and a ring one slot short or
a lag one row short is caught; the register window holds every
own-column tap of the stages that read it; the lags are at least
``repro``'s ``dag_layout``'s; ``builder._chain_table`` encodes the layout;
the form ``builder.win_form`` picks for the chip's chain cells and why;
the plain version of those cells against ``repro``'s
``superstep_chain(..., interpret=True)``; and every chain geometry plans
by the per-entry form's rule, whichever form it runs."""
import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_conformance as conf
from repro import api as japi
from repro import programs as jprograms
from repro.core import precision as jprecision
from repro.core import stencils as jstencils
from repro.kernels import builder as jbuilder
from repro.kernels import ops as jops
from repro_torch import programs
from repro_torch.api import RunConfig, StencilProblem, StencilStage, plan
from repro_torch.core import blocking, boundary, stencils
from repro_torch.kernels import builder, codegen, ops
from test_torch_dag_split import replay

PKGS = {"repro": (jprograms.StencilStage, jstencils),
        "port": (StencilStage, stencils)}
TABLE2 = {1: (), 2: ("diffusion2d", "hotspot2d"),
          3: ("diffusion3d", "hotspot3d")}
KINDS = ("clamp", "reflect", "constant:0.5")


def _custom(nd, rng):
    """A one-input custom stencil that taps a few random offsets within
    radius 1 (its ``apply`` a sum of products)."""
    offs = [tuple(rng.randint(-1, 1) for _ in range(nd))
            for _ in range(rng.randint(1, 4))]
    radius = max(abs(d) for o in offs for d in o)

    def apply(get, c, aux=None):
        acc = 0.0
        for o in offs:
            acc = acc + c["a"] * get(o)
        return acc
    return stencils.Stencil(f"rand{nd}d_{rng.random():.6f}", nd, radius, 4,
                            1, 1, False, ("a",), apply)


def _stencil(nd, rng):
    kind = rng.choice(["table2", "star", "star", "box", "custom"])
    if kind == "table2" and TABLE2[nd]:
        return stencils.STENCILS[rng.choice(TABLE2[nd])]
    if kind == "box":
        return stencils.make_box(nd, rng.choice([1, 2] if nd < 3 else [1]))
    if kind == "custom":
        return _custom(nd, rng)
    return stencils.make_star(nd, rng.choice([0, 1, 2, 3]))


def _bcs(nd, S, rng):
    """Per stage a boundary: a periodic axis is periodic in every stage
    (periodicity is uniform), the others clamp, reflect or constant at
    random per stage and axis."""
    periodic = [rng.random() < 0.25 for _ in range(nd)]
    out = []
    for _ in range(S):
        kinds = tuple("periodic" if p else rng.choice(KINDS)
                      for p in periodic)
        out.append(kinds[0] if len(set(kinds)) == 1 else kinds)
    return out


def _random_chains(seed, count):
    """``count`` seeded random chains: ``(nd, stages, T)`` with 1-3
    stages."""
    for k in range(count):
        rng = random.Random(seed * 1000 + k)
        nd = rng.choice([1, 2, 3])
        S = rng.randint(1, 3)
        sts = [_stencil(nd, rng) for _ in range(S)]
        stages = tuple(zip(sts, _bcs(nd, S, rng)))
        yield nd, stages, rng.randint(1, 8)


def _look_hazard(lay, taps0, look: int, depth: int, nslabs: int):
    """The first tick at which entry 0 reads a row of the field stream
    whose slot of a ring of ``depth`` rows a copy ``look`` rows ahead has
    taken (rows ``t + look`` copied at tick ``t``, as the kernel's
    ``issue``), or None."""
    lag = lay.lags[1]
    for t in range(nslabs + lay.out_lag):
        j = t - lag
        if not 0 <= j < nslabs:
            continue
        for ds, _ in taps0:
            for r in range(max(j - ds, 0), min(j + ds, nslabs - 1) + 1):
                newest = min(t + look, nslabs - 1)
                if any(q % depth == r % depth
                       for q in range(r + 1, newest + 1)):
                    return t
    return None


def _check_chain(stages, T, nslabs=11):
    plan_ = programs.unroll_dag(programs.chain_dag(stages), T)
    lay = builder.chain_layout(stages, T)
    taps = [builder.entry_taps(e) for e in plan_.entries]
    assert all(r < 0 for r in lay.regs)
    for steps in range(T + 1):
        replay(plan_, lay.lags, lay.wins, lay.regs, taps, nslabs, steps,
               True)
    for look in range(1, builder.MAX_LOOK + 1):
        assert _look_hazard(lay, taps[0][0], look, lay.wins[0] + look,
                            nslabs) is None
    return plan_, lay, taps


@pytest.mark.parametrize("chunk", range(8))
def test_random_chains_replay_without_hazards(chunk):
    """25 seeded random chains a chunk (200 in all): the one-barrier layout
    replays every ``steps`` from 0 to T without a hazard, and the field
    stream's ring, ``look`` rows deeper, takes copies 1 to 4 rows ahead
    without overwriting a row entry 0 still reads."""
    for nd, stages, T in _random_chains(chunk, 25):
        _check_chain(stages, T)


@pytest.mark.parametrize("chunk", range(2))
def test_the_register_window_holds_every_own_column_tap(chunk):
    """A stage ``chain_steps`` puts in the register window reads each
    own-column tap, at its signed stream offset ``ds`` and mirrored or
    clipped at the stream's ends, 0 to 2 rows behind its producer's
    newest (``step - ds``); every tap of every stage lies at most ``step``
    rows ahead of the row computed, one less in another column, so no
    tap reads a row the producer has not yet written (the lags of
    ``chain_layout``)."""
    for nd, stages, T in _random_chains(50 + chunk, 50):
        for (st, _), (step, reg) in zip(stages, builder.chain_steps(stages)):
            if builder.stage_op(st) == builder.CUSTOM_OP:
                offs = {n.attr[1] for n in codegen.trace(st).nodes
                        if n.op == "tap"}
            else:
                offs = set(st.offsets)
            for off in offs:
                ds, cross = off[0], any(off[1:])
                assert step - ds >= int(cross), (st.name, off, step)
                if reg and not cross:
                    assert 0 <= step - ds <= 2 and 0 <= step + ds <= 2


def test_the_replay_catches_a_short_ring_a_short_lag_and_a_short_copy():
    """The replay is not vacuous: on ``advect_diffuse2d`` and
    ``diffuse_damp2d`` (radius-0 stages, whose lags do not grow), one slot
    less on any ring, one row less of lag on any entry, or a field-stream
    ring one row shallower than the layout's rows and ``look`` is caught
    at some ``steps``."""
    S, st = PKGS["port"]
    for stages in (((st.make_star(2, 1), None),
                    (stencils.STENCILS["diffusion2d"], None)),
                   ((stencils.STENCILS["diffusion2d"], None),
                    (st.make_star(2, 0), None))):
        T = 3
        plan_, lay, taps = _check_chain(stages, T)

        def hazard(lags, wins):
            for steps in range(T + 1):
                try:
                    replay(plan_, lags, wins, lay.regs, taps, 11, steps,
                           True)
                except AssertionError:
                    return True
            return False
        for v, w in enumerate(lay.wins):
            if w:
                wins = list(lay.wins)
                wins[v] -= 1
                assert hazard(lay.lags, wins), v
        for v in range(1, len(lay.lags)):
            lags = list(lay.lags)
            lags[v] -= 1
            assert hazard(lags, lay.wins), v
        for look in range(1, builder.MAX_LOOK + 1):
            assert _look_hazard(lay, taps[0][0], look,
                                lay.wins[0] + look - 1, 11) is not None


@pytest.mark.parametrize("seed", range(2))
def test_chain_lags_are_at_least_repros_dag_layout(seed):
    """Against ``repro``'s ``dag_layout`` of the same chain (stars, boxes
    and Table-2 stencils drawn alike in both packages): each entry lags at
    least as far as the per-entry-barrier layout, which ``programs.
    dag_layout`` keeps equal to ``repro``'s, and by at most one row a
    stage more (a tap in another column)."""
    for k in range(25):
        rng = [random.Random(seed * 100 + k) for _ in range(2)]
        nd = rng[0].choice([2, 3])
        rng[1].choice([2, 3])
        T = rng[0].randint(1, 6)
        rng[1].randint(1, 6)
        chains = []
        for r, (S, st) in zip(rng, (PKGS["port"], PKGS["repro"])):
            sts = []
            for _ in range(r.randint(1, 3)):
                kind = r.choice(["table2", "star", "box"])
                if kind == "table2":
                    sts.append(st.STENCILS[r.choice(TABLE2[nd])])
                elif kind == "box":
                    sts.append(st.make_box(nd, 1))
                else:
                    sts.append(st.make_star(nd, r.choice([0, 1, 2, 3])))
            chains.append(tuple((s, None) for s in sts))
        mine, theirs = chains
        lay = builder.chain_layout(mine, T)
        ref = jprograms.dag_layout(jprograms.unroll_dag(
            jprograms.chain_dag(theirs), T), 1)
        assert len(lay.lags) == len(ref.lags)
        S = len(mine)
        for i in range(1, len(lay.lags)):
            st = mine[(i - 1) % S][0]
            step = lay.lags[i] - lay.lags[i - 1]
            assert step >= ref.lags[i] - ref.lags[i - 1] == st.radius
            assert step <= st.radius + 1
        assert lay.out_lag >= ref.out_lag


ADVECT = {"c0": 0.7, "c_0_-1": 0.1, "c_0_1": 0.0, "c_1_-1": 0.2,
          "c_1_1": 0.0}


def _advect_diffuse(S, st, bcs=(None, None)):
    return [S(st.make_star(2, 1), coeffs=ADVECT, name="advect",
              boundary=bcs[0]), S("diffusion2d", boundary=bcs[1])]


def _diffuse_damp(S, st):
    return [S("diffusion2d"), S(st.make_star(2, 0), coeffs={"c0": 0.995},
                                name="damp")]


def _star_diffuse3d(S, st):
    return [S(st.make_star(3, 1)), S("diffusion3d")]


def _box3d_r2x2(S, st):
    return [S(st.make_box(3, 2)), S(st.make_box(3, 2))]


def _allen_cahn(S, st):
    def apply(get, c, aux=None):
        u = get((0, 0))
        lap = get((-1, 0)) + get((1, 0)) + get((0, -1)) + get((0, 1)) \
            - 4.0 * u
        return u + c["dt"] * (c["d"] * lap + u - u * u * u)
    return [S(st.Stencil("allen_cahn2d", 2, 1, 12, 1, 1, False,
                         ("dt", "d"), apply),
              coeffs={"dt": 0.1, "d": 0.2})]


def _upwind(S, st):
    def apply(get, c, aux):
        v = aux
        ctr = get((0, 0, 0))
        return ctr - c["dt"] * v * (ctr - get((0, 0, -1)))
    return [S(st.Stencil("upwind3d", 3, 1, 9, 2, 1, True, ("dt",), apply),
              coeffs={"dt": 0.3})]


CELLS = [  # the chip's chain cells: (id, build, dims, boundary, par_time,
    # bsize, par_vec, dtype, the form: None or the start of its reason)
    ("advect_diffuse2d", _advect_diffuse, (16384, 16384), None, 4, (256,),
     1, "float32", None),
    ("diffuse_damp2d", _diffuse_damp, (16384, 16384), None, 4, (256,), 1,
     "float32", None),
    ("star_diffuse3d", _star_diffuse3d, (448, 448, 448), None, 2, (32, 32),
     1, "float32", None),
    ("advect_diffuse2d_bf16", _advect_diffuse, (16384, 16384), None, 4,
     (256,), 1, "bfloat16", None),
    ("allen_cahn2d", _allen_cahn, (16384, 16384), None, 8, (256,), 1,
     "float32", None),
    ("allen_cahn2d_bf16", _allen_cahn, (16384, 16384), None, 8, (256,), 1,
     "bfloat16", None),
    ("upwind3d", _upwind, (448, 448, 448), None, 4, (32, 32), 1, "float32",
     None),
    ("advect_diffuse2d_reflect_constant",
     lambda S, st: _advect_diffuse(S, st, ("reflect", "constant:0.0")),
     (16384, 16384), None, 4, (256,), 1, "float32", "reflect maps"),
    ("advect_diffuse2d_v4", _advect_diffuse, (16384, 16384), None, 4,
     (256,), 4, "float32", "par_vec"),
    ("box3d_r2x2", _box3d_r2x2, (448, 448, 448), None, 2, (32, 32), 1,
     "float32", "the large-table"),
    ("diffusion2d_bsize2048", lambda S, st: [S("diffusion2d"),
                                             S("diffusion2d")],
     (16384, 16384), None, 2, (2048,), 1, "float32", "a plane"),
    ("star1d_r2", lambda S, st: [S(st.make_star(1, 2))], (1 << 20,), None,
     4, (), 1, "float32", "a one-cell"),
    ("advect_diffuse2d_bf16_odd_plane", _advect_diffuse, (40, 245), None, 4,
     (65,), 1, "bfloat16", "a bfloat16 stream"),
    ("advect_diffuse2d_reflect_past_the_grid",
     lambda S, st: _advect_diffuse(S, st, ("reflect", "reflect")),
     (64, 300), None, 2, (96,), 1, "float32", "reflect maps"),
]


def _cell_geometry(case, device="cpu"):
    _, build, dims, bc, T, bsize, V, dtype, _ = case
    problem = StencilProblem(build(*PKGS["port"]), dims, dtype=dtype,
                             **({} if bc is None else {"boundary": bc}))
    geom = plan(problem, RunConfig(backend="hopper", par_time=T,
                                   bsize=bsize, par_vec=V,
                                   device=device)).geometry
    return problem, geom


@pytest.mark.parametrize("case", CELLS, ids=lambda c: c[0])
def test_the_form_of_the_chip_chain_cells(case):
    """The chip's chain cells at full size (the programs of ``chip_smoke.
    py``: its program, bf16, custom and batch phases) take the one-barrier
    form; a chain whose reflect overhang passes the grid
    (advect_diffuse2d reflect|constant), ``par_vec > 1``, the large-table
    route (box3d_r2 x 2), a plane over 1024 cells, the 1D star (a
    one-cell plane), a bfloat16 stream on a padded plane of an odd count
    of cells and a reflect overhang past the grid keep
    ``chain_kernel``/``chain_kernel_big`` and say why;
    the one-barrier form's rings and tables fit a CTA, and the plan's
    kernel limits are those of the per-entry form's rings."""
    problem, geom = _cell_geometry(case)
    cell = 2 if case[7] == "bfloat16" else 4
    stages = problem.exec_stages
    why = case[-1]
    got = builder.win_form(problem.exec_dag, geom, cell)
    if why is None:
        assert got is None
        look = builder.chain_look(stages, geom, cell)
        assert 1 <= look <= builder.MAX_LOOK
        assert (builder.chain_smem(stages, geom, cell, look)
                + builder.CHAIN_TABLE_SMEM) <= blocking.SMEM_LIMIT
        assert builder.win_smem(problem.exec_dag, geom, cell) == \
            builder.chain_smem(stages, geom, cell, look)
    else:
        assert got is not None and got.startswith(why), got
    assert builder.kernel_limits(geom, problem.exec_dag, cell) is None


def test_a_reflect_overhang_past_the_grid_fails_own_columns():
    """The reflect case above takes the per-entry form for the reason it
    names: a block of its geometry mirrors its overhang past the grid."""
    problem, geom = _cell_geometry(CELLS[-1])
    make = boundary.BoundaryCondition.make
    assert not builder.own_columns(geom, make("reflect", 2))
    assert builder.own_columns(geom, make("clamp", 2))


@pytest.mark.parametrize("case", CELLS[:3] + CELLS[4:5],
                         ids=lambda c: c[0])
def test_the_chain_table_encodes_the_layout(case):
    """``builder._chain_table`` (the ``Program`` the one-barrier form
    reads) holds ``chain_layout``'s lag and ring per entry, its producer's
    ring (the field stream's ``look`` rows deeper), the stage, iteration,
    whether its stage reads the register window, and each stage's star
    radius; the entries it unrolls (``launch_form``, ``chain_unroll``)
    reach the launch's parameters and the kernel's name from the launch
    plan alike."""
    _, build, dims, bc, T, bsize, V, dtype, _ = case
    small = tuple(min(d, 40) for d in dims[:1]) + tuple(
        min(d, 3 * b) for d, b in zip(dims[1:], bsize))
    problem = StencilProblem(build(*PKGS["port"]), small)
    geom = plan(problem, RunConfig(backend="hopper", par_time=T,
                                   bsize=bsize, device="cpu")).geometry
    stages = problem.exec_stages
    c = ops.pack_program_coeffs(stages, problem.resolve_coeffs())
    look = builder.chain_look(stages, geom)
    k, out_lag = builder._chain_table(stages, geom, c, look)
    lay = builder.chain_layout(tuple(stages), T)
    wins = (lay.wins[0] + look,) + lay.wins[1:]
    base = builder._ring_bases(wins)
    steps = builder.chain_steps(stages)
    S = len(stages)
    assert out_lag == lay.out_lag
    assert (k.f[0].base, k.f[0].slots) == (0, lay.wins[0] + look)
    for s, (st, _) in enumerate(stages):
        assert k.s[s].pad == builder.star_radius(st, geom.ndim) + 1
    for i in range(S * T):
        en = k.e[i]
        assert (en.lag, en.stage, en.iteration, en.out_slots, en.n_in) == (
            lay.lags[1 + i], i % S, i // S, lay.wins[1 + i], 1)
        assert (en.in_base[0], en.in_slots[0]) == (base[i], wins[i])
        assert en.out_base == base.get(1 + i, 0)
        assert en.pad == int(steps[i % S][1])
    win, kt = builder.launch_form(problem.exec_dag, geom, 4)
    assert win and kt == builder.chain_unroll(S * T)
    assert kt == next((u for u in (4, 8) if S * T <= u), 0)
    prog = builder._prepared(problem.exec_dag, geom, tuple(c.tolist()),
                             torch.device("cpu"), 4)
    assert (prog.win, prog.unroll) == (True, kt)
    params, _, _ = builder._params(prog, geom, 40, T)
    assert params.win == 1 + kt
    assert builder._kernel_name(prog, geom, None, 0) == (
        f"chain_win_kernel<{int(prog.bcs)},{kt}>")


@pytest.mark.parametrize("case", CELLS[:3], ids=lambda c: c[0])
def test_chip_chain_cell_superstep_matches_interpret_kernel(case):
    """The chip's chain cells at a small size: one super-step of the port
    (its plain version here) against ``repro``'s ``superstep_chain(...,
    interpret=True)`` on the same padded input, with and without
    forwarding, on the compute region, within ``tolerance("float32",
    steps, stages=S)``."""
    _, build, dims, bc, T, bsize, V, dtype, _ = case
    small = (23,) + tuple(min(d, 2 * b + 7) for d, b in zip(dims[1:],
                                                            bsize))
    mine = StencilProblem(build(*PKGS["port"]), small)
    want = japi.StencilProblem(build(*PKGS["repro"]), small)
    geom = plan(mine, RunConfig(backend="hopper", par_time=T, bsize=bsize,
                                device="cpu")).geometry
    jgeom = japi.plan(want, japi.RunConfig(
        backend="pallas_interpret", par_time=T, bsize=bsize)).geometry
    g = np.random.default_rng(4).uniform(0.5, 2.0, small).astype(np.float32)
    gp = ops._pad_blocked(torch.from_numpy(g), geom)
    jgp = jops._pad_blocked(jnp.asarray(g), jgeom)
    c = ops.pack_program_coeffs(mine.exec_stages, mine.resolve_coeffs())
    jc = jops.pack_program_coeffs(want.exec_stages,
                                  want.resolve_coeffs(dtype=jnp.float32))
    h = geom.size_halo
    region = (slice(None),) + tuple(slice(h, h + n * cs) for n, cs in
                                    zip(geom.bnum, geom.csize))
    for steps in (T, T - 1):
        got = builder.superstep_chain(mine.exec_stages, geom, gp, c, steps)
        exp = jbuilder.superstep_chain(want.exec_stages, jgeom, jgp, jc,
                                       jnp.asarray(steps, jnp.int32),
                                       interpret=True)
        conf.assert_close(got[region], np.asarray(exp)[region],
                          jprecision.tolerance("float32", steps,
                                               stages=mine.n_stages))


def _sweep():
    """Chains of the chip's kinds and a few more (a box, a star of radius
    2, radius-0 stages, a custom stencil) over block sizes, T and V."""
    st = stencils
    two = [((st.make_star(2, 1), None), (st.STENCILS["diffusion2d"], None)),
           ((st.STENCILS["diffusion2d"], None), (st.make_star(2, 0), None)),
           ((st.make_box(2, 1), None), (st.make_star(2, 2), None)),
           ((_custom(2, random.Random(7)), None),)]
    three = [((st.make_star(3, 1), None), (st.STENCILS["diffusion3d"], None)),
             ((st.make_box(3, 1), None),)]
    one = [((st.make_star(1, 2), None), (st.make_star(1, 1), None))]
    for ndim, progs, sizes in ((2, two, [(64,), (256,), (1024,), (2048,)]),
                               (3, three, [(16, 16), (32, 32), (40, 40)]),
                               (1, one, [()])):
        for bsize in sizes:
            for T in (1, 2, 3, 4, 8, 12, 17):
                for V in (1, 2, 4):
                    yield ndim, progs, bsize, T, V


def _per_entry_limit(geom, stages, cell_bytes):
    """Whether the per-entry form's rule refuses the chain: its layout's
    rings (``smem_bytes``) and tables past one CTA."""
    smem = blocking.smem_bytes(geom, stages, cell_bytes)
    tab = builder.tables_of(geom, stages)
    smem += tab.smem if tab is not None else 0
    return smem > blocking.SMEM_LIMIT


def test_no_chain_geometry_changes_its_plan():
    """Every chain geometry of the sweep is accepted or refused by
    ``kernel_limits`` exactly as the per-entry form's rule decides (the
    rings of the per-entry layout and the tables against one CTA),
    whichever form it runs; the one-barrier form runs only where its own
    rings and tables fit a CTA, and every other accepted geometry keeps a
    per-entry form, with a reason."""
    planned = wins = 0
    for ndim, progs, bsize, T, V in _sweep():
        dims = {1: (4096,), 2: (64, 9000), 3: (16, 200, 200)}[ndim]
        try:
            geom = blocking.BlockGeometry(ndim, dims, 1, T, bsize, V)
        except ValueError:
            continue
        for stages in progs:
            for cell_bytes in (4, 2):
                refused = builder.kernel_limits(geom, stages, cell_bytes)
                assert (refused is not None) == _per_entry_limit(
                    geom, stages, cell_bytes), (ndim, bsize, T, V, stages)
                if refused:
                    continue
                planned += 1
                why = builder.win_form(programs.chain_dag(stages), geom,
                                       cell_bytes)
                if why is None:
                    wins += 1
                    look = builder.chain_look(stages, geom, cell_bytes)
                    assert (builder.chain_smem(stages, geom, cell_bytes,
                                               look)
                            + builder.CHAIN_TABLE_SMEM) <= \
                        blocking.SMEM_LIMIT
                    assert V == 1 and math.prod(geom.bsize) <= 1024
                else:
                    assert isinstance(why, str) and why
    assert planned > 300 and 0 < wins < planned


def test_stage_kinds_that_do_not_follow_keep_the_per_entry_form():
    """Per link of the unrolled chain (the last stage of an iteration feeds
    the first of the next): a consumer that maps a cell under other
    blocked-axis kinds than the value it reads took (clamp after
    constant, reflect after clamp or constant) keeps the per-entry form;
    a constant consumer (it computes at the cell and writes the fill) and
    equal kinds take the one-barrier form."""
    star, diff = stencils.make_star(2, 1), stencils.STENCILS["diffusion2d"]
    make = boundary.BoundaryCondition.make
    cases = [(("reflect", "reflect"), 2, True),
             (("clamp", "constant:0.5"), 1, True),
             (("clamp", "constant:0.5"), 2, False),
             (("constant:1.0", "constant:0.5"), 2, True),
             (("reflect", "clamp"), 1, False),
             (("constant:0.0", "reflect"), 1, False)]
    for (a, b), T, one_barrier in cases:
        geom = blocking.BlockGeometry(2, (40, 300), 1, T, (64,), 1)
        assert all(builder.own_columns(geom, make(k, 2))
                   for k in ("reflect", "clamp"))
        stages = ((star, make(a, 2)), (diff, make(b, 2)))
        assert builder._kinds_follow(stages, 2, T) == one_barrier, (a, b)
        why = builder.chain_form(stages, geom)
        assert (why is None) == one_barrier, (a, b, why)
        if not one_barrier:
            assert why.startswith("a stage's consumer"), why
