"""The stream split of ``csrc/stencil_stream.cu``'s bodies, in its
pure-Python parts: ``kernels/builder.segment_plan`` (the segments of the
stream each CTA of a block streams), the warm-up a segment streams before
its own rows (``stream_warmup``), the main path's register form and its
shared memory (``main_look``, ``window_smem``), and that no geometry the
kernel took before the split is refused now, chains and DAGs.  The
segments' arithmetic is replayed on the plain version, chains and DAGs
(field streams, state nodes, mixed boundaries, custom ``apply``): a
segment whose rows before its warm-up hold NaN in every field still gives
the rows it owns bit for bit."""
import math

import numpy as np
import pytest
import torch

from repro_torch.api import (RunConfig, StencilProblem, StencilProgram,
                             StencilStage, plan)
from repro_torch.core import blocking, stencils
from repro_torch.core.stencils import STENCILS, make_combine, make_star
from repro_torch.kernels import builder, ops
from repro_torch.programs import DagSpec, chain_dag, dag_layout, unroll_dag

#: (nslabs, warm, CTAs a segment, CTAs an SM, SMs, block rows)
PLANS = [(16384, 8, 69, 4, 132, 1), (448, 4, 361, 1, 132, 19),
         (1 << 20, 8, 1, 21, 132, 1), (65536, 1, 1, 20, 132, 1),
         (16384, 8, 9, 1, 132, 1), (16384, 8, 69 * 8, 4, 132, 1),
         (10, 3, 1, 8, 132, 1), (1, 1, 1, 1, 132, 1), (37, 0, 2, 2, 132, 1),
         (4096, 2, 4, 16, 132, 3000), (300, 5, 7, 2, 16, 1)]


@pytest.mark.parametrize("nslabs,warm,ctas,per_sm,n_sm,nby", PLANS)
def test_segments_cover_the_stream_once(nslabs, warm, ctas, per_sm, n_sm,
                                        nby):
    """``nseg`` segments of ``seg`` whole slabs cover ``[0, nslabs)`` once
    (the last one may be shorter, none is empty), fit the grid's y axis
    beside the block rows, keep the warm-up within ``WARM_SHARE`` of a
    segment once the stream is cut, and fill the card for
    ``SPLIT_WAVES`` waves unless the warm-up forbids more segments."""
    seg, nseg = builder.segment_plan(nslabs, warm, ctas, per_sm, n_sm, nby)
    owned = np.zeros(nslabs, int)
    for k in range(nseg):
        s0, s1 = k * seg, min((k + 1) * seg, nslabs)
        assert s0 < s1
        owned[s0:s1] += 1
    assert (owned == 1).all()
    assert nby * nseg <= builder.MAX_GRID_Y
    if nseg > 1:
        assert warm <= builder.WARM_SHARE * seg
    cap = int(nslabs * builder.WARM_SHARE) // warm if warm else nslabs
    waves = nseg * ctas / (per_sm * n_sm)
    assert waves >= builder.SPLIT_WAVES or nseg >= min(
        cap, builder.MAX_GRID_Y // nby, nslabs) or -(-nslabs // (nseg + 1)) \
        == seg


def test_segment_plan_fills_whole_waves():
    """Among the counts that fill two waves, the plan takes the one whose
    waves times ticks a CTA is least: 16384^2 at bsize 256 (69 blocks, 4
    CTAs an SM) runs nearly five full waves, not 16 segments' 2.09."""
    seg, nseg = builder.segment_plan(16384, 8, 69, 4, 132, 1, 8)
    waves = nseg * 69 / (4 * 132)
    assert waves >= 2 and math.ceil(waves) - waves < 0.1
    assert (seg, nseg) == (432, 38)


def test_the_1d_grid_gets_many_segments_and_a_batch_fits():
    """The 1D entry (one block) gets thousands of segments at V = 1 and V =
    16; a batch runs along z beside them, and a 3D grid's block rows times
    its segments stay within gridDim.y."""
    for V, warm in ((1, 8), (16, 1)):
        seg, nseg = builder.segment_plan((1 << 20) // V, warm, 1, 20, 132)
        assert nseg > 1000 and seg * nseg >= (1 << 20) // V
    for batch in (1, 8, builder.MAX_GRID_Y):
        seg, nseg = builder.segment_plan(448, 4, 361 * batch, 1, 132, 19)
        assert 19 * nseg <= builder.MAX_GRID_Y and batch <= 65535
    seg, nseg = builder.segment_plan(1 << 20, 1, 1, 32, 132, 40000)
    assert 40000 * nseg <= builder.MAX_GRID_Y


def _geom(ndim, T, V, bsize, dims=None):
    dims = dims or ((64, 600) if ndim == 2 else (16, 64, 64)
                    if ndim == 3 else (4096,))
    return blocking.BlockGeometry(ndim, dims, 1, T, bsize, V)


@pytest.mark.parametrize("V", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("T", [1, 2, 5, 8])
def test_the_warm_up_covers_the_stream_halo(T, V):
    """A segment streams at least the program's critical-path radius times
    ``par_time`` rows before its own (the stream-axis halo), in whole
    slabs, for a Table-2 stage, a radius-2 star and a two-stage chain."""
    programs = [((STENCILS["diffusion2d"], None),),
                ((make_star(2, 2), None),),
                ((make_star(2, 1), None), (STENCILS["diffusion2d"], None))]
    for stages in programs:
        dag = chain_dag(stages)
        rad = sum(st.radius for st, _ in stages)
        geom = _geom(2, T, V, (64,), (64, 600))
        warm = builder.stream_warmup(dag, geom)
        assert warm * V >= rad * T > (warm - 1) * V


@pytest.mark.parametrize("ndim,bsize", [(2, (64,)), (2, (256,)),
                                        (2, (1000,)), (3, (16, 16)),
                                        (3, (32, 32)), (3, (20, 30))])
@pytest.mark.parametrize("cell_bytes", [4, 2])
def test_register_form_holds_no_more_than_the_rings(ndim, bsize,
                                                    cell_bytes):
    """The main path's register form (V = 1, a cell a thread, up to 16
    entries; 8 in a plane over 512 cells) copies 1 to 4 slabs ahead and
    needs no more shared memory than the layout's ``3 * par_time`` slabs of
    float32 rings; V > 1, more entries and wide planes take the ring form
    (``main_look`` 0), priced as the layout."""
    plane = math.prod(bsize)
    for T in range(1, 20):
        if min(bsize) <= 2 * T:
            continue
        geom = _geom(ndim, T, 1, bsize)
        look = builder.main_look(geom, cell_bytes)
        rings = 3 * T * plane * cell_bytes
        stages = ((STENCILS["diffusion2d" if ndim == 2 else "diffusion3d"],
                   None),)
        if T > 16 or (T > 8 and plane > 512):
            assert look == 0
            assert blocking.smem_bytes(geom, stages, cell_bytes) == rings
            continue
        assert 1 <= look <= min(T, builder.MAX_LOOK)
        smem = builder.window_smem(geom, look, cell_bytes)
        assert blocking.smem_bytes(geom, stages, cell_bytes) == smem
        if cell_bytes == 4:
            assert smem <= rings
        geom_v = _geom(ndim, T, 2, bsize)
        assert builder.main_look(geom_v, cell_bytes) == 0


def test_register_form_needs_rows_on_whole_words():
    """The main path's register form copies the field stream ahead in
    4-byte words laid out from the first row's shift, so in bfloat16 it
    runs only where every stream row starts on the same half of a word (a
    padded plane of an even count of cells); elsewhere the ring form,
    whose shared memory is the layout's and fits wherever the register
    form's did.  float32 is unaffected, and the chain body's one-barrier
    form keeps the per-entry form there and says why."""
    odd = _geom(2, 4, 1, (65,), dims=(40, 280))
    even = _geom(2, 4, 1, (65,), dims=(40, 300))
    assert math.prod(odd.padded_dims) % 2 == 1
    assert math.prod(even.padded_dims) % 2 == 0
    assert not builder.whole_word_rows(odd, 2)
    assert builder.whole_word_rows(odd, 4) and builder.whole_word_rows(even, 2)
    assert builder.main_look(odd, 2) == 0
    assert builder.main_look(odd, 4) == builder.main_look(even, 2) == 4
    stages = ((STENCILS["diffusion2d"], None),)
    assert builder.kernel_limits(odd, stages, 2) is None
    chain = ((make_star(2, 1), None), (STENCILS["diffusion2d"], None))
    assert builder.chain_form(chain, odd, 2).startswith("a bfloat16 stream")
    assert builder.chain_form(chain, odd, 4) is None


def _parent_smem(geom, program, cell_bytes):
    """Shared memory the kernel took for ``program`` before the split: the
    layout's rings, ``par_vec`` rows a slot, and the tables."""
    dag = program if isinstance(program, DagSpec) else chain_dag(program)
    wins = dag_layout(unroll_dag(dag, geom.par_time), geom.par_vec).wins
    smem = sum(wins) * geom.par_vec * math.prod(geom.bsize) * cell_bytes
    tab = builder.tables_of(geom, program)
    return smem + (tab.smem if tab is not None else 0)


def _sweep():
    two = [((STENCILS["diffusion2d"], None),),
           ((STENCILS["hotspot2d"], None),),
           ((make_star(2, 1), None), (STENCILS["diffusion2d"], None)),
           ((STENCILS["diffusion2d"], None), (make_star(2, 0), None))]
    two += [_wave(2).dag, _diamond().dag,
            _mixed_diamond().resolved("clamp", (64, 9000)).dag,
            _fanin4().dag]
    three = [((STENCILS["diffusion3d"], None),),
             ((STENCILS["hotspot3d"], None),),
             ((make_star(3, 1), None), (STENCILS["diffusion3d"], None)),
             _wave(3).dag]
    one = [((make_star(1, 2), None),)]
    for ndim, programs, sizes in ((2, two, [(64,), (256,), (1024,), (2048,),
                                            (4096,), (8192,)]),
                                  (3, three, [(16, 16), (32, 32), (40, 40),
                                              (64, 64), (90, 90)]),
                                  (1, one, [()])):
        for bsize in sizes:
            for T in (1, 2, 3, 4, 6, 8, 12, 16, 17, 24, 40):
                for V in (1, 2, 4, 8, 16, 32):
                    yield ndim, programs, bsize, T, V


def test_no_geometry_the_kernel_took_is_refused_now():
    """Every (program, bsize, par_time, par_vec, storage) whose rings and
    tables fit a CTA before the split (the layout's slots) still passes
    ``kernel_limits``: the register form needs no more shared memory, and
    where it would not fit the ring form takes the plan.  A DAG (the wave
    in 2D and 3D, the diamond, a mixed-boundary diamond, a 4-way fan-in)
    runs the one-barrier form only where its deeper rings and tables fit
    a CTA (``win_form``), else a form with the parent's rings."""
    taken = dags = wins = 0
    for ndim, programs, bsize, T, V in _sweep():
        dims = {1: (4096,), 2: (64, 9000), 3: (16, 200, 200)}[ndim]
        try:
            geom = blocking.BlockGeometry(ndim, dims, 1, T, bsize, V)
        except ValueError:
            continue
        for program in programs:
            for cell_bytes in (4, 2):
                if _parent_smem(geom, program, cell_bytes) > \
                        blocking.SMEM_LIMIT:
                    continue
                taken += 1
                assert builder.kernel_limits(geom, program,
                                             cell_bytes) is None, (
                    ndim, bsize, T, V, cell_bytes, program)
                if not isinstance(program, DagSpec):
                    continue
                dags += 1
                if builder.win_form(program, geom, cell_bytes) is None:
                    wins += 1
                    assert (builder.win_smem(program, geom, cell_bytes)
                            + builder.WIN_TABLE_SMEM) <= blocking.SMEM_LIMIT
    assert taken > 500 and dags > 100 and 0 < wins < dags


def _wave(nd):
    """The wave equation: a star Laplacian of ``u`` fanned with ``u`` and
    ``u_prev`` into a 3-way combine, both fields rotated (two state nodes
    an iteration)."""
    lap = {"c0": -2.0 * nd}
    lap.update({f"c_{a}_{d}": 1.0 for a in range(nd) for d in (-1, 1)})
    return StencilProgram(
        (StencilStage(make_star(nd, 1), coeffs=lap, name="lapu",
                      inputs=("u",)),
         StencilStage(make_combine(nd, 3), name="unext",
                      inputs=("u", "u_prev", "lapu"),
                      coeffs={"w0": 2.0, "w1": -1.0, "w2": 0.16})),
        fields=("u", "u_prev"), updates={"u": "unext", "u_prev": "u"})


def _diamond():
    s = make_star(2, 1)
    return StencilProgram(
        (StencilStage(s, name="a", inputs=("u",)),
         StencilStage(s, name="b", inputs=("u",),
                      coeffs={"c0": 0.5, "c_0_1": 0.2}),
         StencilStage(make_combine(2, 2), name="m", inputs=("a", "b"),
                      coeffs={"w0": 0.6, "w1": 0.4})))


def _mixed_diamond():
    """The diamond with its stages clamp, reflect and constant 0.5."""
    a, b, m = _diamond().stages
    return StencilProgram(
        (StencilStage(a.stencil, name="a", inputs=("u",), boundary="clamp"),
         StencilStage(b.stencil, name="b", inputs=("u",), coeffs=b.coeffs,
                      boundary="reflect"),
         StencilStage(m.stencil, name="m", inputs=("a", "b"),
                      coeffs=m.coeffs, boundary="constant:0.5")))


def _fanin4():
    """Four inputs to one combine, radii 0 to 2, a field carried
    unchanged."""
    return StencilProgram(
        (StencilStage(make_star(2, 2), name="s0", inputs=("f1",)),
         StencilStage(make_star(2, 0), name="s1", inputs=("s0",)),
         StencilStage(stencils.make_box(2, 1), name="s2", inputs=("f0",)),
         StencilStage(make_combine(2, 4), name="out",
                      inputs=("s1", "s2", "f0", "f1"))),
        fields=("f0", "f1", "f2"), updates={"f0": "out", "f1": "f0"})


def _lap2d(x):
    return x((-1, 0)) + x((1, 0)) + x((0, -1)) + x((0, 1)) - 4.0 * x((0, 0))


def _gray_scott():
    """Pearson's reaction-diffusion: one custom stage a field, each
    tapping its own field at radius 1 and reading the other's centre."""
    def un(gets, c, aux=None):
        u, v = gets[0]((0, 0)), gets[1]((0, 0))
        return u + c["dt"] * (c["Du"] * _lap2d(gets[0]) - u * v * v
                              + c["F"] * (1.0 - u))

    def vn(gets, c, aux=None):
        v, u = gets[0]((0, 0)), gets[1]((0, 0))
        return v + c["dt"] * (c["Dv"] * _lap2d(gets[0]) + u * v * v
                              - c["Fk"] * v)
    gs_u = stencils.Stencil("gs_u", 2, 1, 15, 2, 1, False, ("Du", "F", "dt"),
                            un, arity=2)
    gs_v = stencils.Stencil("gs_v", 2, 1, 15, 2, 1, False, ("Dv", "Fk", "dt"),
                            vn, arity=2)
    return StencilProgram(
        (StencilStage(gs_u, name="un", inputs=("u", "v"),
                      coeffs={"Du": 0.16, "F": 0.035, "dt": 1.0}),
         StencilStage(gs_v, name="vn", inputs=("v", "u"),
                      coeffs={"Dv": 0.08, "Fk": 0.095, "dt": 1.0})),
        fields=("u", "v"), updates={"u": "un", "v": "vn"})


CASES = [  # (stages, dims, boundary, par_time, bsize, par_vec, tight): tight
    # where the critical-path radius times par_time is what a wrong row
    # travels, so one slab less of warm-up shows
    (lambda: [StencilStage("diffusion2d")], (70, 90), "clamp", 4, (32,), 1,
     True),
    (lambda: [StencilStage("hotspot2d")], (70, 90), "reflect", 3, (32,), 4,
     True),
    (lambda: [StencilStage(make_star(2, 1)), StencilStage("diffusion2d")],
     (70, 90), "clamp", 2, (32,), 1, True),
    (lambda: [StencilStage("diffusion3d")], (40, 20, 20), "constant:0.5", 2,
     (12, 12), 2, True),
    (lambda: [StencilStage("star1d_r2")], (300,), "clamp", 4, (), 1, True),
    (lambda: [StencilStage("star1d_r2")], (300,), "reflect", 4, (), 16, True),
    # DAGs: field streams, state nodes, fan-in, mixed boundaries, custom
    # apply, at V 1 and 4
    (lambda: _wave(2), (71, 90), "periodic", 4, (32,), 1, True),
    (lambda: _wave(2), (71, 90), "periodic", 3, (32,), 4, True),
    (lambda: _wave(3), (41, 20, 20), "clamp", 2, (12, 12), 1, True),
    (lambda: _wave(3), (41, 20, 20), "clamp", 3, (12, 12), 4, True),
    (_diamond, (72, 90), "clamp", 2, (32,), 1, True),
    (_diamond, (72, 90), "clamp", 3, (32,), 4, True),
    (_mixed_diamond, (73, 90), "clamp", 2, (32,), 1, True),
    (_mixed_diamond, (73, 90), "clamp", 2, (32,), 4, True),
    (_gray_scott, (74, 90), "periodic", 3, (32,), 1, True),
    (_gray_scott, (74, 90), "constant:0.0", 2, (32,), 4, True),
    # the fan-in's field f0 reaches back 2 rows an iteration only through
    # f1, which trails it: a wrong row travels less than 2 * par_time
    (_fanin4, (75, 90), "periodic", 2, (32,), 1, False),
    (_fanin4, (75, 90), "clamp", 3, (32,), 4, False),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}-{c[2]}-"
                                                      f"T{c[3]}-V{c[5]}")
def test_a_segment_owns_its_rows_after_the_warm_up(case):
    """Replayed on the plain version: for each segment of a split into
    many, the stream rows before the segment's first streamed slab set to
    NaN in every field (what a CTA that starts there has not seen) change
    none of the rows the segment owns, with and without PE forwarding
    (through the state nodes of a DAG); where the warm-up is tight, one
    slab less of it does."""
    build, dims, bc, T, bsize, V, tight = case
    problem = StencilProblem(build(), dims, boundary=bc)
    geom = plan(problem, RunConfig(backend="hopper", par_time=T,
                                   bsize=bsize, par_vec=V,
                                   device="cpu")).geometry
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.uniform(0.5, 2.0, problem.state_shape)
                         .astype(np.float32))
    bc0 = problem.structural_bc
    gp = ops._pad_blocked(g, geom, bc0)
    aux = None
    if problem.needs_aux:
        a = torch.from_numpy(rng.uniform(0, 0.1, dims).astype(np.float32))
        aux = ops._pad_blocked(a, geom, bc0)
    dag = problem.exec_dag
    c = ops.pack_dag_coeffs(dag, problem.resolve_coeffs())
    dom = builder._stream_dom(geom, bc0)
    nslabs = gp.shape[-geom.ndim] // V
    warm = builder.stream_warmup(dag, geom)
    seg = max(nslabs // 5, 1)      # more segments than a plan would cut
    nseg = -(-nslabs // seg)
    assert nseg > 2 and warm >= 1
    h = geom.size_halo
    cols = tuple(slice(h, h + n * cs) for n, cs in zip(geom.bnum,
                                                       geom.csize))

    def at(rows):                  # stream rows of every field
        return (Ellipsis, rows) + cols

    def before(x):                 # stream rows [0, x) of every field
        return (Ellipsis, slice(0, x)) + (slice(None),) * (geom.ndim - 1)
    for steps in (T, T - 1):
        full = builder.superstep_dag_plain(dag, geom, gp, c, steps, aux,
                                           torch.zeros_like(gp))
        for k in range(1, nseg):
            s0, s1 = k * seg, min((k + 1) * seg, nslabs)
            a = max(s0 - warm, 0)
            cut = gp.clone()
            cut[before(a * V)] = float("nan")
            got = builder.superstep_dag_plain(dag, geom, cut, c, steps, aux,
                                              torch.zeros_like(gp))
            rows = slice(s0 * V, min(s1 * V, dom))
            assert torch.equal(got[at(rows)], full[at(rows)])
            if tight and a > 0 and rows.start < rows.stop:
                # one slab less of warm-up would not do
                short = gp.clone()
                short[before((a + 1) * V)] = float("nan")
                bad = builder.superstep_dag_plain(
                    dag, geom, short, c, steps, aux, torch.zeros_like(gp))
                if steps == T:
                    assert bad[at(rows)].isnan().any()
