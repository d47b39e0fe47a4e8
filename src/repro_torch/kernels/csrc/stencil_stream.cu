// Streaming super-step of a stencil program, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dag_kernel` of src/repro/kernels/builder.py
// (launched by `_superstep_dag_impl` through `superstep_chain` and
// `superstep_dag`) for these forms: linear stage chains and stage DAGs
// (several field streams, fan-out, fan-in through `make_combine`, state
// nodes), `par_time` iterations unrolled into one super-step, 1D, 2D and 3D
// grids, the clamp, periodic, reflect and constant boundaries (per axis and
// per stage, a DAG's stages included), block planes of any size, tables of
// any length that shared memory holds, float32 or bfloat16 storage with
// float32 arithmetic, and slabs of V = `par_vec` rows (planes in 3D) per
// tick.  A stage is one of the four Table-2 stencils (radius 1), a tap
// table for a stencil whose update is an ordered sum of coefficient x
// neighbour (`make_star`, `make_box`; any radius), a combine `w0*x0 +
// w1*x1 + ...` of its inputs' centres, or a stencil with a custom `apply`
// (any radius and arity), whose device function is generated per program
// (see Custom stencils below).  It computes what that kernel computes: the
// same padded input and output layout and, in the compute region it
// writes, the same values.
//
// Design.  One CTA per overlapped block and stream segment, and one such
// grid per member of a batch (blockIdx.z; the TPU runs the members one
// after the other under `lax.map`, src/repro/api/backends.py:463-478).
// A member's state, output and per-member aux lie `member_stride` and
// `aux_stride` cells after the previous member's, offsets taken in 64 bits
// (a batch of wave2d states at 16384^2 passes 2^31 cells); no CTA's
// arithmetic depends on blockIdx.z, so a batched launch equals one launch
// per member bit for bit.  The offsets are compiled only into the batch
// libraries (STENCIL_BATCH): held in registers, the offset pointers cost
// single-grid launches up to 11% on an H100 (hotspot2d at V = 8, diamond2d
// under reflect), so a single grid runs code without them.  The CTA
// streams axis 0 one slab of V rows per tick through the unrolled entries,
// described by the `Program` table the launcher builds from
// `repro_torch.programs.dag_layout(plan, V)`: per entry its lag behind the
// input streams and its producers' and own rings, all counted in slabs.
// Shared memory holds one ring per producer: each field stream that an
// entry reads and every entry that another entry reads; a value that only
// feeds the output writes straight to device memory, and only the `csize`
// columns of its block.  A ring of W slots holds W*V block planes, and row
// x of the stream sits in plane x mod W*V (slab s in slot s mod W), so a
// ring is addressed by row as when V = 1.  A ring is as deep as its
// consumers need: 2R+1 slots for a consumer of slab radius R = ceil(radius
// / V) one level below, deeper where an edge skips levels (the short branch
// of a diamond, a state node's previous value).
//
// The stream split (every body).  blockIdx.y is the block row plus `nby`
// times the segment: the stream's slabs are cut into segments of `seg`
// slabs, and the CTA of segment k writes slabs [k*seg, (k+1)*seg) only —
// every output row, a field carried unchanged and a DAG's outputs of any
// lag included.  It streams from `warm` slabs before them (the
// critical-path radius times par_time, in slabs: kernels/builder.py
// stream_warmup; a DAG's state nodes take their previous value at no
// radius), whose values are wrong at first — the rows before are not in
// its rings — and are thrown away, as the blocked halo's are; each output
// row is written by one CTA, with the same arithmetic in the same order,
// so the split changes no bit.  Stream-axis boundaries apply at rows 0 and
// dom-1 only (a periodic stream's extension included).  The launcher cuts
// as many segments as fill the card for two waves at the kernel's
// occupancy, fewer where the warm-up would pass 5% of a segment
// (kernels/builder.py segment_plan): 38 segments (2622 CTAs) for the
// 16384^2 grid at bsize 256, thousands for a 1D grid.
//
// The main path (kOp = 0..3, one Table-2 stage, every entry under stage
// 0's boundary) runs one barrier a tick.  Entry i computes slab t-i-1 at
// tick t from its producer's slab of the tick before (the blocked-axis
// neighbours, in shared memory, double-buffered by tick parity) and of
// this tick (the down tap, which the same thread computed just before, at
// the same cell), so all entries of a tick run between one pair of
// barriers.  A thread takes every row of a slab at its cell (vt = 1), and
// reads the stream-axis taps of its cell from its own column.  Its
// register form (V = 1, a cell a thread, at most 16 entries:
// `main_windows`) keeps rows j-1 and j of every entry's producer in
// registers, turned over by unrolling the tick loop three times, copies
// the field stream `look` (up to 4) slabs ahead into staged slots with
// cp.async, keeps Hotspot's power in a per-thread shift register, and runs
// its steady ticks (every entry in range, away from the stream's ends, no
// forwarding) without per-entry tests.  Its ring form (V > 1, planes over
// 1024 cells, more entries: `main_rings`) keeps the layout's 3-slot rings
// and reads the stream-axis taps from the thread's own column of them.  A
// cell outside the grid computes at the position stage 0's boundary maps
// it to and holds that position's values; where reflect maps a block's
// overhang onto cells outside the grid (a grid that ends well inside the
// block), the two differ, and such a block reads the mapped column behind
// a barrier after every entry (`own_columns`).
//
// The DAG bodies at V = 1 (`dag_kernel`, kernels/builder.py win_layout)
// run one barrier a tick too: an entry that reads another thread's cell
// lags its producer by one row more than the stencil's reach, so it reads
// only rows written at an earlier tick, and its own cell of the rows its
// thread wrote this tick; a state node is an alias of the value it
// selects, and a value read only by combines of its own lag stays in a
// register.  Where a thread's own column does not hold what it reads (the
// mixed-boundary body's grid-edge blocks re-impose at read time;
// CTA-uniform) the CTA takes a barrier after every entry; where the
// single-boundary body's reflect maps a block's overhang past the grid,
// or the deeper rings do not fit, the launcher runs the table-driven form.
//
// The chain body at V = 1 (`chain_win_kernel`, kernels/builder.py
// chain_layout: the same lags and rings over the chain as a path graph)
// runs one barrier a tick too, its values re-imposed at push time under
// their consumer's kinds as `chain_body` does; a consumer that maps a cell
// under other blocked-axis kinds than the value it reads took, a reflect
// overhang past the grid, the large-table route, V > 1, one-cell (1D) and
// over-1024-cell planes, and a bfloat16 stream whose rows do not all start
// on one half of a 4-byte word keep `chain_kernel`/`chain_kernel_big`
// (kernels/builder.py chain_form).  It copies the field stream ahead with
// cp.async, runs a Table-2 stage and a star of radius 0 or 1 as
// straight-line code, and keeps each entry's newest own-column rows in
// registers where it unrolls the entries (up to 8).
//
// The chain body's per-entry form (kOp = -1 where the one-barrier form
// does not run) and the DAG bodies' table-driven forms (V > 1, the wide
// form, the large-table route, and those V = 1 launches) keep a
// barrier after every entry: at tick t the CTA pushes slab t of each field
// stream (coalesced; each thread's first rows prefetched one tick ahead
// into registers), then entry i computes slab j = t - lag_i, row by row,
// from rows of its producers' rings up to R slabs either side; the barrier
// after each entry puts a producer's slab in its ring before its consumer
// reads it, and the layout's window depths guarantee that no slot is
// overwritten while it is still read.

// Storage.  `T`, a template argument, is the storage type: float or
// __nv_bfloat16.  The input, aux, output and every ring hold T; a stage
// widens what it reads to float, computes in float and rounds its value to
// T once (round to nearest even) before the value enters a ring or the
// output, as `repro_torch.core.precision.apply_stage` and the TPU kernel's
// `val.astype(sdtype)` do.  Forwarding and state-node selects copy T values.
// For float every conversion is the identity, so the float kernels are the
// code they were before T.
//
// Threads.  A CTA of a table-driven body computes `vt` rows of a slab at
// once, `vt` the largest divisor of V with plane * vt <= 1024 (plane = the
// block's cells in a row or plane); thread tid < plane * vt takes cell tid
// mod plane of rows tv, tv + vt, ... (tv = tid / plane) of each slab,
// `rows` = V / vt in all.  The main-path body takes vt = 1.  The
// table-driven bodies also need a thread per entry to build the tick
// records, so the CTA has max(plane * vt, entries) threads, rounded up to a
// multiple of 32 (`builder.cta_shape` mirrors the launcher's rule); threads
// past plane * vt only build records and meet the barriers.  A plane over
// 1024 cells runs the wide form (`kWide`): 1024 threads, thread tid takes
// cells tid, tid + 1024, ... with every row of a slab (vt = 1, no register
// prefetch); the large-table route runs it at any plane, on min(plane,
// 1024) threads rounded up to 32, each building the records of entries
// tid, tid + threads, ....
//
// Stream rows.  The stream extent `ns` is padded to a multiple of V past
// the real extent `dom` (the grid's, plus the periodic extension, which for
// a periodic stream axis is the grid extended by the halo on each side,
// staged in device memory by kernels/ops.py).  A stream-axis tap of row r
// outside [0, dom-1] follows the tapping stage's stream-axis kind, as the
// TPU kernel's `stream_tap` does: clamp (and the periodic extension) clips
// r, reflect mirrors it about the edge row without repeating it (period
// 2*dom-2), constant reads the fill.  A mirrored row lies within the tap's
// radius of the row computed, so inside the rows the ring holds at every V.
// Rows at or past `dom` are never tapped, so they are neither read,
// computed nor written (the TPU kernel computes and discards them).
// Blocked-axis taps that leave the block are clamped to it — garbage, but
// inside the halo the overlap discards (the halo is rad * par_time, rad
// the DAG's critical-path radius).  A chain entry whose iteration is >=
// `steps` forwards its centre tap (PE forwarding); in a DAG the state nodes
// forward: each updated field takes its new value while the iteration is <
// `steps`, else its previous one, and the stages of later iterations
// compute nothing.
//
// Boundaries.  On grid-edge blocks every value a consumer reads is
// re-imposed along each blocked axis under the consumer's kind, as the TPU
// kernel's `_reimpose_axis` does: a cell outside the grid takes the value
// at the clamped position (clamp), at the mirrored position (reflect:
// 2*lo - y below the edge lo, 2*hi - y above the edge hi, modulo the
// block), or the fill rounded to T (constant); along a periodic axis the
// halo holds wrapped copies and nothing is re-imposed.  Each stage carries
// its kinds and fill in the `Stage` table.  In a chain every value has one
// consumer, the next entry, whose kinds the value takes at push time (the
// TPU kernel's `plan.linear` path); so does every value of a DAG whose
// stages share one boundary (kOp = -2).  A DAG whose stages differ (kOp =
// -3) keeps its values as computed and re-imposes at read time, as the
// TPU kernel's `cat_of`: each tap's blocked position is clipped to the
// block and then mapped under the consumer's kinds (`reimposed`), or reads
// the fill, on grid-edge blocks only (a CTA-uniform test).  Mapping taps
// needs no more shared memory; one ring copy per distinct consumer
// boundary would multiply the rings of the shared values.  The field
// streams arrive padded under stage 0's BC and are pushed as they are; a
// consumer with another BC re-imposes them too.
//
// Hotspot's `power` is read at the centre of each row straight from device
// memory, which L2 serves (in the main path's register form a row a tick
// into a shift register).  The arithmetic uses __fmul_rn/__fadd_rn, which
// nvcc never contracts into FMAs, in the operation order of
// src/repro_torch/core/stencils.py (a tap table in the order of its
// `apply`), row by row, so the kernel and its plain version agree bit for
// bit in both storage types, and a run at any V equals the run at V = 1.
//
// Loop bodies.  Every instruction an entry adds is paid on each of its
// rows, so the kernel has a body for the paper's main path — one
// Table-2 stage (kOp = its id): lag i+1 slabs, coefficients in registers,
// in its register form (`main_kernel<kOp, 0, T, kBC, kT>`, kT = 4, 8 or 16
// entries held) or its ring form (kT = 0) — one for any chain (kOp = -1,
// `chain_win_kernel` at V = 1, `chain_kernel` where it does not run), one
// for any DAG whose stages share one boundary (kOp = -2) and one for any
// DAG (kOp = -3; both `dag_kernel` at V = 1, and `stream_kernel`,
// `stream_kernel_x` where it does not run).  The
// table-driven bodies come in four forms (`Form`): V = 1, where V, vt and
// the row loop fold away; one row of each slab per thread; several rows
// per thread; several cells per thread (the wide form), and in the
// large-table route; the main path's ring form in three (V = 1, every row
// of a slab, the wide form).  All in two storage
// types (one library each), and with or without the reflect and constant
// boundaries (kBC; kOp = -3 only with them), the DAG bodies' one-barrier
// form (`dag_kernel`: kOp -2 with and without kBC, -3) and the chain
// body's (`chain_win_kernel`: 4, 8 or 0 entries unrolled, with and
// without kBC): 82 kernels a library, 328 in the four.  Slab bookkeeping
// with a runtime V cost the V = 1 main path 12% and the DAG body 28% on an
// H100, hence the forms; deciding the boundary kinds at run time cost the
// float32 bodies 3-31%, hence kBC.
// The table-driven bodies copy the table into static shared memory at
// start (`Rec`/`DagRec`: one flat record per entry, rings in rows, a
// Table-2 stage's coefficients inline; the taps and coefficients of tap
// tables), and at the top of each tick thread i computes entry i's ring
// slots for that tick's slab (`TickRec`/`DagTick`), so an entry costs its
// threads one record read and no division.  Striding these two loops over
// the entries instead cost the tap chain about a fifth on an H100
// (chip_smoke.py's advect_diffuse2d).  The DAG body adds the field
// streams, several producers per entry, the combine and the state-node
// select.

// Tables.  Entries, stages (op, ranges, boundary kinds and fill), taps, the
// coefficients of all stages (concatenated in stage order) and the field
// streams travel in one `Program` struct passed by value as a
// __grid_constant__ kernel parameter (3,616 bytes, inside the 4 KB
// parameter space): no device buffer and no copy before the launch.  The
// chain body adds 9,472 bytes of static shared memory to the rings, the DAG
// body 11,520 (`kernels/_build.py::TABLE_SMEM`).  A program past any of
// the `Program` capacities (entries, stages, taps, coefficients, field
// streams, inputs of one entry, or the 16-bit lags and ring slots and
// 8-bit tap offsets of its rows) takes the large-table route: tables of
// the program's own lengths with 32-bit fields and each entry's inputs
// out of line, back to back in a device buffer (`DevTable`;
// `kernels/builder.py` builds and copies it once per program), and the
// records, inputs, taps and coefficients in dynamic shared memory in
// front of the rings, sized to the program.  A device buffer rather than
// the 32 KB parameter space of CUDA 12.1+: its length is bound only by
// shared memory, and one route serves every length.
//
// Bound.  Device-memory bytes: each block reads `dom * bsize` cells per
// field stream (plus the same of `power`) and writes `dom * csize` cells per
// field per super-step, sizeof(T) bytes a cell (`kernels/ops.py::
// dma_traffic_bytes` bills the slab pad too, as the TPU kernel moves it);
// the arithmetic is a few FLOPs per byte, far below the card's balance
// point.
//
// Custom stencils.  A stencil with a custom `apply` runs as op kCustomOp
// in a library of its own program: kernels/codegen.py traces `apply` and
// writes `custom::custom_apply(fn, g, c, aux)` into the header
// stencil_custom.cuh, and kernels/_build.py compiles this file with
// -DSTENCIL_CUSTOM=1 and that header on the include path, instantiating
// only the kernel the program runs (its body CUSTOM_BODY, form
// CUSTOM_FORM, CUSTOM_BC and CUSTOM_BIG, the storage type and the batch
// offsets): one kernel, not 57.  Without STENCIL_CUSTOM none of its code is
// compiled, so the other libraries are the code they were.  The op reads
// its taps one by one through a getter g(z, ds, dy, dx) over input z's ring
// and lag, as the mixed-boundary body reads a Table-2 stage
// (`table2_get`): in the chain and single-boundary DAG bodies at the
// position the value is computed at, clipped to the block, stream rows
// under the stage's kind (`ring_tap`); in the mixed-boundary body
// re-imposed under the consumer's kinds, on every CTA (on interior CTAs
// this maps nothing, and it ran 4% faster there than the push-time code).
// Its aux value is read at `aux + at`, as Hotspot's.
// A stage's `tap_lo` holds its function index.
//
// Left on the table (chip_smoke.py on an H100 80GB HBM3 at 700 W, per
// super-step): the main path's register form runs d2 in 2.73 ms, 4.3x
// its 0.641 ms bytes bound, and h2 in 4.22 against 0.962, issue-bound
// (index and predicate work beside each entry's arithmetic); its
// blocked-axis neighbours are shared-memory loads, not shuffles along a
// warp's row.  A 3D plane of
// 32 x 32 cells is a CTA of 1024 threads at 64 registers, one an SM: d3
// 1.43 ms against 0.215 (two an SM, at 32 registers, spilled and ran
// slower).  The ring form (V > 1, planes over 1024 cells, more than 16
// entries) reads the stream-axis taps from shared memory, and from V = 8
// its rings hold one CTA of 8 warps an SM, where the first design ran 32:
// hotspot2d at V = 8 takes 24.4 ms against 20.5 before.  The chain body's
// one-barrier form reads its records and tick records from shared memory
// per entry and tick and dispatches on the stage's op at run time (see
// PERF.md for its times); a tap table other than a star of radius 0 or 1
// loops over its taps.  The chain body's per-entry form keeps a barrier
// per entry and tick and pushes rows loaded a tick ahead into registers:
// advect_diffuse2d 14.9 ms, 23x its bound.  The DAG bodies' one-barrier
// form reads the stream-axis taps from its rings in shared memory, and
// loads the field streams a tick ahead into registers, not with cp.async
// further ahead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

// The generated device functions of one program's custom stencils
// (kernels/codegen.py: program_header).
#ifndef STENCIL_CUSTOM
#define STENCIL_CUSTOM 0
#endif
#if STENCIL_CUSTOM
#include "stencil_custom.cuh"
#endif

// Capacities of the `Program` table passed as a kernel parameter
// (kernels/_build.py: MAX_*); a program past any of them takes the
// large-table route, whose tables are sized to the program.
constexpr int kMaxEntries = 64;
constexpr int kMaxStages = 16;
constexpr int kMaxTaps = 128;
constexpr int kMaxCoeffs = 192;
constexpr int kMaxFields = 4;
constexpr int kMaxInputs = 4;
constexpr int kMaxThreads = 1024;
// The main path's register form: the entries whose windows a thread holds,
// and the slabs its copies run ahead (kernels/builder.py: WINDOW_ENTRIES,
// MAX_LOOK).
constexpr int kMaxWindowEntries = 16;
constexpr int kMaxLook = 4;
// ... and the most entries it holds in a plane of 1024 cells (more take at
// most 512: kernels/builder.py: WIDE_WINDOW_ENTRIES)
constexpr int kMaxWideWindowEntries = 8;
constexpr int kMaxBatch = 65535;  // gridDim.z

// Whether this library advances batches (kernels/_build.py: LIBRARIES).
#ifndef STENCIL_BATCH
#define STENCIL_BATCH 0
#endif

// The structs are passed from Python (ctypes) and so live outside the
// unnamed namespace: the exported launcher's signature names them.

// Extents in cells.  A 2D grid is a 3D one with a single blocked y row:
// py = by = cy = dy = 1 and hy = 0; a 1D grid one with a single blocked
// cell (all of them 1, hy = hx = 0).
struct Params {
  int ns;           // stream rows (2D) / planes (3D), periodic extension in,
                    // padded to a multiple of V
  int dom;          // real stream rows: no tap reaches past [0, dom-1]
  int V;            // par_vec: rows per slab, one slab per tick
  int ticks;        // ns / V + output lag (in slabs)
  int py, px;       // padded extents of the blocked dims
  int by, bx;       // block extents
  int cy, cx;       // compute extents
  int dy, dx;       // grid extents
  int hy, hx;       // halo widths
  int steps;        // iterations that compute; later ones forward
  int n_entries;    // unrolled entries
  int n_fields;     // field streams (1 but for a DAG)
  int vt;           // rows of a slab computed at once (set by the launcher)
  int rows;         // rows of a slab per thread, V / vt (the launcher)
  int seg;          // stream slabs a segment owns
  int warm;         // slabs a segment streams before its own
  int nby;          // blocks along y: blockIdx.y = block + nby * segment
  int look;         // main path: slabs copied ahead (0: the ring form)
  int win;          // a one-barrier form: 1 for a DAG's (`dag_kernel`), 1
                    // + the entries the chain body's unrolls for a
                    // chain's (`chain_win_kernel`: 4, 8; 0 its ring
                    // form)
  int rad;          // the largest radius of a stage (the one-barrier forms)
};

// One unrolled entry.  Lags and rings are counted in slabs; `out_slots` is 0
// for a value that no entry reads (no ring).  In the chain body's
// one-barrier form `pad` is 1 where the stage's own-column taps read the
// register window, and the stage's `Stage::pad` 1 or 2 marks a star of
// radius 0 or 1 (kernels/builder.py `_chain_table`).  `stage` -1 marks a DAG's
// state node, which selects input 0 (the new value) while its iteration is
// < steps, else input 1 (the field's previous value).  `field` is the
// output field the entry's value drains to, or -1.  A chain entry reads
// input 0 only.  In the DAG bodies' one-barrier form `in_base` holds each
// input's value id (field stream f is f, entry e is n_fields + e),
// `in_slots` nothing, and `pad` the entry's register carry (-1: none).
struct Entry {
  short lag, stage, iteration, field;
  short out_base, out_slots, n_in, pad;
  short in_base[kMaxInputs], in_slots[kMaxInputs];
};
static_assert(sizeof(Entry) == 32, "Entry layout changed");

// `op`: 0 diffusion2d, 1 hotspot2d, 2 diffusion3d, 3 hotspot3d, 4 tap
// table, 5 combine (coefficient z weighs input z's centre), 6 custom
// (`tap_lo` is its function index in `custom_apply`).  `ks`, `ky`,
// `kx`: the stage's boundary kind along the stream axis and the blocked y
// and x axes (a `Kind`; kPeriodic, which re-imposes nothing, along an axis
// the grid does not have), `fill` its constant fill.
struct Stage {
  short op, coeff_lo, tap_lo, tap_n;
  signed char ks, ky, kx, pad;
  float fill;
};
static_assert(sizeof(Stage) == 16, "Stage layout changed");

// Offsets (stream, y, x; y = 0 in 2D, both 0 in 1D) and the stage-local
// coefficient index.
struct Tap {
  signed char ds, dy, dx;
  unsigned char ci;
};

// One field stream of a DAG: its ring (`slots` 0: no entry reads it) and
// whether the field is carried unchanged, so written out as it streams in.
struct Stream {
  short base, slots, out, pad;
};

// The large-table route's rows (kernels/_build.py: BigEntry, Input,
// BigTap, BigStream): 32-bit fields, and an entry's inputs out of line,
// `n_in` of them from `in_lo` on in the table's `ins`.  Its stages are
// `Stage`s: their tap and coefficient offsets stay far below 2^15, since
// shared memory holds fewer taps and coefficients.
struct BigEntry {
  int lag, stage, iteration, field;
  int out_base, out_slots, n_in, in_lo;
};
struct Input {
  int base, slots;
};
struct BigTap {
  int ds, dy, dx, ci;
};
struct BigStream {
  int base, slots, out, pad;
};

struct Program {
  // what a body reads of the table's lengths and tap type (the
  // large-table route's `DevTable` carries its own)
  static constexpr bool kBig = false;
  using TapT = Tap;
  static constexpr int n_taps = kMaxTaps, n_coeffs = kMaxCoeffs;
  Entry e[kMaxEntries];
  Stage s[kMaxStages];
  Tap taps[kMaxTaps];
  float c[kMaxCoeffs];
  Stream f[kMaxFields];
};
// the ctypes mirror in kernels/_build.py (PROGRAM_BYTES) has this size
static_assert(sizeof(Program) == 3616, "Program layout changed");

namespace {

constexpr int kTapOp = 4;
constexpr int kCombineOp = 5;
constexpr int kCustomOp = 6;
constexpr int kSelectOp = 7;  // a state node (no stage)
constexpr int kChainBody = -1;
constexpr int kDagBody = -2;
constexpr int kMixBody = -3;  // a DAG whose stages differ in boundary
constexpr float kTempAmb = 80.0f;  // Hotspot ambient temperature

// Boundary kinds (kernels/builder.py: BC_IDS).
enum Kind { kClamp = 0, kPeriodic = 1, kReflect = 2, kConstant = 3 };

// Storage to float and back: the identity for float; for bfloat16 the
// exact widening and one round to nearest even.
__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float wide(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <class T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Ring offsets of one cell and its blocked-axis neighbours (clamped to the
// block), and its device-memory offset within a row/plane (a padded plane
// holds far fewer than 2^31 cells).
struct Pos {
  int c, n, s, w, e, g;
};

__device__ __forceinline__ Pos pos_at(int y, int x, const Params& p, int sy,
                                      int sx) {
  Pos q;
  q.c = y * p.bx + x;
  q.n = max(y - 1, 0) * p.bx + x;
  q.s = min(y + 1, p.by - 1) * p.bx + x;
  q.w = y * p.bx + max(x - 1, 0);
  q.e = y * p.bx + min(x + 1, p.bx - 1);
  q.g = (sy + y) * p.px + sx + x;
  return q;
}

// A thread's cell `t` along one blocked axis of a block that starts at
// `start` (padded coordinates): the grid's edges in block coordinates are
// lo = h - start and hi = d - 1 + h - start.  `clamp` is the position clamp
// re-imposes (the edge cell), `mirror` the one reflect does (the cell
// mirrored about the edge, modulo the block of n cells), `out` whether the
// cell is outside the grid (constant: the fill).
struct Axis {
  int clamp, mirror;
  bool out;
};

__device__ __forceinline__ Axis axis_at(int t, int start, int h, int d,
                                        int n) {
  const int lo = h - start, hi = d - 1 + h - start;
  Axis a;
  a.clamp = min(max(t, max(lo, 0)), min(hi, n - 1));
  int m = t > hi ? 2 * hi - t : (t < lo ? 2 * lo - t : t);
  m %= n;
  a.mirror = m < 0 ? m + n : m;
  a.out = t < lo || t > hi;
  return a;
}

// Where cell `t` takes a value that enters a ring under kind `k`.
__device__ __forceinline__ int axis_pos(const Axis& a, int t, int k) {
  return k == kClamp ? a.clamp : (k == kReflect ? a.mirror : t);
}

// Whether the cell takes the fill under the blocked-axis kinds ky, kx.
__device__ __forceinline__ bool takes_fill(const Axis& ay, const Axis& ax,
                                           int ky, int kx) {
  return (ky == kConstant && ay.out) || (kx == kConstant && ax.out);
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// What a stencil reads in place of stream rows j-1 (`up`) and j+1 (`dn`)
// past the rows under a constant stream axis: the fill.  Without kBC
// neither, and the reads fold to the rows'.
struct Ends {
  bool up, dn;
  float fill;
};

template <class T>
__device__ __forceinline__ float row_at(const T* row, int c, bool f,
                                        float fill) {
  return f ? fill : wide(row[c]);
}

// The Table-2 stencils.  `up` is stream row j-1, `mid` row j, `dn` row j+1
// of the producer (`e` says where the fill replaces `up` or `dn`); `c` the
// stage's coefficients in `coeff_names` order.

// cc, cw, ce, cs, cn
template <class T>
__device__ __forceinline__ float diffusion2d(const T* up, const T* mid,
                                             const T* dn, const Pos& q,
                                             const float* c, const Ends& e) {
  float v = mul(c[0], wide(mid[q.c]));
  v = add(v, mul(c[1], wide(mid[q.w])));
  v = add(v, mul(c[2], wide(mid[q.e])));
  v = add(v, mul(c[3], row_at(dn, q.c, e.dn, e.fill)));
  return add(v, mul(c[4], row_at(up, q.c, e.up, e.fill)));
}

// sdc, rx1, ry1, rz1
template <class T>
__device__ __forceinline__ float hotspot2d(const T* up, const T* mid,
                                           const T* dn, const Pos& q,
                                           const float* c, const Ends& e,
                                           float aux) {
  const float v = wide(mid[q.c]);
  const float two_v = mul(2.0f, v);
  const float dy = sub(add(row_at(up, q.c, e.up, e.fill),
                           row_at(dn, q.c, e.dn, e.fill)),
                       two_v);
  const float dx = sub(add(wide(mid[q.e]), wide(mid[q.w])), two_v);
  float t = add(aux, mul(dy, c[2]));
  t = add(t, mul(dx, c[1]));
  t = add(t, mul(sub(kTempAmb, v), c[3]));
  return add(v, mul(c[0], t));
}

// cc, cw, ce, cs, cn, cb, ca
template <class T>
__device__ __forceinline__ float diffusion3d(const T* up, const T* mid,
                                             const T* dn, const Pos& q,
                                             const float* c, const Ends& e) {
  float v = mul(c[0], wide(mid[q.c]));
  v = add(v, mul(c[1], wide(mid[q.w])));
  v = add(v, mul(c[2], wide(mid[q.e])));
  v = add(v, mul(c[3], wide(mid[q.s])));
  v = add(v, mul(c[4], wide(mid[q.n])));
  v = add(v, mul(c[5], row_at(up, q.c, e.up, e.fill)));
  return add(v, mul(c[6], row_at(dn, q.c, e.dn, e.fill)));
}

// cc, cn, cs, ce, cw, ca, cb, sdc
template <class T>
__device__ __forceinline__ float hotspot3d(const T* up, const T* mid,
                                           const T* dn, const Pos& q,
                                           const float* c, const Ends& e,
                                           float aux) {
  float v = mul(wide(mid[q.c]), c[0]);
  v = add(v, mul(wide(mid[q.n]), c[1]));
  v = add(v, mul(wide(mid[q.s]), c[2]));
  v = add(v, mul(wide(mid[q.e]), c[3]));
  v = add(v, mul(wide(mid[q.w]), c[4]));
  v = add(v, mul(row_at(dn, q.c, e.dn, e.fill), c[5]));
  v = add(v, mul(row_at(up, q.c, e.up, e.fill), c[6]));
  v = add(v, mul(c[7], aux));
  return add(v, mul(c[5], kTempAmb));
}

// Slot of a ring row: `m` is the slot of row j, `r` a row within W-1 of j
// (true of every tap, mirrored ones included: |r - j| <= radius <= R*V <
// W*V rows).  One wrap, no division.
__device__ __forceinline__ int slot_of(int m, int r, int j, int W) {
  const int s = m + r - j;
  return s < 0 ? s + W : (s >= W ? s - W : s);
}

// The slots of rows x-1 and x+1 around slot m of row x in a ring of W rows
// (a Table-2 stencil's `up` and `dn`), under stream-axis kind `ks`: at the
// ends clamp (and the periodic extension) takes row x again, reflect the
// row on the other side (rows 1 and dom-2); constant reads the fill there
// (`ends`).  Without kBC every kind is taken for clamp.
template <bool kBC>
__device__ __forceinline__ int slot_up(int m, int x, int W, int ks) {
  if (x == 0) return kBC && ks == kReflect ? (m == W - 1 ? 0 : m + 1) : m;
  return m == 0 ? W - 1 : m - 1;
}
template <bool kBC>
__device__ __forceinline__ int slot_dn(int m, int x, int W, int dom, int ks) {
  if (x == dom - 1) return kBC && ks == kReflect ? (m == 0 ? W - 1 : m - 1) : m;
  return m == W - 1 ? 0 : m + 1;
}
template <bool kBC>
__device__ __forceinline__ Ends ends(int x, int dom, int ks, float fill) {
  const bool f = kBC && ks == kConstant;
  return {f && x == 0, f && x == dom - 1, fill};
}

// Stream row `r` outside [0, dom-1] under kind `ks`: clipped (clamp, the
// periodic extension) or mirrored (reflect, period 2*dom-2); constant reads
// the fill, so any row in range does.
__device__ __forceinline__ int stream_row(int r, int dom, int ks) {
  if (ks == kReflect) {
    const int per = max(2 * dom - 2, 1);
    int m = r % per;
    m = m < 0 ? m + per : m;
    return m >= dom ? per - m : m;
  }
  return min(max(r, 0), dom - 1);
}

// One entry of a chain, flattened for shared memory: its ring layout (in
// rows: a slot of the table is V rows), its stage's op, coefficient/tap
// ranges and stream-axis kind and fill, its consumer's blocked-axis kinds
// (`kyx`: ky | kx << 8) and fill, and a Table-2 stage's coefficients
// inline.  Both fills are rounded through the storage type.
struct Rec {  // 96 bytes; the padding keeps `c` 16-byte aligned
  int lag, in_base, in_slots, out_base;
  int out_slots, op, iteration, tap_lo;
  int tap_n, coeff_lo, ks, kyx;
  float fill_s, fill_b, pad0, pad1;
  float c[8];
};
// kernels/_build.py prices the chain body's tables with REC_BYTES
static_assert(sizeof(Rec) == 96, "Rec layout changed");

// One entry at one tick: the slab j it computes, whether it is in the
// stream (bit 0) and computes rather than forwards (bit 1), the slot m of
// the slab's first row in its producer's ring (relative to the ring's
// base), and the offset (in cells) of that row in its own ring.  Row r of
// the slab sits r slots (planes) further in both: a ring's depth is a
// multiple of V.
struct TickRec {  // 32 bytes: two 16-byte loads
  int j, flags, m, outo;
  int pad0, pad1, pad2, pad3;
};
// ... and TICKREC_BYTES
static_assert(sizeof(TickRec) == 32, "TickRec layout changed");

// A tap table: sum over the stage's `tap_n` taps from `tap_lo`, in table
// order, of coefficient x neighbour, the first term alone (as
// `make_star`/`make_box` `apply`).  `ring` is the producer's ring of W
// rows, `m` the slot of row x; (y, xx) the cell; `taps` and `c` the tables
// in shared memory.  Stream taps past the rows follow `ks` (`stream_row`;
// constant reads `fill`); without kBC they clip.
template <bool kBC, class T, class Tp>
__device__ __forceinline__ float tap_sum(const Tp* taps, const float* c,
                                         int tap_lo, int tap_n, int coeff_lo,
                                         const T* ring, int W, int m,
                                         int plane, int x, int y, int xx,
                                         const Params& p, int ks,
                                         float fill) {
  float acc = 0.0f;
  for (int n = 0; n < tap_n; ++n) {
    const Tp tp = taps[tap_lo + n];
    int r = x + tp.ds;
    const bool oob = kBC && (r < 0 || r >= p.dom);
    r = oob ? stream_row(r, p.dom, ks) : min(max(r, 0), p.dom - 1);
    const int ty = min(max(y + tp.dy, 0), p.by - 1);
    const int tx = min(max(xx + tp.dx, 0), p.bx - 1);
    const float v =
        oob && ks == kConstant
            ? fill
            : wide(ring[slot_of(m, r, x, W) * plane + ty * p.bx + tx]);
    const float term = mul(c[coeff_lo + tp.ci], v);
    acc = n ? add(acc, term) : term;
  }
  return acc;
}

#if STENCIL_CUSTOM
// The cell offset of stream row x + d/plane in a ring of WP cells from
// `base`, `at` the offset of row x's plane: one wrap, as `slot_of`.
__device__ __forceinline__ int ring_plane(int at, int base, int WP, int d) {
  const int s = at - base + d;
  return base + (s < 0 ? s + WP : (s >= WP ? s - WP : s));
}

// A custom op's tap (ds, dy, dx) of stream row x at block cell (y, xx), in
// the ring of WP cells from `base` whose plane of row x is at `at`: as a
// tap of `tap_sum`, the blocked position clipped to the block and a stream
// row past the rows under kind `ks` (constant: `fill`).
template <bool kBC, class T>
__device__ __forceinline__ float ring_tap(const T* win, int base, int WP,
                                          int at, int plane, int x, int y,
                                          int xx, int ds, int dy, int dx,
                                          const Params& p, int ks,
                                          float fill) {
  int r = x + ds;
  const bool oob = kBC && (r < 0 || r >= p.dom);
  if (oob && ks == kConstant) return fill;
  r = oob ? stream_row(r, p.dom, ks) : min(max(r, 0), p.dom - 1);
  const int ty = min(max(y + dy, 0), p.by - 1);
  const int tx = min(max(xx + dx, 0), p.bx - 1);
  return wide(win[ring_plane(at, base, WP, (r - x) * plane) + ty * p.bx + tx]);
}
#endif

// One entry of a DAG, flattened for shared memory: its ring layout (in
// rows), op, inputs, coefficient/tap ranges, and a Table-2 stage's
// coefficients; for the mixed-boundary body also its stage's kinds
// (`kinds`: ks | ky << 8 | kx << 16) and fill rounded through the storage
// type.
struct DagRec {  // 112 bytes; `c` 16-byte aligned
  int lag, op, iteration, field;
  int out_base, out_slots, n_in, tap_lo;
  int tap_n, coeff_lo, kinds;
  float fill;
  int in_base[kMaxInputs];
  int in_slots[kMaxInputs];
  float c[8];
};
// kernels/_build.py prices the DAG body's tables with DAGREC_BYTES
static_assert(sizeof(DagRec) == 112, "DagRec layout changed");

// One DAG entry at one tick: the slab j, flags as in `TickRec`, the offset
// (in cells) of the slab's first row in its own ring, its slot in input
// 0's ring (relative to the ring's base), and its offset in every input's
// ring.
struct DagTick {  // 48 bytes: three 16-byte loads
  int j, flags, outo, m;
  int pad0, pad1, pad2, pad3;
  int mid[kMaxInputs];
};
// ... and DAGTICK_BYTES
static_assert(sizeof(DagTick) == 48, "DagTick layout changed");

// `DagRec` and `DagTick` of the large-table route: an entry's inputs out
// of line, `n_in` of them from `in_lo` on, their rings in
// `Records::ins` and their offsets at the tick in `Records::mid`.
struct BigDagRec {  // 96 bytes; `c` 16-byte aligned
  int lag, op, iteration, field;
  int out_base, out_slots, n_in, tap_lo;
  int tap_n, coeff_lo, kinds;
  float fill;
  int in_lo, pad0, pad1, pad2;
  float c[8];
};
// kernels/_build.py prices them with BIG_DAGREC_BYTES, BIG_DAGTICK_BYTES
static_assert(sizeof(BigDagRec) == 96, "BigDagRec layout changed");
struct BigDagTick {  // 16 bytes
  int j, flags, outo, m;
};
static_assert(sizeof(BigDagTick) == 16, "BigDagTick layout changed");

// This thread's rows of the first slab a CTA streams of one field stream
// (`src`, its padded grid at the thread's cell and that slab's first row;
// `dom` counted from that row) into `nxt`: the first kPre of its `nr`
// rows.
template <int kPre, class T>
__device__ __forceinline__ void prefetch_slab(T* nxt, const T* src, int tv,
                                              int vt, int nr, int dom,
                                              size_t pstride) {
#pragma unroll
  for (int q = 0; q < kPre; ++q) {
    const int x = tv + q * vt;
    nxt[q] = q < nr && x < dom ? __ldg(src + (size_t)x * pstride)
                               : narrow<T>(0.0f);
  }
}

// Push this thread's rows of slab t of one field stream (`src` at the
// thread's cell) into `ring` (WV rows; none if null) at plane cell `cell`,
// and write them to `dst` (at the thread's cell; none if null).  The first
// kPre rows come from `nxt`, which then takes the same rows of slab t+1;
// later rows, and all of them when `nxt` is null, are loaded now.
template <int kPre, class T>
__device__ __forceinline__ void push_slab(T* nxt, const T* src, T* ring,
                                          int WV, T* dst, int t, int tv,
                                          int vt, int nr, int V, int dom,
                                          size_t pstride, int plane,
                                          int cell) {
  const int x0 = t * V;
  const int m0 = ring ? x0 % WV : 0;  // slot of the slab's row 0
  const auto put = [&](int r, int x, T v) {
    if (ring) ring[(m0 + r) * plane + cell] = v;
    if (dst) dst[(size_t)x * pstride] = v;
  };
  if (nxt) {
#pragma unroll
    for (int q = 0; q < kPre; ++q) {
      const int r = tv + q * vt;
      const int x = x0 + r;
      if (q < nr && x < dom) {
        put(r, x, nxt[q]);
        if (x + V < dom) nxt[q] = __ldg(src + (size_t)(x + V) * pstride);
      }
    }
  }
  for (int q = nxt ? kPre : 0; q < nr; ++q) {
    const int r = tv + q * vt;
    const int x = x0 + r;
    if (x >= dom) break;
    put(r, x, __ldg(src + (size_t)x * pstride));
  }
}

// A Table-2 stencil at the cell `q`, rows `up`, `mid`, `dn`.
template <int kOp, class T>
__device__ __forceinline__ float table2(const T* up, const T* mid,
                                        const T* dn, const Pos& q,
                                        const float* c, const Ends& e,
                                        const T* aux, size_t row) {
  if (kOp == 0) return diffusion2d(up, mid, dn, q, c, e);
  if (kOp == 1) {
    return hotspot2d(up, mid, dn, q, c, e, wide(__ldg(aux + row + q.g)));
  }
  if (kOp == 2) return diffusion3d(up, mid, dn, q, c, e);
  return hotspot3d(up, mid, dn, q, c, e, wide(__ldg(aux + row + q.g)));
}

// A Table-2 stencil of runtime op `op` (the table-driven bodies).
template <class T>
__device__ __forceinline__ float table2_op(int op, const T* up, const T* mid,
                                           const T* dn, const Pos& q,
                                           const float* c, const Ends& e,
                                           const T* aux, size_t row) {
  switch (op) {
    case 0:
      return table2<0>(up, mid, dn, q, c, e, aux, row);
    case 1:
      return table2<1>(up, mid, dn, q, c, e, aux, row);
    case 2:
      return table2<2>(up, mid, dn, q, c, e, aux, row);
    default:
      return table2<3>(up, mid, dn, q, c, e, aux, row);
  }
}

// How a thread covers a slab (a template argument, so that the V = 1 path
// folds V, vt and the row loop away): V = 1; one row of each slab per
// thread (rows == 1); several rows; or (`kWide`: a block plane over 1024
// cells, and the large-table route at any plane) several cells of the
// plane per thread, each with every row of the slab.
enum Form { kVecOne = 0, kOneRow = 1, kRows = 2, kWide = 3 };

// Calls f(r, x) for this thread's rows of slab j below `dom` in turn: r the
// row within the slab, x the stream row.
template <int kForm, class F>
__device__ __forceinline__ void for_rows(int j, int V, int tv, int vt,
                                         int nr, int dom, F&& f) {
  if constexpr (kForm < kRows) {
    const int x = j * V + tv;
    // at V = 1 the stream is not padded: every row of a slab is below dom
    if (kForm == kVecOne || x < dom) f(tv, x);
  } else {
    for (int u = 0; u < nr; ++u) {
      const int r = tv + u * vt;
      const int x = j * V + r;
      if (x >= dom) break;
      f(r, x);
    }
  }
}

// The stream rows one CTA owns: blockIdx.y
// is its block row plus `nby` times its segment, which writes slabs [s0,
// s1) and streams them from slab a = s0 - warm on (from 0 at most), over
// ticks [a, t_end): the last slab's output lag past s1.
struct Segment {
  int sy;      // block start along y, in padded coordinates
  int s0, s1;  // the slabs it writes
  int a;       // the first slab it streams
  int t_end;   // one past its last tick
};

__device__ __forceinline__ Segment segment_of(const Params& p, int nslabs) {
  const int k = blockIdx.y / p.nby;
  Segment s;
  s.sy = (blockIdx.y - k * p.nby) * p.cy;
  s.s0 = k * p.seg;
  s.s1 = min(s.s0 + p.seg, nslabs);
  s.a = max(s.s0 - p.warm, 0);
  s.t_end = s.s1 + (p.ticks - nslabs);
  return s;
}

// The single-boundary DAG body's table-driven forms of the first slices:
// kOp = -2, any DAG of the table whose stages share one boundary (`gp` and
// `out` then hold `n_fields` padded grids one after the other); kForm one
// of the first three `Form`s (V = 1 where the one-barrier form does not
// run, one row, several rows), the table a kernel parameter, a barrier
// after every entry.  They keep this code: compiled from `stream_body`
// below, which also runs the later forms, the same kernels came out of
// ptxas with other register counts and spills on an H100 build, and ran
// wave2d at V = 4 slower.  Each CTA streams its segment (`Segment`) and
// writes only the slabs it owns.  T: the storage type.  kBC: some stage
// has a reflect or constant axis; without it the per-row and per-entry
// boundary work folds away to the clamp and periodic code (in a run-time
// form it cost the float32 bodies 3-31% on an H100).
template <int kOp, int kForm, class T, bool kBC>
__global__ void __launch_bounds__(1024, 1)
    stream_kernel(const T* __restrict__ gp, const T* __restrict__ aux,
                  T* __restrict__ out, const Params p,
                  const __grid_constant__ Program k, long long member_stride,
                  long long aux_stride) {
#if STENCIL_BATCH
  // batch member blockIdx.z: its state, output and aux
  const size_t member = blockIdx.z;
  gp += member * (size_t)member_stride;
  out += member * (size_t)member_stride;
  if (aux != nullptr) aux += member * (size_t)aux_stride;
#endif
  // the rings, in value-id order
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const win = reinterpret_cast<T*>(smem_raw);
  constexpr bool kV1 = kForm == kVecOne;
  const int plane = p.by * p.bx;
  const int tid = threadIdx.x;
  const int V = kV1 ? 1 : p.V;
  const int vt = kV1 ? 1 : p.vt;
  const int nr = kV1 ? 1 : p.rows;
  const int nslabs = p.ns / V;
  // thread tid < plane * vt takes cell tid mod plane of rows tv, tv + vt,
  // ... of each slab; the others build records and meet the barriers (and
  // touch no memory with their cell)
  const bool act = tid < plane * vt;
  const int tv = kV1 ? 0 : tid / plane;
  const int cell = tid - tv * plane;
  const int ty = cell / p.bx;
  const int tx = cell - ty * p.bx;
  const Segment sg = segment_of(p, nslabs);
  const int sy = sg.sy;  // block start in padded coordinates
  const int sx = blockIdx.x * p.cx;

  // the cell's positions under each blocked-axis kind (no-ops on interior
  // blocks)
  const Axis ay = axis_at(ty, sy, p.hy, p.dy, p.by);
  const Axis ax = axis_at(tx, sx, p.hx, p.dx, p.bx);
  const Pos own = pos_at(ty, tx, p, sy, sx);
  const bool writes = act && ty >= p.hy && ty < p.hy + p.cy && tx >= p.hx &&
                      tx < p.hx + p.cx;
  const size_t pstride = (size_t)p.py * p.px;

  {
    // a DAG: `n_fields` field streams, entries with several producers; all
    // stages share stage 0's boundary (the launcher's rule)
    __shared__ DagRec rec[kMaxEntries];
    __shared__ DagTick trec[kMaxEntries];
    __shared__ Tap s_taps[kMaxTaps];
    __shared__ float s_c[kMaxCoeffs];
    if (tid < p.n_entries) {  // a thread per entry (the launcher's rule)
      const Entry en = k.e[tid];
      DagRec r = {};
      r.lag = en.lag;
      r.iteration = en.iteration;
      r.field = en.field;
      r.out_base = en.out_base * V;
      r.out_slots = en.out_slots * V;
      r.n_in = en.n_in;
      r.op = kSelectOp;
      if (en.stage >= 0) {
        const Stage st = k.s[en.stage];
        r.op = st.op;
        r.tap_lo = st.tap_lo;
        r.tap_n = st.tap_n;
        r.coeff_lo = st.coeff_lo;
        for (int z = 0; z < 8; ++z) {
          r.c[z] = st.op < kTapOp && st.coeff_lo + z < kMaxCoeffs
                       ? k.c[st.coeff_lo + z]
                       : 0.0f;
        }
      }
      for (int z = 0; z < kMaxInputs; ++z) {
        r.in_base[z] = en.in_base[z] * V;
        r.in_slots[z] = max((int)en.in_slots[z], 1) * V;
      }
      rec[tid] = r;
    }
    for (int z = tid; z < kMaxTaps; z += blockDim.x) s_taps[z] = k.taps[z];
    for (int z = tid; z < kMaxCoeffs; z += blockDim.x) s_c[z] = k.c[z];
    __syncthreads();
    const int ey = axis_pos(ay, ty, k.s[0].ky);
    const int ex = axis_pos(ax, tx, k.s[0].kx);
    const Pos edge = pos_at(ey, ex, p, sy, sx);
    const bool fill_edge = kBC && takes_fill(ay, ax, k.s[0].ky, k.s[0].kx);
    const size_t fstride = (size_t)p.ns * pstride;  // one field's grid
    // the first two field streams are prefetched a tick ahead, later ones
    // loaded as they are pushed: four fields' registers spill
    constexpr int kPreFields = 2;
    T nxt[kPreFields][1];
#pragma unroll
    for (int f = 0; f < kPreFields; ++f) {
      if (act && f < p.n_fields) {
        prefetch_slab<1>(nxt[f],
                         gp + f * fstride + own.g +
                             (size_t)sg.a * V * pstride,
                         tv, vt, nr, p.dom - sg.a * V, pstride);
      }
    }
    for (int t = sg.a; t < sg.t_end; ++t) {
      if (act && t < nslabs) {
        // push slab t of every field stream; a field carried unchanged is
        // written out as it streams in, in the slabs this CTA owns
#pragma unroll
        for (int f = 0; f < kMaxFields; ++f) {
          if (f < p.n_fields) {
            const Stream st = k.f[f];
            push_slab<1>(
                f < kPreFields ? nxt[f % kPreFields] : (T*)nullptr,
                gp + f * fstride + own.g,
                st.slots ? win + st.base * V * plane : (T*)nullptr,
                st.slots * V,
                st.out && writes && t >= sg.s0 && t < sg.s1
                    ? out + f * fstride + own.g
                    : (T*)nullptr,
                t, tv, vt, nr, V, p.dom, pstride, plane, cell);
          }
        }
      }
      if (tid < p.n_entries) {  // entry tid's slots at this tick
        const DagRec& e = rec[tid];
        DagTick r;
        r.j = t - e.lag;
        r.flags =
            (r.j >= sg.a && r.j < nslabs) | ((e.iteration < p.steps) << 1);
        const unsigned x0 = min(max(r.j, 0), nslabs - 1) * V;
        r.m = x0 % (unsigned)e.in_slots[0];
        r.outo = e.out_slots
                     ? (e.out_base + x0 % (unsigned)e.out_slots) * plane
                     : 0;
        r.pad0 = r.pad1 = r.pad2 = r.pad3 = 0;
        for (int z = 0; z < kMaxInputs; ++z) {
          r.mid[z] = (e.in_base[z] + (int)(x0 % (unsigned)e.in_slots[z])) *
                     plane;
        }
        trec[tid] = r;
      }
      __syncthreads();
      for (int i = 0; i < p.n_entries; ++i) {
        const DagTick r = trec[i];
        const DagRec& en = rec[i];
        // a stage of an iteration >= steps computes nothing: only the
        // state nodes of its iteration read it, and they forward
        if (act && (r.flags & 1) && ((r.flags & 2) || en.op == kSelectOp)) {
          // a value that enters a ring is re-imposed; one that only drains
          // to the output is taken at its own position
          const bool ring = en.out_slots > 0;
          const Pos q = ring ? edge : own;
          const T* in0 = win + en.in_base[0] * plane;
          const int W = en.in_slots[0];
          for_rows<kForm>(r.j, V, tv, vt, nr, p.dom, [&](int row, int x) {
            const int m = r.m + row;
            const int at = row * plane + q.c;  // row `row` of an input slab
            T val;
            if (en.op == kSelectOp) {
              val = win[((r.flags & 2) ? r.mid[0] : r.mid[1]) + at];
            } else if (en.op == kCombineOp) {
              // make_combine's apply: w0*x0, then + w_z*x_z in input order
              float acc = mul(s_c[en.coeff_lo], wide(win[r.mid[0] + at]));
              for (int z = 1; z < en.n_in; ++z) {
                acc = add(acc,
                          mul(s_c[en.coeff_lo + z], wide(win[r.mid[z] + at])));
              }
              val = narrow<T>(acc);
            } else if (en.op == kTapOp) {
              val = narrow<T>(tap_sum<kBC>(
                  s_taps, s_c, en.tap_lo, en.tap_n, en.coeff_lo, in0, W, m,
                  plane, x, ring ? ey : ty, ring ? ex : tx, p, k.s[0].ks,
                  wide(narrow<T>(k.s[0].fill))));
            } else {
              float c[8];
              for (int z = 0; z < 8; ++z) c[z] = en.c[z];
              const int ks = k.s[0].ks;
              val = narrow<T>(table2_op(
                  en.op, in0 + slot_up<kBC>(m, x, W, ks) * plane,
                  in0 + m * plane,
                  in0 + slot_dn<kBC>(m, x, W, p.dom, ks) * plane, q, c,
                  ends<kBC>(x, p.dom, ks, wide(narrow<T>(k.s[0].fill))), aux,
                  (size_t)x * pstride));
            }
            if (ring && fill_edge) val = narrow<T>(k.s[0].fill);
            if (ring) win[r.outo + row * plane + cell] = val;
            if (en.field >= 0 && writes && r.j >= sg.s0 && r.j < sg.s1) {
              out[en.field * fstride + (size_t)x * pstride + own.g] = val;
            }
          });
        }
        __syncthreads();
      }
    }
  }
}

// One plane cell of a CTA's block: its index, coordinates and positions
// (its own; `edge`, where stage 0's blocked-axis kinds take a value that
// enters a ring), whether it is a thread's (`act`) and in the compute
// region (`writes`), and whether stage 0's kinds give it the fill.
struct Cell {
  int cell, ty, tx, ey, ex;
  Axis ay, ax;
  Pos own, edge;
  bool act, writes, fill_edge;
};

template <bool kBC>
__device__ __forceinline__ Cell cell_at(int cell, bool act, const Params& p,
                                        int sy, int sx, const Stage& s0) {
  Cell c;
  c.cell = cell;
  c.ty = cell / p.bx;
  c.tx = cell - c.ty * p.bx;
  c.ay = axis_at(c.ty, sy, p.hy, p.dy, p.by);
  c.ax = axis_at(c.tx, sx, p.hx, p.dx, p.bx);
  c.own = pos_at(c.ty, c.tx, p, sy, sx);
  c.ey = axis_pos(c.ay, c.ty, s0.ky);
  c.ex = axis_pos(c.ax, c.tx, s0.kx);
  c.edge = pos_at(c.ey, c.ex, p, sy, sx);
  c.act = act;
  c.writes = act && c.ty >= p.hy && c.ty < p.hy + p.cy && c.tx >= p.hx &&
             c.tx < p.hx + p.cx;
  c.fill_edge = kBC && takes_fill(c.ay, c.ax, s0.ky, s0.kx);
  return c;
}

// Block position t along one blocked axis (the grid's edges lo, hi in
// block coordinates, n cells) where a consumer of kind k reads it: t itself
// inside the grid or along a periodic axis, the edge cell (clamp), the
// mirrored cell (reflect, as `axis_at`), or -1 for the fill (constant).
__device__ __forceinline__ int reimposed(int t, int lo, int hi, int n,
                                         int k) {
  if ((t >= lo && t <= hi) || k == kPeriodic) return t;
  if (k == kConstant) return -1;
  if (k == kClamp) return min(max(t, max(lo, 0)), min(hi, n - 1));
  int m = t > hi ? 2 * hi - t : 2 * lo - t;
  m %= n;
  return m < 0 ? m + n : m;
}

// The Table-2 stencils over a getter g(ds, dy, dx) of the widened tap at
// that stream, y and x offset (the mixed-boundary DAG body, whose taps are
// re-imposed one by one), in the operation order of the functions above;
// Hotspot's power at `aux + at`.
template <class T, class G>
__device__ __forceinline__ float table2_get(int op, const G& g,
                                            const float* c, const T* aux,
                                            size_t at) {
  switch (op) {
    case 0: {  // diffusion2d
      float v = mul(c[0], g(0, 0, 0));
      v = add(v, mul(c[1], g(0, 0, -1)));
      v = add(v, mul(c[2], g(0, 0, 1)));
      v = add(v, mul(c[3], g(1, 0, 0)));
      return add(v, mul(c[4], g(-1, 0, 0)));
    }
    case 1: {  // hotspot2d
      const float v = g(0, 0, 0);
      const float two_v = mul(2.0f, v);
      const float dy = sub(add(g(-1, 0, 0), g(1, 0, 0)), two_v);
      const float dx = sub(add(g(0, 0, 1), g(0, 0, -1)), two_v);
      float t = add(wide(__ldg(aux + at)), mul(dy, c[2]));
      t = add(t, mul(dx, c[1]));
      t = add(t, mul(sub(kTempAmb, v), c[3]));
      return add(v, mul(c[0], t));
    }
    case 2: {  // diffusion3d
      float v = mul(c[0], g(0, 0, 0));
      v = add(v, mul(c[1], g(0, 0, -1)));
      v = add(v, mul(c[2], g(0, 0, 1)));
      v = add(v, mul(c[3], g(0, 1, 0)));
      v = add(v, mul(c[4], g(0, -1, 0)));
      v = add(v, mul(c[5], g(-1, 0, 0)));
      return add(v, mul(c[6], g(1, 0, 0)));
    }
    default: {  // hotspot3d
      float v = mul(g(0, 0, 0), c[0]);
      v = add(v, mul(g(0, -1, 0), c[1]));
      v = add(v, mul(g(0, 1, 0), c[2]));
      v = add(v, mul(g(0, 0, 1), c[3]));
      v = add(v, mul(g(0, 0, -1), c[4]));
      v = add(v, mul(g(1, 0, 0), c[5]));
      v = add(v, mul(g(-1, 0, 0), c[6]));
      v = add(v, mul(c[7], wide(__ldg(aux + at))));
      return add(v, mul(c[5], kTempAmb));
    }
  }
}

// The large-table route's view of a program laid out in device memory with
// tables of the program's own lengths (kernels/_build.py: program_type):
// the members a body reads carry `Program`'s names, so one body reads
// either.
struct DevTable {
  static constexpr bool kBig = true;
  using TapT = BigTap;
  const BigEntry* e;
  const Stage* s;
  const BigTap* taps;
  const float* c;
  const BigStream* f;
  const Input* ins;
  int n_taps, n_coeffs, n_inputs;
};

// Input z of entry `en`: its ring's first slot and depth, in slabs.
__device__ __forceinline__ Input input_of(const Program&, const Entry& en,
                                          int z) {
  return {en.in_base[z], en.in_slots[z]};
}
__device__ __forceinline__ Input input_of(const DevTable& k,
                                          const BigEntry& en, int z) {
  return k.ins[en.in_lo + z];
}

// Bytes at the front of the large-table route's dynamic shared memory: per
// entry a record R and a tick record TR, the `n_inputs` inputs' rings,
// the taps, the coefficients and the inputs' offsets at the tick,
// rounded up to 16 so that the rings after them stay aligned
// (kernels/_build.py: big_table_bytes; the chain body keeps no inputs).
template <class R, class TR>
__device__ __forceinline__ size_t table_bytes(int n_entries, int n_taps,
                                              int n_coeffs, int n_inputs) {
  return ((size_t)n_entries * (sizeof(R) + sizeof(TR)) +
          (sizeof(Input) + 4) * (size_t)n_inputs + sizeof(BigTap) * n_taps +
          4 * (size_t)n_coeffs + 15) /
         16 * 16;
}

// The records of a table-driven body and the program's taps and
// coefficients in shared memory: static arrays sized to the caps when the
// table is a kernel parameter, else the front of the dynamic shared
// memory, sized to the program, with the DAG entries' inputs (`n_inputs`:
// their rings in rows, and their offsets at the tick).
template <class R, class TR, class Tp>
struct Records {
  R* rec;
  TR* trec;
  Tp* taps;
  float* c;
  Input* ins;
  int* mid;
};

template <class R, class TR, class K>
__device__ __forceinline__ Records<R, TR, typename K::TapT> records(
    unsigned char* dyn, const K& k, int n, int n_inputs) {
  using Tp = typename K::TapT;
  if constexpr (K::kBig) {
    R* rec = reinterpret_cast<R*>(dyn);
    TR* trec = reinterpret_cast<TR*>(rec + n);
    Input* ins = reinterpret_cast<Input*>(trec + n);
    Tp* taps = reinterpret_cast<Tp*>(ins + n_inputs);
    float* c = reinterpret_cast<float*>(taps + k.n_taps);
    return {rec, trec, taps, c, ins, reinterpret_cast<int*>(c + k.n_coeffs)};
  } else {
    __shared__ R rec[kMaxEntries];
    __shared__ TR trec[kMaxEntries];
    __shared__ Tp taps[kMaxTaps];
    __shared__ float c[kMaxCoeffs];
    return {rec, trec, taps, c, nullptr, nullptr};
  }
}

// The DAG bodies' later table-driven forms, one body for all, with a
// barrier after every entry: the wide form (kWide) of the single-boundary
// body (every value that enters a ring re-imposed at push time under stage
// 0's boundary); kOp = -3 (the consumers re-impose at read time) in every
// form (at V = 1 where the one-barrier form `dag_kernel` does not run:
// kernels/builder.py win_form); and the large-table route of both (K =
// `DevTable`, the wide form).  A thread covers its cells through `cells`
// and builds the records of its entries through `entries`; each CTA
// streams its segment (`Segment`) and writes only the slabs it owns.  K:
// `Program` (the table as a kernel parameter) or `DevTable`.
template <int kOp, int kForm, class T, bool kBC, class K>
__device__ __forceinline__ void stream_body(const T* __restrict__ gp,
                                            const T* __restrict__ aux,
                                            T* __restrict__ out,
                                            const Params& p, const K& k,
                                            long long member_stride,
                                            long long aux_stride) {
#if STENCIL_BATCH
  // batch member blockIdx.z: its state, output and aux
  const size_t member = blockIdx.z;
  gp += member * (size_t)member_stride;
  out += member * (size_t)member_stride;
  if (aux != nullptr) aux += member * (size_t)aux_stride;
#endif
  constexpr bool kV1 = kForm == kVecOne;
  constexpr bool kW = kForm == kWide;
  constexpr bool kMix = kOp == kMixBody;
  // the rings, in value-id order (in the large-table route after the
  // records)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  size_t front = 0;
  if constexpr (K::kBig) {
    front = table_bytes<BigDagRec, BigDagTick>(p.n_entries, k.n_taps,
                                               k.n_coeffs, k.n_inputs);
  }
  T* const win = reinterpret_cast<T*>(smem_raw + front);
  const int plane = p.by * p.bx;
  const int tid = threadIdx.x;
  const int V = kV1 ? 1 : p.V;
  const int vt = kV1 ? 1 : p.vt;
  const int nr = kV1 ? 1 : p.rows;
  const int nslabs = p.ns / V;
  // thread tid < plane * vt takes cell tid mod plane of rows tv, tv + vt,
  // ... of each slab; the others build records and meet the barriers (and
  // touch no memory with their cell).  In the wide form a thread takes
  // cells tid, tid + blockDim.x, ... with every row of a slab.
  const bool act = tid < plane * vt;
  const int tv = kV1 || kW ? 0 : tid / plane;
  const Segment sg = segment_of(p, nslabs);
  const int sy = sg.sy;  // block start in padded coordinates
  const int sx = blockIdx.x * p.cx;
  const Cell me = cell_at<kBC>(tid - tv * plane, act, p, sy, sx, k.s[0]);
  const size_t pstride = (size_t)p.py * p.px;
  // calls f(cell) for each plane cell this thread takes
  const auto cells = [&](auto&& f) {
    if constexpr (!kW) {
      if (me.act) f(me);
    } else {
      for (int c = tid; c < plane; c += blockDim.x) {
        f(cell_at<kBC>(c, true, p, sy, sx, k.s[0]));
      }
    }
  };
  // calls f(i) for each entry whose records this thread builds: entry tid
  // (the launcher gives a table-driven body a thread per entry) or, in
  // the large-table route, every blockDim.x-th from tid
  const auto entries = [&](auto&& f) {
    if constexpr (!K::kBig) {
      if (tid < p.n_entries) f(tid);
    } else {
      for (int i = tid; i < p.n_entries; i += blockDim.x) f(i);
    }
  };
  // whether slab j is this CTA's to write
  const auto owns = [&](int j) { return j >= sg.s0 && j < sg.s1; };

  {
    // a DAG: `n_fields` field streams, entries with several producers.
    // Single-boundary (kDagBody, which `builder.superstep_dag` picks only
    // when the stages share one): every value that enters a ring is
    // re-imposed at push time under stage 0's boundary.  Mixed
    // (kMixBody): values enter their rings as computed, and
    // each consumer re-imposes every tap it reads under its own kinds, on
    // grid-edge blocks only.
    using DR = std::conditional_t<K::kBig, BigDagRec, DagRec>;
    using DT = std::conditional_t<K::kBig, BigDagTick, DagTick>;
    int n_inputs = 0;
    if constexpr (K::kBig) n_inputs = k.n_inputs;
    const auto sm = records<DR, DT>(smem_raw, k, p.n_entries, n_inputs);
    DR* const rec = sm.rec;
    DT* const trec = sm.trec;
    // input z of an entry's record: its ring's first row and depth in
    // rows, and its offset (in cells) at this tick
    const auto ring_of = [&](const DR& en, int z) -> Input {
      if constexpr (K::kBig) {
        return sm.ins[en.in_lo + z];
      } else {
        return {en.in_base[z], en.in_slots[z]};
      }
    };
    const auto mid = [&](const DT& r, const DR& en, int z) -> int {
      if constexpr (K::kBig) {
        return sm.mid[en.in_lo + z];
      } else {
        return r.mid[z];
      }
    };
    entries([&](int e) {
      const auto en = k.e[e];
      DR r = {};
      r.lag = en.lag;
      r.iteration = en.iteration;
      r.field = en.field;
      r.out_base = en.out_base * V;
      r.out_slots = en.out_slots * V;
      r.n_in = en.n_in;
      r.op = kSelectOp;
      if (en.stage >= 0) {
        const Stage st = k.s[en.stage];
        r.op = st.op;
        r.tap_lo = st.tap_lo;
        r.tap_n = st.tap_n;
        r.coeff_lo = st.coeff_lo;
        for (int z = 0; z < 8; ++z) {
          r.c[z] = st.op < kTapOp && st.coeff_lo + z < k.n_coeffs
                       ? k.c[st.coeff_lo + z]
                       : 0.0f;
        }
        if constexpr (kMix) {
          r.kinds = st.ks | (st.ky << 8) | (st.kx << 16);
          r.fill = wide(narrow<T>(st.fill));
        }
      }
      if constexpr (K::kBig) {
        r.in_lo = en.in_lo;
        for (int z = 0; z < en.n_in; ++z) {
          const Input in = k.ins[en.in_lo + z];
          sm.ins[en.in_lo + z] = {in.base * V, max(in.slots, 1) * V};
        }
      } else {
        for (int z = 0; z < kMaxInputs; ++z) {
          r.in_base[z] = en.in_base[z] * V;
          r.in_slots[z] = max((int)en.in_slots[z], 1) * V;
        }
      }
      rec[e] = r;
    });
    for (int z = tid; z < k.n_taps; z += blockDim.x) sm.taps[z] = k.taps[z];
    for (int z = tid; z < k.n_coeffs; z += blockDim.x) sm.c[z] = k.c[z];
    __syncthreads();
    // the grid's edges in block coordinates, and whether this block has
    // any (CTA-uniform): the mixed body re-imposes only there
    const int loy = p.hy - sy, hiy = p.dy - 1 + p.hy - sy;
    const int lox = p.hx - sx, hix = p.dx - 1 + p.hx - sx;
    const bool edge_block =
        loy > 0 || hiy < p.by - 1 || lox > 0 || hix < p.bx - 1;
    const size_t fstride = (size_t)p.ns * pstride;  // one field's grid
    // the first two field streams are prefetched a tick ahead, later ones
    // loaded as they are pushed: four fields' registers spill
    constexpr int kPreFields = 2;
    T nxt[kPreFields][1];
#pragma unroll
    for (int f = 0; f < kPreFields; ++f) {
      if (!kW && act && f < p.n_fields) {
        prefetch_slab<1>(nxt[f],
                         gp + f * fstride + me.own.g +
                             (size_t)sg.a * V * pstride,
                         tv, vt, nr, p.dom - sg.a * V, pstride);
      }
    }
    for (int t = sg.a; t < sg.t_end; ++t) {
      if (t < nslabs) {
        // push slab t of every field stream; a field carried unchanged is
        // written out as it streams in, in the slabs this CTA owns
        cells([&](const Cell& cl) {
#pragma unroll
          for (int f = 0; f < (K::kBig ? p.n_fields : kMaxFields); ++f) {
            if (f < p.n_fields) {
              const auto st = k.f[f];
              push_slab<1>(
                  !kW && f < kPreFields ? nxt[f % kPreFields] : (T*)nullptr,
                  gp + f * fstride + cl.own.g,
                  st.slots ? win + st.base * V * plane : (T*)nullptr,
                  st.slots * V,
                  st.out && cl.writes && owns(t)
                      ? out + f * fstride + cl.own.g
                      : (T*)nullptr,
                  t, tv, vt, nr, V, p.dom, pstride, plane, cl.cell);
            }
          }
        });
      }
      entries([&](int e) {  // entry e's slots at this tick
        const DR& en = rec[e];
        DT r;
        r.j = t - en.lag;
        r.flags =
            (r.j >= sg.a && r.j < nslabs) | ((en.iteration < p.steps) << 1);
        const unsigned x0 = min(max(r.j, 0), nslabs - 1) * V;
        r.m = x0 % (unsigned)ring_of(en, 0).slots;
        r.outo = en.out_slots
                     ? (en.out_base + x0 % (unsigned)en.out_slots) * plane
                     : 0;
        if constexpr (K::kBig) {
          for (int z = 0; z < en.n_in; ++z) {
            const Input in = ring_of(en, z);
            sm.mid[en.in_lo + z] =
                (in.base + (int)(x0 % (unsigned)in.slots)) * plane;
          }
        } else {
          r.pad0 = r.pad1 = r.pad2 = r.pad3 = 0;
          for (int z = 0; z < kMaxInputs; ++z) {
            r.mid[z] =
                (en.in_base[z] + (int)(x0 % (unsigned)en.in_slots[z])) *
                plane;
          }
        }
        trec[e] = r;
      });
      __syncthreads();
      for (int i = 0; i < p.n_entries; ++i) {
        const DT r = trec[i];
        const DR& en = rec[i];
        // a stage of an iteration >= steps computes nothing: only the
        // state nodes of its iteration read it, and they forward
        if ((r.flags & 1) && ((r.flags & 2) || en.op == kSelectOp)) {
          cells([&](const Cell& cl) {
            const bool ring = en.out_slots > 0;
            const Input i0 = ring_of(en, 0);
            const T* in0 = win + i0.base * plane;
            const int W = i0.slots;
            // the single-boundary code: the cell computed at position q
            // (taps at block cell (qy, qx)) under stream kind ks and fill
            // `fill`, and the fill taken where `fill_edge`
            const auto push_time = [&](const Pos& q, int qy, int qx, int ks,
                                       float fill, bool fill_edge) {
              for_rows<kForm>(r.j, V, tv, vt, nr, p.dom, [&](int row, int x) {
                const int m = r.m + row;
                const int at = row * plane + q.c;  // row `row` of an input
                T val;
                if (en.op == kSelectOp) {
                  val = win[mid(r, en, (r.flags & 2) ? 0 : 1) + at];
                } else if (en.op == kCombineOp) {
                  // make_combine's apply: w0*x0, then + w_z*x_z in order
                  float acc =
                      mul(sm.c[en.coeff_lo], wide(win[mid(r, en, 0) + at]));
                  for (int z = 1; z < en.n_in; ++z) {
                    acc = add(acc, mul(sm.c[en.coeff_lo + z],
                                       wide(win[mid(r, en, z) + at])));
                  }
                  val = narrow<T>(acc);
                } else if (en.op == kTapOp) {
                  val = narrow<T>(tap_sum<kBC>(sm.taps, sm.c, en.tap_lo,
                                               en.tap_n, en.coeff_lo, in0, W,
                                               m, plane, x, qy, qx, p, ks,
                                               fill));
#if STENCIL_CUSTOM
                } else if (en.op == kCustomOp) {
                  // input z's tap: its ring and its offset at this tick
                  val = narrow<T>(custom::custom_apply(
                      en.tap_lo,
                      [&](int z, int ds, int dy, int dx) {
                        const Input in = ring_of(en, z);
                        return ring_tap<kBC>(
                            win, in.base * plane, in.slots * plane,
                            mid(r, en, z) + row * plane, plane, x, qy, qx,
                            ds, dy, dx, p, ks, fill);
                      },
                      sm.c + en.coeff_lo, [&] {
                        return wide(__ldg(aux + (size_t)x * pstride + q.g));
                      }));
#endif
                } else {
                  float c[8];
                  for (int z = 0; z < 8; ++z) c[z] = en.c[z];
                  val = narrow<T>(table2_op(
                      en.op, in0 + slot_up<kBC>(m, x, W, ks) * plane,
                      in0 + m * plane,
                      in0 + slot_dn<kBC>(m, x, W, p.dom, ks) * plane, q, c,
                      ends<kBC>(x, p.dom, ks, fill), aux,
                      (size_t)x * pstride));
                }
                if (fill_edge) val = narrow<T>(fill);
                if (ring) win[r.outo + row * plane + cl.cell] = val;
                if (en.field >= 0 && cl.writes && owns(r.j)) {
                  out[en.field * fstride + (size_t)x * pstride + cl.own.g] =
                      val;
                }
              });
            };
            if constexpr (!kMix) {
              // a value that enters a ring is re-imposed; one that only
              // drains to the output is taken at its own position
              push_time(ring ? cl.edge : cl.own, ring ? cl.ey : cl.ty,
                        ring ? cl.ex : cl.tx, k.s[0].ks,
                        wide(narrow<T>(k.s[0].fill)), ring && cl.fill_edge);
            } else if (!edge_block
#if STENCIL_CUSTOM
                       // a custom op takes the getter below on every CTA:
                       // 145.1 against 150.8 ms through push_time on the
                       // interior ones (an Allen-Cahn, star and combine DAG
                       // at 16384^2, H100 80GB HBM3, 700 W)
                       && en.op != kCustomOp
#endif
            ) {
              // off the grid's edges re-imposing maps nothing: the cell's
              // own position under the entry's stream kind.  (Taking this
              // path per cell on grid-edge blocks too, for the cells whose
              // taps stay in the grid, cost diamond2d 1.7x on an H100
              // 80GB HBM3 at 700 W: a warp holding both kinds of cell pays
              // both paths, and the barrier after each entry waits for
              // it.)
              push_time(cl.own, cl.ty, cl.tx, en.kinds & 0xff, en.fill,
                        false);
            } else {
              const int ks = en.kinds & 0xff, ky = (en.kinds >> 8) & 0xff,
                        kx = en.kinds >> 16;
              // where a tap at block cell (y, x) reads under this entry's
              // blocked-axis kinds: a plane offset, or -1 for the fill
              const auto at = [&](int y, int x) {
                y = reimposed(y, loy, hiy, p.by, ky);
                x = reimposed(x, lox, hix, p.bx, kx);
                return y < 0 || x < 0 ? -1 : y * p.bx + x;
              };
              const int oc = at(cl.ty, cl.tx);
              for_rows<kForm>(r.j, V, tv, vt, nr, p.dom, [&](int row, int x) {
                const int m = r.m + row;
                // input 0's tap (ds, dy, dx) of row x under this entry's
                // kinds: a stream row past the rows follows ks (constant:
                // the fill), a blocked position clips to the block and is
                // then re-imposed
                const auto tap = [&](int ds, int dy, int dx) {
                  int rr = x + ds;
                  const bool oob = rr < 0 || rr >= p.dom;
                  if (oob && ks == kConstant) return en.fill;
                  rr = oob ? stream_row(rr, p.dom, ks) : rr;
                  const int o = at(min(max(cl.ty + dy, 0), p.by - 1),
                                   min(max(cl.tx + dx, 0), p.bx - 1));
                  return o < 0 ? en.fill
                               : wide(in0[slot_of(m, rr, x, W) * plane + o]);
                };
                T val;
                if (en.op == kSelectOp) {
                  val = win[mid(r, en, (r.flags & 2) ? 0 : 1) + row * plane +
                            cl.own.c];
                } else if (en.op == kCombineOp) {
                  const auto in = [&](int z) {
                    return oc < 0 ? en.fill
                                  : wide(win[mid(r, en, z) + row * plane +
                                             oc]);
                  };
                  float acc = mul(sm.c[en.coeff_lo], in(0));
                  for (int z = 1; z < en.n_in; ++z) {
                    acc = add(acc, mul(sm.c[en.coeff_lo + z], in(z)));
                  }
                  val = narrow<T>(acc);
                } else if (en.op == kTapOp) {
                  float acc = 0.0f;
                  for (int n = 0; n < en.tap_n; ++n) {
                    const auto tp = sm.taps[en.tap_lo + n];
                    const float term = mul(sm.c[en.coeff_lo + tp.ci],
                                           tap(tp.ds, tp.dy, tp.dx));
                    acc = n ? add(acc, term) : term;
                  }
                  val = narrow<T>(acc);
#if STENCIL_CUSTOM
                } else if (en.op == kCustomOp) {
                  // as `tap`, over input z's ring at its offset this tick
                  val = narrow<T>(custom::custom_apply(
                      en.tap_lo,
                      [&](int z, int ds, int dy, int dx) {
                        int rr = x + ds;
                        const bool oob = rr < 0 || rr >= p.dom;
                        if (oob && ks == kConstant) return en.fill;
                        rr = oob ? stream_row(rr, p.dom, ks) : rr;
                        const int o = at(min(max(cl.ty + dy, 0), p.by - 1),
                                         min(max(cl.tx + dx, 0), p.bx - 1));
                        if (o < 0) return en.fill;
                        const Input in = ring_of(en, z);
                        return wide(win[ring_plane(
                                            mid(r, en, z) + row * plane,
                                            in.base * plane, in.slots * plane,
                                            (rr - x) * plane) +
                                        o]);
                      },
                      sm.c + en.coeff_lo, [&] {
                        return wide(
                            __ldg(aux + (size_t)x * pstride + cl.own.g));
                      }));
#endif
                } else {
                  val = narrow<T>(table2_get(en.op, tap, en.c, aux,
                                             (size_t)x * pstride + cl.own.g));
                }
                if (ring) win[r.outo + row * plane + cl.cell] = val;
                if (en.field >= 0 && cl.writes && owns(r.j)) {
                  out[en.field * fstride + (size_t)x * pstride + cl.own.g] =
                      val;
                }
              });
            }
          });
        }
        __syncthreads();
      }
    }
  }
}

// --- The DAG bodies' one-barrier form ---------------------------------------

constexpr int kWinForm = 4;   // its form id (kernels/builder.py: WIN_FORM)
constexpr int kNoOp = 8;      // a state node no output drains: an alias
constexpr int kCarries = 4;   // register carries (kernels/builder.py: CARRIES)

// One entry of the one-barrier form, flattened for shared memory: its lag,
// op (a state node that drains to an output selects; one that does not is
// kNoOp), whether it computes (`live`: its iteration is < steps), the
// field it drains to, its own ring (first cell, rows) and register carry,
// whether a consumer reads it (single-boundary: it is re-imposed), its
// stage's tables, kinds and fill, and per input the ring (first cell,
// rows) and carry of the value it reads, state nodes resolved by `steps`.
struct WinRec {  // 144 bytes; `c` 16-byte aligned
  int lag, op, live, field;
  int out_base, out_slots, out_reg, n_in;
  int tap_lo, tap_n, coeff_lo, kinds;
  float fill;
  int consumed, pad0, pad1;
  int in_base[kMaxInputs];
  int in_slots[kMaxInputs];
  int in_reg[kMaxInputs];
  float c[8];
};
// kernels/builder.py prices its tables with WINREC_BYTES, WINTICK_BYTES
static_assert(sizeof(WinRec) == 144, "WinRec layout changed");

// One entry at one tick: the cell offset of its slab in its own ring, and
// the slot (relative to the ring) of that slab in each input's ring.
struct WinTick {  // 32 bytes: two 16-byte loads
  int outo, pad0, pad1, pad2;
  int m[kMaxInputs];
};
static_assert(sizeof(WinTick) == 32, "WinTick layout changed");

// A tap of a tap table as the one-barrier form reads it away from the
// stream's ends, its blocked-axis offset unclipped: its stream offset, its
// offset in the plane, and its coefficient.
struct TapX {  // 16 bytes: one load
  int ds, dcell;
  float c;
  int pad;
};

// A tap table as `tap_sum`, whose taps in the cell's own column (dy = dx =
// 0) read the thread's own cell `own`: in the one-barrier form a thread
// reads another thread's cell only in rows written at an earlier tick.
template <bool kBC, class T>
__device__ __forceinline__ float tap_sum_own(const Tap* taps, const float* c,
                                             int tap_lo, int tap_n,
                                             int coeff_lo, const T* ring,
                                             int W, int m, int plane, int x,
                                             int y, int xx, int own,
                                             const Params& p, int ks,
                                             float fill) {
  float acc = 0.0f;
  for (int n = 0; n < tap_n; ++n) {
    const Tap tp = taps[tap_lo + n];
    int r = x + tp.ds;
    const bool oob = kBC && (r < 0 || r >= p.dom);
    r = oob ? stream_row(r, p.dom, ks) : min(max(r, 0), p.dom - 1);
    const int at = (tp.dy | tp.dx)
                       ? min(max(y + tp.dy, 0), p.by - 1) * p.bx +
                             min(max(xx + tp.dx, 0), p.bx - 1)
                       : own;
    const float v = oob && ks == kConstant
                        ? fill
                        : wide(ring[slot_of(m, r, x, W) * plane + at]);
    const float term = mul(c[coeff_lo + tp.ci], v);
    acc = n ? add(acc, term) : term;
  }
  return acc;
}

// The cells an unclipped blocked-axis tap of radius `rad` reaches before a
// plane's first cell or past its last (kernels/builder.py: win_smem).
__device__ __host__ __forceinline__ int win_pad(const Params& p) {
  return p.rad * (p.by > 1 ? p.bx + 1 : 1);
}

// The DAG bodies at V = 1 in one barrier a tick (kOp = -2, -3; the layout
// is kernels/builder.py win_layout, the table `_win_table`).  A CTA streams
// its segment (`Segment`) one row a tick, a cell a thread.  Entry i
// computes row t - lag_i at tick t; its lags keep every read of another
// thread's cell in rows written at an earlier tick, so the tick's entries
// run between one pair of barriers, each thread reading its own cell of
// the rows written this tick (its producers ran before it in the same
// thread).  Taps in the cell's own column read the thread's own cell: in
// the single-boundary body the position a value is computed at (`edge`)
// holds the same values as the cell, which kernels/builder.py own_columns
// checks at plan time (a geometry where it does not runs `stream_kernel`); in
// the mixed-boundary body a block off the grid's edges maps nothing.  A
// state node copies nothing: its readers read the value it selects by
// `steps` (resolved once, when the records are built), and it only drains
// that value to its output field.  A value whose readers are combines at
// its own lag stays in a register carry.  The mixed-boundary body's
// grid-edge blocks (CTA-uniform; `slow`) re-impose every tap at read time
// from other columns, so they read rings only, behind a barrier after the
// push and after every entry.  Each thread of the first n_entries builds
// its entry's tick record for the next tick, into the other of two
// buffers, from slots it turns over by one a tick.  A row `rad` rows
// inside the stream's ends (CTA-uniform: `fast`) reads its tap tables from
// `TapX` records and its custom taps at plain offsets, neither clipping
// to the block: a tap that leaves the block reads a cell of the padded
// rings, and only a cell within the stage's radius of the block's sides
// (in the halo, which the overlap discards: its values reach no compute
// cell within the super-step) reads one.  The entries that only alias
// are left out of the tick.  A CTA has up to 1024 threads (a 3D plane of
// 32 x 32 cells), so 64 registers a thread; at 48 and 40 registers (five
// and six CTAs of 256 threads an SM) wave2d and diamond2d ran slower on
// an H100.
template <int kOp, class T, bool kBC>
__global__ void __launch_bounds__(1024, 1)
    dag_kernel(const T* __restrict__ gp, const T* __restrict__ aux,
               T* __restrict__ out, const Params p,
               const __grid_constant__ Program k, long long member_stride,
               long long aux_stride) {
#if STENCIL_BATCH
  // batch member blockIdx.z: its state, output and aux
  const size_t member = blockIdx.z;
  gp += member * (size_t)member_stride;
  out += member * (size_t)member_stride;
  if (aux != nullptr) aux += member * (size_t)aux_stride;
#endif
  constexpr bool kMix = kOp == kMixBody;
  // the rings, after `pad` cells that an unclipped tap may reach before the
  // first (as many follow the last)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const win = reinterpret_cast<T*>(smem_raw) + win_pad(p);
  __shared__ WinRec rec[kMaxEntries];
  __shared__ WinTick trec[2][kMaxEntries];
  __shared__ Tap s_taps[kMaxTaps];
  __shared__ TapX s_tapx[kMaxTaps];
  __shared__ float s_c[kMaxCoeffs];
  __shared__ int s_act[kMaxEntries + 1];  // the entries that compute, count
  const int plane = p.by * p.bx;
  const int tid = threadIdx.x;
  const int nslabs = p.ns;
  const int n = p.n_entries;
  const int F = p.n_fields;
  const Segment sg = segment_of(p, nslabs);
  const int sx = blockIdx.x * p.cx;
  const Cell me = cell_at<kBC>(tid, tid < plane, p, sg.sy, sx, k.s[0]);
  const size_t pstride = (size_t)p.py * p.px;
  const size_t fstride = (size_t)p.ns * pstride;  // one field's grid
  // the grid's edges in block coordinates, and whether the mixed body
  // re-imposes in this block (CTA-uniform): a grid edge along an axis
  // that is not periodic
  const int loy = p.hy - sg.sy, hiy = p.dy - 1 + p.hy - sg.sy;
  const int lox = p.hx - sx, hix = p.dx - 1 + p.hx - sx;
  const bool slow =
      kMix && ((k.s[0].ky != kPeriodic && (loy > 0 || hiy < p.by - 1)) ||
               (k.s[0].kx != kPeriodic && (lox > 0 || hix < p.bx - 1)));

  // the records: each input's value resolved through the state nodes
  int cnt[kMaxInputs + 1];  // entry tid's slots at the tick being built
  const auto resolve = [&](int v) {
    while (v >= F && k.e[v - F].stage < 0) {
      const Entry& e = k.e[v - F];
      v = e.iteration < p.steps ? e.in_base[0] : e.in_base[1];
    }
    return v;
  };
  const auto wrap = [](int x, int w) {
    const int m = x % w;
    return m < 0 ? m + w : m;
  };
  if (tid < n) {  // a thread per entry (the launcher's rule)
    const Entry en = k.e[tid];
    WinRec r = {};
    r.lag = en.lag;
    r.field = en.field;
    r.out_base = en.out_base * plane;
    r.out_slots = en.out_slots;
    r.out_reg = en.pad;
    r.consumed = en.out_slots > 0 || en.pad >= 0;
    r.live = 1;
    int ins[kMaxInputs] = {0, 0, 0, 0};
    if (en.stage >= 0) {
      const Stage st = k.s[en.stage];
      r.op = st.op;
      r.live = en.iteration < p.steps;
      r.n_in = en.n_in;
      r.tap_lo = st.tap_lo;
      r.tap_n = st.tap_n;
      r.coeff_lo = st.coeff_lo;
      r.kinds = st.ks | (st.ky << 8) | (st.kx << 16);
      r.fill = wide(narrow<T>(st.fill));
      for (int z = 0; z < 8; ++z) {
        r.c[z] = st.op < kTapOp && st.coeff_lo + z < kMaxCoeffs
                     ? k.c[st.coeff_lo + z]
                     : 0.0f;
      }
      for (int z = 0; z < en.n_in; ++z) ins[z] = resolve(en.in_base[z]);
    } else {
      r.op = en.field >= 0 ? kSelectOp : kNoOp;
      r.n_in = 1;
      ins[0] = resolve(F + tid);
    }
    for (int z = 0; z < kMaxInputs; ++z) {
      int base = 0, slots = 1, reg = -1;
      if (z < r.n_in) {
        const int v = ins[z];
        if (v < F) {
          base = k.f[v].base;
          slots = k.f[v].slots;
        } else {
          base = k.e[v - F].out_base;
          slots = k.e[v - F].out_slots;
          reg = k.e[v - F].pad;
        }
      }
      r.in_base[z] = base * plane;
      r.in_slots[z] = max(slots, 1);
      r.in_reg[z] = reg;
    }
    rec[tid] = r;
    // the slots of the first tick's rows, and its tick record
    const int j0 = sg.a - r.lag;
    cnt[0] = wrap(j0, max(r.out_slots, 1));
    WinTick w;
    w.outo = r.out_base + cnt[0] * plane;
    w.pad0 = w.pad1 = w.pad2 = 0;
#pragma unroll
    for (int z = 0; z < kMaxInputs; ++z) {
      cnt[z + 1] = wrap(j0, r.in_slots[z]);
      w.m[z] = cnt[z + 1];
    }
    trec[sg.a & 1][tid] = w;
  }
  for (int z = tid; z < kMaxTaps; z += blockDim.x) {
    const Tap tp = k.taps[z];
    s_taps[z] = tp;
    // the coefficient of the tap table that holds tap z
    float c = 0.0f;
    for (int st = 0; st < kMaxStages; ++st) {
      const Stage& sg_ = k.s[st];
      if (sg_.op == kTapOp && z >= sg_.tap_lo && z < sg_.tap_lo + sg_.tap_n &&
          sg_.coeff_lo + tp.ci < kMaxCoeffs) {
        c = k.c[sg_.coeff_lo + tp.ci];
      }
    }
    s_tapx[z] = {tp.ds, tp.dy * p.bx + tp.dx, c, 0};
  }
  for (int z = tid; z < kMaxCoeffs; z += blockDim.x) s_c[z] = k.c[z];
  __syncthreads();
  if (tid == 0) {
    int a = 0;
    for (int i = 0; i < n; ++i) {
      if (rec[i].op != kNoOp) s_act[a++] = i;
    }
    s_act[kMaxEntries] = a;
  }
  __syncthreads();
  const int n_act = s_act[kMaxEntries];
  const auto wrap1 = [](int s, int w) {  // one wrap into [0, w)
    return s < 0 ? s + w : (s >= w ? s - w : s);
  };

  // the field streams: the first two loaded a tick ahead into registers,
  // each ring's slot of the row pushed turned over by one a tick
  constexpr int kPreFields = 2;
  T nxt[kPreFields];
  int fslot[kMaxFields];
#pragma unroll
  for (int f = 0; f < kMaxFields; ++f) {
    fslot[f] = f < F && k.f[f].slots ? sg.a % k.f[f].slots : 0;
    if (f < kPreFields) {
      nxt[f] = me.act && f < F && sg.a < p.dom
                   ? __ldg(gp + f * fstride + me.own.g +
                           (size_t)sg.a * pstride)
                   : narrow<T>(0.0f);
    }
  }
  float carry[kCarries];
#pragma unroll
  for (int q = 0; q < kCarries; ++q) carry[q] = 0.0f;
  const auto carry_get = [&](int s) {
    float v = carry[0];
#pragma unroll
    for (int q = 1; q < kCarries; ++q) v = s == q ? carry[q] : v;
    return v;
  };
  const auto carry_set = [&](int s, float v) {
#pragma unroll
    for (int q = 0; q < kCarries; ++q) carry[q] = s == q ? v : carry[q];
  };

  for (int t = sg.a; t < sg.t_end; ++t) {
    if (t < nslabs) {
      // push row t of every field stream; a field carried unchanged is
      // written out as it streams in, in the rows this CTA owns
#pragma unroll
      for (int f = 0; f < kMaxFields; ++f) {
        if (f < F) {
          const Stream st = k.f[f];
          if (me.act) {
            const T* const src = gp + f * fstride + me.own.g;
            T v;
            if (f < kPreFields) {
              v = nxt[f];
              if (t + 1 < p.dom) {
                nxt[f] = __ldg(src + (size_t)(t + 1) * pstride);
              }
            } else {
              v = __ldg(src + (size_t)t * pstride);
            }
            if (st.slots) win[(st.base + fslot[f]) * plane + me.cell] = v;
            if (st.out && me.writes && t >= sg.s0 && t < sg.s1) {
              out[f * fstride + (size_t)t * pstride + me.own.g] = v;
            }
          }
          fslot[f] = fslot[f] + 1 == st.slots ? 0 : fslot[f] + 1;
        }
      }
    }
    if (slow) __syncthreads();
    const WinTick* const tr = trec[t & 1];
    for (int ii = 0; ii < n_act; ++ii) {
      const int i = s_act[ii];
      const WinRec& en = rec[i];
      const int j = t - en.lag;  // CTA-uniform
      if (en.live && j >= sg.a && j < nslabs && me.act) {
        const WinTick& r = tr[i];
        const T* const in0 = win + en.in_base[0];
        const int W = en.in_slots[0];
        const int m = r.m[0];
        const int ks = en.kinds & 0xff;
        T val;
        if (!slow) {
          // no stream-axis tap of this entry clips or maps (CTA-uniform)
          const bool fast = j >= p.rad && j + p.rad < p.dom;
          // the cell computed at position q (taps around block cell (qy,
          // qx)), its own column at its own cell
          const bool at_edge = !kMix && en.consumed;
          const Pos& q = at_edge ? me.edge : me.own;
          const int qy = at_edge ? me.ey : me.ty;
          const int qx = at_edge ? me.ex : me.tx;
          const int qcell = qy * p.bx + qx;
          // input z's row j at the thread's own cell
          const auto input = [&](int z) {
            return en.in_reg[z] >= 0
                       ? carry_get(en.in_reg[z])
                       : wide(win[en.in_base[z] + r.m[z] * plane + me.cell]);
          };
          if (en.op == kSelectOp) {
            val = narrow<T>(input(0));
          } else if (en.op == kCombineOp) {
            // make_combine's apply: w0*x0, then + w_z*x_z in input order
            float acc = mul(s_c[en.coeff_lo], input(0));
            for (int z = 1; z < en.n_in; ++z) {
              acc = add(acc, mul(s_c[en.coeff_lo + z], input(z)));
            }
            val = narrow<T>(acc);
          } else if (en.op == kTapOp) {
            if (fast) {
              float acc = 0.0f;
              for (int q = 0; q < en.tap_n; ++q) {
                const TapX tp = s_tapx[en.tap_lo + q];
                const int at = tp.dcell ? qcell + tp.dcell : me.cell;
                const float term =
                    mul(tp.c, wide(in0[wrap1(m + tp.ds, W) * plane + at]));
                acc = q ? add(acc, term) : term;
              }
              val = narrow<T>(acc);
            } else {
              val = narrow<T>(tap_sum_own<kBC>(s_taps, s_c, en.tap_lo,
                                               en.tap_n, en.coeff_lo, in0, W,
                                               m, plane, j, qy, qx, me.cell,
                                               p, ks, en.fill));
            }
#if STENCIL_CUSTOM
          } else if (en.op == kCustomOp) {
            // input z's tap, taps in the own column at the own cell
            val = narrow<T>(custom::custom_apply(
                en.tap_lo,
                [&](int z, int ds, int dy, int dx) {
                  if (fast) {
                    return wide(win[en.in_base[z] +
                                    wrap1(r.m[z] + ds, en.in_slots[z]) *
                                        plane +
                                    ((dy | dx) ? qcell + dy * p.bx + dx
                                               : me.cell)]);
                  }
                  int rr = j + ds;
                  const bool oob = kBC && (rr < 0 || rr >= p.dom);
                  if (oob && ks == kConstant) return en.fill;
                  rr = oob ? stream_row(rr, p.dom, ks)
                           : min(max(rr, 0), p.dom - 1);
                  const int o = (dy | dx)
                                    ? min(max(qy + dy, 0), p.by - 1) * p.bx +
                                          min(max(qx + dx, 0), p.bx - 1)
                                    : me.cell;
                  return wide(win[en.in_base[z] +
                                  slot_of(r.m[z], rr, j, en.in_slots[z]) *
                                      plane +
                                  o]);
                },
                s_c + en.coeff_lo, [&] {
                  return wide(__ldg(aux + (size_t)j * pstride + q.g));
                }));
#endif
          } else {
            float c[8];
            for (int z = 0; z < 8; ++z) c[z] = en.c[z];
            Pos qc = q;
            qc.c = me.cell;
            val = narrow<T>(table2_op(
                en.op, in0 + slot_up<kBC>(m, j, W, ks) * plane,
                in0 + m * plane,
                in0 + slot_dn<kBC>(m, j, W, p.dom, ks) * plane, qc, c,
                ends<kBC>(j, p.dom, ks, en.fill), aux,
                (size_t)j * pstride));
          }
          if (at_edge && me.fill_edge) val = narrow<T>(en.fill);
          if (en.out_reg >= 0) {
            carry_set(en.out_reg, wide(val));
          } else if (en.out_slots) {
            win[r.outo + me.cell] = val;
          }
        } else {
          const int ky = (en.kinds >> 8) & 0xff, kx = en.kinds >> 16;
          // where a tap at block cell (y, x) reads under this entry's
          // blocked-axis kinds: a plane offset, or -1 for the fill
          const auto at = [&](int y, int x) {
            y = reimposed(y, loy, hiy, p.by, ky);
            x = reimposed(x, lox, hix, p.bx, kx);
            return y < 0 || x < 0 ? -1 : y * p.bx + x;
          };
          const int oc = at(me.ty, me.tx);
          // input z's tap (ds, dy, dx) of row j under this entry's kinds:
          // a stream row past the rows follows ks (constant: the fill), a
          // blocked position clips to the block and is then re-imposed
          const auto tap_of = [&](int z, int ds, int dy, int dx) {
            int rr = j + ds;
            const bool oob = rr < 0 || rr >= p.dom;
            if (oob && ks == kConstant) return en.fill;
            rr = oob ? stream_row(rr, p.dom, ks) : rr;
            const int o = at(min(max(me.ty + dy, 0), p.by - 1),
                             min(max(me.tx + dx, 0), p.bx - 1));
            return o < 0 ? en.fill
                         : wide(win[en.in_base[z] +
                                    slot_of(r.m[z], rr, j, en.in_slots[z]) *
                                        plane +
                                    o]);
          };
          const auto tap = [&](int ds, int dy, int dx) {
            return tap_of(0, ds, dy, dx);
          };
          if (en.op == kSelectOp) {
            val = win[en.in_base[0] + m * plane + me.cell];
          } else if (en.op == kCombineOp) {
            const auto in = [&](int z) {
              return oc < 0 ? en.fill
                            : wide(win[en.in_base[z] + r.m[z] * plane + oc]);
            };
            float acc = mul(s_c[en.coeff_lo], in(0));
            for (int z = 1; z < en.n_in; ++z) {
              acc = add(acc, mul(s_c[en.coeff_lo + z], in(z)));
            }
            val = narrow<T>(acc);
          } else if (en.op == kTapOp) {
            float acc = 0.0f;
            for (int q = 0; q < en.tap_n; ++q) {
              const Tap tp = s_taps[en.tap_lo + q];
              const float term =
                  mul(s_c[en.coeff_lo + tp.ci], tap(tp.ds, tp.dy, tp.dx));
              acc = q ? add(acc, term) : term;
            }
            val = narrow<T>(acc);
#if STENCIL_CUSTOM
          } else if (en.op == kCustomOp) {
            val = narrow<T>(custom::custom_apply(
                en.tap_lo, tap_of, s_c + en.coeff_lo, [&] {
                  return wide(__ldg(aux + (size_t)j * pstride + me.own.g));
                }));
#endif
          } else {
            val = narrow<T>(table2_get(en.op, tap, en.c, aux,
                                       (size_t)j * pstride + me.own.g));
          }
          if (en.out_slots) win[r.outo + me.cell] = val;
        }
        if (en.field >= 0 && me.writes && j >= sg.s0 && j < sg.s1) {
          out[en.field * fstride + (size_t)j * pstride + me.own.g] = val;
        }
      }
      if (slow) __syncthreads();
    }
    if (tid < n) {  // entry tid's record for the next tick
      const WinRec& r = rec[tid];
      cnt[0] = cnt[0] + 1 == max(r.out_slots, 1) ? 0 : cnt[0] + 1;
      WinTick w;
      w.outo = r.out_base + cnt[0] * plane;
      w.pad0 = w.pad1 = w.pad2 = 0;
#pragma unroll
      for (int z = 0; z < kMaxInputs; ++z) {
        cnt[z + 1] = cnt[z + 1] + 1 == r.in_slots[z] ? 0 : cnt[z + 1] + 1;
        w.m[z] = cnt[z + 1];
      }
      trec[(t + 1) & 1][tid] = w;
    }
    __syncthreads();
  }
}


// --- The main-path and chain bodies ----------------------------------------

// cp.async of one 4-byte word, `src_bytes` of it read and the rest
// zero-filled; commit groups; wait until at most `n` (0..3) groups of this
// thread are in flight.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0) {
    cp_async_wait<0>();
  } else if (n == 1) {
    cp_async_wait<1>();
  } else if (n == 2) {
    cp_async_wait<2>();
  } else {
    cp_async_wait<3>();
  }
}

// Whether the stream row at `gp + g0` starts in the second half of a
// 4-byte word (bfloat16 only).
template <class T>
__device__ __forceinline__ int row_shift(const T* gp, int g0) {
  if constexpr (sizeof(T) == 4) {
    return 0;
  } else {
    return static_cast<int>((reinterpret_cast<size_t>(gp + g0) >> 1) & 1);
  }
}

// A staged slot holds the block's `by` rows `srow` cells apart (bx; for
// bfloat16 bx + 2 rounded up to even), row y from cell row_shift(y) on,
// so that every copy is one aligned word.  This
// thread's copy of a slab: `dst` its cell in the slot (-1: none), `src` its
// source's cell offset in a stream row of `gp`, `bytes` read.  float: the
// thread's cell; bfloat16: one word of a row (from the word holding the
// row's first cell), whose last word reads only the row's last cell.
struct Piece {
  int dst, src, bytes;
};

template <class T>
__device__ __forceinline__ Piece piece_of(int tid, const T* gp,
                                          const Params& p, int sy, int sx,
                                          int srow) {
  Piece pc = {-1, 0, 4};
  if constexpr (sizeof(T) == 4) {
    if (tid < p.by * p.bx) {
      const int y = tid / p.bx, x = tid - y * p.bx;
      pc.dst = y * srow + x;
      pc.src = (sy + y) * p.px + sx + x;
    }
  } else {
    const int wr = srow / 2;  // words a staged row
    if (tid < p.by * wr) {
      const int y = tid / wr, w = tid - y * wr;
      const int g0 = (sy + y) * p.px + sx;
      const int first = 2 * w - row_shift(gp, g0);  // the word's first cell
      if (first < p.bx) {
        pc.dst = y * srow + 2 * w;
        pc.src = g0 + first;
        pc.bytes = first + 1 < p.bx ? 4 : 2;
      }
    }
  }
  return pc;
}

// Cell (y, x) and its blocked-axis neighbours (clamped to the block) in a
// staged slot, as `pos_at` gives them in a ring.
template <class T>
__device__ __forceinline__ Pos staged_at(int y, int x, const T* gp,
                                         const Params& p, int sy, int sx,
                                         int srow) {
  const auto at = [&](int yy, int xx) {
    return yy * srow + row_shift(gp, (sy + yy) * p.px + sx) + xx;
  };
  Pos q;
  q.c = at(y, x);
  q.n = at(max(y - 1, 0), x);
  q.s = at(min(y + 1, p.by - 1), x);
  q.w = at(y, max(x - 1, 0));
  q.e = at(y, min(x + 1, p.bx - 1));
  q.g = 0;
  return q;
}

// The Table-2 stencils over the stream-axis taps as values (`up`, `ctr`,
// `dn`: rows j-1, j, j+1 of the producer at the cell) and the producer's
// row j `nb` at the blocked-axis neighbours of `q`, in the operation order
// of the functions above.
template <int kOp, class T>
__device__ __forceinline__ float table2_win(float up, float ctr, float dn,
                                            const T* nb, const Pos& q,
                                            const float* c, float aux) {
  if (kOp == 0) {
    float v = mul(c[0], ctr);
    v = add(v, mul(c[1], wide(nb[q.w])));
    v = add(v, mul(c[2], wide(nb[q.e])));
    v = add(v, mul(c[3], dn));
    return add(v, mul(c[4], up));
  }
  if (kOp == 1) {
    const float two_v = mul(2.0f, ctr);
    const float dy = sub(add(up, dn), two_v);
    const float dx = sub(add(wide(nb[q.e]), wide(nb[q.w])), two_v);
    float t = add(aux, mul(dy, c[2]));
    t = add(t, mul(dx, c[1]));
    t = add(t, mul(sub(kTempAmb, ctr), c[3]));
    return add(ctr, mul(c[0], t));
  }
  if (kOp == 2) {
    float v = mul(c[0], ctr);
    v = add(v, mul(c[1], wide(nb[q.w])));
    v = add(v, mul(c[2], wide(nb[q.e])));
    v = add(v, mul(c[3], wide(nb[q.s])));
    v = add(v, mul(c[4], wide(nb[q.n])));
    v = add(v, mul(c[5], up));
    return add(v, mul(c[6], dn));
  }
  float v = mul(ctr, c[0]);
  v = add(v, mul(wide(nb[q.n]), c[1]));
  v = add(v, mul(wide(nb[q.s]), c[2]));
  v = add(v, mul(wide(nb[q.e]), c[3]));
  v = add(v, mul(wide(nb[q.w]), c[4]));
  v = add(v, mul(dn, c[5]));
  v = add(v, mul(up, c[6]));
  v = add(v, mul(c[7], aux));
  return add(v, mul(c[5], kTempAmb));
}

// The up and down taps of stream row x from a window (rows x-1, x, x+1 of
// the producer at the cell): at the rows' ends clamp takes row x again,
// reflect the row on the other side and constant the fill, as `slot_up`,
// `slot_dn` and `ends` read them from a ring.
template <bool kBC>
__device__ __forceinline__ void window_ends(float& u, float& d, float up,
                                            float mid, float dn, int x,
                                            int dom, int ks, float fill) {
  u = up;
  d = dn;
  if (x == 0) {
    u = kBC && ks == kConstant ? fill : (kBC && ks == kReflect ? dn : mid);
  }
  if (x == dom - 1) {
    d = kBC && ks == kConstant ? fill : (kBC && ks == kReflect ? up : mid);
  }
}

// Whether reflect maps every cell of a block's axis that lies outside the
// grid onto a cell inside it (lo, hi: the grid's edges in block
// coordinates, n cells).  Then a cell outside the grid holds, in every
// ring and in the field stream, what the cell it maps to holds, and a
// thread may take the stream-axis taps of the position it computes at
// from its own column.  A grid that ends well inside a block's overhang
// maps some cells onto others outside it, whose values differ.
__device__ __forceinline__ bool mirrors_inside(int lo, int hi, int n) {
  const bool above = hi >= n - 1 || 2 * hi - (n - 1) >= max(lo, 0);
  const bool below = lo <= 0 || 2 * lo <= min(hi, n - 1);
  return above && below;
}

// Whether every cell of the block at (sy, sx) maps, under stage 0's
// blocked-axis kinds, onto a cell holding the same values (CTA-uniform):
// always but under reflect (`mirrors_inside`).
template <bool kBC>
__device__ __forceinline__ bool own_columns(const Params& p, int sy, int sx,
                                            const Stage& s0) {
  if (!kBC) return true;
  return (s0.ky != kReflect ||
          mirrors_inside(p.hy - sy, p.dy - 1 + p.hy - sy, p.by)) &&
         (s0.kx != kReflect ||
          mirrors_inside(p.hx - sx, p.dx - 1 + p.hx - sx, p.bx));
}

// The main path's register form: V = 1, a cell a thread, at most kT
// entries, and in bfloat16 only where every stream row starts on the same
// half of a 4-byte word as the first, since each copy ahead is a word laid
// out from the first row's shift (kernels/builder.py: main_look,
// whole_word_rows).  Each thread keeps rows j-1 and
// j of every entry's producer at its cell in registers (`up`, `mid`);
// shared memory holds the field stream's slabs, staged by cp.async `look`
// slabs ahead in `look + 2` slots, and each entry's value of the last two
// ticks (for its consumer's blocked-axis neighbours).  Entry i computes
// slab t - i - 1 at tick t from its producer's slab of the tick before (the
// neighbours, and the centre and up taps in registers) and of this tick
// (the down tap: the value this thread computed just before), so all
// entries of a tick run between one pair of barriers.  A thread's window
// holds the column its entry reads the stream at: its own, or for an
// entry whose value enters a ring the position stage 0's boundary maps
// its cell to, which holds the same values (`own_columns`).  A block where
// it does not (reflect, past a grid that ends inside its overhang) reads
// each down tap from the producer's buffer at that position, behind a
// barrier after every entry.
template <int kOp, class T, bool kBC, int kT>
__device__ __forceinline__ void main_windows(const T* __restrict__ gp,
                                             const T* __restrict__ aux,
                                             T* __restrict__ out,
                                             const Params& p,
                                             const Program& k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int plane = p.by * p.bx;
  const int nslabs = p.ns;
  const int n = p.n_entries;
  const int tid = threadIdx.x;
  const bool act = tid < plane;
  const int cell = act ? tid : 0;
  const int ty = cell / p.bx;
  const int tx = cell - ty * p.bx;
  const Segment sg = segment_of(p, nslabs);
  const int sy = sg.sy;
  const int sx = blockIdx.x * p.cx;
  const Stage s0 = k.s[0];
  const Axis ay = axis_at(ty, sy, p.hy, p.dy, p.by);
  const Axis ax = axis_at(tx, sx, p.hx, p.dx, p.bx);
  const int ey = axis_pos(ay, ty, s0.ky), ex = axis_pos(ax, tx, s0.kx);
  const Pos own = pos_at(ty, tx, p, sy, sx);
  const Pos edge = pos_at(ey, ex, p, sy, sx);
  const bool writes = act && ty >= p.hy && ty < p.hy + p.cy && tx >= p.hx &&
                      tx < p.hx + p.cx;
  const bool fill_edge = kBC && takes_fill(ay, ax, s0.ky, s0.kx);
  const T fill_t = narrow<T>(s0.fill);
  const float fill_f = wide(fill_t);
  const size_t pstride = (size_t)p.py * p.px;
  // shared memory: S staged slots, then two block planes per entry with a
  // consumer (its values of the ticks t and t-1, by parity)
  const int L = p.look, S = L + 2;
  const int srow = sizeof(T) == 4 ? p.bx : (p.bx + 3) & ~1;
  const int sslot = p.by * srow;
  T* const stage = reinterpret_cast<T*>(smem_raw);
  T* const buf = stage + S * sslot;
  const bool exact = own_columns<kBC>(p, sy, sx, s0);
  const Piece pc = piece_of(tid, gp, p, sy, sx, srow);
  // entry 0 reads the stream where it computes: its window's column and
  // the neighbours
  const Pos sq = n == 1 ? staged_at(ty, tx, gp, p, sy, sx, srow)
                        : staged_at(ey, ex, gp, p, sy, sx, srow);
  float c[8];
  for (int z = 0; z < 8; ++z) c[z] = k.c[z];
  // the windows of entries 0..n-2, whose values enter a ring, and of the
  // last entry, whose value drains out: three rows each, of which tick
  // phase P (t - a mod 3) reads rows P and P+1 (mod 3) as the up and
  // centre taps and stores the producer's new row into row P+2, so that
  // the windows turn over without moves
  float w[kT - 1][3], w_last[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int i = 0; i < kT - 1; ++i) w[i][r] = 0.0f;
    w_last[r] = 0.0f;
  }
  // Hotspot's power: entry i < n-1 at tick t reads row t-i-1 at the
  // position it computes at, which this thread loaded i+1 ticks before
  // (`pw`, shifted a row a tick); the last entry reads its cell's row,
  // loaded a tick ahead (`pw_last`)
  constexpr bool kAux = kOp == 1 || kOp == 3;
  const auto aux_row = [&](int r, const Pos& q) {
    return kAux && r >= 0 && r < p.dom
               ? wide(__ldg(aux + (size_t)r * pstride + q.g))
               : 0.0f;
  };
  float pw[kT - 1];
#pragma unroll
  for (int i = 0; i < kT - 1; ++i) pw[i] = aux_row(sg.a - 1 - i, edge);
  float pw_last = aux_row(sg.a - n, own);
  // copy slab s (stream row s) into staged slot `slot`; one group a slab
  const auto issue = [&](int s, int slot) {
    if (pc.dst >= 0 && s < p.dom) {
      cp_async4(stage + slot * sslot + pc.dst,
                gp + (size_t)s * pstride + pc.src, pc.bytes);
    }
    cp_async_commit();
  };
  int st = sg.a % S;  // the slot of slab t
  for (int u = 0; u < L; ++u) issue(sg.a + u, st + u < S ? st + u : st + u - S);
  cp_async_wait_pending(L - 1);
  __syncthreads();
  // One tick: the entries in phase P.  kSteady: every entry computes a
  // row it owns away from the stream's ends, and none forwards (most
  // ticks), so the entries run without their range, end and forwarding
  // tests; inactive threads compute at cell 0 and store nothing.
  const auto entries = [&](int t, const T* prev, T* now_buf,
                           const T* was_buf, float fresh, auto phase,
                           auto steady) {
    constexpr int P = decltype(phase)::value;
    constexpr int U = P, M = (P + 1) % 3, D = (P + 2) % 3;
    constexpr bool kSteady = decltype(steady)::value;
#pragma unroll
    for (int i = 0; i < kT - 1; ++i) {
      if (i < n - 1) {
        const int j = t - (i + 1);  // CTA-uniform
        const T* const nb = i == 0 ? prev : was_buf + 2 * (i - 1) * plane;
        float val = 0.0f;
        if constexpr (kSteady) {
          T v = narrow<T>(table2_win<kOp>(w[i][U], w[i][M], fresh, nb,
                                          i == 0 ? sq : edge, c, pw[i]));
          if (fill_edge) v = fill_t;
          if (act) now_buf[2 * i * plane + cell] = v;
          val = wide(v);
        } else if (act && j >= sg.a && j < nslabs) {
          T v;
          if (i < p.steps) {
            float u, d;
            window_ends<kBC>(u, d, w[i][U], w[i][M], fresh, j, p.dom, s0.ks,
                             fill_f);
            v = narrow<T>(table2_win<kOp>(u, w[i][M], d, nb,
                                          i == 0 ? sq : edge, c, pw[i]));
          } else {
            v = narrow<T>(w[i][M]);
          }
          if (fill_edge) v = fill_t;
          now_buf[2 * i * plane + cell] = v;
          val = wide(v);
        }
        w[i][D] = fresh;
        fresh = val;
        if (!kSteady && !exact) {
          // entry i+1's down tap at its column, once every thread's value
          // of entry i is in
          __syncthreads();
          fresh = wide(now_buf[2 * i * plane +
                               (i + 1 == n - 1 ? own.c : edge.c)]);
        }
      }
    }
    // the last entry: at the cell's own position, into the output
    const int j = t - n;
    const T* const nb = n == 1 ? prev : was_buf + 2 * (n - 2) * plane;
    const Pos& q = n == 1 ? sq : own;
    if constexpr (kSteady) {
      const T v = narrow<T>(table2_win<kOp>(w_last[U], w_last[M], fresh, nb,
                                            q, c, pw_last));
      if (writes && j >= sg.s0) out[(size_t)j * pstride + own.g] = v;
    } else if (act && j >= sg.a && j < nslabs) {
      T v;
      if (n - 1 < p.steps) {
        float u, d;
        window_ends<kBC>(u, d, w_last[U], w_last[M], fresh, j, p.dom, s0.ks,
                         fill_f);
        v = narrow<T>(table2_win<kOp>(u, w_last[M], d, nb, q, c, pw_last));
      } else {
        v = narrow<T>(w_last[M]);
      }
      if (writes && j >= sg.s0) out[(size_t)j * pstride + own.g] = v;
    }
    w_last[D] = fresh;
  };
  const bool all_steps = p.steps >= n && exact;
  const int first_steady = max(sg.a, 1) + n;  // the last entry past row 0
  const auto tick = [&](int t, auto phase) {
    issue(t + L, st + L < S ? st + L : st + L - S);
    const T* const prev = stage + (st ? st - 1 : S - 1) * sslot;  // slab t-1
    T* const now_buf = buf + (t & 1) * plane;           // entry i: + 2i planes
    const T* const was_buf = buf + ((t & 1) ^ 1) * plane;
    // the stream's row t at entry 0's column: its down tap
    const float fresh = t < nslabs ? wide(stage[st * sslot + sq.c]) : 0.0f;
    const float pw_new = aux_row(t, edge);
    const float pw_next = aux_row(t + 1 - n, own);
    if (all_steps && t >= first_steady && t < p.dom - 1) {
      entries(t, prev, now_buf, was_buf, fresh, phase, std::true_type());
    } else {
      entries(t, prev, now_buf, was_buf, fresh, phase, std::false_type());
    }
    if constexpr (kAux) {
#pragma unroll
      for (int i = kT - 2; i > 0; --i) pw[i] = pw[i - 1];
      pw[0] = pw_new;
      pw_last = pw_next;
    }
    st = st + 1 == S ? 0 : st + 1;
    cp_async_wait_pending(L - 1);
    __syncthreads();
  };
  for (int t = sg.a; t < sg.t_end; t += 3) {
    tick(t, std::integral_constant<int, 0>());
    if (t + 1 < sg.t_end) tick(t + 1, std::integral_constant<int, 1>());
    if (t + 2 < sg.t_end) tick(t + 2, std::integral_constant<int, 2>());
  }
  cp_async_wait<0>();
}

// The main path's ring form: any V (a thread takes every row of a slab at
// its cell), the wide form, and more than kMaxWindowEntries entries.  Ring
// i of 3 slabs holds entry i's producer (ring 0 the field stream, pushed
// from registers loaded a tick ahead); a thread reads the stream-axis taps
// of its cells from their own column — rows it wrote itself, the down tap
// this tick — and the blocked-axis neighbours from its producer's slab of
// the tick before, so a tick also needs one barrier.  A block whose cells
// do not all hold their mapped cells' values (`own_columns`) reads the
// stream-axis taps at the mapped column, behind a barrier after the push
// and after every entry.
template <int kOp, int kForm, class T, bool kBC>
__device__ __forceinline__ void main_rings(const T* __restrict__ gp,
                                           const T* __restrict__ aux,
                                           T* __restrict__ out,
                                           const Params& p,
                                           const Program& k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const win = reinterpret_cast<T*>(smem_raw);
  constexpr bool kV1 = kForm == kVecOne;
  constexpr bool kW = kForm == kWide;
  const int plane = p.by * p.bx;
  const int tid = threadIdx.x;
  const int V = kV1 ? 1 : p.V;
  const int nslabs = p.ns / V;
  const int WV = 3 * V;
  const Segment sg = segment_of(p, nslabs);
  const int sx = blockIdx.x * p.cx;
  const Cell me = cell_at<kBC>(tid, tid < plane, p, sg.sy, sx, k.s[0]);
  const size_t pstride = (size_t)p.py * p.px;
  const bool exact = own_columns<kBC>(p, sg.sy, sx, k.s[0]);
  const auto cells = [&](auto&& f) {
    if constexpr (!kW) {
      if (me.act) f(me);
    } else {
      for (int z = tid; z < plane; z += blockDim.x) {
        f(cell_at<kBC>(z, true, p, sg.sy, sx, k.s[0]));
      }
    }
  };
  constexpr int kPre = kV1 ? 1 : 4;
  const T fill_t = narrow<T>(k.s[0].fill);
  const int ks = k.s[0].ks;
  T nxt[kPre];
  if (!kW && me.act) {
    prefetch_slab<kPre>(nxt, gp + me.own.g + (size_t)sg.a * V * pstride, 0,
                        1, V, p.dom - sg.a * V, pstride);
  }
  float c[8];
  for (int z = 0; z < 8; ++z) c[z] = k.c[z];
  for (int t = sg.a; t < sg.t_end; ++t) {
    if (t < nslabs) {
      cells([&](const Cell& cl) {
        push_slab<kPre>(kW ? (T*)nullptr : nxt, gp + cl.own.g, win, WV,
                        (T*)nullptr, t, 0, 1, V, V, p.dom, pstride, plane,
                        cl.cell);
      });
    }
    if (!exact) __syncthreads();
    for (int i = 0; i < p.n_entries; ++i) {
      const int j = t - (i + 1);  // CTA-uniform
      if (j >= sg.a && j < nslabs) {
        const bool last = i == p.n_entries - 1;
        const T* const ring = win + i * WV * plane;
        const int m0 = (j % 3) * V;
        cells([&](const Cell& cl) {
          // the stream-axis taps at the cell's own column
          Pos q = last ? cl.own : cl.edge;
          if (exact) q.c = cl.cell;
          const auto put = [&](int m, int x, T val) {
            if (!last) {
              win[((i + 1) * WV + m) * plane + cl.cell] =
                  cl.fill_edge ? fill_t : val;
            } else if (cl.writes && j >= sg.s0) {
              out[(size_t)x * pstride + cl.own.g] = val;
            }
          };
          if constexpr (kForm == kRows) {
            // rolled down the slab's rows: the up and centre taps from
            // the row before, one load a row (in the wide form and at V =
            // 1 this cost more than it saved on an H100)
            const int x0 = j * V;
            float up = wide(ring[(m0 ? m0 - 1 : WV - 1) * plane + q.c]);
            float mid = wide(ring[m0 * plane + q.c]);
            const int rows = min(V, p.dom - x0);
            for (int r = 0; r < rows; ++r) {
              const int m = m0 + r, x = x0 + r;
              const float dn =
                  wide(ring[(m + 1 == WV ? 0 : m + 1) * plane + q.c]);
              T val;
              if (i < p.steps) {
                float u, d;
                window_ends<kBC>(u, d, up, mid, dn, x, p.dom, ks,
                                 wide(fill_t));
                const float a =
                    kOp == 1 || kOp == 3
                        ? wide(__ldg(aux + (size_t)x * pstride + q.g))
                        : 0.0f;
                val = narrow<T>(
                    table2_win<kOp>(u, mid, d, ring + m * plane, q, c, a));
              } else {
                val = narrow<T>(mid);
              }
              put(m, x, val);
              up = mid;
              mid = dn;
            }
          } else {
            for_rows<kV1 ? kVecOne : kRows>(
                j, V, 0, 1, V, p.dom, [&](int r, int x) {
                  const int m = m0 + r;
                  const T* const mid = ring + m * plane;
                  put(m, x,
                      i < p.steps
                          ? narrow<T>(table2<kOp>(
                                ring + slot_up<kBC>(m, x, WV, ks) * plane,
                                mid,
                                ring +
                                    slot_dn<kBC>(m, x, WV, p.dom, ks) * plane,
                                q, c, ends<kBC>(x, p.dom, ks, wide(fill_t)),
                                aux, (size_t)x * pstride))
                          : mid[q.c]);
                });
          }
        });
      }
      if (!exact) __syncthreads();
    }
    __syncthreads();
  }
}

// The chain body (kOp = -1) in every form, the large-table route (K =
// `DevTable`, the wide form) included: `dag_layout`'s lags and rings and a
// barrier per entry and tick; its CTA streams one segment.
template <int kForm, class T, bool kBC, class K>
__device__ __forceinline__ void chain_body(const T* __restrict__ gp,
                                           const T* __restrict__ aux,
                                           T* __restrict__ out,
                                           const Params& p, const K& k) {
  constexpr bool kV1 = kForm == kVecOne;
  constexpr bool kW = kForm == kWide;
  // the rings, in value-id order (in the large-table route after the
  // records)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  size_t front = 0;
  if constexpr (K::kBig) {
    front = table_bytes<Rec, TickRec>(p.n_entries, k.n_taps, k.n_coeffs, 0);
  }
  T* const win = reinterpret_cast<T*>(smem_raw + front);
  const int plane = p.by * p.bx;
  const int tid = threadIdx.x;
  const int V = kV1 ? 1 : p.V;
  const int vt = kV1 ? 1 : p.vt;
  const int nr = kV1 ? 1 : p.rows;
  const int nslabs = p.ns / V;
  // thread tid < plane * vt takes cell tid mod plane of rows tv, tv + vt,
  // ... of each slab; the others build records and meet the barriers (and
  // touch no memory with their cell).  In the wide form a thread takes
  // cells tid, tid + blockDim.x, ... with every row of a slab.
  const bool act = tid < plane * vt;
  const int tv = kV1 || kW ? 0 : tid / plane;
  const Segment sg = segment_of(p, nslabs);
  const int sy = sg.sy;
  const int sx = blockIdx.x * p.cx;
  const Cell me = cell_at<kBC>(tid - tv * plane, act, p, sy, sx, k.s[0]);
  const size_t pstride = (size_t)p.py * p.px;
  // calls f(cell) for each plane cell this thread takes
  const auto cells = [&](auto&& f) {
    if constexpr (!kW) {
      if (me.act) f(me);
    } else {
      for (int z = tid; z < plane; z += blockDim.x) {
        f(cell_at<kBC>(z, true, p, sy, sx, k.s[0]));
      }
    }
  };
  // calls f(i) for each entry whose records this thread builds: entry tid
  // (the launcher gives a table-driven body a thread per entry) or, in
  // the large-table route, every blockDim.x-th from tid
  const auto entries = [&](auto&& f) {
    if constexpr (!K::kBig) {
      if (tid < p.n_entries) f(tid);
    } else {
      for (int i = tid; i < p.n_entries; i += blockDim.x) f(i);
    }
  };
  const auto sm = records<Rec, TickRec>(smem_raw, k, p.n_entries, 0);
  Rec* const rec = sm.rec;
  TickRec* const trec = sm.trec;
  entries([&](int e) {
    const auto en = k.e[e];
    const Stage st = k.s[en.stage];
    // the consumer: the next entry (the last one's value drains out)
    const Stage sc = e + 1 < p.n_entries ? k.s[k.e[e + 1].stage] : st;
    const Input in = input_of(k, en, 0);
    // rings in rows: a slot of the table is V block planes
    Rec r = {en.lag,          in.base * V,       in.slots * V,
             en.out_base * V, en.out_slots * V,  st.op,
             en.iteration,    st.tap_lo,         st.tap_n,
             st.coeff_lo,     st.ks,             sc.ky | (sc.kx << 8),
             wide(narrow<T>(st.fill)),           wide(narrow<T>(sc.fill)),
             0.0f,            0.0f};
    for (int z = 0; z < 8; ++z) {
      r.c[z] = st.op != kTapOp && st.coeff_lo + z < k.n_coeffs
                   ? k.c[st.coeff_lo + z]
                   : 0.0f;
    }
    rec[e] = r;
  });
  for (int z = tid; z < k.n_taps; z += blockDim.x) sm.taps[z] = k.taps[z];
  for (int z = tid; z < k.n_coeffs; z += blockDim.x) sm.c[z] = k.c[z];
  __syncthreads();
  // without kBC every stage re-imposes as stage 0 does (periodicity is
  // uniform, the other axes clamp)
  // the input stream's ring is entry 0's producer
  T* const stream_ring = win + rec[0].in_base * plane;
  const int stream_rows = rec[0].in_slots;
  T nxt[1];
  if (!kW && act) {
    prefetch_slab<1>(nxt, gp + me.own.g + (size_t)sg.a * V * pstride, tv,
                     vt, nr, p.dom - sg.a * V, pstride);
  }
  for (int t = sg.a; t < sg.t_end; ++t) {
    if (t < nslabs) {
      cells([&](const Cell& cl) {
        push_slab<1>(kW ? (T*)nullptr : nxt, gp + cl.own.g, stream_ring,
                     stream_rows, (T*)nullptr, t, tv, vt, nr, V, p.dom,
                     pstride, plane, cl.cell);
      });
    }
    entries([&](int e) {  // entry e's slots at this tick
      const Rec& en = rec[e];
      TickRec r;
      r.j = t - en.lag;
      r.flags =
          (r.j >= sg.a && r.j < nslabs) | ((en.iteration < p.steps) << 1);
      const unsigned x0 = min(max(r.j, 0), nslabs - 1) * V;
      r.m = x0 % (unsigned)en.in_slots;
      r.outo = en.out_slots
                   ? (en.out_base + x0 % (unsigned)en.out_slots) * plane
                   : 0;
      r.pad0 = r.pad1 = r.pad2 = r.pad3 = 0;
      trec[e] = r;
    });
    __syncthreads();
    for (int i = 0; i < p.n_entries; ++i) {
      const TickRec r = trec[i];
      if (r.flags & 1) {
        cells([&](const Cell& cl) {
          const Rec& en = rec[i];
          const bool last = i == p.n_entries - 1;
          // a value that enters a ring is taken where its consumer's
          // blocked-axis kinds say
          const int ky = en.kyx & 0xff, kx = en.kyx >> 8;
          const int qy =
              last ? cl.ty : (kBC ? axis_pos(cl.ay, cl.ty, ky) : cl.ey);
          const int qx =
              last ? cl.tx : (kBC ? axis_pos(cl.ax, cl.tx, kx) : cl.ex);
          const bool fill_edge =
              kBC && !last && takes_fill(cl.ay, cl.ax, ky, kx);
          const Pos q = !kBC ? (last ? cl.own : cl.edge)
                             : pos_at(qy, qx, p, sy, sx);
          const T* ring = win + en.in_base * plane;
          const int W = en.in_slots;
          for_rows<kForm>(r.j, V, tv, vt, nr, p.dom, [&](int row, int x) {
            const int m = r.m + row;
            T val;
            if (!(r.flags & 2)) {
              val = ring[m * plane + q.c];
            } else if (en.op == kTapOp) {
              val = narrow<T>(tap_sum<kBC>(sm.taps, sm.c, en.tap_lo,
                                           en.tap_n, en.coeff_lo, ring, W,
                                           m, plane, x, qy, qx, p, en.ks,
                                           en.fill_s));
#if STENCIL_CUSTOM
            } else if (en.op == kCustomOp) {
              const int base = en.in_base * plane;
              val = narrow<T>(custom::custom_apply(
                  en.tap_lo,
                  [&](int, int ds, int dy, int dx) {
                    return ring_tap<kBC>(win, base, W * plane,
                                         base + m * plane, plane, x, qy,
                                         qx, ds, dy, dx, p, en.ks,
                                         en.fill_s);
                  },
                  sm.c + en.coeff_lo, [&] {
                    return wide(__ldg(aux + (size_t)x * pstride + q.g));
                  }));
#endif
            } else {
              float c[8];
              for (int z = 0; z < 8; ++z) c[z] = en.c[z];
              val = narrow<T>(table2_op(
                  en.op, ring + slot_up<kBC>(m, x, W, en.ks) * plane,
                  ring + m * plane,
                  ring + slot_dn<kBC>(m, x, W, p.dom, en.ks) * plane, q, c,
                  ends<kBC>(x, p.dom, en.ks, en.fill_s), aux,
                  (size_t)x * pstride));
            }
            if (!last) {
              win[r.outo + row * plane + cl.cell] =
                  fill_edge ? narrow<T>(en.fill_b) : val;
            } else if (cl.writes && r.j >= sg.s0) {
              out[(size_t)x * pstride + cl.own.g] = val;
            }
          });
        });
      }
      __syncthreads();
    }
  }
}

// --- The chain body's one-barrier form --------------------------------------

// One entry of the chain body's one-barrier form, flattened for shared
// memory: its lag and `step` (its lag less its producer's: the stage's
// reach in rows); `mode` its op (bits 0-7), flags (kChainLive: its
// iteration is < steps, else it forwards; kChainReg: its own-column taps
// read the register window; kChainSame: its consumer's blocked-axis kinds
// are stage 0's) and its stage's stream-axis kind (bits 16-23); its
// producer's ring (first cell from the rings' start, rows) and its own
// (the last entry has none); its stage's taps (`taps`: first | count <<
// 16) and coefficients; its consumer's blocked-axis kinds (`kyx`: ky | kx
// << 8); its stage's fill and its consumer's (rounded through the storage
// type); and the coefficients of a Table-2 stage or a star.
struct ChainWinRec {  // 80 bytes; 16-byte aligned
  int lag, step, mode, in_base;
  int in_slots, out_base, out_slots, taps;
  int coeff_lo, kyx;
  float fill_s, fill_b;
  float c[8];
};
// kernels/builder.py prices its tables with CHAINREC_BYTES, CHAINTICK_BYTES,
// CHAINTAP_BYTES
static_assert(sizeof(ChainWinRec) == 80, "ChainWinRec layout changed");
constexpr int kChainLive = 1 << 8, kChainReg = 2 << 8, kChainSame = 4 << 8;
// A tap table in the order of `make_star(nd, 0)` (the centre alone) or
// `make_star(nd, 1)` (the centre, then -1 and +1 along each axis in turn;
// kernels/builder.py marks its stage, `Stage::pad` 1 or 2), computed in
// that order from the register window and the ring without reading a tap
// table.
constexpr int kStar0Op = 12, kStar1Op = 13;

// One entry at one tick, built a tick ahead by the entry's thread: the row
// j it computes, whether j is one of the segment's rows (`run`), the cells
// (from the rings' start) of its producer's rows j + step, j + step - 1
// and j + step - 2 (its newest and the two before), of its own ring's row
// j, and the slot of the producer's newest row.
struct ChainTick {  // 32 bytes: two 16-byte loads
  int j, run, r0, r1;
  int r2, outo, sp, pad;
};
static_assert(sizeof(ChainTick) == 32, "ChainTick layout changed");

// A tap of a tap table as the one-barrier chain form reads it: its
// offsets, `e` (its stage's step less ds: the rows it lies behind its
// producer's newest), its offset in the block plane and its coefficient.
struct ChainTap {  // 16 bytes: one load
  short ds, dy, dx, e;
  int dcell;
  float c;
};
static_assert(sizeof(ChainTap) == 16, "ChainTap layout changed");

// Cells before the first ring and after the last that an unclipped tap of
// radius `rad` may reach: `rad` rows and cells of the staged field stream
// (`srow` cells a row), and two more for the bfloat16 row shift, rounded
// up to an even count so that the staged slots stay 4-byte aligned
// (kernels/builder.py: chain_pad).
__device__ __host__ __forceinline__ int chain_pad(const Params& p, int srow) {
  return (p.rad * (p.by > 1 ? srow + 1 : 1) + 3) & ~1;
}

// The chain body (kOp = -1) at V = 1 in one barrier a tick (the layout is
// kernels/builder.py chain_layout, the DAG bodies' win_layout of the
// chain as a path graph; the table `_chain_table`).  A CTA streams its segment
// (`Segment`) one row a tick, a cell a thread.  Entry i computes row j =
// t - lag_i at tick t: a tap in its own column lags its producer by |ds|
// rows, one in another column by |ds| + 1, so a thread reads another
// thread's cell only in rows written at an earlier tick and its own cell
// of the rows it wrote this tick, and the tick's entries run between one
// pair of barriers.  As in `chain_body`, every value that enters a ring is
// computed at the position its consumer's blocked-axis kinds map the cell
// to and takes the fill where that consumer is constant and the cell
// outside the grid; the producer's value at the thread's own cell equals
// its value at that position, since every block's overhang mirrors inside
// the grid and each consumer maps a cell as the value it reads was mapped
// (kernels/builder.py chain_form checks both at plan time).  The field
// stream is copied by cp.async `look` rows ahead into its staged ring (in
// bfloat16 a row from the 4-byte word holding its first cell, as
// `main_windows`), which the layout's rows and `look` more hold.  Thread i
// of the first n_entries builds entry i's tick record a tick ahead, into
// the other of two buffers.  A Table-2 stage and a star of radius 0 or 1
// run straight-line code; other tap tables loop over their taps, a custom
// `apply` reads its taps through a getter.  Register form (`p.win` - 1 kT
// = 4 or 8 entries, the least that holds the chain): the entry loop
// unrolled, and, where a stage's own-column taps reach at most 2 rows
// behind the producer's newest (`kChainReg`: a Table-2 stencil, a star of
// radius 0 or 1), a window of its producer's rows at the thread's cell in
// registers: the newest, passed on from the entry before in the same
// thread, and the one before (kT 8) or two before (kT 4); the rest
// from the ring.  In probes on an H100 a deeper window spilled at 8
// entries and 64 registers and ran no faster, and more registers a thread
// (fewer CTAs of 256 threads an SM) ran slower.  Ring form (kT = 0): the
// entries in a loop, every tap from the rings (chip_smoke.py times it on
// advect_diffuse2d at 16 entries).  Taps away from the
// stream's ends (`fast`, CTA-uniform) neither clip nor map the stream row;
// blocked-axis taps are read unclipped, as `dag_kernel` reads them (a tap
// that leaves the block reads a padded cell, and feeds only halo cells
// the overlap discards).  Each CTA writes only the rows it owns.
template <class T, bool kBC, int kT>
__global__ void __launch_bounds__(1024, 1)
    chain_win_kernel(const T* __restrict__ gp, const T* __restrict__ aux,
                     T* __restrict__ out, const Params p,
                     const __grid_constant__ Program k,
                     long long member_stride, long long aux_stride) {
#if STENCIL_BATCH
  // batch member blockIdx.z: its state, output and aux
  const size_t member = blockIdx.z;
  gp += member * (size_t)member_stride;
  out += member * (size_t)member_stride;
  if (aux != nullptr) aux += member * (size_t)aux_stride;
#endif
  __shared__ __align__(16) ChainWinRec rec[kMaxEntries];
  __shared__ __align__(16) ChainTick trec[2][kMaxEntries];
  __shared__ __align__(16) ChainTap s_taps[kMaxTaps];
  __shared__ float s_c[kMaxCoeffs];
  const int plane = p.by * p.bx;
  const int tid = threadIdx.x;
  const int nslabs = p.ns;
  const int n = p.n_entries;
  const Segment sg = segment_of(p, nslabs);
  const int sy = sg.sy;
  const int sx = blockIdx.x * p.cx;
  const Cell me = cell_at<kBC>(tid, tid < plane, p, sy, sx, k.s[0]);
  const size_t pstride = (size_t)p.py * p.px;
  // the field stream's staged ring: `D0` slots of `by` rows `srow` cells
  // apart, row y from cell `shift(y)` on; then the entries' rings of block
  // planes, from cell `D0 * sslot` on
  const int srow = sizeof(T) == 4 ? p.bx : (p.bx + 3) & ~1;
  const int sslot = p.by * srow;
  const int D0 = k.f[0].slots;
  const int look = p.look;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const win = reinterpret_cast<T*>(smem_raw) + chain_pad(p, srow);
  // where block cell (y, x) sits in a staged slot
  const int sb = sizeof(T) == 4
                     ? 0
                     : static_cast<int>(
                           ((reinterpret_cast<size_t>(gp) >> 1) +
                            (size_t)sy * p.px + sx) &
                           1);
  const auto staged = [&](int y, int x) {
    if constexpr (sizeof(T) == 4) {
      return y * p.bx + x;
    } else {
      return y * srow + ((sb + y * p.px) & 1) + x;
    }
  };

  // entry tid's records, and its slots: its producer's newest row and its
  // own row j, turned over by one a tick
  int cp = 0, co = 0;
  if (tid < n) {  // a thread per entry (the launcher's rule)
    const Entry en = k.e[tid];
    const Stage st = k.s[en.stage];
    // the consumer: the next entry (the last one's value drains out)
    const Stage sc = tid + 1 < n ? k.s[k.e[tid + 1].stage] : st;
    const int rings = D0 * (sslot - plane);  // entry ring slot s at s*plane+
    const int op = st.op == kTapOp && st.pad == 1   ? kStar0Op
                   : st.op == kTapOp && st.pad == 2 ? kStar1Op
                                                    : st.op;
    ChainWinRec r = {};
    r.lag = en.lag;
    r.step = en.lag - (tid ? k.e[tid - 1].lag : 0);
    r.mode = (op & 0xff) | (en.iteration < p.steps ? kChainLive : 0) |
             (kT > 0 && en.pad ? kChainReg : 0) |
             (sc.ky == k.s[0].ky && sc.kx == k.s[0].kx ? kChainSame : 0) |
             ((st.ks & 0xff) << 16);
    r.in_base = tid ? en.in_base[0] * plane + rings : 0;
    r.in_slots = en.in_slots[0];
    r.out_base = en.out_base * plane + rings;
    r.out_slots = en.out_slots;
    r.taps = st.tap_lo | (st.tap_n << 16);
    r.coeff_lo = st.coeff_lo;
    r.kyx = sc.ky | (sc.kx << 8);
    r.fill_s = wide(narrow<T>(st.fill));
    r.fill_b = wide(narrow<T>(sc.fill));
    for (int z = 0; z < 8; ++z) {
      r.c[z] = (st.op < kTapOp || op >= kStar0Op) &&
                       st.coeff_lo + z < kMaxCoeffs
                   ? k.c[st.coeff_lo + z]
                   : 0.0f;
    }
    rec[tid] = r;
    const auto mod = [](int x, int w) {
      const int m = x % w;
      return m < 0 ? m + w : m;
    };
    cp = mod(sg.a - (tid ? k.e[tid - 1].lag : 0), r.in_slots);
    co = mod(sg.a - r.lag, max(r.out_slots, 1));
  }
  // entry tid's record at tick u, whose producer's newest row is in slot
  // cp and whose row j in slot co
  const auto tick_rec = [&](int u) {
    const ChainWinRec& r = rec[tid];
    const int S = tid ? plane : sslot;
    const int W = r.in_slots;
    const auto back = [&](int e) {  // the slot e rows before the newest
      int s = cp - e;
      while (s < 0) s += W;
      return r.in_base + s * S;
    };
    ChainTick tk;
    tk.j = u - r.lag;
    tk.run = tk.j >= sg.a && tk.j < nslabs;
    tk.r0 = back(0);
    tk.r1 = back(1);
    tk.r2 = back(2);
    tk.outo = r.out_base + co * plane;
    tk.sp = cp;
    tk.pad = 0;
    trec[u & 1][tid] = tk;
  };
  for (int z = tid; z < kMaxTaps; z += blockDim.x) {
    const Tap tp = k.taps[z];
    // the coefficient and step of the tap table that holds tap z (stage s
    // runs first as entry s)
    float c = 0.0f;
    int step = 0;
    for (int s = 0; s < kMaxStages; ++s) {
      const Stage& st = k.s[s];
      if (st.op == kTapOp && z >= st.tap_lo && z < st.tap_lo + st.tap_n &&
          st.coeff_lo + tp.ci < kMaxCoeffs && s < n) {
        c = k.c[st.coeff_lo + tp.ci];
        step = k.e[s].lag - (s ? k.e[s - 1].lag : 0);
      }
    }
    s_taps[z] = {tp.ds, tp.dy, tp.dx, static_cast<short>(step - tp.ds),
                 tp.dy * p.bx + tp.dx, c};
  }
  for (int z = tid; z < kMaxCoeffs; z += blockDim.x) s_c[z] = k.c[z];
  __syncthreads();
  if (tid < n) tick_rec(sg.a);

  // this thread's copies of a row of the field stream (a float32 cell, or
  // a bfloat16 word of a staged row; at most two a thread), one commit
  // group a row
  const Piece pc0 = piece_of(tid, gp, p, sy, sx, srow);
  const Piece pc1 = piece_of(tid + blockDim.x, gp, p, sy, sx, srow);
  const auto issue = [&](int s, int slot) {
    if (s < p.dom) {
      T* const dst = win + slot * sslot;
      const T* const src = gp + (size_t)s * pstride;
      if (pc0.dst >= 0) cp_async4(dst + pc0.dst, src + pc0.src, pc0.bytes);
      if (sizeof(T) == 2 && pc1.dst >= 0) {
        cp_async4(dst + pc1.dst, src + pc1.src, pc1.bytes);
      }
    }
    cp_async_commit();
  };
  int st = sg.a % D0;  // the stream's slot of row t
  for (int u = 0; u < look; ++u) {
    issue(sg.a + u, st + u < D0 ? st + u : st + u - D0);
  }
  cp_async_wait_pending(look - 1);
  __syncthreads();

  // the thread's cell and the position stage 0's kinds map it to, in the
  // staged stream and in a ring
  const int sown = staged(me.ty, me.tx);
  const int sedge = staged(me.ey, me.ex);
  const int pedge = me.ey * p.bx + me.ex;
  // per unrolled entry its producer's rows before the newest at the
  // thread's cell that the window keeps: 2 of them with 4 entries, 1 with
  // more (the register form's windows)
  constexpr int kKeep = kT == 4 ? 2 : 1;
  float w[kT > 0 ? kT : 1][2];
#pragma unroll
  for (int i = 0; i < (kT > 0 ? kT : 1); ++i) w[i][0] = w[i][1] = 0.0f;

  for (int t = sg.a; t < sg.t_end; ++t) {
    issue(t + look, st + look < D0 ? st + look : st + look - D0);
    // entry 0's newest own-column value: the stream's row t at the cell
    float fresh =
        me.act && t < nslabs ? wide(win[st * sslot + sown]) : 0.0f;
    const ChainTick* const tr = trec[t & 1];
    // entry i at its tick record `tk`; `wu`, `wm`, `fr` its producer's rows
    // 2, 1 and 0 behind the newest at the cell (kChainReg).  Returns the
    // value it computed at the cell (0 where it computes nothing).
    const auto entry = [&](int i, const ChainTick& tk, float wu, float wm,
                           float fr) -> float {
      if (!(me.act && tk.run)) return 0.0f;
      const ChainWinRec& en = rec[i];
      const int j = tk.j;  // CTA-uniform
      const int mode = en.mode, L = en.step;
      const bool last = i == n - 1;
      const bool stream = i == 0;  // reads the staged field stream
      const bool reg = kT > 0 && (mode & kChainReg);
      const int oo = stream ? sown : me.cell;
      // the producer's row e behind its newest (j + L - e)
      const auto row = [&](int e) -> const T* {
        if (e == 0) return win + tk.r0;
        if (e == 1) return win + tk.r1;
        if (e == 2) return win + tk.r2;
        const int s = tk.sp - e;
        return win + en.in_base +
               (s < 0 ? s + en.in_slots : s) * (stream ? sslot : plane);
      };
      // ... at the thread's own cell
      const auto own_at = [&](int e) {
        if (reg && e == 0) return fr;
        if (reg && e == 1 && kKeep >= 1) return wm;
        if (reg && e == 2 && kKeep >= 2) return wu;
        return wide(row(e)[oo]);
      };
      // the position the value is computed at: the cell itself for the
      // last entry, else where its consumer's blocked-axis kinds map it
      int qy = me.ty, qx = me.tx, qo = oo;
      bool fill_edge = false;
      if (!last) {
        if (!kBC || (mode & kChainSame)) {
          qy = me.ey;
          qx = me.ex;
          qo = stream ? sedge : pedge;
          fill_edge = me.fill_edge;
        } else {
          const int ky = en.kyx & 0xff, kx = en.kyx >> 8;
          qy = axis_pos(me.ay, me.ty, ky);
          qx = axis_pos(me.ax, me.tx, kx);
          qo = stream ? staged(qy, qx) : qy * p.bx + qx;
          fill_edge = takes_fill(me.ay, me.ax, ky, kx);
        }
      }
      // the producer's cell offset of the cell (dy, dx) from the position
      const auto at = [&](int dy, int dx, int dcell) {
        if (sizeof(T) != 4 && stream) return staged(qy + dy, qx + dx);
        return qo + dcell;
      };
      const int op = mode & 0xff;
      const int ks = (mode >> 16) & 0xff;
      T v;
      if (!(mode & kChainLive)) {
        v = narrow<T>(L == 0 ? own_at(0)
                             : (L == 1 ? own_at(1)
                                       : (L == 2 && reg ? own_at(2)
                                                        : wide(row(L)[oo]))));
      } else if (op == kStar1Op || op == kStar0Op || op < kTapOp) {
        // step 0 (a star of radius 0: the centre is the newest row) or 1:
        // rows j-1, j, j+1 at the cell, row j at the position's neighbours
        const float4 c0 = *reinterpret_cast<const float4*>(en.c);
        const float4 c1 = *reinterpret_cast<const float4*>(en.c + 4);
        if (op == kStar0Op) {
          v = narrow<T>(mul(c0.x, own_at(0)));
        } else {
          float u, d;
          const float m = own_at(1);
          window_ends<kBC>(u, d, own_at(2), m, own_at(0), j, p.dom, ks,
                           en.fill_s);
          const T* const nb = row(1);
          if (op == kStar1Op) {
            // c0 x centre, then rows j-1 and j+1, then y-1, y+1 (3D) and
            // x-1, x+1 (3, 5 or 7 taps: 1D, 2D, 3D)
            const int nt = en.taps >> 16;
            float acc = mul(c0.x, m);
            acc = add(acc, mul(c0.y, u));
            acc = add(acc, mul(c0.z, d));
            if (nt == 5) {
              acc = add(acc, mul(c0.w, wide(nb[at(0, -1, -1)])));
              acc = add(acc, mul(c1.x, wide(nb[at(0, 1, 1)])));
            } else if (nt == 7) {
              acc = add(acc, mul(c0.w, wide(nb[at(-1, 0, -p.bx)])));
              acc = add(acc, mul(c1.x, wide(nb[at(1, 0, p.bx)])));
              acc = add(acc, mul(c1.y, wide(nb[at(0, -1, -1)])));
              acc = add(acc, mul(c1.z, wide(nb[at(0, 1, 1)])));
            }
            v = narrow<T>(acc);
          } else {
            Pos q;
            q.c = qo;
            q.w = at(0, -1, -1);
            q.e = at(0, 1, 1);
            q.n = at(-1, 0, -p.bx);
            q.s = at(1, 0, p.bx);
            const float c[8] = {c0.x, c0.y, c0.z, c0.w,
                                c1.x, c1.y, c1.z, c1.w};
            const float a =
                op == 1 || op == 3
                    ? wide(__ldg(aux + (size_t)j * pstride +
                                 (sy + qy) * p.px + sx + qx))
                    : 0.0f;
            switch (op) {
              case 0:
                v = narrow<T>(table2_win<0>(u, m, d, nb, q, c, a));
                break;
              case 1:
                v = narrow<T>(table2_win<1>(u, m, d, nb, q, c, a));
                break;
              case 2:
                v = narrow<T>(table2_win<2>(u, m, d, nb, q, c, a));
                break;
              default:
                v = narrow<T>(table2_win<3>(u, m, d, nb, q, c, a));
                break;
            }
          }
        }
      } else {
        // no stream-axis tap of this row clips or maps (CTA-uniform)
        const bool fast = j >= p.rad && j + p.rad < p.dom;
        // the tap (ds, dy, dx) of row j, e rows behind the producer's
        // newest: a stream row past the rows follows ks (constant: the
        // stage's fill)
        const auto tap = [&](int ds, int dy, int dx, int dcell,
                             int e) -> float {
          if (!fast) {
            const int r = j + ds;
            if (r < 0 || r >= p.dom) {
              if (kBC && ks == kConstant) return en.fill_s;
              e = L + j - (kBC ? stream_row(r, p.dom, ks)
                               : min(max(r, 0), p.dom - 1));
            }
          }
          const T* const src = row(e);
          if (!(dy | dx)) {
            return reg && e <= kKeep
                       ? (e == 0 ? fr : (e == 1 ? wm : wu))
                       : wide(src[oo]);
          }
          return wide(src[at(dy, dx, dcell)]);
        };
        if (op == kTapOp) {
          const int lo = en.taps & 0xffff, nt = en.taps >> 16;
          float acc = 0.0f;
          for (int q = 0; q < nt; ++q) {
            const ChainTap tp = s_taps[lo + q];
            const float term =
                mul(tp.c, tap(tp.ds, tp.dy, tp.dx, tp.dcell, tp.e));
            acc = q ? add(acc, term) : term;
          }
          v = narrow<T>(acc);
#if STENCIL_CUSTOM
        } else if (op == kCustomOp) {
          const auto apply = [&](const auto& g) {
            return narrow<T>(custom::custom_apply(
                en.taps & 0xffff, g, s_c + en.coeff_lo, [&] {
                  return wide(__ldg(aux + (size_t)j * pstride +
                                    (sy + qy) * p.px + sx + qx));
                }));
          };
          // away from the stream's ends, at a step of 0 or 1 the rows of
          // the generated taps (literal offsets) are compile-time: the
          // tick record's and the window's
          const auto fixed = [&](auto step) {
            constexpr int kL = decltype(step)::value;
            return apply([&](int, int ds, int dy, int dx) -> float {
              const int e = kL - ds;
              if (!(dy | dx)) return own_at(e);
              return wide(row(e)[at(dy, dx, dy * p.bx + dx)]);
            });
          };
          if (fast && L == 1) {
            v = fixed(std::integral_constant<int, 1>());
          } else if (fast && L == 0) {
            v = fixed(std::integral_constant<int, 0>());
          } else {
            v = apply([&](int, int ds, int dy, int dx) {
              return tap(ds, dy, dx, dy * p.bx + dx, L - ds);
            });
          }
#endif
        } else {
          v = narrow<T>(0.0f);
        }
      }
      if (!last) {
        if (fill_edge) v = narrow<T>(en.fill_b);
        win[tk.outo + me.cell] = v;
      } else if (me.writes && j >= sg.s0) {
        out[(size_t)j * pstride + me.own.g] = v;
      }
      return wide(v);
    };
    if constexpr (kT > 0) {
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        if (i < n) {
          const float val = entry(i, tr[i], w[i][0], w[i][1], fresh);
          if (kKeep >= 2) w[i][0] = w[i][1];
          w[i][1] = fresh;
          fresh = val;
        }
      }
    } else {
      for (int i = 0; i < n; ++i) entry(i, tr[i], 0.0f, 0.0f, 0.0f);
    }
    if (tid < n) {  // entry tid's record for the next tick
      const ChainWinRec& r = rec[tid];
      cp = cp + 1 == r.in_slots ? 0 : cp + 1;
      co = co + 1 >= r.out_slots ? 0 : co + 1;
      tick_rec(t + 1);
    }
    st = st + 1 == D0 ? 0 : st + 1;
    cp_async_wait_pending(look - 1);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// The main path's kernels: the register form (kT > 0, the entries it
// holds; V = 1) or the ring form (kT = 0) of form kForm.  The register
// form of 16 entries asks for at most 512 threads, so that its windows
// get 128 registers a thread (at 64 they spilled).
template <int kOp, int kForm, class T, bool kBC, int kT>
__global__ void __launch_bounds__(kT > kMaxWideWindowEntries ? 512 : 1024,
                                  1)
    main_kernel(const T* __restrict__ gp, const T* __restrict__ aux,
                T* __restrict__ out, const Params p,
                const __grid_constant__ Program k, long long member_stride,
                long long aux_stride) {
#if STENCIL_BATCH
  // batch member blockIdx.z: its state, output and aux
  const size_t member = blockIdx.z;
  gp += member * (size_t)member_stride;
  out += member * (size_t)member_stride;
  if (aux != nullptr) aux += member * (size_t)aux_stride;
#endif
  if constexpr (kT > 0) {
    main_windows<kOp, T, kBC, kT>(gp, aux, out, p, k);
  } else {
    main_rings<kOp, kForm, T, kBC>(gp, aux, out, p, k);
  }
}

// The chain body's kernels: the table as a __grid_constant__ parameter, or
// (the large-table route, the wide form only) in device memory.
template <int kForm, class T, bool kBC, class K>
__device__ __forceinline__ void chain_member(const T* gp, const T* aux,
                                             T* out, const Params& p,
                                             const K& k,
                                             long long member_stride,
                                             long long aux_stride) {
#if STENCIL_BATCH
  // batch member blockIdx.z: its state, output and aux
  const size_t member = blockIdx.z;
  gp += member * (size_t)member_stride;
  out += member * (size_t)member_stride;
  if (aux != nullptr) aux += member * (size_t)aux_stride;
#endif
  chain_body<kForm, T, kBC>(gp, aux, out, p, k);
}

template <int kForm, class T, bool kBC>
__global__ void __launch_bounds__(1024, 1)
    chain_kernel(const T* __restrict__ gp, const T* __restrict__ aux,
                 T* __restrict__ out, const Params p,
                 const __grid_constant__ Program k, long long member_stride,
                 long long aux_stride) {
  chain_member<kForm, T, kBC>(gp, aux, out, p, k, member_stride,
                              aux_stride);
}

template <class T, bool kBC>
__global__ void __launch_bounds__(1024, 1)
    chain_kernel_big(const T* __restrict__ gp, const T* __restrict__ aux,
                     T* __restrict__ out, const Params p, const DevTable k,
                     long long member_stride, long long aux_stride) {
  chain_member<kWide, T, kBC>(gp, aux, out, p, k, member_stride,
                              aux_stride);
}

// The later forms' kernels: the table as a __grid_constant__ parameter, or
// (the large-table route, the wide form only) in device memory.
template <int kOp, int kForm, class T, bool kBC>
__global__ void __launch_bounds__(1024, 1)
    stream_kernel_x(const T* __restrict__ gp, const T* __restrict__ aux,
                    T* __restrict__ out, const Params p,
                    const __grid_constant__ Program k,
                    long long member_stride, long long aux_stride) {
  stream_body<kOp, kForm, T, kBC>(gp, aux, out, p, k, member_stride,
                                  aux_stride);
}

template <int kOp, class T, bool kBC>
__global__ void __launch_bounds__(1024, 1)
    stream_kernel_big(const T* __restrict__ gp, const T* __restrict__ aux,
                      T* __restrict__ out, const Params p, const DevTable k,
                      long long member_stride, long long aux_stride) {
  stream_body<kOp, kWide, T, kBC>(gp, aux, out, p, k, member_stride,
                                  aux_stride);
}

// The launch grid: blocks along x, blocks along y times segments along y,
// batch members along z, and the cells from one member's state (and aux)
// to the next's.
struct Grid {
  int x, y, z;
  long long member_stride, aux_stride;
};

// What one launch takes besides its kernel, parameters and table; with
// `occupancy` set, the launch only reports the CTAs an SM holds there.
struct Launch {
  const void* gp;
  const void* aux;
  void* out;
  Grid g;
  int threads;
  size_t smem;
  cudaStream_t stream;
  int* occupancy;
};

// One launch of `kernel` (K: `Program` or `DevTable`), or its occupancy.
template <class T, class F, class K>
cudaError_t launch_kernel(F kernel, const Params& p, const K& k,
                          const Launch& l) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (e != cudaSuccess) return e;
  if (l.occupancy) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(l.occupancy, kernel,
                                                         l.threads, l.smem);
  }
  kernel<<<dim3(l.g.x, l.g.y, l.g.z), l.threads, l.smem, l.stream>>>(
      static_cast<const T*>(l.gp), static_cast<const T*>(l.aux),
      static_cast<T*>(l.out), p, k, l.g.member_stride, l.g.aux_stride);
  return cudaGetLastError();
}

// The form a launch whose `p.vt` and `p.rows` are set runs (the main
// path's register form aside): the DAG bodies' one-barrier form where
// `p.win` asks for it, the large-table route and planes over 1024 cells
// the wide form.
int form_of(const Params& p, bool big) {
  if (p.win) return kWinForm;
  if (big || p.by * p.bx > kMaxThreads) return kWide;
  if (p.V == 1) return kVecOne;
  return p.rows == 1 ? kOneRow : kRows;
}

// The DAG bodies' table-driven forms: the single-boundary body's first
// three forms run `stream_kernel`, the rest `stream_kernel_x`.
template <int kOp, int kForm, class T, bool kBC>
cudaError_t launch_as(const Params& p, const Program& k, const Launch& l) {
  if constexpr (kForm == kWide || kOp == kMixBody) {
    return launch_kernel<T>(stream_kernel_x<kOp, kForm, T, kBC>, p, k, l);
  } else {
    return launch_kernel<T>(stream_kernel<kOp, kForm, T, kBC>, p, k, l);
  }
}

// The DAG bodies: the one-barrier form (`dag_kernel`), or the table-driven
// form of the launch.
template <int kOp, class T, bool kBC>
cudaError_t launch_dag(const Params& p, const Program& k, const Launch& l) {
  switch (form_of(p, false)) {
    case kWinForm:
      return launch_kernel<T>(dag_kernel<kOp, T, kBC>, p, k, l);
    case kWide:
      return launch_as<kOp, kWide, T, kBC>(p, k, l);
    case kVecOne:
      return launch_as<kOp, kVecOne, T, kBC>(p, k, l);
    case kOneRow:
      return launch_as<kOp, kOneRow, T, kBC>(p, k, l);
    default:
      return launch_as<kOp, kRows, T, kBC>(p, k, l);
  }
}

// The main path: the register form by its entries (`p.look` > 0), else
// the ring form.
template <int kOp, class T, bool kBC>
cudaError_t launch_main(const Params& p, const Program& k, const Launch& l) {
  if (p.look > 0) {
    if (p.n_entries <= 4) {
      return launch_kernel<T>(main_kernel<kOp, kVecOne, T, kBC, 4>, p, k, l);
    }
    if (p.n_entries <= 8) {
      return launch_kernel<T>(main_kernel<kOp, kVecOne, T, kBC, 8>, p, k, l);
    }
    return launch_kernel<T>(main_kernel<kOp, kVecOne, T, kBC, 16>, p, k, l);
  }
  switch (form_of(p, false)) {
    case kWide:
      return launch_kernel<T>(main_kernel<kOp, kWide, T, kBC, 0>, p, k, l);
    case kVecOne:
      return launch_kernel<T>(main_kernel<kOp, kVecOne, T, kBC, 0>, p, k, l);
    default:
      return launch_kernel<T>(main_kernel<kOp, kRows, T, kBC, 0>, p, k, l);
  }
}

// The chain body: its one-barrier form (`chain_win_kernel`) where `p.win`
// asks for it, else the form of the launch.
template <class T, bool kBC>
cudaError_t launch_chain(const Params& p, const Program& k, const Launch& l) {
  switch (form_of(p, false)) {
    case kWinForm:
      switch (p.win - 1) {
        case 4:
          return launch_kernel<T>(chain_win_kernel<T, kBC, 4>, p, k, l);
        case 8:
          return launch_kernel<T>(chain_win_kernel<T, kBC, 8>, p, k, l);
        default:
          return launch_kernel<T>(chain_win_kernel<T, kBC, 0>, p, k, l);
      }
    case kWide:
      return launch_kernel<T>(chain_kernel<kWide, T, kBC>, p, k, l);
    case kVecOne:
      return launch_kernel<T>(chain_kernel<kVecOne, T, kBC>, p, k, l);
    case kOneRow:
      return launch_kernel<T>(chain_kernel<kOneRow, T, kBC>, p, k, l);
    default:
      return launch_kernel<T>(chain_kernel<kRows, T, kBC>, p, k, l);
  }
}

template <class T, bool kBC>
cudaError_t launch_body(int kernel_op, const Params& p, const Program& k,
                        const Launch& l) {
  switch (kernel_op) {
    case kMixBody:
      if constexpr (kBC) return launch_dag<kMixBody, T, true>(p, k, l);
      return cudaErrorInvalidValue;
    case kDagBody:
      return launch_dag<kDagBody, T, kBC>(p, k, l);
    case kChainBody:
      return launch_chain<T, kBC>(p, k, l);
    case 0:
      return launch_main<0, T, kBC>(p, k, l);
    case 1:
      return launch_main<1, T, kBC>(p, k, l);
    case 2:
      return launch_main<2, T, kBC>(p, k, l);
    case 3:
      return launch_main<3, T, kBC>(p, k, l);
    default:
      return cudaErrorInvalidValue;
  }
}

template <class T, bool kBC>
cudaError_t launch_big_body(int kernel_op, const Params& p, const DevTable& k,
                            const Launch& l) {
  switch (kernel_op) {
    case kMixBody:
      if constexpr (kBC) {
        return launch_kernel<T>(stream_kernel_big<kMixBody, T, true>, p, k, l);
      }
      return cudaErrorInvalidValue;
    case kDagBody:
      return launch_kernel<T>(stream_kernel_big<kDagBody, T, kBC>, p, k, l);
    case kChainBody:
      return launch_kernel<T>(chain_kernel_big<T, kBC>, p, k, l);
    default:
      return cudaErrorInvalidValue;
  }
}

// The storage type of this library: it is built once per type, and once
// more per type for batches (kernels/_build.py: LIBRARIES), so that the
// four quarters of the kernels compile in parallel.
#ifndef STENCIL_BF16
#define STENCIL_BF16 0
#endif
#if STENCIL_BF16
using Storage = __nv_bfloat16;
#else
using Storage = float;
#endif

// Checks a launch, fills `p.vt` and `p.rows` and returns the CTA's threads
// by the rule of the header (`builder.cta_shape`), or 0 if the launch is
// invalid.  `big`: the large-table route (table-driven bodies only; the
// wide form at any plane, entries beyond the threads strided).  The
// main-path body takes every row of a slab per thread (vt = 1).
int cta_threads(int kernel_op, int bcs, Params& p, int batch,
                long long member_stride, long long aux_stride, bool big) {
  const int plane = p.by * p.bx;
  const bool wide = big || plane > kMaxThreads;
  const bool main = kernel_op >= 0;
  int vt = 1;  // else the largest divisor of V with plane * vt <= 1024
  for (int d = 2; !wide && !main && d <= p.V && plane * d <= kMaxThreads;
       ++d) {
    if (p.V % d == 0) vt = d;
  }
  const bool table = kernel_op < 0;
  const bool dag = kernel_op == kDagBody || kernel_op == kMixBody;
  // the main-path body reads no entry table, so only the table-driven
  // bodies are bound by its capacity and need a thread per entry
  if (vt < 1 || plane < 1 || p.V < 1 || p.dom < 1 || p.ns % p.V != 0 ||
      p.dom > p.ns || p.ns - p.dom >= p.V || p.n_entries < 1 ||
      (table && !big && p.n_entries > kMaxEntries) || (big && !table) ||
      kernel_op < kMixBody || (kernel_op == kMixBody && bcs != 1) ||
      p.n_fields < 1 || (!dag && p.n_fields > 1) ||
      (dag && !big && p.n_fields > kMaxFields) ||
      (bcs != 0 && bcs != 1) || batch < 1 ||
      batch > (STENCIL_BATCH ? kMaxBatch : 1) || member_stride < 0 ||
      aux_stride < 0 || (batch > 1 && member_stride == 0)) {
    return 0;
  }
  p.vt = vt;
  p.rows = p.V / vt;
  if (wide) return min((plane + 31) / 32 * 32, kMaxThreads);
  return (max(plane * vt, table ? p.n_entries : 0) + 31) / 32 * 32;
}

// Whether the stream split of a launch whose grid has `grid_y` rows holds
// together: `nby` block rows times the segments that `seg` slabs each
// make of the stream, copies ahead only in the main path's register form
// and (1 to kMaxLook of them) in the chain body's one-barrier form, and a
// one-barrier form only for a chain or a DAG at V = 1 whose table is a
// kernel parameter and whose plane a CTA's threads cover.
bool split_ok(int kernel_op, const Params& p, int grid_y, bool big) {
  if (p.nby < 1 || p.seg < 1 || p.warm < 0 || p.V < 1 || grid_y < 1 ||
      grid_y % p.nby != 0) {
    return false;
  }
  const int nslabs = p.ns / p.V;
  const int nseg = grid_y / p.nby;
  if ((long long)(nseg - 1) * p.seg >= nslabs ||
      (long long)nseg * p.seg < nslabs) {
    return false;
  }
  const bool chain_win = p.win != 0 && kernel_op == kChainBody;
  if (p.win != 0 &&
      ((!chain_win && p.win != 1) || kernel_op > kChainBody || big ||
       p.V != 1 || p.by * p.bx > kMaxThreads ||
       (chain_win ? p.look < 1 || p.look > kMaxLook : p.look != 0))) {
    return false;
  }
  if (chain_win) {
    // the register form holds its entries
    const int kt = p.win - 1;
    return kt == 0 || ((kt == 4 || kt == 8) && p.n_entries <= kt);
  }
  if (p.look == 0) return true;
  return kernel_op >= 0 && !big && p.V == 1 &&
         p.by * p.bx <= (p.n_entries > kMaxWideWindowEntries ? 512
                                                            : kMaxThreads) &&
         p.n_entries <= kMaxWindowEntries && p.look <= kMaxLook;
}

#if STENCIL_CUSTOM
#ifndef CUSTOM_KT
#define CUSTOM_KT 0
#endif
// Whether a launch is the one kernel this custom library holds (the chain
// body's one-barrier form by the entries it unrolls).
bool custom_kernel(int kernel_op, int bcs, const Params& p, bool big) {
  return kernel_op == CUSTOM_BODY && bcs == CUSTOM_BC &&
         big == (CUSTOM_BIG != 0) && form_of(p, big) == CUSTOM_FORM &&
         (CUSTOM_BODY != kChainBody || CUSTOM_FORM != kWinForm ||
          p.win - 1 == CUSTOM_KT);
}

// This custom library's one kernel (a chain body, or a DAG body).
template <class K>
cudaError_t launch_custom(const Params& p, const K& k, const Launch& l) {
  if constexpr (K::kBig) {
    if constexpr (CUSTOM_BODY == kChainBody) {
      return launch_kernel<Storage>(
          chain_kernel_big<Storage, CUSTOM_BC != 0>, p, k, l);
    } else {
      return launch_kernel<Storage>(
          stream_kernel_big<CUSTOM_BODY, Storage, CUSTOM_BC != 0>, p, k, l);
    }
  } else if constexpr (CUSTOM_BODY == kChainBody &&
                       CUSTOM_FORM == kWinForm) {
    return launch_kernel<Storage>(
        chain_win_kernel<Storage, CUSTOM_BC != 0, CUSTOM_KT>, p, k, l);
  } else if constexpr (CUSTOM_BODY == kChainBody) {
    return launch_kernel<Storage>(
        chain_kernel<CUSTOM_FORM, Storage, CUSTOM_BC != 0>, p, k, l);
  } else if constexpr (CUSTOM_FORM == kWinForm) {
    return launch_kernel<Storage>(
        dag_kernel<CUSTOM_BODY, Storage, CUSTOM_BC != 0>, p, k, l);
  } else {
    return launch_kernel<Storage>(
        stream_kernel_x<CUSTOM_BODY, CUSTOM_FORM, Storage, CUSTOM_BC != 0>, p,
        k, l);
  }
}
#endif

// Launches (or, with `l.occupancy`, sizes) one super-step of a program
// whose table is a kernel parameter.
cudaError_t run_program(int kernel_op, int bcs, const Params& p,
                        const Program& k, const Launch& l) {
#if STENCIL_CUSTOM
  // a custom library holds one kernel (see Custom stencils)
#if CUSTOM_BIG
  return cudaErrorInvalidValue;
#else
  if (!custom_kernel(kernel_op, bcs, p, false)) return cudaErrorInvalidValue;
  return launch_custom(p, k, l);
#endif
#else
  return bcs ? launch_body<Storage, true>(kernel_op, p, k, l)
             : launch_body<Storage, false>(kernel_op, p, k, l);
#endif
}

// ... of a program whose table is in device memory (the large-table route).
cudaError_t run_big(int kernel_op, int bcs, const Params& p,
                    const DevTable& k, const Launch& l) {
#if STENCIL_CUSTOM
#if CUSTOM_BIG
  if (!custom_kernel(kernel_op, bcs, p, true)) return cudaErrorInvalidValue;
  return launch_custom(p, k, l);
#else
  return cudaErrorInvalidValue;
#endif
#else
  return bcs ? launch_big_body<Storage, true>(kernel_op, p, k, l)
             : launch_big_body<Storage, false>(kernel_op, p, k, l);
#endif
}

// The large-table route's view of `table` (see stencil_stream_launch_big).
DevTable dev_table(const void* table, const Params& p, int n_stages,
                   int n_taps, int n_coeffs, int n_inputs) {
  DevTable k;
  k.e = static_cast<const BigEntry*>(table);
  k.s = reinterpret_cast<const Stage*>(k.e + p.n_entries);
  k.taps = reinterpret_cast<const BigTap*>(k.s + n_stages);
  k.c = reinterpret_cast<const float*>(k.taps + n_taps);
  k.f = reinterpret_cast<const BigStream*>(k.c + n_coeffs);
  k.ins = reinterpret_cast<const Input*>(k.f + p.n_fields);
  k.n_taps = n_taps;
  k.n_coeffs = n_coeffs;
  k.n_inputs = n_inputs;
  return k;
}

}  // namespace


// `kernel_op`: 0..3 runs a single-stage chain of that Table-2 stencil (the
// main-path body), -1 any chain of the table, -2 any DAG of the table whose
// stages share one boundary, -3 any DAG, over `Storage` grids.  `bcs`: 1
// when some stage has a reflect or constant axis (the kernels with the
// boundary work; -3 needs it), else 0.  `batch` members (at most 65535,
// the cap of gridDim.z; 1 unless the library is built with STENCIL_BATCH)
// are advanced at once: member b's state and output start `member_stride`
// cells after `gp` and `out`, its aux `aux_stride` cells after `aux` (0 for
// an aux grid the batch shares).  `grid_y` is `p.nby` block rows times the
// stream's segments (`p.seg` slabs each; one for the DAG bodies).  Fills
// `p.vt` and `p.rows` and sizes the CTA by the rule of the header
// (`builder.cta_shape`).  Returns the cudaError_t of the launch (0 on
// success).  `k` is copied into the kernel's parameters; the caller may
// free it when this returns.
extern "C" int stencil_stream_launch(int kernel_op, int bcs, const void* gp,
                                     const void* aux, void* out, Params p,
                                     const Program* k, int grid_x, int grid_y,
                                     int batch, long long member_stride,
                                     long long aux_stride, size_t smem,
                                     void* stream) {
  const int threads = cta_threads(kernel_op, bcs, p, batch, member_stride,
                                  aux_stride, false);
  if (!threads || !split_ok(kernel_op, p, grid_y, false)) {
    return cudaErrorInvalidValue;
  }
  const Launch l = {gp,      aux,  out, {grid_x, grid_y, batch, member_stride,
                                         aux_stride},
                    threads, smem, static_cast<cudaStream_t>(stream),
                    nullptr};
  return run_program(kernel_op, bcs, p, *k, l);
}

// The large-table route of a table-driven body (`kernel_op` -1, -2 or -3):
// `table` is a device buffer holding `p.n_entries` entries (`BigEntry`),
// `n_stages` stages, `n_taps` taps (`BigTap`), `n_coeffs` coefficients,
// `p.n_fields` field streams (`BigStream`) and the entries' `n_inputs`
// inputs back to back (kernels/_build.py: program_type), which must
// outlive the kernel; `smem` counts the records in front of the rings
// (kernels/_build.py: big_table_bytes).  Otherwise as
// `stencil_stream_launch`.
extern "C" int stencil_stream_launch_big(
    int kernel_op, int bcs, const void* gp, const void* aux, void* out,
    Params p, const void* table, int n_stages, int n_taps, int n_coeffs,
    int n_inputs, int grid_x, int grid_y, int batch, long long member_stride,
    long long aux_stride, size_t smem, void* stream) {
  const int threads = cta_threads(kernel_op, bcs, p, batch, member_stride,
                                  aux_stride, true);
  if (!threads || !split_ok(kernel_op, p, grid_y, true) || table == nullptr ||
      n_stages < 1 || n_taps < 0 || n_coeffs < 0 || n_inputs < p.n_entries) {
    return cudaErrorInvalidValue;
  }
  const Launch l = {gp,      aux,  out, {grid_x, grid_y, batch, member_stride,
                                         aux_stride},
                    threads, smem, static_cast<cudaStream_t>(stream),
                    nullptr};
  return run_big(kernel_op, bcs, p,
                 dev_table(table, p, n_stages, n_taps, n_coeffs, n_inputs), l);
}

// The CTAs of the kernel a launch with these arguments would run that one
// SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor: its
// threads, registers and shared memory), or -1 if the launch is invalid;
// `big`: the large-table route.  The launcher sizes the stream split by it
// (kernels/builder.py: segment_plan).
extern "C" int stencil_stream_occupancy(int kernel_op, int bcs, Params p,
                                        int big, int batch,
                                        long long member_stride,
                                        long long aux_stride, size_t smem) {
  const int threads = cta_threads(kernel_op, bcs, p, batch, member_stride,
                                  aux_stride, big != 0);
  if (!threads) return -1;
  int per_sm = 0;
  const Launch l = {nullptr, nullptr, nullptr, {1, 1, 1, 0, 0}, threads, smem,
                    nullptr, &per_sm};
  static const Program k = {};
  const cudaError_t e =
      big ? run_big(kernel_op, bcs, p, DevTable{}, l)
          : run_program(kernel_op, bcs, p, k, l);
  return e == cudaSuccess ? per_sm : -1;
}

extern "C" const char* stencil_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
