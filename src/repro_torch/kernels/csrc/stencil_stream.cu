// Streaming super-step of a stencil program, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dag_kernel` of src/repro/kernels/builder.py
// (launched by `_superstep_dag_impl` through `superstep_chain` and
// `superstep_dag`) for these forms: linear stage chains and stage DAGs
// (several field streams, fan-out, fan-in through `make_combine`, state
// nodes), `par_time` iterations unrolled into one super-step, 2D and 3D
// grids, clamp and periodic boundaries (per axis), float32 storage, one row
// or plane per tick (par_vec = 1).  A stage is one of the four Table-2
// stencils (radius 1), a tap table for a stencil whose update is an ordered
// sum of coefficient x neighbour (`make_star`, `make_box`; any radius), or
// a combine `w0*x0 + w1*x1 + ...` of its inputs' centres.  It computes what
// that kernel computes: the same padded input and output layout and, in
// the compute region it writes, the same values.
//
// Design.  One CTA per overlapped block (grid = bnum).  One thread per block
// column (2D) or per (y, x) cell of the block plane (3D).  The CTA streams
// axis 0 through the unrolled entries, described by the `Program` table the
// launcher builds from `repro_torch.programs.dag_layout`: per entry its lag
// behind the input streams, its producers' rings (base and slot count) and
// its own ring.  Shared memory holds one ring of block planes per
// producer: each field stream that an entry reads and every entry that
// another entry reads; a value that only feeds the output writes straight
// to device memory, and only the `csize` columns of its block.  A ring is
// as deep as its consumers need: 2R+1 slots for a radius-R consumer one
// level below, deeper where an edge skips levels (the short branch of a
// diamond, a state node's previous value).  At tick t the CTA pushes input
// row t of each field stream (coalesced, prefetched one tick ahead into a
// register), then entry i computes row j = t - lag_i from rows j-R..j+R of
// its producers' rings; a barrier follows each entry, so a producer's row
// is in its ring before its consumer reads it, and the layout's window
// depths guarantee that no slot is overwritten while it is still read.
// Stream-axis taps clip to [0, ns-1] of the stream, which for a periodic
// stream axis is the grid extended by the halo on each side (the wrap is
// staged in device memory by kernels/ops.py); blocked-axis taps that leave
// the block are clamped to it — garbage, but inside the halo the overlap
// discards (the halo is rad * par_time, rad the DAG's critical-path
// radius).  A chain entry whose iteration is >= `steps` forwards its centre
// tap (PE forwarding); in a DAG the state nodes forward: each updated field
// takes its new value while the iteration is < `steps`, else its previous
// one, and the stages of later iterations compute nothing.
//
// Boundaries.  On grid-edge blocks every value that enters a ring is taken
// at the position clamped to the grid along each clamp axis (the
// blocked-axis boundary re-imposition of the TPU kernel); along a periodic
// blocked axis the halo holds wrapped copies and nothing is re-imposed.
// The TPU kernel re-imposes each consumer's own BC when it reads a DAG's
// values; doing it once when the value is pushed gives the same values
// here, because every stage runs clamp or periodic and periodicity is
// uniform across a program's stages, so every consumer of a value applies
// the same rule along each axis.  Constant and reflect BCs, which may
// differ per consumer, need that read-time re-imposition (ROADMAP B1c).
//
// Hotspot's `power` is read at the centre of row j straight from device
// memory, which L2 serves.  The arithmetic uses __fmul_rn/__fadd_rn, which
// nvcc never contracts into FMAs, in the operation order of
// src/repro_torch/core/stencils.py (a tap table in the order of its
// `apply`), so the kernel and its plain version agree bit for bit.
//
// Three loop bodies, one template.  With 8 warps to an SM (2D), every
// instruction an entry adds is paid on each of its rows, so the kernel has
// a body for the paper's main path — one Table-2 stage (kOp = its id): lag
// i+1, 3-slot rings, coefficients in registers — one for any chain (kOp =
// -1) and one for any DAG (kOp = -2).  The table-driven bodies copy the
// table into static shared memory at start (`Rec`/`DagRec`: one flat
// record per entry, a Table-2 stage's coefficients inline; the taps and
// coefficients of tap tables), and at the top of each tick thread i
// computes entry i's ring offsets for that tick (`TickRec`/`DagTick`), so
// an entry costs its threads one record read and no division.  So these
// bodies need at least as many threads as entries, which a program of
// radius-0 stages (entries but no halo) on a narrow block can break: the
// launcher refuses it (as does `kernel_limits`).  Striding these two loops
// over the entries instead cost the tap chain about a fifth on an H100
// (chip_smoke.py's advect_diffuse2d).  The chain body still costs more per
// entry than the main-path body: on an H100 (chip_smoke.py), 8 entries of
// diffusion2d and a radius-0 damp over 16384^2 take 1.8x the time of 8
// diffusion2d entries.  The DAG body adds the field streams, several
// producers per entry, the combine and the state-node select.
//
// Tables.  Entries, stages, taps, the coefficients of all stages
// (concatenated in stage order) and the field streams travel in one
// `Program` struct passed by value as a __grid_constant__ kernel parameter
// (3,488 bytes, inside the 4 KB parameter space): no device buffer and no
// copy before the launch.  The chain body adds 8,448 bytes of static shared
// memory to the rings, the DAG body 11,520 (`kernels/_build.py::
// TABLE_SMEM`).
//
// Bound.  Device-memory bytes: each block reads `ns * bsize` cells per field
// stream (plus the same of `power`) and writes `ns * csize` cells per field
// per super-step (`kernels/ops.py::dma_traffic_bytes`); the arithmetic is a
// few FLOPs per byte, far below the card's balance point.
//
// Left on the table by this first design: no cp.async or TMA (a tick waits
// on one register-prefetched load per thread and stream), one CTA barrier
// per entry and tick, table-driven bodies that cost more per entry than
// the main-path body, and a CTA count of `num_blocks` — 69 for the 16384^2
// grid at bsize 256 — against 132 SMs.

#include <cuda_runtime.h>
#include <stddef.h>

// Capacities of the tables (kernels/_build.py: MAX_*).
constexpr int kMaxEntries = 64;
constexpr int kMaxStages = 16;
constexpr int kMaxTaps = 128;
constexpr int kMaxCoeffs = 192;
constexpr int kMaxFields = 4;
constexpr int kMaxInputs = 4;

// The structs are passed from Python (ctypes) and so live outside the
// unnamed namespace: the exported launcher's signature names them.

// Extents in cells.  A 2D grid is a 3D one with a single blocked y row:
// py = by = cy = dy = 1 and hy = 0.
struct Params {
  int ns;           // stream rows (2D) / planes (3D), periodic extension in
  int ticks;        // ns + output lag
  int py, px;       // padded extents of the blocked dims
  int by, bx;       // block extents
  int cy, cx;       // compute extents
  int dy, dx;       // grid extents
  int hy, hx;       // halo widths
  int per_y, per_x; // 1 where the blocked axis is periodic
  int steps;        // iterations that compute; later ones forward
  int n_entries;    // unrolled entries
  int n_fields;     // field streams (1 but for a DAG)
};

// One unrolled entry.  Rings are counted in block planes; `out_slots` is 0
// for a value that no entry reads (no ring).  `stage` -1 marks a DAG's
// state node, which selects input 0 (the new value) while its iteration is
// < steps, else input 1 (the field's previous value).  `field` is the
// output field the entry's value drains to, or -1.  A chain entry reads
// input 0 only.
struct Entry {
  short lag, stage, iteration, field;
  short out_base, out_slots, n_in, pad;
  short in_base[kMaxInputs], in_slots[kMaxInputs];
};
static_assert(sizeof(Entry) == 32, "Entry layout changed");

// `op`: 0 diffusion2d, 1 hotspot2d, 2 diffusion3d, 3 hotspot3d, 4 tap
// table, 5 combine (coefficient z weighs input z's centre).
struct Stage {
  short op, coeff_lo, tap_lo, tap_n;
};

// Offsets (stream, y, x; y = 0 in 2D) and the stage-local coefficient index.
struct Tap {
  signed char ds, dy, dx;
  unsigned char ci;
};

// One field stream of a DAG: its ring (`slots` 0: no entry reads it) and
// whether the field is carried unchanged, so written out as it streams in.
struct Stream {
  short base, slots, out, pad;
};

struct Program {
  Entry e[kMaxEntries];
  Stage s[kMaxStages];
  Tap taps[kMaxTaps];
  float c[kMaxCoeffs];
  Stream f[kMaxFields];
};
// the ctypes mirror in kernels/_build.py (PROGRAM_BYTES) has this size
static_assert(sizeof(Program) == 3488, "Program layout changed");

namespace {

constexpr int kTapOp = 4;
constexpr int kCombineOp = 5;
constexpr int kSelectOp = 6;  // a state node (no stage)
constexpr int kChainBody = -1;
constexpr int kDagBody = -2;
constexpr float kTempAmb = 80.0f;  // Hotspot ambient temperature

// Ring offsets of one cell and its blocked-axis neighbours (clamped to the
// block), and its device-memory offset within a row/plane.
struct Pos {
  int c, n, s, w, e;
  size_t g;
};

__device__ __forceinline__ Pos pos_at(int y, int x, const Params& p, int sy,
                                      int sx) {
  Pos q;
  q.c = y * p.bx + x;
  q.n = max(y - 1, 0) * p.bx + x;
  q.s = min(y + 1, p.by - 1) * p.bx + x;
  q.w = y * p.bx + max(x - 1, 0);
  q.e = y * p.bx + min(x + 1, p.bx - 1);
  q.g = (size_t)(sy + y) * p.px + sx + x;
  return q;
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

// The Table-2 stencils.  `up` is stream row j-1, `mid` row j, `dn` row j+1
// of the producer; `c` the stage's coefficients in `coeff_names` order.

// cc, cw, ce, cs, cn
__device__ __forceinline__ float diffusion2d(const float* up, const float* mid,
                                             const float* dn, const Pos& q,
                                             const float* c) {
  float v = mul(c[0], mid[q.c]);
  v = add(v, mul(c[1], mid[q.w]));
  v = add(v, mul(c[2], mid[q.e]));
  v = add(v, mul(c[3], dn[q.c]));
  return add(v, mul(c[4], up[q.c]));
}

// sdc, rx1, ry1, rz1
__device__ __forceinline__ float hotspot2d(const float* up, const float* mid,
                                           const float* dn, const Pos& q,
                                           const float* c, float aux) {
  const float v = mid[q.c];
  const float two_v = mul(2.0f, v);
  const float dy = sub(add(up[q.c], dn[q.c]), two_v);
  const float dx = sub(add(mid[q.e], mid[q.w]), two_v);
  float t = add(aux, mul(dy, c[2]));
  t = add(t, mul(dx, c[1]));
  t = add(t, mul(sub(kTempAmb, v), c[3]));
  return add(v, mul(c[0], t));
}

// cc, cw, ce, cs, cn, cb, ca
__device__ __forceinline__ float diffusion3d(const float* up, const float* mid,
                                             const float* dn, const Pos& q,
                                             const float* c) {
  float v = mul(c[0], mid[q.c]);
  v = add(v, mul(c[1], mid[q.w]));
  v = add(v, mul(c[2], mid[q.e]));
  v = add(v, mul(c[3], mid[q.s]));
  v = add(v, mul(c[4], mid[q.n]));
  v = add(v, mul(c[5], up[q.c]));
  return add(v, mul(c[6], dn[q.c]));
}

// cc, cn, cs, ce, cw, ca, cb, sdc
__device__ __forceinline__ float hotspot3d(const float* up, const float* mid,
                                           const float* dn, const Pos& q,
                                           const float* c, float aux) {
  float v = mul(mid[q.c], c[0]);
  v = add(v, mul(mid[q.n], c[1]));
  v = add(v, mul(mid[q.s], c[2]));
  v = add(v, mul(mid[q.e], c[3]));
  v = add(v, mul(mid[q.w], c[4]));
  v = add(v, mul(dn[q.c], c[5]));
  v = add(v, mul(up[q.c], c[6]));
  v = add(v, mul(c[7], aux));
  return add(v, mul(c[5], kTempAmb));
}

// Slot of a ring row: `m` is the slot of row j, `r` a row within W-1 of j
// (true of every tap: |r - j| <= R < W).  One wrap, no division.
__device__ __forceinline__ int slot_of(int m, int r, int j, int W) {
  const int s = m + r - j;
  return s < 0 ? s + W : (s >= W ? s - W : s);
}

// One entry of a chain, flattened for shared memory: its ring layout, its
// stage's op and coefficient/tap ranges, and a Table-2 stage's
// coefficients inline.
struct Rec {  // 80 bytes; the padding keeps `c` 16-byte aligned
  int lag, in_base, in_slots, out_base;
  int out_slots, op, iteration, tap_lo;
  int tap_n, coeff_lo, pad0, pad1;
  float c[8];
};
// kernels/_build.py prices the chain body's tables with REC_BYTES
static_assert(sizeof(Rec) == 80, "Rec layout changed");

// One entry at one tick: the row j it computes, whether it is in the stream
// (bit 0) and computes rather than forwards (bit 1), the slot m of row j in
// its producer's ring, and the ring offsets (in floats) of rows j-1, j, j+1
// and of its own output slot.
struct TickRec {  // 32 bytes: two 16-byte loads
  int j, flags, m, pad;
  int up, mid, dn, outo;
};
// ... and TICKREC_BYTES
static_assert(sizeof(TickRec) == 32, "TickRec layout changed");

// A tap table: sum over the stage's `tap_n` taps from `tap_lo`, in table
// order, of coefficient x neighbour, the first term alone (as
// `make_star`/`make_box` `apply`).  `ring` is the producer's ring of W
// slots, `m` the slot of row j; `taps` and `c` the tables in shared memory.
__device__ __forceinline__ float tap_sum(const Tap* taps, const float* c,
                                         int tap_lo, int tap_n, int coeff_lo,
                                         const float* ring, int W, int m,
                                         int plane, int j, int y, int x,
                                         const Params& p) {
  float acc = 0.0f;
  for (int n = 0; n < tap_n; ++n) {
    const Tap tp = taps[tap_lo + n];
    const int r = min(max(j + tp.ds, 0), p.ns - 1);
    const int yy = min(max(y + tp.dy, 0), p.by - 1);
    const int xx = min(max(x + tp.dx, 0), p.bx - 1);
    const float term = mul(c[coeff_lo + tp.ci],
                           ring[slot_of(m, r, j, W) * plane + yy * p.bx + xx]);
    acc = n ? add(acc, term) : term;
  }
  return acc;
}

// One entry of a DAG, flattened for shared memory: its ring layout, op,
// inputs, coefficient/tap ranges, and a Table-2 stage's coefficients.
struct DagRec {  // 112 bytes; `c` 16-byte aligned
  int lag, op, iteration, field;
  int out_base, out_slots, n_in, tap_lo;
  int tap_n, coeff_lo, pad0, pad1;
  int in_base[kMaxInputs];
  int in_slots[kMaxInputs];
  float c[8];
};
// kernels/_build.py prices the DAG body's tables with DAGREC_BYTES
static_assert(sizeof(DagRec) == 112, "DagRec layout changed");

// One DAG entry at one tick: the row j, flags as in `TickRec`, the slot m
// of row j in input 0's ring and the offsets (in floats) of its own output
// slot, of rows j-1 and j+1 of input 0, and of row j of every input.
struct DagTick {  // 48 bytes: three 16-byte loads
  int j, flags, outo, m;
  int up, dn, pad0, pad1;
  int mid[kMaxInputs];
};
// ... and DAGTICK_BYTES
static_assert(sizeof(DagTick) == 48, "DagTick layout changed");

// A Table-2 stencil at the cell `q`, rows `up`, `mid`, `dn`.
template <int kOp>
__device__ __forceinline__ float table2(const float* up, const float* mid,
                                        const float* dn, const Pos& q,
                                        const float* c, const float* aux,
                                        size_t row) {
  if (kOp == 0) return diffusion2d(up, mid, dn, q, c);
  if (kOp == 1) return hotspot2d(up, mid, dn, q, c, __ldg(aux + row + q.g));
  if (kOp == 2) return diffusion3d(up, mid, dn, q, c);
  return hotspot3d(up, mid, dn, q, c, __ldg(aux + row + q.g));
}

// A Table-2 stencil of runtime op `op` (the table-driven bodies).
__device__ __forceinline__ float table2_op(int op, const float* up,
                                           const float* mid, const float* dn,
                                           const Pos& q, const float* c,
                                           const float* aux, size_t row) {
  switch (op) {
    case 0:
      return table2<0>(up, mid, dn, q, c, aux, row);
    case 1:
      return table2<1>(up, mid, dn, q, c, aux, row);
    case 2:
      return table2<2>(up, mid, dn, q, c, aux, row);
    default:
      return table2<3>(up, mid, dn, q, c, aux, row);
  }
}

// kOp in 0..3: a single-stage chain of that Table-2 stencil.  kOp = -1: any
// chain of the table.  kOp = -2: any DAG of the table; `gp` and `out` then
// hold `n_fields` padded grids one after the other.
template <int kOp>
__global__ void __launch_bounds__(1024)
    stream_kernel(const float* __restrict__ gp, const float* __restrict__ aux,
                  float* __restrict__ out, const Params p,
                  const __grid_constant__ Program k) {
  extern __shared__ float win[];  // the rings, in value-id order
  const int plane = p.by * p.bx;
  const int tid = threadIdx.x;
  const int ty = tid / p.bx;
  const int tx = tid - ty * p.bx;
  const int sy = blockIdx.y * p.cy;  // block start in padded coordinates
  const int sx = blockIdx.x * p.cx;

  // grid edges in block coordinates: values entering a ring are taken at
  // the position clamped to [lo, hi] (a no-op on interior blocks, and along
  // a periodic axis, whose halo holds wrapped copies)
  const int lo_y = p.per_y ? 0 : max(p.hy - sy, 0);
  const int hi_y = p.per_y ? p.by - 1 : min(p.dy - 1 + p.hy - sy, p.by - 1);
  const int lo_x = p.per_x ? 0 : max(p.hx - sx, 0);
  const int hi_x = p.per_x ? p.bx - 1 : min(p.dx - 1 + p.hx - sx, p.bx - 1);
  const int ey = min(max(ty, lo_y), hi_y);
  const int ex = min(max(tx, lo_x), hi_x);
  const Pos own = pos_at(ty, tx, p, sy, sx);
  const Pos edge = pos_at(ey, ex, p, sy, sx);
  const bool writes = ty >= p.hy && ty < p.hy + p.cy && tx >= p.hx &&
                      tx < p.hx + p.cx;
  const size_t pstride = (size_t)p.py * p.px;

  if constexpr (kOp >= 0) {
    float next = __ldg(gp + own.g);
    // the main path: entry i lags i+1 rows and reads ring i of 3 slots
    float c[8];
    for (int z = 0; z < 8; ++z) c[z] = k.c[z];
    for (int t = 0; t < p.ticks; ++t) {
      if (t < p.ns) {
        const float v = next;
        if (t + 1 < p.ns) next = __ldg(gp + (size_t)(t + 1) * pstride + own.g);
        win[(t % 3) * plane + tid] = v;
      }
      __syncthreads();
      for (int i = 0; i < p.n_entries; ++i) {
        const int j = t - (i + 1);  // CTA-uniform
        if (j >= 0 && j < p.ns) {
          const float* ring = win + i * 3 * plane;
          const float* up = ring + (max(j - 1, 0) % 3) * plane;
          const float* mid = ring + (j % 3) * plane;
          const float* dn = ring + (min(j + 1, p.ns - 1) % 3) * plane;
          const bool last = i == p.n_entries - 1;
          const Pos q = last ? own : edge;
          const float val =
              i < p.steps
                  ? table2<kOp>(up, mid, dn, q, c, aux, (size_t)j * pstride)
                  : mid[q.c];
          if (!last) {
            win[((i + 1) * 3 + j % 3) * plane + tid] = val;
          } else if (writes) {
            out[(size_t)j * pstride + own.g] = val;
          }
        }
        __syncthreads();
      }
    }
  } else if constexpr (kOp == kChainBody) {
    float next = __ldg(gp + own.g);
    __shared__ Rec rec[kMaxEntries];
    __shared__ TickRec trec[kMaxEntries];
    __shared__ Tap s_taps[kMaxTaps];
    __shared__ float s_c[kMaxCoeffs];
    if (tid < p.n_entries) {  // one thread per entry (launcher checks)
      const Entry en = k.e[tid];
      const Stage st = k.s[en.stage];
      Rec r = {en.lag,       en.in_base[0], en.in_slots[0], en.out_base,
               en.out_slots, st.op,         en.iteration,  st.tap_lo,
               st.tap_n,     st.coeff_lo,   0,             0};
      for (int z = 0; z < 8; ++z) {
        r.c[z] = st.op != kTapOp && st.coeff_lo + z < kMaxCoeffs
                     ? k.c[st.coeff_lo + z]
                     : 0.0f;
      }
      rec[tid] = r;
    }
    for (int z = tid; z < kMaxTaps; z += blockDim.x) s_taps[z] = k.taps[z];
    for (int z = tid; z < kMaxCoeffs; z += blockDim.x) s_c[z] = k.c[z];
    __syncthreads();
    // the input stream's ring is entry 0's producer
    float* const stream_ring = win + rec[0].in_base * plane;
    const unsigned stream_slots = rec[0].in_slots;
    for (int t = 0; t < p.ticks; ++t) {
      if (t < p.ns) {
        const float v = next;
        if (t + 1 < p.ns) next = __ldg(gp + (size_t)(t + 1) * pstride + own.g);
        stream_ring[((unsigned)t % stream_slots) * plane + tid] = v;
      }
      if (tid < p.n_entries) {  // entry tid's offsets at this tick
        const Rec& e = rec[tid];
        TickRec r;
        r.j = t - e.lag;
        r.flags = (r.j >= 0 && r.j < p.ns) | ((e.iteration < p.steps) << 1);
        const int jj = min(max(r.j, 0), p.ns - 1);
        const int W = e.in_slots;
        r.m = (unsigned)jj % (unsigned)W;
        r.pad = 0;
        r.mid = (e.in_base + r.m) * plane;
        r.up = (e.in_base + slot_of(r.m, max(jj - 1, 0), jj, W)) * plane;
        r.dn = (e.in_base + slot_of(r.m, min(jj + 1, p.ns - 1), jj, W)) *
               plane;
        r.outo = e.out_slots
                     ? (e.out_base + (unsigned)jj % (unsigned)e.out_slots) *
                           plane
                     : 0;
        trec[tid] = r;
      }
      __syncthreads();
      for (int i = 0; i < p.n_entries; ++i) {
        const TickRec r = trec[i];
        if (r.flags & 1) {
          const Rec& en = rec[i];
          const int j = r.j;
          const bool last = i == p.n_entries - 1;
          const Pos q = last ? own : edge;
          const size_t row = (size_t)j * pstride;
          float val;
          if (!(r.flags & 2)) {
            val = win[r.mid + q.c];
          } else if (en.op == kTapOp) {
            val = tap_sum(s_taps, s_c, en.tap_lo, en.tap_n, en.coeff_lo,
                          win + en.in_base * plane, en.in_slots, r.m, plane,
                          j, last ? ty : ey, last ? tx : ex, p);
          } else {
            float c[8];
            for (int z = 0; z < 8; ++z) c[z] = en.c[z];
            val = table2_op(en.op, win + r.up, win + r.mid, win + r.dn, q, c,
                            aux, row);
          }
          if (!last) {
            win[r.outo + tid] = val;
          } else if (writes) {
            out[row + own.g] = val;
          }
        }
        __syncthreads();
      }
    }
  } else {
    // a DAG: `n_fields` field streams, entries with several producers
    __shared__ DagRec rec[kMaxEntries];
    __shared__ DagTick trec[kMaxEntries];
    __shared__ Tap s_taps[kMaxTaps];
    __shared__ float s_c[kMaxCoeffs];
    if (tid < p.n_entries) {  // one thread per entry (launcher checks)
      const Entry en = k.e[tid];
      DagRec r = {};
      r.lag = en.lag;
      r.iteration = en.iteration;
      r.field = en.field;
      r.out_base = en.out_base;
      r.out_slots = en.out_slots;
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
        r.in_base[z] = en.in_base[z];
        r.in_slots[z] = max((int)en.in_slots[z], 1);
      }
      rec[tid] = r;
    }
    for (int z = tid; z < kMaxTaps; z += blockDim.x) s_taps[z] = k.taps[z];
    for (int z = tid; z < kMaxCoeffs; z += blockDim.x) s_c[z] = k.c[z];
    __syncthreads();
    const size_t fstride = (size_t)p.ns * pstride;  // one field's grid
    float next[kMaxFields];
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
      if (f < p.n_fields) next[f] = __ldg(gp + f * fstride + own.g);
    }
    for (int t = 0; t < p.ticks; ++t) {
      if (t < p.ns) {
        // push row t of every field stream; a field carried unchanged is
        // written out as it streams in
        const size_t row = (size_t)t * pstride;
#pragma unroll
        for (int f = 0; f < kMaxFields; ++f) {
          if (f < p.n_fields) {
            const float v = next[f];
            if (t + 1 < p.ns) {
              next[f] = __ldg(gp + f * fstride + row + pstride + own.g);
            }
            const Stream st = k.f[f];
            if (st.slots) win[(st.base + t % st.slots) * plane + tid] = v;
            if (st.out && writes) out[f * fstride + row + own.g] = v;
          }
        }
      }
      if (tid < p.n_entries) {  // entry tid's offsets at this tick
        const DagRec& e = rec[tid];
        DagTick r;
        r.j = t - e.lag;
        r.flags = (r.j >= 0 && r.j < p.ns) | ((e.iteration < p.steps) << 1);
        const int jj = min(max(r.j, 0), p.ns - 1);
        const int W = e.in_slots[0];
        r.m = (unsigned)jj % (unsigned)W;
        r.up = (e.in_base[0] + slot_of(r.m, max(jj - 1, 0), jj, W)) * plane;
        r.dn = (e.in_base[0] + slot_of(r.m, min(jj + 1, p.ns - 1), jj, W)) *
               plane;
        r.pad0 = r.pad1 = 0;
        for (int z = 0; z < kMaxInputs; ++z) {
          r.mid[z] = (e.in_base[z] + (int)((unsigned)jj %
                                           (unsigned)e.in_slots[z])) *
                     plane;
        }
        r.outo = e.out_slots
                     ? (e.out_base + (unsigned)jj % (unsigned)e.out_slots) *
                           plane
                     : 0;
        trec[tid] = r;
      }
      __syncthreads();
      for (int i = 0; i < p.n_entries; ++i) {
        const DagTick r = trec[i];
        const DagRec& en = rec[i];
        // a stage of an iteration >= steps computes nothing: only the
        // state nodes of its iteration read it, and they forward
        if ((r.flags & 1) && ((r.flags & 2) || en.op == kSelectOp)) {
          const int j = r.j;
          // a value that enters a ring is taken at the grid-clamped
          // position; one that only drains to the output at its own
          const bool ring = en.out_slots > 0;
          const Pos q = ring ? edge : own;
          const size_t row = (size_t)j * pstride;
          float val;
          if (en.op == kSelectOp) {
            val = win[((r.flags & 2) ? r.mid[0] : r.mid[1]) + q.c];
          } else if (en.op == kCombineOp) {
            // make_combine's apply: w0*x0, then + w_z*x_z in input order
            val = mul(s_c[en.coeff_lo], win[r.mid[0] + q.c]);
            for (int z = 1; z < en.n_in; ++z) {
              val = add(val, mul(s_c[en.coeff_lo + z], win[r.mid[z] + q.c]));
            }
          } else if (en.op == kTapOp) {
            val = tap_sum(s_taps, s_c, en.tap_lo, en.tap_n, en.coeff_lo,
                          win + en.in_base[0] * plane, en.in_slots[0], r.m,
                          plane, j, ring ? ey : ty, ring ? ex : tx, p);
          } else {
            float c[8];
            for (int z = 0; z < 8; ++z) c[z] = en.c[z];
            val = table2_op(en.op, win + r.up, win + r.mid[0], win + r.dn, q,
                            c, aux, row);
          }
          if (ring) win[r.outo + tid] = val;
          if (en.field >= 0 && writes) {
            out[en.field * fstride + row + own.g] = val;
          }
        }
        __syncthreads();
      }
    }
  }
}

template <int kOp>
cudaError_t launch(const float* gp, const float* aux, float* out,
                   const Params& p, const Program& k, int grid_x, int grid_y,
                   size_t smem, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      stream_kernel<kOp>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  stream_kernel<kOp><<<dim3(grid_x, grid_y), p.by * p.bx, smem, stream>>>(
      gp, aux, out, p, k);
  return cudaGetLastError();
}

}  // namespace

// `kernel_op`: 0..3 runs a single-stage chain of that Table-2 stencil (the
// main-path body), -1 any chain of the table, -2 any DAG of the table.
// Returns the cudaError_t of the launch (0 on success).  `k` is copied into
// the kernel's parameters; the caller may free it when this returns.
extern "C" int stencil_stream_launch(int kernel_op, const float* gp,
                                     const float* aux, float* out, Params p,
                                     const Program* k, int grid_x, int grid_y,
                                     size_t smem, void* stream) {
  // the main-path body reads no entry table, so only the table-driven
  // bodies are bound by its capacity and need a thread per entry
  if (p.n_entries < 1 ||
      (kernel_op < 0 &&
       (p.n_entries > kMaxEntries || p.n_entries > p.by * p.bx)) ||
      p.n_fields < 1 || p.n_fields > (kernel_op == kDagBody ? kMaxFields : 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kernel_op) {
    case kDagBody:
      return launch<kDagBody>(gp, aux, out, p, *k, grid_x, grid_y, smem, s);
    case kChainBody:
      return launch<kChainBody>(gp, aux, out, p, *k, grid_x, grid_y, smem,
                                s);
    case 0:
      return launch<0>(gp, aux, out, p, *k, grid_x, grid_y, smem, s);
    case 1:
      return launch<1>(gp, aux, out, p, *k, grid_x, grid_y, smem, s);
    case 2:
      return launch<2>(gp, aux, out, p, *k, grid_x, grid_y, smem, s);
    case 3:
      return launch<3>(gp, aux, out, p, *k, grid_x, grid_y, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* stencil_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
