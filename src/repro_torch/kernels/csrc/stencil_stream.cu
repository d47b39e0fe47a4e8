// Streaming super-step of a single-stage stencil chain, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dag_kernel` of src/repro/kernels/builder.py
// (launched by `_superstep_dag_impl` through `superstep_chain`) for its
// single-stage linear-chain form: 2D and 3D grids, the four Table-2
// stencils (radius 1), clamp boundary, float32 storage, one row or plane
// per tick (par_vec = 1).  It computes what that kernel computes: the same
// padded input and output layout and, in the compute region it writes, the
// same values.
//
// Design.  One CTA per overlapped block (grid = bnum).  One thread per block
// column (2D) or per (y, x) cell of the block plane (3D).  The CTA streams
// axis 0 through `par_time` fused entries.  Shared memory holds a ring of
// 3 (= 2R+1) rows or planes per producer: the input stream and entries
// 0..par_time-2; the last entry writes straight to device memory, and only
// the `csize` columns of its block.  At tick k the CTA pushes input row k
// (coalesced, prefetched one tick ahead into a register), then entry i
// computes row j = k - (i+1) from its producer's ring.  Stream-axis taps
// clip to [0, ns-1]; blocked-axis taps that leave the block are clamped to
// it — garbage, but inside the halo the overlap discards.  Entries whose
// iteration is >= `steps` forward their centre tap (PE forwarding).  On
// grid-edge blocks every value that enters a ring is taken at the position
// clamped to the grid (the blocked-axis boundary re-imposition of the TPU
// kernel).  Hotspot's `power` is read at the centre straight from device
// memory, which L2 serves.  The arithmetic uses __fmul_rn/__fadd_rn, which
// nvcc never contracts into FMAs, in the operation order of
// src/repro_torch/core/stencils.py, so the kernel and its plain version
// agree bit for bit.
//
// Bound.  Device-memory bytes: each block reads `ns * bsize` cells (plus
// the same of `power`) and writes `ns * csize` cells per super-step
// (`kernels/ops.py::dma_traffic_bytes`); the arithmetic is a few FLOPs per
// byte, far below the card's balance point.
//
// Left on the table by this first design: no cp.async or TMA (a tick waits
// on one register-prefetched load per thread), `par_time + 1` CTA barriers
// per tick, and a CTA count of `num_blocks` — 69 for the 16384^2 grid at
// bsize 256 — against 132 SMs.

#include <cuda_runtime.h>
#include <stddef.h>

// The two structs are passed by value from Python (ctypes) and so live
// outside the unnamed namespace: the exported launcher's signature names
// them.
struct Coeffs {
  float c[8];
};

// Extents in cells.  A 2D grid is a 3D one with a single blocked y row:
// py = by = cy = dy = 1 and hy = 0.
struct Params {
  int ns;        // stream rows (2D) / planes (3D)
  int ticks;     // ns + output lag
  int py, px;    // padded extents of the blocked dims
  int by, bx;    // block extents
  int cy, cx;    // compute extents
  int dy, dx;    // grid extents
  int hy, hx;    // halo widths
  int par_time;  // fused entries
  int steps;     // entries that compute; the rest forward (<= par_time)
};

namespace {

constexpr int kWin = 3;            // ring slots per producer: 2R + 1, R = 1
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

// `up` is stream row j-1, `mid` row j, `dn` row j+1 of the producer.
// Coefficients come in the stencil's `coeff_names` order.

struct Diffusion2D {  // cc, cw, ce, cs, cn
  static constexpr bool kAux = false;
  __device__ static float apply(const float* up, const float* mid,
                                const float* dn, const Pos& q,
                                const Coeffs& k, float) {
    float v = mul(k.c[0], mid[q.c]);
    v = add(v, mul(k.c[1], mid[q.w]));
    v = add(v, mul(k.c[2], mid[q.e]));
    v = add(v, mul(k.c[3], dn[q.c]));
    return add(v, mul(k.c[4], up[q.c]));
  }
};

struct Hotspot2D {  // sdc, rx1, ry1, rz1
  static constexpr bool kAux = true;
  __device__ static float apply(const float* up, const float* mid,
                                const float* dn, const Pos& q,
                                const Coeffs& k, float aux) {
    const float v = mid[q.c];
    const float two_v = mul(2.0f, v);
    const float dy = sub(add(up[q.c], dn[q.c]), two_v);
    const float dx = sub(add(mid[q.e], mid[q.w]), two_v);
    float t = add(aux, mul(dy, k.c[2]));
    t = add(t, mul(dx, k.c[1]));
    t = add(t, mul(sub(kTempAmb, v), k.c[3]));
    return add(v, mul(k.c[0], t));
  }
};

struct Diffusion3D {  // cc, cw, ce, cs, cn, cb, ca
  static constexpr bool kAux = false;
  __device__ static float apply(const float* up, const float* mid,
                                const float* dn, const Pos& q,
                                const Coeffs& k, float) {
    float v = mul(k.c[0], mid[q.c]);
    v = add(v, mul(k.c[1], mid[q.w]));
    v = add(v, mul(k.c[2], mid[q.e]));
    v = add(v, mul(k.c[3], mid[q.s]));
    v = add(v, mul(k.c[4], mid[q.n]));
    v = add(v, mul(k.c[5], up[q.c]));
    return add(v, mul(k.c[6], dn[q.c]));
  }
};

struct Hotspot3D {  // cc, cn, cs, ce, cw, ca, cb, sdc
  static constexpr bool kAux = true;
  __device__ static float apply(const float* up, const float* mid,
                                const float* dn, const Pos& q,
                                const Coeffs& k, float aux) {
    float v = mul(mid[q.c], k.c[0]);
    v = add(v, mul(mid[q.n], k.c[1]));
    v = add(v, mul(mid[q.s], k.c[2]));
    v = add(v, mul(mid[q.e], k.c[3]));
    v = add(v, mul(mid[q.w], k.c[4]));
    v = add(v, mul(dn[q.c], k.c[5]));
    v = add(v, mul(up[q.c], k.c[6]));
    v = add(v, mul(k.c[7], aux));
    return add(v, mul(k.c[5], kTempAmb));
  }
};

template <class S>
__global__ void __launch_bounds__(1024)
    stream_kernel(const float* __restrict__ gp, const float* __restrict__ aux,
                  float* __restrict__ out, Params p, Coeffs k) {
  extern __shared__ float win[];  // [par_time][kWin][by * bx]
  const int plane = p.by * p.bx;
  const int tid = threadIdx.x;
  const int ty = tid / p.bx;
  const int tx = tid - ty * p.bx;
  const int sy = blockIdx.y * p.cy;  // block start in padded coordinates
  const int sx = blockIdx.x * p.cx;

  // grid edges in block coordinates: values entering a ring are taken at
  // the position clamped to [lo, hi] (a no-op on interior blocks)
  const int lo_y = max(p.hy - sy, 0);
  const int hi_y = min(p.dy - 1 + p.hy - sy, p.by - 1);
  const int lo_x = max(p.hx - sx, 0);
  const int hi_x = min(p.dx - 1 + p.hx - sx, p.bx - 1);
  const Pos own = pos_at(ty, tx, p, sy, sx);
  const Pos edge = pos_at(min(max(ty, lo_y), hi_y), min(max(tx, lo_x), hi_x),
                          p, sy, sx);
  const bool writes = ty >= p.hy && ty < p.hy + p.cy && tx >= p.hx &&
                      tx < p.hx + p.cx;
  const size_t pstride = (size_t)p.py * p.px;

  float next = __ldg(gp + own.g);
  for (int t = 0; t < p.ticks; ++t) {
    if (t < p.ns) {
      const float v = next;
      if (t + 1 < p.ns) next = __ldg(gp + (size_t)(t + 1) * pstride + own.g);
      win[(t % kWin) * plane + tid] = v;
    }
    __syncthreads();
    for (int i = 0; i < p.par_time; ++i) {
      const int j = t - (i + 1);  // CTA-uniform
      if (j >= 0 && j < p.ns) {
        const float* ring = win + i * kWin * plane;
        const float* up = ring + (max(j - 1, 0) % kWin) * plane;
        const float* mid = ring + (j % kWin) * plane;
        const float* dn = ring + (min(j + 1, p.ns - 1) % kWin) * plane;
        const bool last = i == p.par_time - 1;
        const Pos q = last ? own : edge;
        float val;
        if (i < p.steps) {
          float a = 0.0f;
          if (S::kAux) a = __ldg(aux + (size_t)j * pstride + q.g);
          val = S::apply(up, mid, dn, q, k, a);
        } else {
          val = mid[q.c];
        }
        if (!last) {
          win[((i + 1) * kWin + j % kWin) * plane + tid] = val;
        } else if (writes) {
          out[(size_t)j * pstride + own.g] = val;
        }
      }
      __syncthreads();
    }
  }
}

template <class S>
cudaError_t launch(const float* gp, const float* aux, float* out,
                   const Params& p, const Coeffs& k, int grid_x, int grid_y,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  stream_kernel<S><<<dim3(grid_x, grid_y), p.by * p.bx, smem, stream>>>(
      gp, aux, out, p, k);
  return cudaGetLastError();
}

}  // namespace

// stencil_id: 0 diffusion2d, 1 hotspot2d, 2 diffusion3d, 3 hotspot3d.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int stencil_stream_launch(int stencil_id, const float* gp,
                                     const float* aux, float* out, Params p,
                                     Coeffs k, int grid_x, int grid_y,
                                     size_t smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stencil_id) {
    case 0:
      return launch<Diffusion2D>(gp, aux, out, p, k, grid_x, grid_y, smem, s);
    case 1:
      return launch<Hotspot2D>(gp, aux, out, p, k, grid_x, grid_y, smem, s);
    case 2:
      return launch<Diffusion3D>(gp, aux, out, p, k, grid_x, grid_y, smem, s);
    case 3:
      return launch<Hotspot3D>(gp, aux, out, p, k, grid_x, grid_y, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* stencil_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
