// Causal (or full) flash-attention forward with GQA, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// src/repro/kernels/flash_attention.py:66 (launched by `_flash_fwd_pallas`
// under the `flash_attention` custom_vjp).  It computes what that kernel
// computes: for every (batch, query head, query row), the softmax over the
// keys it may see (causal: key <= query, aligned top-left, from 0 on both
// axes) of q.k * D**-0.5, applied to V, written as O in q's dtype, and the
// row's log-sum-exp `lse = m + log(max(l, 1e-30))` in f32.  Query head h
// reads KV head h / (H / Hkv).  Masked scores are -1e30, never -inf, so exp
// never yields NaN in the masked part of a tile.  Rows past the end of the
// keys or queries are zero-filled on load and never written.
//
// Two forms, each a template over the head dim D; the launcher dispatches
// on (dtype, D) and refuses any pair it was not built for (kForms):
//
// bf16, D in {64, 112, 128} (flash_fwd_kernel).  One CTA per (64-row
// query tile, batch * head), 4 warps of 16 query rows each.  Q, K, V and O
// are read and written in the model's (B, S, H, D) layout through strides:
// no transposed copy.  The CTA walks 64-key K/V tiles up to the causal
// diagonal; each tile is copied into shared memory with cp.async (16 bytes
// a thread), V's copy overlapping S = Q K^T and the next K's copy
// overlapping P V.  Both products are warp-level mma.sync.m16n8k16 bf16
// with f32 accumulation (D / 16 k-steps for S, D / 8 n-tiles of O: 14 at
// D = 112); Q stays in registers as A fragments, S's accumulators become
// P's A fragments in place (P rounded to bf16).  The online softmax
// (running max m, partial row sum l, rescale of the O accumulator) is f32,
// in base 2 with log2(e) folded into the scale.  Only the last tile a CTA
// visits is masked (the diagonal, or the ragged end of the keys).  Heavier
// (later) query tiles are scheduled first.
//
// f32, D in {8, 12, 16, 64, 112, 128} (flash_fwd_f32_kernel).  The TPU
// kernel keeps P in f32 when its inputs are f32 (`p.astype(v.dtype)`), and
// a tf32 mma would drop 13 bits of mantissa against it, so S, P and P V
// are f32 FMAs on the CUDA cores.  One CTA of 256 threads per (64-row
// query tile, batch * head), in 16 row groups of 16 threads: a thread owns
// rows rg + 16i (i < 4) and, of each 64-key tile, keys cg + 16j (j < 4),
// so the 16 threads of a row group are 16 neighbouring lanes and reduce a
// row's max and sum by shuffles.  Q (scaled by D**-0.5 once, in shared
// memory, as the TPU kernel scales q), the K and V tiles and P's 64 x 64
// tile live in dynamic shared memory (121,856 bytes at D = 128); rows are
// padded to a stride that is 4 modulo 8 floats, so the float4 reads of
// eight neighbouring keys hit distinct banks.  A thread accumulates O for
// its 4 rows and the float4 chunks cg + 16m of the head dim (2 chunks at
// D = 128, 1 at D <= 64; at D = 8 and 12 the threads past the row's
// chunks idle in P V).  Every head dim of the repo's configs is a multiple
// of 4, so a row is whole 16-byte cp.async chunks (D = 12: three).  The
// softmax is in natural units with expf, and o = acc / l, as the TPU
// kernel computes them.
//
// Bound.  At the serving shape of qwen3-1.7b (B 8, S 4096, H 16, Hkv 8,
// D 128, causal) the work is 0.55 TFLOP of products, 0.556 ms at 989
// TFLOP/s in bf16, against 0.40 GB of Q, K, V, O and lse, 0.121 ms at
// 3.35 TB/s: operations bound it.  In f32 the same work on the CUDA cores
// takes at least 8.2 ms at 67 TFLOP/s (H100 SXM, non-tensor FP32).
//
// Left for a later design: wgmma (the only way to the full tensor-core
// rate), TMA copies driven by a producer warp with mbarriers, ldmatrix for
// the fragments, and a deeper K/V ring; for f32, a 3xTF32 split on the
// tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Passed by value from Python (ctypes), so it lives outside the unnamed
// namespace: the exported launcher's signature names it.  Strides are in
// elements; the head dimension is contiguous.
struct FlashParams {
  const void* q;  // (B, Sq, H, D) bf16 or f32
  const void* k;  // (B, Skv, Hkv, D) like q
  const void* v;  // (B, Skv, Hkv, D) like q
  void* o;        // (B, Sq, H, D) like q
  float* lse;     // (B, H, Sq) f32, contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, H, Hkv, Sq, Skv, D;
  int causal;
  int dtype;         // 0: bf16, 1: f32
  float scale;       // D**-0.5
  float scale_log2;  // D**-0.5 * log2(e)
};

namespace {

constexpr int kBlockM = 64;  // query rows per CTA
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.69314718055994530942f;

// 16 bytes global -> shared; `valid == false` zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// --- bf16: mma.sync on the tensor cores -------------------------------------

constexpr int kWarps = 4;  // 16 query rows each
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy keys [n0, n0 + kBlockN) of one KV head into a padded smem tile.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* base,
                                          long long s_stride, int n0, int skv,
                                          int tid) {
  constexpr int kStride = D + 8;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(kBlockN * kChunks % kThreads == 0, "whole chunks a thread");
#pragma unroll
  for (int i = 0; i < kBlockN * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = n0 + row < skv;
    const uint16_t* src = base + (valid ? (n0 + row) * s_stride : 0) + col;
    cp_async16(dst + row * kStride + col, src, valid);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashParams p) {
  static_assert(D % 16 == 0, "m16n8k16 tiles the head dim");
  constexpr int kStride = D + 8;  // padded smem row: conflict-free fragments
  __shared__ __align__(16) uint16_t sK[kBlockN * kStride];
  __shared__ __align__(16) uint16_t sV[kBlockN * kStride];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread within the group

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int n_qtiles = gridDim.y;
  const int qtile = n_qtiles - 1 - blockIdx.y;  // heaviest tiles first
  const int q0 = qtile * kBlockM;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const uint16_t* qb = static_cast<const uint16_t*>(p.q) + b * p.q_sb +
                       h * p.q_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + b * p.k_sb +
                       hk * p.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + b * p.v_sb +
                       hk * p.v_sh;

  // K/V tiles this CTA needs: up to the one holding its last row's key.
  int n_tiles = (p.Skv + kBlockN - 1) / kBlockN;
  if (p.causal) {
    const int last_row = min(q0 + kBlockM, p.Sq) - 1;
    n_tiles = min(n_tiles, last_row / kBlockN + 1);
  }

  load_tile<D>(sK, kb, p.k_ss, 0, p.Skv, tid);
  cp_async_commit();
  load_tile<D>(sV, vb, p.v_ss, 0, p.Skv, tid);
  cp_async_commit();

  // Q as A fragments of m16n8k16: qa[kk] covers head dims [16kk, 16kk+16).
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const bool ok = row < p.Sq;
      const uint16_t* src = qb + (ok ? row : 0) * p.q_ss + kk * 16 + 2 * t;
      qa[kk][r] = ok ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      qa[kk][r + 2] = ok ? *reinterpret_cast<const uint32_t*>(src + 8) : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};  // running max, base-2 units
  float l_run[2] = {0.f, 0.f};          // this thread's part of the row sum

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    cp_async_wait_1();  // K_j has landed (V_j may be in flight)
    __syncthreads();

    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
        const uint16_t* kp = sK + (nt * 8 + g) * kStride + kk * 16 + 2 * t;
        mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }
    __syncthreads();  // every warp is done with K_j
    if (j + 1 < n_tiles) {
      load_tile<D>(sK, kb, p.k_ss, n0 + kBlockN, p.Skv, tid);
    }
    cp_async_commit();

    const bool mask = (n0 + kBlockN > p.Skv) ||
                      (p.causal && n0 + kBlockN - 1 > q0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[nt][c] * p.scale_log2;
        if (mask) {
          const int row = row0 + (c >= 2 ? 8 : 0);
          const int col = n0 + nt * 8 + 2 * t + (c & 1);
          if (col >= p.Skv || (p.causal && col > row)) x = kNegInf;
        }
        s[nt][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = exp2f(s[nt][c] - mx[c >> 1]);
        s[nt][c] = e;
        l_run[c >> 1] += e;
      }
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }

    cp_async_wait_1();  // V_j has landed (K_{j+1} may be in flight)
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      // P's accumulators of key columns [16kk, 16kk+16) as an A fragment
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint16_t* vp = sV + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const uint16_t* v0 = vp + dt * 8;
        const uint32_t b0 = uint32_t(v0[0]) | (uint32_t(v0[kStride]) << 16);
        const uint32_t b1 = uint32_t(v0[8 * kStride]) |
                            (uint32_t(v0[9 * kStride]) << 16);
        mma_bf16(acc[dt], pa, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with V_j
    if (j + 1 < n_tiles) {
      load_tile<D>(sV, vb, p.v_ss, n0 + kBlockN, p.Skv, tid);
    }
    cp_async_commit();
  }

  uint16_t* ob = static_cast<uint16_t*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = 1.f / l;
    uint16_t* orow = ob + row * p.o_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    if (t == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
          m_run[r] * kLn2 + logf(l);
    }
  }
}

// --- f32: FMAs on the CUDA cores --------------------------------------------

constexpr int kF32Threads = 256;        // 16 row groups of 16 threads
constexpr int kPStride = kBlockN + 16;  // P tile row: two row groups a warp
                                        // store to the two bank halves

// Padded smem row of an f32 tile, in floats: 4 modulo 8, so the float4
// reads of 8 neighbouring rows fall in distinct banks.
__host__ __device__ constexpr int f32_stride(int D) {
  return D % 8 == 4 ? D : D + 4;
}

template <int D>
constexpr int f32_smem_bytes() {
  return (3 * kBlockM * f32_stride(D) + kBlockM * kPStride) * 4;
}

// Copy rows [r0, r0 + kRows) of one head into a padded f32 smem tile, in
// 16-byte chunks; rows at or past `limit` are zero-filled.
template <int D, int kRows>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* base,
                                              long long s_stride, int r0,
                                              int limit, int tid) {
  constexpr int kChunks = D / 4;
  constexpr int kS = f32_stride(D);
  constexpr int kIters = (kRows * kChunks + kF32Threads - 1) / kF32Threads;
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    const int c = tid + i * kF32Threads;
    if (c < kRows * kChunks) {
      const int row = c / kChunks;
      const int col = (c % kChunks) * 4;
      const bool valid = r0 + row < limit;
      const float* src = base + (valid ? (r0 + row) * s_stride : 0) + col;
      cp_async16(dst + row * kS + col, src, valid);
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& v) {
  acc.x = fmaf(a, v.x, acc.x);
  acc.y = fmaf(a, v.y, acc.y);
  acc.z = fmaf(a, v.z, acc.z);
  acc.w = fmaf(a, v.w, acc.w);
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Max (or sum) of a row over the 16 lanes of its row group.
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_fwd_f32_kernel(const FlashParams p) {
  static_assert(D % 4 == 0, "whole 16-byte chunks a row");
  constexpr int kS = f32_stride(D);
  constexpr int kC = D / 4;               // float4 chunks per row
  constexpr int kNC = (kC + 15) / 16;     // chunks a thread accumulates
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockM * kS;
  float* sV = sK + kBlockN * kS;
  float* sP = sV + kBlockN * kS;

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows rg + 16i
  const int cg = tid % 16;  // keys cg + 16j of a tile; O chunks cg + 16m

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int qtile = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int q0 = qtile * kBlockM;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb +
                    hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb +
                    hk * p.v_sh;

  int n_tiles = (p.Skv + kBlockN - 1) / kBlockN;
  if (p.causal) {
    const int last_row = min(q0 + kBlockM, p.Sq) - 1;
    n_tiles = min(n_tiles, last_row / kBlockN + 1);
  }

  load_rows_f32<D, kBlockM>(sQ, qb, p.q_ss, q0, p.Sq, tid);
  load_rows_f32<D, kBlockN>(sK, kb, p.k_ss, 0, p.Skv, tid);
  cp_async_commit();
  load_rows_f32<D, kBlockN>(sV, vb, p.v_ss, 0, p.Skv, tid);
  cp_async_commit();
  cp_async_wait_1();  // Q and K_0 have landed
  __syncthreads();
  for (int c = tid; c < kBlockM * kC; c += kF32Threads) {
    float4* x = reinterpret_cast<float4*>(sQ + (c / kC) * kS) + c % kC;
    float4 y = *x;
    y.x *= p.scale;
    y.y *= p.scale;
    y.z *= p.scale;
    y.w *= p.scale;
    *x = y;
  }

  float4 acc[4][kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int m = 0; m < kNC; ++m) acc[i][m] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m_run[4], l_run[4];  // running max; this thread's part of the sum
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    cp_async_wait_1();  // K_j has landed (V_j may be in flight)
    __syncthreads();    // (and the scaled Q is visible)

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(sQ + (rg + 16 * i) * kS + d);
        kv[i] = *reinterpret_cast<const float4*>(sK + (cg + 16 * i) * kS + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = dot4(qv[i], kv[jj], s[i][jj]);
      }
    }
    __syncthreads();  // every thread is done with K_j
    if (j + 1 < n_tiles) {
      load_rows_f32<D, kBlockN>(sK, kb, p.k_ss, n0 + kBlockN, p.Skv, tid);
    }
    cp_async_commit();

    const bool mask = (n0 + kBlockN > p.Skv) ||
                      (p.causal && n0 + kBlockN - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
      float mx = m_run[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = n0 + cg + 16 * jj;
        if (mask && (col >= p.Skv || (p.causal && col > row))) {
          s[i][jj] = kNegInf;
        }
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = group_max(mx);
      const float corr = expf(m_run[i] - mx);
      m_run[i] = mx;
      l_run[i] *= corr;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float e = expf(s[i][jj] - mx);
        l_run[i] += e;
        sP[(rg + 16 * i) * kPStride + cg + 16 * jj] = e;
      }
#pragma unroll
      for (int m = 0; m < kNC; ++m) {
        acc[i][m].x *= corr;
        acc[i][m].y *= corr;
        acc[i][m].z *= corr;
        acc[i][m].w *= corr;
      }
    }

    cp_async_wait_1();  // V_j has landed (K_{j+1} may be in flight)
    __syncthreads();    // and P's tile is complete
#pragma unroll 2
    for (int kk = 0; kk < kBlockN; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(sP + (rg + 16 * i) * kPStride +
                                                 kk);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int m = 0; m < kNC; ++m) {
          const int c = cg + 16 * m;
          if (kC % 16 == 0 || c < kC) {
            const float4 vv =
                *reinterpret_cast<const float4*>(sV + (kk + t) * kS + 4 * c);
#pragma unroll
            for (int i = 0; i < 4; ++i) fma4(acc[i][m], comp(pv[i], t), vv);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with V_j and P
    if (j + 1 < n_tiles) {
      load_rows_f32<D, kBlockN>(sV, vb, p.v_ss, n0 + kBlockN, p.Skv, tid);
    }
    cp_async_commit();
  }

  float* ob = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = fmaxf(group_sum(l_run[i]), 1e-30f);
    const int row = q0 + rg + 16 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int m = 0; m < kNC; ++m) {
      const int c = cg + 16 * m;
      if (kC % 16 == 0 || c < kC) {
        const float4 a = acc[i][m];
        *reinterpret_cast<float4*>(ob + row * p.o_ss + 4 * c) =
            make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
      }
    }
    if (cg == 0) {
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
          m_run[i] + logf(l);
    }
  }
}

template <int D>
int launch_bf16(const FlashParams& p, cudaStream_t s) {
  const dim3 grid(p.B * p.H, (p.Sq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<D><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const FlashParams& p, cudaStream_t s) {
  constexpr int smem = f32_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.H, (p.Sq + kBlockM - 1) / kBlockM);
  flash_fwd_f32_kernel<D><<<grid, kF32Threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The forms built here, (dtype, D): the wrapper's table
// (kernels/flash_attention.py::FORMS) must equal it.
int dispatch(const FlashParams& p, cudaStream_t s) {
  if (p.dtype == 0) {
    switch (p.D) {
      case 64: return launch_bf16<64>(p, s);
      case 112: return launch_bf16<112>(p, s);
      case 128: return launch_bf16<128>(p, s);
    }
  } else if (p.dtype == 1) {
    switch (p.D) {
      case 8: return launch_f32<8>(p, s);
      case 12: return launch_f32<12>(p, s);
      case 16: return launch_f32<16>(p, s);
      case 64: return launch_f32<64>(p, s);
      case 112: return launch_f32<112>(p, s);
      case 128: return launch_f32<128>(p, s);
    }
  }
  return -1;
}

bool has_form(int dtype, int D) {
  if (dtype == 0) return D == 64 || D == 112 || D == 128;
  if (dtype == 1) {
    return D == 8 || D == 12 || D == 16 || D == 64 || D == 112 || D == 128;
  }
  return false;
}

}  // namespace

// 1 if the library holds the form (dtype 0 bf16, 1 f32; head dim D).
extern "C" int flash_fwd_has_form(int dtype, int D) {
  return has_form(dtype, D) ? 1 : 0;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for shapes or a (dtype, D) it does not take.
extern "C" int flash_fwd_launch(FlashParams p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0 ||
      p.Sq <= 0 || p.Skv <= 0 || !has_form(p.dtype, p.D) ||
      (p.Sq + kBlockM - 1) / kBlockM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = dispatch(p, static_cast<cudaStream_t>(stream));
  return err < 0 ? static_cast<int>(cudaErrorInvalidValue) : err;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
