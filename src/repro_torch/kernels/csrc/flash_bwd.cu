// Flash-attention backward with GQA, for Hopper (sm_90a): dQ, and dK/dV.
//
// Replaces the TPU kernels `_bwd_dq_kernel` (src/repro/kernels/
// flash_attention.py:162, launched at :261) and `_bwd_dkv_kernel` (:198,
// launched at :281), both launched by `_flash_bwd_pallas` under the
// `flash_attention` custom_vjp.  They compute what those kernels compute,
// from the forward's O and f32 log-sum-exp `lse`:
//
//   S = Q K^T * scale (masked: -1e30, never -inf)   P = exp(S - lse)
//   dP = dO V^T        delta = rowsum(dO * O)        dS = P * (dP - delta)
//   dQ = scale * dS K  dK = scale * dS^T Q           dV = P^T dO
//
// with scale = D**-0.5, query head h reading KV head h / (H / Hkv), and the
// causal mask aligned top-left (query i sees keys 0..i).  Two kernels:
//
// flash_bwd_dq_kernel.  One CTA per (64-row query tile, batch * head), 4
// warps of 16 query rows.  Q and dO tiles are copied into shared memory
// once; delta for the tile's rows is computed here from O and dO (the TPU
// version computes it outside the kernel) and written out for the dK/dV
// kernel.  The CTA walks 64-key K/V tiles up to the causal diagonal (the
// TPU kernel's `nkv_eff`), K double-buffered and V single-buffered, both
// copied with cp.async; tile j + 1's copies overlap tile j's dS K product.
// Per tile: S and dP as mma.sync.m16n8k16 (bf16 operands from shared
// memory, f32 accumulators), P and dS in f32 in the accumulators, dS
// rounded to bf16 in registers as the A operand of dQ += dS K.  dQ stays
// in f32 registers and is written once, times scale, in bf16.
//
// flash_bwd_dkv_kernel.  One CTA per (64-key tile, batch * KV head), 4
// warps of 16 keys.  K and V are copied into shared memory once.  The CTA
// loops over the G query heads of its group and, for each, over 32-row
// query tiles from the first one that sees its keys (the TPU kernel's
// `first`), Q, dO, lse and delta double-buffered with cp.async.  Per tile
// it forms S^T = K Q^T and dP^T = V dO^T directly in transposed form,
// P^T and dS^T in f32, and accumulates dV += P^T dO and dK += dS^T Q with
// P^T and dS^T rounded to bf16 as A operands.  Summing the G query heads
// inside the CTA replaces the TPU version's per-q-head f32 outputs and the
// sum outside the kernel (ROADMAP B4).  dK * scale and dV are written once
// in bf16.  Heavier (earlier) key tiles come first in the grid.
//
// Both kernels read and write the model's (B, S, H, D) layout through
// strides, take any Sq and Skv (rows past the end are zero-filled on load
// and never written), and round P and dS to bf16 before their products
// where the TPU keeps f32; `check_bwd_against_plain` in
// kernels/flash_attention.py bounds that rounding.
//
// Bound.  At the training shape of qwen3-1.7b (B 8, S 4096, H 16, Hkv 8,
// D 128, causal) one product is 2 * B * H * (S^2 / 2) * D = 2.749e11 FLOP.
// The dQ kernel recomputes S and dP and forms dS K: 3 products, 0.834 ms
// at 989 TFLOP/s (H100 SXM, bf16 dense), against 0.68 GB of Q, K, V, O,
// dO, lse, dQ and delta, 0.20 ms at 3.35 TB/s.  The dK/dV kernel
// recomputes S and dP and forms P^T dO and dS^T Q: 4 products, 1.112 ms.
// Operations bound both.  This design uses the tensor cores through
// warp-level mma.sync and keeps every score tile in registers; left for a
// later design: wgmma, TMA copies driven by a producer warp with
// mbarriers, and ldmatrix (.trans) fragments in place of the 16-bit
// shared-memory loads of the transposed operands.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Passed by value from Python (ctypes), so it lives outside the unnamed
// namespace: the exported launchers' signatures name it.  Strides are in
// elements; the head dimension is contiguous.
struct FlashBwdParams {
  const void* q;     // (B, Sq, H, D) bf16
  const void* k;     // (B, Skv, Hkv, D) bf16
  const void* v;     // (B, Skv, Hkv, D) bf16
  const void* o;     // (B, Sq, H, D) bf16, the forward's output
  const void* dout;  // (B, Sq, H, D) bf16
  const float* lse;  // (B, H, Sq) f32, contiguous
  float* delta;      // (B, H, Sq) f32, contiguous: written by dq, read by dkv
  void* dq;          // (B, Sq, H, D) bf16
  void* dk;          // (B, Skv, Hkv, D) bf16
  void* dv;          // (B, Skv, Hkv, D) bf16
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int B, H, Hkv, Sq, Skv, D;  // D must be 128
  int causal;
  float scale;       // D**-0.5
  float scale_log2;  // D**-0.5 * log2(e)
};

namespace {

constexpr int D = 128;          // head dim
constexpr int kStride = D + 8;  // padded smem row: conflict-free fragments
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsDq = 64;     // query rows per dq CTA (16 per warp)
constexpr int kKeysDq = 64;     // keys per K/V tile of the dq loop
constexpr int kKeysDkv = 64;    // keys per dkv CTA (16 per warp)
constexpr int kRowsDkv = 32;    // query rows per tile of the dkv loop
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kDqSmem = (2 * kRowsDq + 3 * kKeysDq) * kStride * 2;
constexpr int kDkvSmem = (2 * kKeysDkv + 4 * kRowsDkv) * kStride * 2 +
                         4 * kRowsDkv * 4;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; `valid == false` zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

// 4 bytes global -> shared; `valid == false` zero-fills the destination.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [r0, r0 + kRows) of one head (row stride `s_stride`) into a
// padded smem tile; rows at or past `limit` are zero-filled.
template <int kRows>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* base,
                                          long long s_stride, int r0,
                                          int limit, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert(kRows * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int row = c / kChunks;
    const int col = (c % kChunks) * 8;
    const bool valid = r0 + row < limit;
    const uint16_t* src = base + (valid ? (r0 + row) * s_stride : 0) + col;
    cp_async16(dst + row * kStride + col, src, valid);
  }
}

// A fragment (16 x 16, row-major) of the smem tile `s` at rows [r, r+16),
// columns [c, c+16).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* s,
                                       int r, int c, int g, int t) {
  const uint16_t* p0 = s + (r + g) * kStride + c + 2 * t;
  const uint16_t* p1 = p0 + 8 * kStride;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment (16 x 8) with B[k][n] = s[n0 + n][k0 + k]: the tile holds B
// transposed (one smem row per column n), as K does for Q K^T.
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const uint16_t* s, int n0, int k0,
                                          int g, int t) {
  const uint16_t* p = s + (n0 + g) * kStride + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment (16 x 8) with B[k][n] = s[k0 + k][n0 + n]: the tile holds B
// as it is (one smem row per k), as K does for dS K.
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1,
                                          const uint16_t* s, int k0, int n0,
                                          int g, int t) {
  const uint16_t* p = s + (k0 + 2 * t) * kStride + n0 + g;
  b0 = uint32_t(p[0]) | (uint32_t(p[kStride]) << 16);
  b1 = uint32_t(p[8 * kStride]) | (uint32_t(p[9 * kStride]) << 16);
}

// Accumulators of columns [16kk, 16kk + 16) as the A fragment of the next
// product, rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[N][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const FlashBwdParams p) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sQ = smem;
  uint16_t* sdO = sQ + kRowsDq * kStride;
  uint16_t* sK = sdO + kRowsDq * kStride;  // two buffers
  uint16_t* sV = sK + 2 * kKeysDq * kStride;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread within the group

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int qtile = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int q0 = qtile * kRowsDq;
  const int wr = warp * 16;        // the warp's first row in the tile
  const int row0 = q0 + wr + g;    // this thread's rows: row0, row0 + 8

  const uint16_t* qb = static_cast<const uint16_t*>(p.q) + b * p.q_sb +
                       h * p.q_sh;
  const uint16_t* dob = static_cast<const uint16_t*>(p.dout) + b * p.do_sb +
                        h * p.do_sh;
  const uint16_t* ob = static_cast<const uint16_t*>(p.o) + b * p.o_sb +
                       h * p.o_sh;
  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + b * p.k_sb +
                       hk * p.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + b * p.v_sb +
                       hk * p.v_sh;
  const long long rows_at = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // K/V tiles this CTA needs: up to the one holding its last row's key.
  int n_tiles = (p.Skv + kKeysDq - 1) / kKeysDq;
  if (p.causal) {
    const int last_row = min(q0 + kRowsDq, p.Sq) - 1;
    n_tiles = min(n_tiles, last_row / kKeysDq + 1);
  }

  load_tile<kRowsDq>(sQ, qb, p.q_ss, q0, p.Sq, tid);
  load_tile<kRowsDq>(sdO, dob, p.do_ss, q0, p.Sq, tid);
  load_tile<kKeysDq>(sK, kb, p.k_ss, 0, p.Skv, tid);
  load_tile<kKeysDq>(sV, vb, p.v_ss, 0, p.Skv, tid);
  cp_async_commit();

  float lse2[2];  // lse in base 2
  float dlt[2];   // delta = rowsum(dO * O)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < p.Sq ? p.lse[rows_at + row] * kLog2e : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float acc = 0.f;
    if (row < p.Sq) {
      const uint16_t* orow = ob + row * p.o_ss;
      const uint16_t* drow = sdO + (wr + g + 8 * r) * kStride;
#pragma unroll
      for (int c = 2 * t; c < D; c += 8) {
        const uint32_t ov = *reinterpret_cast<const uint32_t*>(orow + c);
        const uint32_t dv = *reinterpret_cast<const uint32_t*>(drow + c);
        acc += bf16_lo(ov) * bf16_lo(dv) + bf16_hi(ov) * bf16_hi(dv);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dlt[r] = acc;
    if (t == 0 && row < p.Sq) p.delta[rows_at + row] = acc;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[dt][c] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kKeysDq;
    const uint16_t* cK = sK + (j & 1) * kKeysDq * kStride;
    cp_async_wait_all();  // K_j and V_j have landed
    __syncthreads();

    float s[kKeysDq / 8][4];
    float dp[kKeysDq / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeysDq / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = 0.f;
        dp[nt][c] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a(qa, sQ, wr, kk * 16, g, t);
      load_a(da, sdO, wr, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < kKeysDq / 8; ++nt) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, cK, nt * 8, kk * 16, g, t);
        mma_bf16(s[nt], qa, b0, b1);
        load_b_nk(b0, b1, sV, nt * 8, kk * 16, g, t);
        mma_bf16(dp[nt], da, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with V_j and with K_{j-1}
    if (j + 1 < n_tiles) {
      load_tile<kKeysDq>(sK + ((j + 1) & 1) * kKeysDq * kStride, kb, p.k_ss,
                         n0 + kKeysDq, p.Skv, tid);
      load_tile<kKeysDq>(sV, vb, p.v_ss, n0 + kKeysDq, p.Skv, tid);
    }
    cp_async_commit();

    const bool mask = (n0 + kKeysDq > p.Skv) ||
                      (p.causal && n0 + kKeysDq - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < kKeysDq / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[nt][c] * p.scale_log2;
        if (mask) {
          const int row = row0 + (c >= 2 ? 8 : 0);
          const int col = n0 + nt * 8 + 2 * t + (c & 1);
          if (col >= p.Skv || (p.causal && col > row)) x = kNegInf;
        }
        const float pr = exp2f(x - lse2[c >> 1]);
        s[nt][c] = pr * (dp[nt][c] - dlt[c >> 1]);  // dS, in place
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeysDq / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, cK, kk * 16, dt * 8, g, t);
        mma_bf16(dq[dt], a, b0, b1);
      }
    }
  }

  uint16_t* dqb = static_cast<uint16_t*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    uint16_t* drow = dqb + row * p.dq_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(drow + dt * 8) =
          pack_bf16(dq[dt][2 * r] * p.scale, dq[dt][2 * r + 1] * p.scale);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const FlashBwdParams p) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* sK = smem;
  uint16_t* sV = sK + kKeysDkv * kStride;
  uint16_t* sQ = sV + kKeysDkv * kStride;     // two buffers
  uint16_t* sdO = sQ + 2 * kRowsDkv * kStride;  // two buffers
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kRowsDkv * kStride);
  float* sDlt = sLse + 2 * kRowsDkv;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const int bh = blockIdx.x;
  const int b = bh / p.Hkv;
  const int hk = bh % p.Hkv;
  const int G = p.H / p.Hkv;
  const int k0 = blockIdx.y * kKeysDkv;  // earlier (heavier) tiles first
  const int wr = warp * 16;
  const int key0 = k0 + wr + g;  // this thread's keys: key0, key0 + 8

  const uint16_t* kb = static_cast<const uint16_t*>(p.k) + b * p.k_sb +
                       hk * p.k_sh;
  const uint16_t* vb = static_cast<const uint16_t*>(p.v) + b * p.v_sb +
                       hk * p.v_sh;

  // Query tiles per head: from the first that sees key k0 (causal) on.
  const int nq = (p.Sq + kRowsDkv - 1) / kRowsDkv;
  const int first = p.causal ? min(k0 / kRowsDkv, nq) : 0;
  const int count = nq - first;
  const int total = G * count;

  load_tile<kKeysDkv>(sK, kb, p.k_ss, k0, p.Skv, tid);
  load_tile<kKeysDkv>(sV, vb, p.v_ss, k0, p.Skv, tid);

  // Copy query tile `it` (head hk * G + it / count) into buffer `buf`.
  auto issue = [&](int it, int buf) {
    const int h = hk * G + it / count;
    const int i0 = (first + it % count) * kRowsDkv;
    const uint16_t* qb = static_cast<const uint16_t*>(p.q) + b * p.q_sb +
                         h * p.q_sh;
    const uint16_t* dob = static_cast<const uint16_t*>(p.dout) +
                          b * p.do_sb + h * p.do_sh;
    load_tile<kRowsDkv>(sQ + buf * kRowsDkv * kStride, qb, p.q_ss, i0, p.Sq,
                        tid);
    load_tile<kRowsDkv>(sdO + buf * kRowsDkv * kStride, dob, p.do_ss, i0,
                        p.Sq, tid);
    if (tid < kRowsDkv) {
      const int row = i0 + tid;
      const bool valid = row < p.Sq;
      const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq +
                           (valid ? row : 0);
      cp_async4(sLse + buf * kRowsDkv + tid, p.lse + at, valid);
      cp_async4(sDlt + buf * kRowsDkv + tid, p.delta + at, valid);
    }
  };
  if (total > 0) issue(0, 0);
  cp_async_commit();

  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dk[dt][c] = 0.f;
      dv[dt][c] = 0.f;
    }
  }

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    cp_async_wait_all();  // tile `it` (and K, V) have landed
    __syncthreads();      // and every warp is done with tile it - 1
    if (it + 1 < total) issue(it + 1, buf ^ 1);
    cp_async_commit();

    const int i0 = (first + it % count) * kRowsDkv;
    const uint16_t* cQ = sQ + buf * kRowsDkv * kStride;
    const uint16_t* cdO = sdO + buf * kRowsDkv * kStride;
    const float* cLse = sLse + buf * kRowsDkv;
    const float* cDlt = sDlt + buf * kRowsDkv;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 query rows per warp.
    float st[kRowsDkv / 8][4];
    float dpt[kRowsDkv / 8][4];
#pragma unroll
    for (int nt = 0; nt < kRowsDkv / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        st[nt][c] = 0.f;
        dpt[nt][c] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, wr, kk * 16, g, t);
      load_a(va, sV, wr, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < kRowsDkv / 8; ++nt) {
        uint32_t b0, b1;
        load_b_nk(b0, b1, cQ, nt * 8, kk * 16, g, t);
        mma_bf16(st[nt], ka, b0, b1);
        load_b_nk(b0, b1, cdO, nt * 8, kk * 16, g, t);
        mma_bf16(dpt[nt], va, b0, b1);
      }
    }

    const bool mask = (i0 + kRowsDkv > p.Sq) ||
                      (p.causal && i0 < k0 + kKeysDkv - 1);
#pragma unroll
    for (int nt = 0; nt < kRowsDkv / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = nt * 8 + 2 * t + (c & 1);  // query row in the tile
        float x = st[nt][c] * p.scale_log2;
        if (mask) {
          const int key = key0 + (c >= 2 ? 8 : 0);
          const int row = i0 + col;
          if (row >= p.Sq || (p.causal && row < key)) x = kNegInf;
        }
        const float pr = exp2f(x - cLse[col] * kLog2e);
        st[nt][c] = pr;                             // P^T
        dpt[nt][c] = pr * (dpt[nt][c] - cDlt[col]);  // dS^T
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's query rows.
#pragma unroll
    for (int kk = 0; kk < kRowsDkv / 16; ++kk) {
      uint32_t pa[4], sa[4];
      acc_to_a(pa, st, kk);
      acc_to_a(sa, dpt, kk);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, cdO, kk * 16, dt * 8, g, t);
        mma_bf16(dv[dt], pa, b0, b1);
        load_b_kn(b0, b1, cQ, kk * 16, dt * 8, g, t);
        mma_bf16(dk[dt], sa, b0, b1);
      }
    }
  }

  uint16_t* dkb = static_cast<uint16_t*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  uint16_t* dvb = static_cast<uint16_t*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.Skv) continue;
    uint16_t* krow = dkb + key * p.dk_ss + 2 * t;
    uint16_t* vrow = dvb + key * p.dv_ss + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(krow + dt * 8) =
          pack_bf16(dk[dt][2 * r] * p.scale, dk[dt][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(vrow + dt * 8) =
          pack_bf16(dv[dt][2 * r], dv[dt][2 * r + 1]);
    }
  }
}

bool valid_params(const FlashBwdParams& p) {
  return p.B > 0 && p.H > 0 && p.Hkv > 0 && p.H % p.Hkv == 0 && p.Sq > 0 &&
         p.Skv > 0 && p.D == D;
}

}  // namespace

// dQ, and delta for the dK/dV kernel.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int flash_bwd_dq_launch(FlashBwdParams p, void* stream) {
  if (!valid_params(p) || (p.Sq + kRowsDq - 1) / kRowsDq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.H, (p.Sq + kRowsDq - 1) / kRowsDq);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dK and dV; reads the delta that flash_bwd_dq_launch wrote.
extern "C" int flash_bwd_dkv_launch(FlashBwdParams p, void* stream) {
  if (!valid_params(p) || (p.Skv + kKeysDkv - 1) / kKeysDkv > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(p.B * p.Hkv, (p.Skv + kKeysDkv - 1) / kKeysDkv);
  flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
