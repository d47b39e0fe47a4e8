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
// on (dtype, D) and refuses any pair it was not built for (has_form):
//
// bf16, D in {64, 112, 128} (flash_fwd_kernel).  What bounds it: at the
// serving shape of qwen3-1.7b (B 8, S 4096, H 16, Hkv 8, D 128, causal) the
// two products are 0.55 TFLOP, 0.556 ms at 989 TFLOP/s, against 0.40 GB of
// Q, K, V, O and lse, 0.121 ms at 3.35 TB/s: operations, and only wgmma
// reaches the tensor cores' full rate (mma.sync is capped well below
// it).  The design:
// - A CTA of 128 query rows of one (batch, head), in three warpgroups.  The
//   producer gives its registers up (setmaxnreg 24) and one of its threads
//   issues every copy; the two consumers take 240 each and own 64 rows.
//   Each K/V tile is fetched once per 128 query rows.
// - TMA: Q once; K and V through a ring of kStages stages, each with a
//   "full" mbarrier per tensor (transaction bytes) and an "empty" one (an
//   arrival per consumer warp).  No thread spends issue slots or registers
//   on copies, and no __syncthreads() sits in the loop.  Boxes are 64
//   columns by 128 rows of one head, 128-byte swizzled, from 4-D (D, heads,
//   rows, batch) tensor maps built over the caller's strides (no transposed
//   copy); what lies past D = 112, past the rows or past the batch is
//   zero-filled.  The maps are encoded by the launcher and passed as
//   __grid_constant__ parameters.
// - S = Q K^T: wgmma m64n128k16 per consumer, Q and K both K-major in
//   shared memory, accumulated in f32, D / 16 k-steps.
// - The online softmax (running max m, row sum l, rescale of O) is f32, in
//   base 2 with log2(e) folded into the scale; a row's max and sum take two
//   quad shuffles.  Only the diagonal tile and the ragged end of the keys
//   are masked.
// - O += P V: S's accumulators become P's bf16 A fragments in registers in
//   place (for 16-bit types the accumulator layout is the A layout); V is
//   the B operand straight from shared memory, MN-major through wgmma's
//   transpose flag, so there is no 16-bit load of V at all.  At D = 112
//   P V runs at N = 128 over both 64-column panels and the last 16 columns
//   (zero-filled, never stored) are dropped: a 128-byte swizzled MN-major
//   operand is laid out in 64-column atoms, and one shape for 112 and 128
//   costs 1/8 more P V work and 16 registers at 112.
// - The heaviest (latest) query tiles go first over every head, for the
//   causal tail.
// - Epilogue: O / l to bf16, stored per thread; lse per row; rows at or
//   past Sq are never written.
// Left for later designs: overlapping one consumer's softmax with the
// other's products (ping-pong), S_{j+1} under P_j V_j within a consumer, a
// persistent grid, clusters with TMA multicast of K and V.
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
// kernel computes them.  The same work on the CUDA cores takes at least
// 8.2 ms at 67 TFLOP/s (H100 SXM, non-tensor FP32) at the serving shape.
// Left for a later design: a 3xTF32 split on the tensor cores.

#include "hopper.cuh"  // mbarriers, TMA, wgmma: shared with flash_bwd.cu

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

constexpr int kBlockM = 64;  // query rows per f32 CTA
constexpr int kBlockN = 64;  // keys per f32 K/V tile
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

// --- bf16: wgmma from a TMA ring --------------------------------------------

constexpr int kQRows = 128;  // query rows per CTA: 64 per consumer
constexpr int kKeys = 128;   // keys per K/V tile
constexpr int kStages = 2;   // K/V tiles in flight
constexpr int kBf16Threads = 3 * kWarpgroup;  // a producer, two consumers
constexpr int kConsumerWarps = 8;
constexpr int kPanelBytes = 128 * kRowBytes;  // a panel of 128 rows

// Dynamic shared memory of the bf16 kernel, from a 1024-byte aligned base:
// Q, the K and V rings, then the mbarriers (Q's, and per stage K's and V's
// full and empty ones).
template <int D>
struct Bf16Smem {
  static constexpr int kPanels = padded(D) / kPanelCols;
  static constexpr int kTile = kPanels * kPanelBytes;  // Q, or a K/V stage
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBars = kV + kStages * kTile;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStages) + kAtomBytes;
};

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_fwd_kernel(const FlashParams p,
                     const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     int n_qtiles) {
  using L = Bf16Smem<D>;
  constexpr int DP = padded(D);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) +
       kAtomBytes - 1) & ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t sQ = base + L::kQ;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  // mbarriers, one a stage s at + 8 s: Q's, K's and V's "full" ones
  // (transaction bytes) and K's and V's "empty" ones (consumer warps)
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  // The heaviest query tiles first, each over every (batch, head).
  const int qtile = n_qtiles - 1 - blockIdx.x / (p.B * p.H);
  const int bh = blockIdx.x % (p.B * p.H);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qtile * kQRows;

  // K/V tiles this CTA needs: up to the one holding its last row's key.
  // kKeys == kQRows, so every tile starts at or before the CTA's first row
  // and no row of a tile is masked whole (its exponents would all be 0).
  static_assert(kKeys == kQRows, "no query row sees no key of a tile");
  int n_tiles = (p.Skv + kKeys - 1) / kKeys;
  if (p.causal) {
    n_tiles = min(n_tiles, (min(q0 + kQRows, p.Sq) - 1) / kKeys + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kConsumerWarps);
      mbar_init(v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 0) {
    // Producer: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int pn = 0; pn < L::kPanels; ++pn) {
        tma_load(sQ + pn * kPanelBytes, &tm_q, q_full, pn * kPanelCols, h, q0,
                 b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        // the stage's previous K (then V) has been released (passes at
        // once on the first round)
        const uint32_t released = ((j / kStages) & 1) ^ 1;
        mbar_wait(k_empty + 8 * s, released);
        mbar_expect_tx(k_full + 8 * s, L::kTile);
        for (int pn = 0; pn < L::kPanels; ++pn) {
          tma_load(sK + s * L::kTile + pn * kPanelBytes, &tm_k, k_full + 8 * s,
                   pn * kPanelCols, hk, j * kKeys, b);
        }
        mbar_wait(v_empty + 8 * s, released);
        mbar_expect_tx(v_full + 8 * s, L::kTile);
        for (int pn = 0; pn < L::kPanels; ++pn) {
          tma_load(sV + s * L::kTile + pn * kPanelBytes, &tm_v, v_full + 8 * s,
                   pn * kPanelCols, hk, j * kKeys, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int t = threadIdx.x % kWarpgroup;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane / 4;   // accumulator row group
    const int tq = lane % 4;  // thread within the group
    const int r0 = q0 + 64 * cw;
    const int row0 = r0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
    // Q's 64 rows of this warpgroup: 8 swizzle atoms into each panel
    const uint32_t sQw = sQ + cw * 64 * 128;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m_run[2] = {kNegInf, kNegInf};  // running max, base-2 units
    float l_run[2] = {0.f, 0.f};          // this thread's part of the row sum

    // Per tile j: S_j = Q K_j^T is issued, then P_{j-1} V_{j-1}, and the
    // softmax of S_j runs while the second product is on the tensor cores.
    // K_j is released as soon as S_j is done, V_{j-1} once P_{j-1} V_{j-1}
    // is, so the producer refills each a tile or more before it is needed.
    float sc[kKeys / 2];
    uint32_t pa[kKeys / 16][4];
    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int sp = (j + kStages - 1) % kStages;  // tile j - 1's stage
      const int n0 = j * kKeys;

      // S = Q K^T over the head dim in k-steps of 16 columns (32 bytes
      // into a 128-byte swizzled row; D = 112 takes 7, never reading the
      // zero-filled columns 112-127)
      mbar_wait(k_full + 8 * s, (j / kStages) & 1);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
        wgmma_ss_n128(sc, smem_desc(sQw + off, 16, kAtomBytes),
                      smem_desc(sK + s * L::kTile + off, 16, kAtomBytes),
                      kk > 0);
      }
      wgmma_commit();
      if (j > 0) {
        // O += P V: V's rows are the k dimension, its head dim contiguous
        // (MN-major): 16 keys a k-step (two swizzle atoms), the 64-column
        // panels one leading-byte offset apart
        mbar_wait(v_full + 8 * sp, ((j - 1) / kStages) & 1);
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          wgmma_rs<DP>(o, pa[kk],
                       smem_desc(sV + sp * L::kTile + kk * 2 * kAtomBytes,
                                 kPanelBytes, kAtomBytes));
        }
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_empty + 8 * s);

      // online softmax in base 2 (scores scaled by D**-0.5 log2(e) inside
      // the exponent's FMA); only the diagonal tile and the ragged end of
      // the keys are masked
      const bool mask = (n0 + kKeys > p.Skv) ||
                        (p.causal && n0 + kKeys - 1 > r0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (mask) {
            const int row = row0 + (e >= 2 ? 8 : 0);
            const int col = n0 + nt * 8 + 2 * tq + (e & 1);
            if (col >= p.Skv || (p.causal && col > row)) {
              sc[4 * nt + e] = kNegInf;
            }
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * nt + e]);
        }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(m_run[r], mx[r] * p.scale_log2);
        corr[r] = ex2(m_run[r] - mx[r]);
        m_run[r] = mx[r];
        l_run[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], p.scale_log2, -mx[(i >> 1) & 1]));
        l_run[(i >> 1) & 1] += sc[i];
      }

      if (j > 0) {
        wgmma_wait<0>();
        fence_regs(o);
        if (lane == 0) mbar_arrive(v_empty + 8 * sp);
      }
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= corr[0];
        o[4 * i + 1] *= corr[0];
        o[4 * i + 2] *= corr[1];
        o[4 * i + 3] *= corr[1];
      }
      // P rounded to bf16: the accumulators of key columns [16kk, 16kk+16)
      // are the A fragment of the kk-th k-step of P V, in place
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
        }
      }
    }
    {  // the last tile's P V
      const int sp = (n_tiles - 1) % kStages;
      mbar_wait(v_full + 8 * sp, ((n_tiles - 1) / kStages) & 1);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_rs<DP>(o, pa[kk],
                     smem_desc(sV + sp * L::kTile + kk * 2 * kAtomBytes,
                               kPanelBytes, kAtomBytes));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
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
      uint16_t* orow = ob + row * p.o_ss + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(orow + nt * 8) =
            pack_bf16(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
      }
      if (tq == 0) {
        p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
            m_run[r] * kLn2 + logf(l);
      }
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
  CUtensorMap tm_q, tm_k, tm_v;
  int err = encode(&tm_q, p.q, p.D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb,
                   kQRows);
  if (err == 0) {
    err = encode(&tm_k, p.k, p.D, p.Hkv, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb,
                 kQRows);
  }
  if (err == 0) {
    err = encode(&tm_v, p.v, p.D, p.Hkv, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb,
                 kQRows);
  }
  if (err != 0) return err;
  constexpr int smem = Bf16Smem<D>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_qtiles = (p.Sq + kQRows - 1) / kQRows;
  const long long ctas = static_cast<long long>(p.B) * p.H * n_qtiles;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<D><<<static_cast<unsigned>(ctas), kBf16Threads, smem, s>>>(
      p, tm_q, tm_k, tm_v, n_qtiles);
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

// Launches on `stream`; returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for shapes or a (dtype, D) it does not take, or a
// tensor-map error of the bf16 form (flash_fwd_error_string names it).
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
  if (err == kNoEncoder) {
    return "the driver offers no cuTensorMapEncodeTiled";
  }
  if (err >= kEncodeError && err < kNoEncoder) {
    return "cuTensorMapEncodeTiled refused a tensor map of q, k or v "
           "(CUresult: the code less 100000)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
