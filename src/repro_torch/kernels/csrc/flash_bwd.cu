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
// causal mask aligned top-left (query i sees keys 0..i).  Each kernel is a
// template over the head dim D, in two forms; the launchers dispatch on
// (dtype, D) and refuse any pair they were not built for.  Both forms read
// and write the model's (B, S, H, D) layout through strides and take any
// Sq and Skv (rows past the end are zero-filled on load and never
// written).  No form uses atomics: every sum runs in a fixed order, so two
// launches on the same inputs agree bit for bit.
//
// What bounds them.  At the training shape of qwen3-1.7b (B 8, S 4096, H
// 16, Hkv 8, D 128, causal) one product is 2 * B * H * (S^2 / 2) * D =
// 2.749e11 FLOP.  The dQ kernel recomputes S and dP and forms dS K: 3
// products, 0.834 ms at 989 TFLOP/s (H100 SXM, bf16 dense), against 0.68
// GB of Q, K, V, O, dO, lse, dQ and delta, 0.20 ms at 3.35 TB/s.  The
// dK/dV kernel recomputes S and dP and forms P^T dO and dS^T Q: 4
// products, 1.112 ms.  Operations bound both, and only wgmma reaches the
// tensor cores' full rate; in f32 on the CUDA cores (67 TFLOP/s) the same
// work takes at least 12.3 and 16.4 ms.
//
// bf16, D in {64, 112, 128}: wgmma from TMA rings, the design of
// flash_fwd.cu's bf16 forward (the shared pieces are in hopper.cuh).
// - A CTA is three warpgroups: a producer that gives its registers up
//   (setmaxnreg 24), one thread of which issues every TMA copy, and two
//   consumers (240 registers each) of 64 rows.  Copies land on "full"
//   mbarriers (transaction bytes) and stages are handed back on "empty"
//   ones (an arrival per consumer warp); no __syncthreads() sits in a
//   loop and no thread spends registers on copies.
// - Tiles are 64 columns of one head by 64 rows, 128-byte swizzled, from
//   4-D (D, heads, rows, batch) tensor maps over the caller's strides;
//   what lies past D = 112, past the rows or past the batch is
//   zero-filled.  A 128-row operand is two such boxes per panel.
// - Every operand is read by wgmma straight from shared memory, either
//   K-major (Q, dO, K, V as A or B of S and dP) or MN-major through the
//   transpose flag (K in dS K, dO in P^T dO, Q in dS^T Q); P, P^T, dS
//   and dS^T are f32 accumulators rounded to bf16 A fragments in place
//   (for 16-bit types the accumulator layout is the A layout).  Nothing
//   goes through shared memory on its way between products, and there is
//   no 16-bit shared-memory load.  At D = 112 the head-dim products run
//   at N 128 over both panels and the last 16 columns (zero-filled, never
//   stored) are dropped, as in the forward's P V.
// - P = exp2(S * scale * log2(e) - lse * log2(e)) on the special-function
//   unit; dS = P (dP - delta) in f32; only the diagonal tile and the
//   ragged ends are masked.  P and dS are rounded to bf16 before their
//   products and everything else stays f32, the rounding points of the
//   warp-level kernels these replace (`check_bwd_against_plain` bounds
//   that rounding).
//
// flash_bwd_dq_kernel.  A CTA owns 128 query rows of one (batch, head),
// the heaviest (latest) query tiles first.  Q and dO are loaded once;
// delta = rowsum(dO * O) for its rows is computed from device memory (the
// TPU version computes it outside the kernel) and written out for the
// dK/dV kernel.  K and V come in 64-key tiles through a ring of kStagesDq
// stages up to the causal diagonal (the TPU kernel's `nkv_eff`), each
// with its own full and empty barriers: V_j is handed back as soon as S_j
// and dP_j are done, K_j only after dQ += dS_j K_j, which runs under the
// next tile's S and dP (so K needs the third stage).  S = Q K^T and dP =
// dO V^T are SS wgmmas (m64n64); dQ += dS K is register-sourced.  dQ
// stays in f32 registers and is written once, times scale, in bf16.
//
// flash_bwd_dkv_kernel.  A CTA owns 128 keys of one (batch, KV head), the
// heavier (earlier) key tiles first.  K and V are loaded once.  The ring
// walks the G query heads of the group and, for each, the 64-row query
// tiles from the first that sees its keys (the TPU kernel's `first`):
// each stage brings the Q and dO tiles by TMA and the tile's 64 lse and
// delta values, copied by the producer's second warp with cp.async onto
// the same full barrier.  S^T = K Q^T and dP^T = V dO^T are SS wgmmas
// with M = keys; P^T and dS^T take each column's lse and delta from
// shared memory; dV += P^T dO and dK += dS^T Q are register-sourced.
// Summing the G query heads inside the CTA replaces the TPU version's
// per-q-head f32 outputs and the sum outside the kernel (ROADMAP B4).
// dK * scale and dV are written once in bf16.
//
// Left for later designs: ping-pong of the two consumers, the next tile's
// S^T and dP^T under dK/dV's products (registers: dK and dV alone take
// 128), a persistent grid, and FA3's single kernel of 5 products (S, dP,
// dV, dK, dQ once each: 1.390 ms bound at D 128 against 1.946), whose dQ
// sums over key tiles need an ordered (semaphore) accumulation to stay
// deterministic where f32 atomics are not.
//
// f32, D in {8, 12, 16, 64, 112, 128}: FMAs on the CUDA cores, P and dS
// kept in f32 as the TPU kernels keep them (a tf32 mma would drop 13 bits
// of mantissa).  Both kernels use 256 threads in 16 groups of 16
// neighbouring lanes, the layout of flash_fwd.cu's f32 form, and rows in
// shared memory padded to a stride of 4 modulo 8 floats.
//
// flash_bwd_dq_f32_kernel.  One CTA per (64-row query tile, batch * head):
// a thread owns rows rg + 16i and, of each 64-key tile, keys cg + 16j (i,
// j < 4).  Q, dO and the K and V tiles (cp.async, 16-byte chunks; V's next
// copy overlaps dS K) sit in dynamic shared memory, delta is computed from
// O and dO and written for the dK/dV kernel, S and dP are float4 dot
// products, dS goes through a 64 x 64 shared tile, and dQ (rows rg + 16i,
// float4 chunks cg + 16m of the head dim) accumulates dS K in registers.
//
// flash_bwd_dkv_f32_kernel.  One CTA per (64-key tile, batch * KV head):
// a thread owns keys kg + 16i and, of each 64-row query tile, rows qg +
// 16j.  Over the G query heads and the query tiles from `first` on, it
// forms S^T and dP^T, stores P^T and dS^T as 64 x 64 shared tiles, and
// accumulates dV += P^T dO and dK += dS^T Q for its keys and chunks; the G
// heads are summed in the CTA as in the bf16 form.  Left for a later
// design: a 3xTF32 split on the tensor cores.

#include "hopper.cuh"

// Passed by value from Python (ctypes), so it lives outside the unnamed
// namespace: the exported launchers' signatures name it.  Strides are in
// elements; the head dimension is contiguous.
struct FlashBwdParams {
  const void* q;     // (B, Sq, H, D) bf16 or f32
  const void* k;     // (B, Skv, Hkv, D) like q
  const void* v;     // (B, Skv, Hkv, D) like q
  const void* o;     // (B, Sq, H, D) like q, the forward's output
  const void* dout;  // (B, Sq, H, D) like q
  const float* lse;  // (B, H, Sq) f32, contiguous
  float* delta;      // (B, H, Sq) f32, contiguous: written by dq, read by dkv
  void* dq;          // (B, Sq, H, D) like q
  void* dk;          // (B, Skv, Hkv, D) like q
  void* dv;          // (B, Skv, Hkv, D) like q
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int B, H, Hkv, Sq, Skv, D;
  int causal;
  int dtype;         // 0: bf16, 1: f32
  float scale;       // D**-0.5
  float scale_log2;  // D**-0.5 * log2(e)
};

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

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

// --- bf16: wgmma from TMA rings ---------------------------------------------

constexpr int kBf16Threads = 3 * kWarpgroup;  // a producer, two consumers
constexpr int kConsumerWarps = 8;
constexpr int kRowsDq = 128;   // query rows per dQ CTA: 64 per consumer
constexpr int kKeysDkv = 128;  // keys per dK/dV CTA: 64 per consumer
constexpr int kTile = 64;      // keys of a dQ ring tile, query rows of a
                               // dK/dV one, and the rows of every TMA box
constexpr int kStagesDq = 3;   // K/V tiles in flight
constexpr int kStagesDkv = 2;  // Q/dO tiles in flight
constexpr int kHalfPanel = kTile * kRowBytes;  // a 64-row panel, 8 KB
constexpr int kFullPanel = 2 * kHalfPanel;     // a 128-row panel

// Dynamic shared memory of the dQ kernel, from a 1024-byte aligned base:
// Q and dO (128 rows), the K and V rings, delta of the CTA's rows, then the
// mbarriers (Q and dO's, and per stage K's and V's full and empty ones).
template <int D>
struct DqSmem {
  static constexpr int kPanels = padded(D) / kPanelCols;
  static constexpr int kRows = kPanels * kFullPanel;  // Q or dO
  static constexpr int kStage = kPanels * kHalfPanel;  // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kdO = kQ + kRows;
  static constexpr int kK = kdO + kRows;
  static constexpr int kV = kK + kStagesDq * kStage;
  static constexpr int kDelta = kV + kStagesDq * kStage;
  static constexpr int kBars = kDelta + 4 * kRowsDq;
  static constexpr int kBytes = kBars + 8 * (1 + 4 * kStagesDq) + kAtomBytes;
};

// Dynamic shared memory of the dK/dV kernel: K and V (128 keys), the Q and
// dO rings, lse and delta of each stage's rows, then the mbarriers (K and
// V's, and per stage a full and an empty one).
template <int D>
struct DkvSmem {
  static constexpr int kPanels = padded(D) / kPanelCols;
  static constexpr int kRows = kPanels * kFullPanel;  // K or V
  static constexpr int kStage = kPanels * kHalfPanel;  // a Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kRows;
  static constexpr int kQ = kV + kRows;
  static constexpr int kdO = kQ + kStagesDkv * kStage;
  static constexpr int kLse = kdO + kStagesDkv * kStage;
  static constexpr int kDelta = kLse + 4 * kTile * kStagesDkv;
  static constexpr int kBars = kDelta + 4 * kTile * kStagesDkv;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStagesDkv) + kAtomBytes;
};

// wgmma descriptor of k-step kk (16 columns) of a K-major operand whose
// 64-column panels lie `panel` bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk, int panel) {
  return smem_desc(tile + (kk / 4) * panel + (kk % 4) * 32, 16, kAtomBytes);
}

// wgmma descriptor of k-step kk (16 rows: two swizzle atoms) of an
// MN-major operand, a 64-row tile whose 64-column panels lie one leading
// byte offset apart.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 2 * kAtomBytes, kHalfPanel, kAtomBytes);
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// acc + the dot product of 8 bf16 pairs.
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b,
                                      float acc) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w};
  const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(bf16_lo(av[i]), bf16_lo(bv[i]), acc);
    acc = fmaf(bf16_hi(av[i]), bf16_hi(bv[i]), acc);
  }
  return acc;
}

// Shared-memory address `at` as a generic pointer, given the generic and
// shared addresses of the dynamic shared memory's start.
template <typename T>
__device__ __forceinline__ T* generic(uint8_t* raw, uint32_t raw_at,
                                      uint32_t at) {
  return reinterpret_cast<T*>(raw + (at - raw_at));
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bwd_dq_kernel(const FlashBwdParams p,
                        const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        int n_qtiles) {
  using L = DqSmem<D>;
  constexpr int DP = padded(D);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(
      smem_raw));
  const uint32_t base = (raw + kAtomBytes - 1) &
                        ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t sQ = base + L::kQ;
  const uint32_t sdO = base + L::kdO;
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  float* sDelta = generic<float>(smem_raw, raw, base + L::kDelta);
  // mbarriers, one a stage s at + 8 s: Q and dO's "full" one, K's and V's
  // "full" ones (transaction bytes) and "empty" ones (consumer warps)
  const uint32_t qdo_full = base + L::kBars;
  const uint32_t k_full = qdo_full + 8;
  const uint32_t v_full = k_full + 8 * kStagesDq;
  const uint32_t k_empty = v_full + 8 * kStagesDq;
  const uint32_t v_empty = k_empty + 8 * kStagesDq;

  // The heaviest query tiles first, each over every (batch, head).
  const int qtile = n_qtiles - 1 - blockIdx.x / (p.B * p.H);
  const int bh = blockIdx.x % (p.B * p.H);
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int q0 = qtile * kRowsDq;

  // K/V tiles this CTA needs: up to the one holding its last row's key.
  int n_tiles = (p.Skv + kTile - 1) / kTile;
  if (p.causal) {
    n_tiles = min(n_tiles, (min(q0 + kRowsDq, p.Sq) - 1) / kTile + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStagesDq; ++s) {
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
      mbar_expect_tx(qdo_full, 2 * L::kRows);
      for (int pn = 0; pn < L::kPanels; ++pn) {
        for (int half = 0; half < 2; ++half) {
          const uint32_t at = pn * kFullPanel + half * kHalfPanel;
          tma_load(sQ + at, &tm_q, qdo_full, pn * kPanelCols, h,
                   q0 + half * kTile, b);
          tma_load(sdO + at, &tm_do, qdo_full, pn * kPanelCols, h,
                   q0 + half * kTile, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStagesDq;
        // the stage's previous V (then K) has been handed back (passes at
        // once on the first round); V goes first, as it is released first
        const uint32_t released = ((j / kStagesDq) & 1) ^ 1;
        mbar_wait(v_empty + 8 * s, released);
        mbar_expect_tx(v_full + 8 * s, L::kStage);
        for (int pn = 0; pn < L::kPanels; ++pn) {
          tma_load(sV + s * L::kStage + pn * kHalfPanel, &tm_v,
                   v_full + 8 * s, pn * kPanelCols, hk, j * kTile, b);
        }
        mbar_wait(k_empty + 8 * s, released);
        mbar_expect_tx(k_full + 8 * s, L::kStage);
        for (int pn = 0; pn < L::kPanels; ++pn) {
          tma_load(sK + s * L::kStage + pn * kHalfPanel, &tm_k,
                   k_full + 8 * s, pn * kPanelCols, hk, j * kTile, b);
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
    const long long rows_at = (static_cast<long long>(b) * p.H + h) * p.Sq;

    {  // delta = rowsum(dO * O): two threads a row, half the head dim each,
       // in 16-byte chunks from device memory while Q and dO land
      const int r = t / 2;
      const int half = t % 2;
      const int row = r0 + r;
      float acc = 0.f;
      if (row < p.Sq) {
        const uint4* orow = reinterpret_cast<const uint4*>(
            static_cast<const uint16_t*>(p.o) + b * p.o_sb + h * p.o_sh +
            row * p.o_ss + half * (D / 2));
        const uint4* drow = reinterpret_cast<const uint4*>(
            static_cast<const uint16_t*>(p.dout) + b * p.do_sb +
            h * p.do_sh + row * p.do_ss + half * (D / 2));
#pragma unroll
        for (int c = 0; c < D / 16; ++c) acc = dot8(orow[c], drow[c], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        sDelta[64 * cw + r] = acc;
        if (row < p.Sq) p.delta[rows_at + row] = acc;
      }
      // the warpgroup's own named barrier
      asm volatile("bar.sync %0, %1;\n" ::"r"(1 + cw), "n"(kWarpgroup)
                   : "memory");
    }
    float lse2[2];  // lse in base 2
    float dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < p.Sq ? p.lse[rows_at + row] * kLog2e : 0.f;
      dlt[r] = sDelta[row - q0];
    }
    // Q's and dO's 64 rows of this warpgroup: 8 swizzle atoms into each
    // 128-row panel
    const uint32_t sQw = sQ + cw * kHalfPanel;
    const uint32_t sdOw = sdO + cw * kHalfPanel;

    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    // Per tile j: S_j and dP_j are issued, then dQ += dS_{j-1} K_{j-1},
    // and dS_j is formed while that product is on the tensor cores.  V_j
    // is released as soon as S_j and dP_j are done, K_{j-1} once dS_{j-1}
    // K_{j-1} is.
    float s[kTile / 2];
    float dp[kTile / 2];
    uint32_t da[kTile / 16][4];
    mbar_wait(qdo_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStagesDq;
      const int sp = (j + kStagesDq - 1) % kStagesDq;  // tile j - 1's stage
      const int n0 = j * kTile;
      const uint32_t parity = (j / kStagesDq) & 1;

      // S = Q K^T and dP = dO V^T over the head dim in k-steps of 16
      // columns (D = 112 takes 7, never reading the zero-filled columns)
      mbar_wait(k_full + 8 * st, parity);
      mbar_wait(v_full + 8 * st, parity);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n64(s, kmajor(sQw, kk, kFullPanel),
                     kmajor(sK + st * L::kStage, kk, kHalfPanel), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n64(dp, kmajor(sdOw, kk, kFullPanel),
                     kmajor(sV + st * L::kStage, kk, kHalfPanel), kk > 0);
      }
      wgmma_commit();
      if (j > 0) {
        // dQ += dS K: K's rows are the k dimension, its head dim
        // contiguous (MN-major)
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          wgmma_rs<DP>(dq, da[kk], mnmajor(sK + sp * L::kStage, kk));
        }
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);
      fence_regs(dp);
      if (lane == 0) mbar_arrive(v_empty + 8 * st);

      // dS = P (dP - delta), P in base 2 with the scale folded into the
      // exponent's FMA; only the diagonal tile and the ragged end of the
      // keys are masked
      const bool mask = (n0 + kTile > p.Skv) ||
                        (p.causal && n0 + kTile - 1 > r0);
#pragma unroll
      for (int i = 0; i < kTile / 2; ++i) {
        const int r = (i >> 1) & 1;
        float pr = ex2(fmaf(s[i], p.scale_log2, -lse2[r]));
        if (mask) {
          const int row = row0 + 8 * r;
          const int col = n0 + 8 * (i >> 2) + 2 * tq + (i & 1);
          if (col >= p.Skv || (p.causal && col > row)) pr = 0.f;
        }
        s[i] = pr * (dp[i] - dlt[r]);
      }

      if (j > 0) {
        wgmma_wait<0>();
        fence_regs(dq);
        if (lane == 0) mbar_arrive(k_empty + 8 * sp);
      }
      // dS rounded to bf16: the accumulators of key columns [16kk, 16kk +
      // 16) are the A fragment of the kk-th k-step of dS K, in place
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          da[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
        }
      }
    }
    {  // the last tile's dS K
      const int sp = (n_tiles - 1) % kStagesDq;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_rs<DP>(dq, da[kk], mnmajor(sK + sp * L::kStage, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }

    uint16_t* dqb = static_cast<uint16_t*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      uint16_t* drow = dqb + row * p.dq_ss + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(drow + nt * 8) = pack_bf16(
            dq[4 * nt + 2 * r] * p.scale, dq[4 * nt + 2 * r + 1] * p.scale);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
    flash_bwd_dkv_kernel(const FlashBwdParams p,
                         const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         int n_ktiles) {
  using L = DkvSmem<D>;
  constexpr int DP = padded(D);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(
      smem_raw));
  const uint32_t base = (raw + kAtomBytes - 1) &
                        ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t sK = base + L::kK;
  const uint32_t sV = base + L::kV;
  const uint32_t sQ = base + L::kQ;
  const uint32_t sdO = base + L::kdO;
  float* sLse = generic<float>(smem_raw, raw, base + L::kLse);
  float* sDlt = generic<float>(smem_raw, raw, base + L::kDelta);
  // mbarriers: K and V's "full" one, then per stage s (at + 8 s) a "full"
  // one (the Q and dO tiles' transaction bytes and the 32 lse/delta
  // copiers) and an "empty" one (consumer warps)
  const uint32_t kv_full = base + L::kBars;
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * kStagesDkv;

  // The heavier (earlier) key tiles first, each over every (batch, KV
  // head).
  const int ktile = blockIdx.x / (p.B * p.Hkv);
  const int bh = blockIdx.x % (p.B * p.Hkv);
  const int b = bh / p.Hkv;
  const int hk = bh % p.Hkv;
  const int G = p.H / p.Hkv;
  const int k0 = ktile * kKeysDkv;

  // Query tiles per head: from the first that sees key k0 (causal) on.
  const int nq = (p.Sq + kTile - 1) / kTile;
  const int first = p.causal ? min(k0 / kTile, nq) : 0;
  const int count = nq - first;
  const int total = G * count;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStagesDkv; ++s) {
      mbar_init(full + 8 * s, 1 + 32);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWarpgroup;
  if (wg == 0) {
    // Producer: thread 0 issues every TMA copy, warp 1 copies lse and
    // delta.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    if (threadIdx.x == 0 && total > 0) {
      mbar_expect_tx(kv_full, 2 * L::kRows);
      for (int pn = 0; pn < L::kPanels; ++pn) {
        for (int half = 0; half < 2; ++half) {
          const uint32_t at = pn * kFullPanel + half * kHalfPanel;
          tma_load(sK + at, &tm_k, kv_full, pn * kPanelCols, hk,
                   k0 + half * kTile, b);
          tma_load(sV + at, &tm_v, kv_full, pn * kPanelCols, hk,
                   k0 + half * kTile, b);
        }
      }
      for (int it = 0; it < total; ++it) {
        const int s = it % kStagesDkv;
        const int h = hk * G + it / count;
        const int i0 = (first + it % count) * kTile;
        mbar_wait(empty + 8 * s, ((it / kStagesDkv) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * L::kStage);
        for (int pn = 0; pn < L::kPanels; ++pn) {
          tma_load(sQ + s * L::kStage + pn * kHalfPanel, &tm_q, full + 8 * s,
                   pn * kPanelCols, h, i0, b);
          tma_load(sdO + s * L::kStage + pn * kHalfPanel, &tm_do,
                   full + 8 * s, pn * kPanelCols, h, i0, b);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < total; ++it) {
        const int s = it % kStagesDkv;
        const int h = hk * G + it / count;
        const int i0 = (first + it % count) * kTile;
        mbar_wait(empty + 8 * s, ((it / kStagesDkv) & 1) ^ 1);
        const long long rows_at = (static_cast<long long>(b) * p.H + h) *
                                  p.Sq;
#pragma unroll
        for (int c = 0; c < kTile / 32; ++c) {
          const int row = i0 + lane + 32 * c;
          const bool valid = row < p.Sq;
          const long long at = rows_at + (valid ? row : 0);
          cp_async4(sLse + s * kTile + lane + 32 * c, p.lse + at, valid);
          cp_async4(sDlt + s * kTile + lane + 32 * c, p.delta + at, valid);
        }
        // arrives on the stage's full barrier once the copies have landed
        asm volatile(
            "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                full + 8 * s)
            : "memory");
      }
    }
  } else {
    // Consumers: warpgroup cw owns keys k0 + 64 cw .. + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int t = threadIdx.x % kWarpgroup;
    const int warp = t / 32;
    const int lane = t % 32;
    const int g = lane / 4;
    const int tq = lane % 4;
    const int kc0 = k0 + 64 * cw;
    const int key0 = kc0 + 16 * warp + g;  // this thread's keys: key0, + 8
    const uint32_t sKw = sK + cw * kHalfPanel;
    const uint32_t sVw = sV + cw * kHalfPanel;

    float dk[DP / 2];
    float dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    float st[kTile / 2];   // S^T, then P^T
    float dpt[kTile / 2];  // dP^T, then dS^T
    uint32_t pa[kTile / 16][4];
    uint32_t sa[kTile / 16][4];
    if (total > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < total; ++it) {
      const int s = it % kStagesDkv;
      const int i0 = (first + it % count) * kTile;
      const uint32_t cQ = sQ + s * L::kStage;
      const uint32_t cdO = sdO + s * L::kStage;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 query rows
      mbar_wait(full + 8 * s, (it / kStagesDkv) & 1);
      __syncwarp();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n64(st, kmajor(sKw, kk, kFullPanel),
                     kmajor(cQ, kk, kHalfPanel), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_ss_n64(dpt, kmajor(sVw, kk, kFullPanel),
                     kmajor(cdO, kk, kHalfPanel), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T: column c (query row i0 + c) takes its own lse and
      // delta from the stage
      const bool mask = (i0 + kTile > p.Sq) ||
                        (p.causal && i0 < kc0 + kTile - 1);
      const float* cLse = sLse + s * kTile;
      const float* cDlt = sDlt + s * kTile;
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const int c = 8 * nt + 2 * tq;
        const float2 l2 = *reinterpret_cast<const float2*>(cLse + c);
        const float2 d2 = *reinterpret_cast<const float2*>(cDlt + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * nt + e;
          const float lse = (e & 1) ? l2.y : l2.x;
          const float dl = (e & 1) ? d2.y : d2.x;
          float pr = ex2(fmaf(st[i], p.scale_log2, -lse * kLog2e));
          if (mask) {
            const int key = key0 + 8 * (e >> 1);
            const int row = i0 + c + (e & 1);
            if (row >= p.Sq || (p.causal && row < key)) pr = 0.f;
          }
          st[i] = pr;
          dpt[i] = pr * (dpt[i] - dl);
        }
      }
      // rounded to bf16: the accumulators of query columns [16kk, 16kk +
      // 16) are the A fragments of the kk-th k-step, in place
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[kk][i] = pack_bf16(st[8 * kk + 2 * i], st[8 * kk + 2 * i + 1]);
          sa[kk][i] = pack_bf16(dpt[8 * kk + 2 * i], dpt[8 * kk + 2 * i + 1]);
        }
      }

      // dV += P^T dO and dK += dS^T Q: dO's and Q's rows are the k
      // dimension, their head dim contiguous (MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_rs<DP>(dv, pa[kk], mnmajor(cdO, kk));
      }
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        wgmma_rs<DP>(dk, sa[kk], mnmajor(cQ, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    uint16_t* dkb = static_cast<uint16_t*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
    uint16_t* dvb = static_cast<uint16_t*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= p.Skv) continue;
      uint16_t* krow = dkb + key * p.dk_ss + 2 * tq;
      uint16_t* vrow = dvb + key * p.dv_ss + 2 * tq;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(krow + nt * 8) = pack_bf16(
            dk[4 * nt + 2 * r] * p.scale, dk[4 * nt + 2 * r + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(vrow + nt * 8) =
            pack_bf16(dv[4 * nt + 2 * r], dv[4 * nt + 2 * r + 1]);
      }
    }
  }
}


// --- f32: FMAs on the CUDA cores --------------------------------------------

constexpr int kF32Threads = 256;  // 16 groups of 16 neighbouring lanes
constexpr int kF32Rows = 64;      // query rows (dq) or keys (dkv) a CTA
constexpr int kF32Tile = 64;      // keys (dq) or query rows (dkv) a tile
constexpr int kPStride = kF32Tile + 16;  // a group's two rows a warp store
                                         // to the two bank halves

// Padded smem row of an f32 tile, in floats: 4 modulo 8, so the float4
// reads of 8 neighbouring rows fall in distinct banks.
__host__ __device__ constexpr int f32_stride(int D) {
  return D % 8 == 4 ? D : D + 4;
}

template <int D>
constexpr int dq_f32_smem_bytes() {
  return (4 * kF32Rows * f32_stride(D) + kF32Rows * kPStride) * 4;
}

template <int D>
constexpr int dkv_f32_smem_bytes() {
  return (4 * kF32Rows * f32_stride(D) + 2 * kF32Rows * kPStride +
          2 * kF32Tile) * 4;
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

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float4 scaled(const float4& a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dq_f32_kernel(const FlashBwdParams p) {
  static_assert(D % 4 == 0, "whole 16-byte chunks a row");
  constexpr int kS = f32_stride(D);
  constexpr int kC = D / 4;            // float4 chunks per row
  constexpr int kNC = (kC + 15) / 16;  // chunks a thread accumulates
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;
  float* sdO = sQ + kF32Rows * kS;
  float* sK = sdO + kF32Rows * kS;
  float* sV = sK + kF32Tile * kS;
  float* sdS = sV + kF32Tile * kS;

  const int tid = threadIdx.x;
  const int rg = tid / 16;  // rows rg + 16i
  const int cg = tid % 16;  // keys cg + 16j of a tile; dQ chunks cg + 16m

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hk = h / (p.H / p.Hkv);
  const int qtile = gridDim.y - 1 - blockIdx.y;  // heaviest tiles first
  const int q0 = qtile * kF32Rows;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dob = static_cast<const float*>(p.dout) + b * p.do_sb +
                     h * p.do_sh;
  const float* ob = static_cast<const float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb +
                    hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb +
                    hk * p.v_sh;
  const long long rows_at = (static_cast<long long>(b) * p.H + h) * p.Sq;

  int n_tiles = (p.Skv + kF32Tile - 1) / kF32Tile;
  if (p.causal) {
    const int last_row = min(q0 + kF32Rows, p.Sq) - 1;
    n_tiles = min(n_tiles, last_row / kF32Tile + 1);
  }

  load_rows_f32<D, kF32Rows>(sQ, qb, p.q_ss, q0, p.Sq, tid);
  load_rows_f32<D, kF32Rows>(sdO, dob, p.do_ss, q0, p.Sq, tid);
  load_rows_f32<D, kF32Tile>(sK, kb, p.k_ss, 0, p.Skv, tid);
  load_rows_f32<D, kF32Tile>(sV, vb, p.v_ss, 0, p.Skv, tid);
  cp_async_commit();

  float lse[4], dlt[4];  // lse and delta = rowsum(dO * O) of rows rg + 16i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    lse[i] = row < p.Sq ? p.lse[rows_at + row] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    float acc = 0.f;
    if (row < p.Sq) {
#pragma unroll
      for (int m = 0; m < kNC; ++m) {
        const int c = cg + 16 * m;
        if (kC % 16 == 0 || c < kC) {
          acc = dot4(*reinterpret_cast<const float4*>(ob + row * p.o_ss +
                                                      4 * c),
                     *reinterpret_cast<const float4*>(
                         sdO + (rg + 16 * i) * kS + 4 * c),
                     acc);
        }
      }
    }
    dlt[i] = group_sum(acc);
    if (cg == 0 && row < p.Sq) p.delta[rows_at + row] = dlt[i];
  }

  float4 dq[4][kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int m = 0; m < kNC; ++m) dq[i][m] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kF32Tile;
    cp_async_wait_all();  // K_j and V_j have landed
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = 0.f;
        dp[i][jj] = 0.f;
      }
    }
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], dv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(sQ + (rg + 16 * i) * kS + d);
        dv[i] = *reinterpret_cast<const float4*>(sdO + (rg + 16 * i) * kS + d);
        kv[i] = *reinterpret_cast<const float4*>(sK + (cg + 16 * i) * kS + d);
        vv[i] = *reinterpret_cast<const float4*>(sV + (cg + 16 * i) * kS + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          s[i][jj] = dot4(qv[i], kv[jj], s[i][jj]);
          dp[i][jj] = dot4(dv[i], vv[jj], dp[i][jj]);
        }
      }
    }
    __syncthreads();  // every thread is done with V_j (K_j stays)
    if (j + 1 < n_tiles) {
      load_rows_f32<D, kF32Tile>(sV, vb, p.v_ss, n0 + kF32Tile, p.Skv, tid);
    }
    cp_async_commit();

    const bool mask = (n0 + kF32Tile > p.Skv) ||
                      (p.causal && n0 + kF32Tile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = n0 + cg + 16 * jj;
        float x = s[i][jj] * p.scale;
        if (mask && (col >= p.Skv || (p.causal && col > row))) x = kNegInf;
        const float pr = expf(x - lse[i]);
        sdS[(rg + 16 * i) * kPStride + cg + 16 * jj] = pr * (dp[i][jj] -
                                                             dlt[i]);
      }
    }
    __syncthreads();  // dS's tile is complete
#pragma unroll 2
    for (int kk = 0; kk < kF32Tile; kk += 4) {
      float4 ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ds[i] = *reinterpret_cast<const float4*>(
            sdS + (rg + 16 * i) * kPStride + kk);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int m = 0; m < kNC; ++m) {
          const int c = cg + 16 * m;
          if (kC % 16 == 0 || c < kC) {
            const float4 kv =
                *reinterpret_cast<const float4*>(sK + (kk + t) * kS + 4 * c);
#pragma unroll
            for (int i = 0; i < 4; ++i) fma4(dq[i][m], comp(ds[i], t), kv);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with K_j and dS
    if (j + 1 < n_tiles) {
      load_rows_f32<D, kF32Tile>(sK, kb, p.k_ss, n0 + kF32Tile, p.Skv, tid);
    }
    cp_async_commit();
  }

  float* dqb = static_cast<float*>(p.dq) + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= p.Sq) continue;
#pragma unroll
    for (int m = 0; m < kNC; ++m) {
      const int c = cg + 16 * m;
      if (kC % 16 == 0 || c < kC) {
        *reinterpret_cast<float4*>(dqb + row * p.dq_ss + 4 * c) =
            scaled(dq[i][m], p.scale);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_bwd_dkv_f32_kernel(const FlashBwdParams p) {
  static_assert(D % 4 == 0, "whole 16-byte chunks a row");
  constexpr int kS = f32_stride(D);
  constexpr int kC = D / 4;
  constexpr int kNC = (kC + 15) / 16;
  extern __shared__ __align__(16) float smem_f32[];
  float* sK = smem_f32;
  float* sV = sK + kF32Rows * kS;
  float* sQ = sV + kF32Rows * kS;
  float* sdO = sQ + kF32Tile * kS;
  float* sPt = sdO + kF32Tile * kS;     // P^T: (key, query row)
  float* sdSt = sPt + kF32Rows * kPStride;
  float* sLse = sdSt + kF32Rows * kPStride;
  float* sDlt = sLse + kF32Tile;

  const int tid = threadIdx.x;
  const int kg = tid / 16;  // keys kg + 16i; dK/dV chunks qg + 16m
  const int qg = tid % 16;  // query rows qg + 16j of a tile

  const int bh = blockIdx.x;
  const int b = bh / p.Hkv;
  const int hk = bh % p.Hkv;
  const int G = p.H / p.Hkv;
  const int k0 = blockIdx.y * kF32Rows;  // earlier (heavier) tiles first

  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb +
                    hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb +
                    hk * p.v_sh;

  // Query tiles per head: from the first that sees key k0 (causal) on.
  const int nq = (p.Sq + kF32Tile - 1) / kF32Tile;
  const int first = p.causal ? min(k0 / kF32Tile, nq) : 0;
  const int count = nq - first;
  const int total = G * count;

  load_rows_f32<D, kF32Rows>(sK, kb, p.k_ss, k0, p.Skv, tid);
  load_rows_f32<D, kF32Rows>(sV, vb, p.v_ss, k0, p.Skv, tid);

  // Copy query tile `it` (head hk * G + it / count) into the tile buffers.
  auto fetch = [&](int it) {
    const int h = hk * G + it / count;
    const int i0 = (first + it % count) * kF32Tile;
    const float* qb = static_cast<const float*>(p.q) + b * p.q_sb +
                      h * p.q_sh;
    const float* dob = static_cast<const float*>(p.dout) + b * p.do_sb +
                       h * p.do_sh;
    load_rows_f32<D, kF32Tile>(sQ, qb, p.q_ss, i0, p.Sq, tid);
    load_rows_f32<D, kF32Tile>(sdO, dob, p.do_ss, i0, p.Sq, tid);
    if (tid < kF32Tile) {
      const int row = i0 + tid;
      const bool valid = row < p.Sq;
      const long long at = (static_cast<long long>(b) * p.H + h) * p.Sq +
                           (valid ? row : 0);
      cp_async4(sLse + tid, p.lse + at, valid);
      cp_async4(sDlt + tid, p.delta + at, valid);
    }
  };
  if (total > 0) fetch(0);
  cp_async_commit();

  float4 dk[4][kNC], dv[4][kNC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int m = 0; m < kNC; ++m) {
      dk[i][m] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv[i][m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  for (int it = 0; it < total; ++it) {
    cp_async_wait_all();  // tile `it` (and K, V) have landed
    __syncthreads();
    const int i0 = (first + it % count) * kF32Tile;

    // S^T = K Q^T and dP^T = V dO^T: keys kg + 16i x rows qg + 16j.
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        st[i][jj] = 0.f;
        dpt[i][jj] = 0.f;
      }
    }
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kv[4], vv[4], qv[4], dv4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = *reinterpret_cast<const float4*>(sK + (kg + 16 * i) * kS + d);
        vv[i] = *reinterpret_cast<const float4*>(sV + (kg + 16 * i) * kS + d);
        qv[i] = *reinterpret_cast<const float4*>(sQ + (qg + 16 * i) * kS + d);
        dv4[i] =
            *reinterpret_cast<const float4*>(sdO + (qg + 16 * i) * kS + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          st[i][jj] = dot4(kv[i], qv[jj], st[i][jj]);
          dpt[i][jj] = dot4(vv[i], dv4[jj], dpt[i][jj]);
        }
      }
    }

    const bool mask = (i0 + kF32Tile > p.Sq) ||
                      (p.causal && i0 < k0 + kF32Rows - 1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + kg + 16 * i;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = qg + 16 * jj;  // query row in the tile
        const int row = i0 + col;
        float x = st[i][jj] * p.scale;
        if (mask && (row >= p.Sq || (p.causal && row < key))) x = kNegInf;
        const float pr = expf(x - sLse[col]);
        sPt[(kg + 16 * i) * kPStride + col] = pr;
        sdSt[(kg + 16 * i) * kPStride + col] = pr * (dpt[i][jj] - sDlt[col]);
      }
    }
    __syncthreads();  // P^T and dS^T are complete

    // dV += P^T dO and dK += dS^T Q over the tile's query rows.
#pragma unroll 2
    for (int qq = 0; qq < kF32Tile; qq += 4) {
      float4 pt[4], dst[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pt[i] = *reinterpret_cast<const float4*>(
            sPt + (kg + 16 * i) * kPStride + qq);
        dst[i] = *reinterpret_cast<const float4*>(
            sdSt + (kg + 16 * i) * kPStride + qq);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int m = 0; m < kNC; ++m) {
          const int c = qg + 16 * m;
          if (kC % 16 == 0 || c < kC) {
            const float4 dov =
                *reinterpret_cast<const float4*>(sdO + (qq + t) * kS + 4 * c);
            const float4 qv =
                *reinterpret_cast<const float4*>(sQ + (qq + t) * kS + 4 * c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              fma4(dv[i][m], comp(pt[i], t), dov);
              fma4(dk[i][m], comp(dst[i], t), qv);
            }
          }
        }
      }
    }
    __syncthreads();  // every thread is done with the tile
    if (it + 1 < total) fetch(it + 1);
    cp_async_commit();
  }

  float* dkb = static_cast<float*>(p.dk) + b * p.dk_sb + hk * p.dk_sh;
  float* dvb = static_cast<float*>(p.dv) + b * p.dv_sb + hk * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + kg + 16 * i;
    if (key >= p.Skv) continue;
#pragma unroll
    for (int m = 0; m < kNC; ++m) {
      const int c = qg + 16 * m;
      if (kC % 16 == 0 || c < kC) {
        *reinterpret_cast<float4*>(dkb + key * p.dk_ss + 4 * c) =
            scaled(dk[i][m], p.scale);
        *reinterpret_cast<float4*>(dvb + key * p.dv_ss + 4 * c) = dv[i][m];
      }
    }
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory (opted in
// above 48 KB) on a (B * heads, tiles) grid.
template <typename Kernel>
int launch(Kernel kernel, int threads, int smem, int heads, int tiles,
           const FlashBwdParams& p, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(p.B * heads, tiles), threads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 forms' head dims (wgmma k-steps of 16 columns).
constexpr bool bf16_form(int D) { return D == 64 || D == 112 || D == 128; }

// The four bf16 (D, heads, rows, batch) maps of q, dO, k and v, boxes of
// 64 rows.  Returns 0 or a tensor-map error code.
int encode_maps(const FlashBwdParams& p, CUtensorMap (&tm)[4]) {
  int err = encode(&tm[0], p.q, p.D, p.H, p.Sq, p.B, p.q_sh, p.q_ss, p.q_sb,
                   kTile);
  if (err == 0) {
    err = encode(&tm[1], p.dout, p.D, p.H, p.Sq, p.B, p.do_sh, p.do_ss,
                 p.do_sb, kTile);
  }
  if (err == 0) {
    err = encode(&tm[2], p.k, p.D, p.Hkv, p.Skv, p.B, p.k_sh, p.k_ss, p.k_sb,
                 kTile);
  }
  if (err == 0) {
    err = encode(&tm[3], p.v, p.D, p.Hkv, p.Skv, p.B, p.v_sh, p.v_ss, p.v_sb,
                 kTile);
  }
  return err;
}

// Launch a bf16 kernel with `smem` bytes of dynamic shared memory on a 1-D
// grid of B * heads * tiles CTAs.
template <typename Kernel>
int launch_bf16(Kernel kernel, int smem, int heads, int tiles,
                const FlashBwdParams& p, cudaStream_t s) {
  CUtensorMap tm[4];
  const int err = encode_maps(p, tm);
  if (err != 0) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long ctas = static_cast<long long>(p.B) * heads * tiles;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(ctas), kBf16Threads, smem, s>>>(
      p, tm[0], tm[1], tm[2], tm[3], tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const FlashBwdParams& p, cudaStream_t s) {
  if (p.dtype == 0) {
    if constexpr (bf16_form(D)) {
      return launch_bf16(flash_bwd_dq_kernel<D>, DqSmem<D>::kBytes, p.H,
                         (p.Sq + kRowsDq - 1) / kRowsDq, p, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(flash_bwd_dq_f32_kernel<D>, kF32Threads,
                dq_f32_smem_bytes<D>(), p.H,
                (p.Sq + kF32Rows - 1) / kF32Rows, p, s);
}

template <int D>
int launch_dkv(const FlashBwdParams& p, cudaStream_t s) {
  if (p.dtype == 0) {
    if constexpr (bf16_form(D)) {
      return launch_bf16(flash_bwd_dkv_kernel<D>, DkvSmem<D>::kBytes, p.Hkv,
                         (p.Skv + kKeysDkv - 1) / kKeysDkv, p, s);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(flash_bwd_dkv_f32_kernel<D>, kF32Threads,
                dkv_f32_smem_bytes<D>(), p.Hkv,
                (p.Skv + kF32Rows - 1) / kF32Rows, p, s);
}

// The forms built here, (dtype, D): the wrapper's table
// (kernels/flash_attention.py::FORMS) must equal it.
bool has_form(int dtype, int D) {
  if (dtype == 0) return bf16_form(D);
  if (dtype == 1) {
    return D == 8 || D == 12 || D == 16 || D == 64 || D == 112 || D == 128;
  }
  return false;
}

template <bool kDq>
int dispatch(const FlashBwdParams& p, cudaStream_t s) {
  switch (p.D) {
    case 8: return kDq ? launch_dq<8>(p, s) : launch_dkv<8>(p, s);
    case 12: return kDq ? launch_dq<12>(p, s) : launch_dkv<12>(p, s);
    case 16: return kDq ? launch_dq<16>(p, s) : launch_dkv<16>(p, s);
    case 64: return kDq ? launch_dq<64>(p, s) : launch_dkv<64>(p, s);
    case 112: return kDq ? launch_dq<112>(p, s) : launch_dkv<112>(p, s);
    case 128: return kDq ? launch_dq<128>(p, s) : launch_dkv<128>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool valid_params(const FlashBwdParams& p) {
  return p.B > 0 && p.H > 0 && p.Hkv > 0 && p.H % p.Hkv == 0 && p.Sq > 0 &&
         p.Skv > 0 && has_form(p.dtype, p.D);
}

}  // namespace

// 1 if the library holds the form (dtype 0 bf16, 1 f32; head dim D).
extern "C" int flash_bwd_has_form(int dtype, int D) {
  return has_form(dtype, D) ? 1 : 0;
}

// dQ, and delta for the dK/dV kernel.  Launches on `stream`; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for shapes or a
// (dtype, D) it does not take (the f32 grid's y axis holds at most 65535
// tiles), or a tensor-map error of the bf16 form (flash_bwd_error_string
// names it).
extern "C" int flash_bwd_dq_launch(FlashBwdParams p, void* stream) {
  if (!valid_params(p) || (p.Sq + kF32Rows - 1) / kF32Rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<true>(p, static_cast<cudaStream_t>(stream));
}

// dK and dV; reads the delta that flash_bwd_dq_launch wrote.
extern "C" int flash_bwd_dkv_launch(FlashBwdParams p, void* stream) {
  if (!valid_params(p) || (p.Skv + kF32Rows - 1) / kF32Rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<false>(p, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_bwd_error_string(int err) {
  if (err == kNoEncoder) {
    return "the driver offers no cuTensorMapEncodeTiled";
  }
  if (err >= kEncodeError && err < kNoEncoder) {
    return "cuTensorMapEncodeTiled refused a tensor map of q, dO, k or v "
           "(CUresult: the code less 100000)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
