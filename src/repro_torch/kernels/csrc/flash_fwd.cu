// Causal (or full) flash-attention forward with GQA, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel` of
// src/repro/kernels/flash_attention.py:66 (launched by `_flash_fwd_pallas`
// under the `flash_attention` custom_vjp).  It computes what that kernel
// computes: for every (batch, query head, query row), the softmax over the
// keys it may see (causal: key <= query, aligned top-left, from 0 on both
// axes) of q.k * D**-0.5, applied to V, written as O in bf16, and the row's
// log-sum-exp `lse = m + log(max(l, 1e-30))` in f32.  Query head h reads
// KV head h / (H / Hkv).  Masked scores are -1e30, never -inf, so exp never
// yields NaN in the masked part of a tile.
//
// Design.  One CTA per (64-row query tile, batch * head), 4 warps of 16
// query rows each.  Q, K, V and O are read and written in the model's
// (B, S, H, D) layout through strides: no transposed copy.  The CTA walks
// 64-key K/V tiles up to the causal diagonal; each tile is copied into
// shared memory with cp.async (16 bytes a thread, rows past Skv
// zero-filled), V's copy overlapping S = Q K^T and the next K's copy
// overlapping P V.  Both products are warp-level mma.sync.m16n8k16 bf16
// with f32 accumulation; Q stays in registers as A fragments, S's
// accumulators become P's A fragments in place (P rounded to bf16).  The
// online softmax (running max m, partial row sum l, rescale of the O
// accumulator) is f32, in base 2 with log2(e) folded into the scale.  Only
// the last tile a CTA visits is masked (the diagonal, or the ragged end of
// the keys).  Heavier (later) query tiles are scheduled first.
//
// Bound.  At the serving shape of qwen3-1.7b (B 8, S 4096, H 16, Hkv 8,
// D 128, causal) the work is 0.55 TFLOP of tensor-core products, 0.556 ms
// at 989 TFLOP/s, against 0.40 GB of Q, K, V, O and lse, 0.121 ms at
// 3.35 TB/s: operations bound it.
//
// Left for a later design: wgmma (the only way to the full tensor-core
// rate), TMA copies driven by a producer warp with mbarriers, ldmatrix for
// the fragments, and a deeper K/V ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Passed by value from Python (ctypes), so it lives outside the unnamed
// namespace: the exported launcher's signature names it.  Strides are in
// elements; the head dimension is contiguous.
struct FlashParams {
  const void* q;  // (B, Sq, H, D) bf16
  const void* k;  // (B, Skv, Hkv, D) bf16
  const void* v;  // (B, Skv, Hkv, D) bf16
  void* o;        // (B, Sq, H, D) bf16
  float* lse;     // (B, H, Sq) f32, contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, H, Hkv, Sq, Skv, D;  // D must be 128
  int causal;
  float scale_log2;  // D**-0.5 * log2(e)
};

namespace {

constexpr int D = 128;       // head dim
constexpr int kBlockM = 64;  // query rows per CTA
constexpr int kBlockN = 64;  // keys per K/V tile
constexpr int kWarps = 4;    // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.69314718055994530942f;

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

// Copy keys [n0, n0 + kBlockN) of one KV head into a padded smem tile.
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* base,
                                          long long s_stride, int n0, int skv,
                                          int tid) {
  constexpr int kStride = D + 8;
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
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

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashParams p) {
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

  load_tile(sK, kb, p.k_ss, 0, p.Skv, tid);
  cp_async_commit();
  load_tile(sV, vb, p.v_ss, 0, p.Skv, tid);
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
    if (j + 1 < n_tiles) load_tile(sK, kb, p.k_ss, n0 + kBlockN, p.Skv, tid);
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
    if (j + 1 < n_tiles) load_tile(sV, vb, p.v_ss, n0 + kBlockN, p.Skv, tid);
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

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int flash_fwd_launch(FlashParams p, void* stream) {
  if (p.B <= 0 || p.H <= 0 || p.Hkv <= 0 || p.H % p.Hkv != 0 ||
      p.Sq <= 0 || p.Skv <= 0 || p.D != D ||
      (p.Sq + kBlockM - 1) / kBlockM > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(p.B * p.H, (p.Sq + kBlockM - 1) / kBlockM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  flash_fwd_kernel<<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
