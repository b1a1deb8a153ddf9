// Flash attention for Hopper (sm_90a): forward, and the backward as two
// kernels (dQ; dK and dV).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   _fwd (body _fwd_kernel)       -> flash_fwd_wgmma_kernel (bf16)
//                                    flash_fwd_kernel (f32)
//   _bwd (body _bwd_dq_kernel)    -> flash_bwd_dq_wgmma_kernel (bf16)
//                                    flash_bwd_dq_kernel (f32)
//   _bwd (body _bwd_dkv_kernel)   -> flash_bwd_dkv_wgmma_kernel (bf16)
//                                    flash_bwd_dkv_kernel (f32)
//
//   q [B, Lq, H, D]; k, v [B, Lk, H, D] (the strides of each family are
//   arguments: the f32 kernels read them directly, the bf16 kernels give
//   them to TMA's tensor maps)
//   out = softmax(q.k^T * scale) . v, lse [B, H, Lq] f32 (natural log)
//   causal: key j is visible from query i iff q_off + i >= k_off + j
//   dropout on the probabilities with the denominator undropped:
//     keep iff bits16(seed, b*H + h, i, j) >= t, t = round(p * 65536),
//     kept values scaled by 65536 / (65536 - t); t = 0 keeps everything
//     (bit-equal to no dropout), t = 65536 drops everything
//   fully masked rows give out = 0 and lse = -1e30, as on the TPU.
//   D in {32, 64, 96, 128}.
//
// The dropout bits are a counter-based hash of the element's indices
// (murmur3's finaliser, two 16-bit draws per 32-bit hash: keys 2j and
// 2j+1 of one query row share a hash).  Every kernel regenerates the
// same mask whatever its tiling, and the plain PyTorch version
// (ops/flash_attention.py: dropout_keep_mask) reproduces it bit for bit.
// The TPU kernel seeded its PRNG per (seed, b, h, q-block, k-block)
// instead, so its mask depended on the block shapes.
//
// Bound on this card, at BERT-base (B 64, H 12, L 512, D 64, bf16):
// the forward does 4.BHL^2.D = 51.5 GFLOP (0.052 ms at 989 TFLOP/s) and
// moves q, k, v, out and lse, 201 MB (0.060 ms at 3.35 TB/s): nearly
// balanced.  The backward needs five L^2.D products (129 GFLOP); the
// split into a dQ and a dK/dV kernel recomputes S and dP in both, seven
// products.  Dropout adds ~10 integer operations per hash, one hash
// per two elements (forward, dQ) or per element (dK/dV).
//
// What the bf16 design does about it: wgmma, the only way to the tensor
// cores' full rate, fed by TMA, one block a tile of 128 rows in two
// warpgroups (256 threads: a thread may hold 255 registers, which dK and
// dV at D 128 need; a separate producer warp would cap it at 168):
//   * thread 0 loads the block's resident operand once and streams the
//     other through a ring of 3 stages in shared memory, each guarded by
//     full mbarriers (TMA completes them) and an empty one (each warp
//     arrives when done with it); it refills a stage as soon as both
//     warpgroups have let it go, two tiles ahead of the compute;
//   * the two warpgroups own 64 rows each.  The score products
//     take both operands from shared memory (wgmma m64nNk16, K-major),
//     the scores stay in the f32 accumulator registers through the mask,
//     softmax (branch-free, exp2 on the special-function unit) and
//     dropout, and the probabilities (or dS) feed the next
//     product straight from registers, rounded to bf16, as wgmma's A
//     operand, with the streamed tile read MN-major (the transpose flag)
//     as B:
//       forward  S = Q.K^T (128 keys a tile), O += P.V;
//       dQ       S = Q.K^T, dP = dO.V^T (64 keys a tile), dQ += dS.K;
//       dK, dV   S^T = K.Q^T, dP^T = V.dO^T (64 queries a tile),
//                dV += U^T.dO, dK += dS^T.Q;
//   * TMA reads the [B, L, H, D] tensors in place through rank-4 tensor
//     maps (D, H, L, B) with boxes of (W, 1, rows, 1): each box lands as a
//     plain [rows][W] tile, W = 64 (128-byte swizzle) where D is a
//     multiple of 64, else 32 (64-byte swizzle), so every head dim is a
//     whole number of boxes (D 96 is three of 32) and no column is
//     padded.  A ragged L reads TMA's zero fill, and the masks drop those
//     rows.
//   * causal blocks stop at the diagonal (forward, dQ; their tiles run
//     heaviest first) or start there (dK/dV); only the tiles that cross
//     the diagonal or the ragged end evaluate the mask;
//   * the backward has no atomics: each output element is summed by one
//     block in a fixed order, so it is bitwise deterministic.
// f32 inputs stay exact f32 on the CUDA cores (no TF32, no 3xTF32).  The
// forward (flash_fwd_kernel): one block of 4 warps per (b, h, 64-row
// tile), each warp 16 rows in the mma.sync C-fragment layout, the
// streamed operand double-buffered by cp.async, products by FMA.  The
// backward (flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel): one block
// of 256 threads per (b, h, 128-row tile; 64 rows at D 96 and 128, where
// dK and dV fill the registers), every product an outer product of
// register tiles (8 x 4 a thread at D 64: 48 values read from shared
// memory as float4 for 128 FMAs), P, U and dS through shared memory in
// the layout the next product reads, the streamed tiles double-buffered
// by cp.async.  dQ: S = Q.K^T and dP = dO.V^T over 64-key tiles, dQ +=
// dS.K; dK/dV: S^T = K.Q^T and dP^T = V.dO^T over 64-query tiles (32
// above D 64), dV += U^T.dO, dK += dS^T.Q.  Each output sums in a fixed
// order, no atomics.  What bounds them: the FMA pipe and the shared
// memory reads beside it, and the element-wise work (exp2, mask,
// dropout hash) between barriers that one block an SM does not overlap
// with products (PERF.md).

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;      // backward input
  const float* delta;    // backward input
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  long long qb, qh, ql;  // element strides of q, out, dout, dq
  long long kb, kh, kl;  // element strides of k, v, dk, dv
  int B, H, Lq, Lk;
  float scale;           // softmax scale
  float scale_log2;      // scale * log2(e)
  int causal, q_off, k_off;
  unsigned seed;
  int drop_t;            // 0 (no dropout) .. 65536 (drop everything)
  float drop_scale;      // 65536 / (65536 - t), 0 when t = 65536
};

// ------------------------------------------------------------ the hash
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, uint32_t bh,
                                            uint32_t q) {
  return fmix32(fmix32(seed * 0x9E3779B1u ^ bh * 0x85EBCA77u) ^
                q * 0xC2B2AE3Du);
}

__device__ __forceinline__ uint32_t pair_bits(uint32_t rk, uint32_t kpair) {
  return fmix32(rk ^ kpair * 0x27D4EB2Fu);
}

// ----------------------------------------------------- small utilities
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// 2^x by the special-function unit (max relative error ~2^-22, flushes
// subnormals): the bf16 kernels' probabilities, rounded to bf16 next, and
// the f32 backward's (within its 2e-5 tolerance)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  return kj < p.Lk && qi < p.Lq && (!p.causal || kj + p.k_off <= qi + p.q_off);
}

__device__ __forceinline__ float keep_factor(const Params& p, uint32_t bits) {
  return (int)bits >= p.drop_t ? p.drop_scale : 0.f;
}

// 1 where a 16-bit draw keeps its element
__device__ __forceinline__ uint32_t keep_bit(const Params& p, uint32_t bits) {
  return (int)bits >= p.drop_t ? 1u : 0u;
}

// the factor of element i of a keep mask: 1 / (1 - p) kept, 0 dropped
__device__ __forceinline__ float kept_factor(const Params& p, uint32_t mask,
                                             int i) {
  return (mask >> i) & 1u ? p.drop_scale : 0.f;
}

// number of key tiles of `tile` rows a query block [q0, q0 + rows) needs
__device__ __forceinline__ int key_tiles(const Params& p, int q0, int rows,
                                         int tile) {
  int n = (p.Lk + tile - 1) / tile;
  if (p.causal) {
    const int last = min(p.Lq, q0 + rows) - 1 + p.q_off - p.k_off;
    n = min(n, last < 0 ? 0 : last / tile + 1);
  }
  return n;
}

// ================================================ f32: FMA, CUDA cores
namespace f32 {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;   // rows one block owns
constexpr int kTile = 64;            // rows of a streamed tile

// smem row stride in elements: rows padded by 16 bytes
template <int D>
struct Smem {
  static constexpr int S = D + 4;
};

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// rows [row0, row0 + rows) of one (b, h) slice -> smem, asynchronously;
// rows at or past `valid` are zero.  Every thread of the block takes
// part; the caller commits the group.
template <int D>
__device__ __forceinline__ void load_tile(float* sm, const float* g,
                                          long long row_stride, int row0,
                                          int valid, int rows) {
  constexpr int E = 4;                 // elements per 16-byte vector
  constexpr int VPR = D / E;
  constexpr int S = Smem<D>::S;
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * E;
    const bool ok = row0 + r < valid;
    cp_async16(sm + r * S + c,
               ok ? g + (long long)(row0 + r) * row_stride + c : g, ok);
  }
}

// The accumulators are mma.sync m16n8 C fragments: lane (g = lane / 4,
// t = lane % 4) holds c[n][0..1] at row g, cols 8n + 2t + {0, 1} and
// c[n][2..3] at row g + 8, the same cols.

// C[16 x 8NT] += A[16 x KD] . B[8NT x KD]^T, A and B row-major in smem
// with row stride S (A: this warp's 16 rows)
template <int NT, int KD, int S>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4], const float* A,
                                        const float* B, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int k = 0; k < KD; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(A + g * S + k);
    const float4 x1 = *reinterpret_cast<const float4*>(A + (g + 8) * S + k);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b = B + (n * 8 + 2 * t) * S + k;
      const float4 y0 = *reinterpret_cast<const float4*>(b);
      const float4 y1 = *reinterpret_cast<const float4*>(b + S);
      float c0 = c[n][0], c1 = c[n][1], c2 = c[n][2], c3 = c[n][3];
      c0 = fmaf(x0.x, y0.x, c0); c0 = fmaf(x0.y, y0.y, c0);
      c0 = fmaf(x0.z, y0.z, c0); c0 = fmaf(x0.w, y0.w, c0);
      c1 = fmaf(x0.x, y1.x, c1); c1 = fmaf(x0.y, y1.y, c1);
      c1 = fmaf(x0.z, y1.z, c1); c1 = fmaf(x0.w, y1.w, c1);
      c2 = fmaf(x1.x, y0.x, c2); c2 = fmaf(x1.y, y0.y, c2);
      c2 = fmaf(x1.z, y0.z, c2); c2 = fmaf(x1.w, y0.w, c2);
      c3 = fmaf(x1.x, y1.x, c3); c3 = fmaf(x1.y, y1.y, c3);
      c3 = fmaf(x1.z, y1.z, c3); c3 = fmaf(x1.w, y1.w, c3);
      c[n][0] = c0; c[n][1] = c1; c[n][2] = c2; c[n][3] = c3;
    }
  }
}

// C[16 x 8NT] += P[16 x 8KT] . B[8KT x 8NT]: P is this warp's C fragment
// of an earlier product (held in registers), B row-major in smem
template <int NT, int KT, int S>
__device__ __forceinline__ void gemm_nn(float (&c)[NT][4],
                                        const float (&p)[KT][4],
                                        const float* B, int lane) {
  const int t = lane & 3, quad = lane & ~3;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      // column 8j + e of rows g and g + 8 lives in lane quad + e / 2
      const float ag = __shfl_sync(kFull, p[j][e & 1], quad | (e >> 1));
      const float ag8 = __shfl_sync(kFull, p[j][2 + (e & 1)], quad | (e >> 1));
      const float* b = B + (8 * j + e) * S + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(b + 8 * n);
        c[n][0] = fmaf(ag, y.x, c[n][0]);
        c[n][1] = fmaf(ag, y.y, c[n][1]);
        c[n][2] = fmaf(ag8, y.x, c[n][2]);
        c[n][3] = fmaf(ag8, y.y, c[n][3]);
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

}  // namespace f32

// ------------------------------------------------------- f32 forward
template <int D>
__global__ void __launch_bounds__(f32::kThreads)
flash_fwd_kernel(const Params p) {
  using namespace f32;
  constexpr int S = Smem<D>::S, NK = kTile / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Kb = Qs + kRows * S;          // two K tiles, then two V tiles
  float* Vb = Kb + 2 * kTile * S;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* q = static_cast<const float*>(p.q) + b * p.qb + h * p.qh;
  const float* k = static_cast<const float*>(p.k) + b * p.kb + h * p.kh;
  const float* v = static_cast<const float*>(p.v) + b * p.kb + h * p.kh;
  const int nkt = key_tiles(p, q0, kRows, kTile);
  load_tile<D>(Qs, q, p.ql, q0, p.Lq, kRows);
  if (nkt > 0) {
    load_tile<D>(Kb, k, p.kl, 0, p.Lk, kTile);
    load_tile<D>(Vb, v, p.kl, 0, p.Lk, kTile);
  }
  cp_async_commit();
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const bool drop = p.drop_t > 0;
  const uint32_t bh = (uint32_t)(b * p.H + h);
  uint32_t rk[2] = {0u, 0u};
  if (drop) {
    rk[0] = row_key(p.seed, bh, row[0]);
    rk[1] = row_key(p.seed, bh, row[1]);
  }
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[ND][4];
  zero(acc);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {                // the next tile, while this one runs
      const int nb = ((kt + 1) & 1) * kTile * S;
      load_tile<D>(Kb + nb, k, p.kl, (kt + 1) * kTile, p.Lk, kTile);
      load_tile<D>(Vb + nb, v, p.kl, (kt + 1) * kTile, p.Lk, kTile);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const float* Ks = Kb + (kt & 1) * kTile * S;
    const float* Vs = Vb + (kt & 1) * kTile * S;
    float s[NK][4];
    zero(s);
    gemm_nt<NK, D, S>(s, Qs + warp * 16 * S, Ks, lane);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt * kTile + n * 8 + 2 * t + (e & 1);
        const float x = visible(p, row[e >> 1], col)
                            ? s[n][e] * p.scale_log2 : kNeg;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float pr = x > 0.5f * kNeg ? exp2f(x - m[e >> 1]) : 0.f;
        l[e >> 1] += pr;     // the denominator is undropped
        s[n][e] = pr;
      }
      if (drop) {
        const uint32_t kp = (uint32_t)(kt * kTile + n * 8 + 2 * t) >> 1;
        const uint32_t x0 = pair_bits(rk[0], kp), x1 = pair_bits(rk[1], kp);
        s[n][0] *= keep_factor(p, x0 & 0xFFFFu);
        s[n][1] *= keep_factor(p, x0 >> 16);
        s[n][2] *= keep_factor(p, x1 & 0xFFFFu);
        s[n][3] *= keep_factor(p, x1 >> 16);
      }
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }
    gemm_nn<ND, NK, S>(acc, s, Vs, lane);
    __syncthreads();                   // this buffer is refilled next
  }
  cp_async_wait_all();
  float* out = static_cast<float*>(p.out) + b * p.qb + h * p.qh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (row[r] >= p.Lq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    float* o = out + (long long)row[r] * p.ql + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(o + n * 8, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0)
      p.lse_out[(long long)bh * p.Lq + row[r]] =
          lr > 0.f ? m[r] * kLn2 + logf(lr) : kNeg;
  }
}

// ================================ f32 backward: register-tiled FMA
// One block of 256 threads, (ty, tx) = (tid / 16, tid % 16).  Each
// product is an outer product of register tiles: thread (ty, tx) owns
// rows ty * RM + i of a block's resident rows and, in a score tile, the
// streamed rows tx + 16 j (NT products, both operands read as float4
// along the head dim), or, in an output tile, the head-dim columns
// tx * RD + c (NN products: the first operand read as float4 along its
// depth, the second as float4 / float2 along the columns).  P, U and dS
// go to shared memory in the layout the next product reads.
namespace rt {

constexpr int kThreads = 256;

// tile sizes by head dim: BM resident rows (queries in dQ, keys in
// dK/dV), BK keys a dQ step, BQ queries a dK/dV step; rows padded by 16
// bytes in shared memory
template <int D>
struct Bwd {
  static constexpr int BM = D <= 64 ? 128 : 64;
  static constexpr int BK = 64;
  static constexpr int BQ = D <= 64 ? 64 : 32;
  static constexpr int S = D + 4;
  static constexpr int RM = BM / 16;
  static constexpr int RD = D / 16;
  static constexpr size_t kDqSmem =
      (size_t)(2 * BM * S + 4 * BK * S + BM * (BK + 4)) * 4;
  static constexpr size_t kDkvSmem =
      (size_t)(2 * BM * S + 4 * BQ * S + 2 * BM * (BQ + 4) + 6 * BQ) * 4;
};

// rows [row0, row0 + rows) of one (b, h) slice -> sm (stride D + 4),
// asynchronously; rows at or past `valid` are zero.  Every thread of the
// block takes part; the caller commits the group.
template <int D>
__device__ __forceinline__ void load_rows(float* sm, const float* g,
                                          long long row_stride, int row0,
                                          int valid, int rows) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 4;
    const bool ok = row0 + r < valid;
    f32::cp_async16(sm + r * (D + 4) + c,
                    ok ? g + (long long)(row0 + r) * row_stride + c : g, ok);
  }
}

// acc[i][j] += sum_d a[i * SA + d] * b[16 j * SB + d], d < KD (a at the
// thread's first row, b at its first streamed row)
template <int RM, int RN, int KD, int SA, int SB>
__device__ __forceinline__ void nt(float (&acc)[RM][RN],
                                   const float* __restrict__ a,
                                   const float* __restrict__ b) {
#pragma unroll 2
  for (int d = 0; d < KD; d += 4) {
    float4 x[RM], y[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + i * SA + d);
#pragma unroll
    for (int j = 0; j < RN; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + 16 * j * SB + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float c = acc[i][j];
        c = fmaf(x[i].x, y[j].x, c);
        c = fmaf(x[i].y, y[j].y, c);
        c = fmaf(x[i].z, y[j].z, c);
        c = fmaf(x[i].w, y[j].w, c);
        acc[i][j] = c;
      }
  }
}

// RN consecutive floats (RN a multiple of 2; 16-byte loads where RN is a
// multiple of 4)
template <int RN>
__device__ __forceinline__ void load_cols(float (&y)[RN], const float* p) {
  if constexpr (RN % 4 == 0) {
#pragma unroll
    for (int c = 0; c < RN; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      y[c] = v.x; y[c + 1] = v.y; y[c + 2] = v.z; y[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < RN; c += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + c);
      y[c] = v.x; y[c + 1] = v.y;
    }
  }
}

// acc[i][c] += sum_k a[i * SA + k] * b[k * SB + c], k < KD (a at the
// thread's first row, b at its first column)
template <int RM, int RN, int KD, int SA, int SB>
__device__ __forceinline__ void nn(float (&acc)[RM][RN],
                                   const float* __restrict__ a,
                                   const float* __restrict__ b) {
#pragma unroll 2
  for (int k = 0; k < KD; k += 4) {
    float4 x[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + i * SA + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float y[RN];
      load_cols<RN>(y, b + (k + kk) * SB);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float xv = kk == 0 ? x[i].x : kk == 1 ? x[i].y
                         : kk == 2 ? x[i].z : x[i].w;
#pragma unroll
        for (int c = 0; c < RN; ++c) acc[i][c] = fmaf(xv, y[c], acc[i][c]);
      }
    }
  }
}

template <int RM, int RN>
__device__ __forceinline__ void zero(float (&c)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) c[i][j] = 0.f;
}

// a thread's RM x RN outputs at rows row0 + i (< valid), columns
// col0 + c, row stride ld
template <int RM, int RN>
__device__ __forceinline__ void store_rows(float* o, const float (&c)[RM][RN],
                                           long long ld, int row0,
                                           int valid, int col0) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    if (row0 + i >= valid) continue;
    float* p = o + (long long)(row0 + i) * ld + col0;
#pragma unroll
    for (int k = 0; k < RN; k += 2) store2(p + k, c[i][k], c[i][k + 1]);
  }
}

}  // namespace rt

// ---------------------------------------------------- f32 backward: dQ
// One block per (b, h, BM-query tile); the key and value tiles (BK rows)
// stream through a double buffer by cp.async.  Per tile: S = Q.K^T and
// dP = dO.V^T (thread: RM queries x 4 keys, keys tx + 16 j), dS into
// shared memory, dQ += dS.K (thread: RM queries x RD columns).
template <int D>
__global__ void __launch_bounds__(rt::kThreads, 1)
flash_bwd_dq_f32_kernel(const Params p) {
  using C = rt::Bwd<D>;
  constexpr int BM = C::BM, BK = C::BK, S = C::S, RM = C::RM, RD = C::RD;
  constexpr int RK = BK / 16, SP = BK + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BM * S;
  float* Kb = dOs + BM * S;            // two K tiles, then two V tiles
  float* Vb = Kb + 2 * BK * S;
  float* dSs = Vb + 2 * BK * S;        // [BM][SP]
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long qoff = b * p.qb + h * p.qh, koff = b * p.kb + h * p.kh;
  const float* k = static_cast<const float*>(p.k) + koff;
  const float* v = static_cast<const float*>(p.v) + koff;
  const int nkt = key_tiles(p, q0, BM, BK);
  rt::load_rows<D>(Qs, static_cast<const float*>(p.q) + qoff, p.ql, q0, p.Lq,
                   BM);
  rt::load_rows<D>(dOs, static_cast<const float*>(p.dout) + qoff, p.ql, q0,
                   p.Lq, BM);
  if (nkt > 0) {
    rt::load_rows<D>(Kb, k, p.kl, 0, p.Lk, BK);
    rt::load_rows<D>(Vb, v, p.kl, 0, p.Lk, BK);
  }
  f32::cp_async_commit();
  const int r0 = q0 + ty * RM;         // the thread's first query
  const bool drop = p.drop_t > 0;
  const uint32_t bh = (uint32_t)(b * p.H + h);
  const int odd = tx & 1;              // its keys' parity
  float lse2[RM], dl[RM];
  uint32_t rk[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const bool ok = r0 + i < p.Lq;
    lse2[i] = ok ? p.lse[(long long)bh * p.Lq + r0 + i] * kLog2e : 0.f;
    dl[i] = ok ? p.delta[(long long)bh * p.Lq + r0 + i] : 0.f;
    rk[i] = drop ? row_key(p.seed, bh, r0 + i) : 0u;
  }
  float dq[RM][RD];
  rt::zero(dq);
  for (int kt = 0; kt < nkt; ++kt) {
    f32::cp_async_wait_all();
    __syncthreads();                   // tile kt is in; tile kt-1 is done
    if (kt + 1 < nkt) {
      const int nb = ((kt + 1) & 1) * BK * S;
      rt::load_rows<D>(Kb + nb, k, p.kl, (kt + 1) * BK, p.Lk, BK);
      rt::load_rows<D>(Vb + nb, v, p.kl, (kt + 1) * BK, p.Lk, BK);
    }
    f32::cp_async_commit();
    const float* Ks = Kb + (kt & 1) * BK * S;
    const float* Vs = Vb + (kt & 1) * BK * S;
    float s[RM][RK], dp[RM][RK];
    rt::zero(s);
    rt::zero(dp);
    rt::nt<RM, RK, D, S, S>(s, Qs + ty * RM * S, Ks + tx * S);
    rt::nt<RM, RK, D, S, S>(dp, dOs + ty * RM * S, Vs + tx * S);
    const int key0 = kt * BK;
    // only tiles that cross the ragged ends or the diagonal test masks
    const bool edge = key0 + BK > p.Lk || q0 + BM > p.Lq ||
                      (p.causal && key0 + BK - 1 + p.k_off > q0 + p.q_off);
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      const int key = key0 + tx + 16 * j;
#pragma unroll
      for (int i2 = 0; i2 < RM; i2 += 2) {
        // keys 2m and 2m + 1 sit in lanes tx and tx ^ 1 and share a
        // hash: each lane hashes one of the two rows and swaps
        float kf[2] = {1.f, 1.f};
        if (drop) {
          const uint32_t mine = pair_bits(odd ? rk[i2 + 1] : rk[i2],
                                          (uint32_t)key >> 1);
          const uint32_t other = __shfl_xor_sync(kFull, mine, 1);
          const uint32_t x0 = odd ? other : mine, x1 = odd ? mine : other;
          kf[0] = keep_factor(p, odd ? x0 >> 16 : x0 & 0xFFFFu);
          kf[1] = keep_factor(p, odd ? x1 >> 16 : x1 & 0xFFFFu);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = i2 + e;
          float pr = fast_exp2(s[i][j] * p.scale_log2 - lse2[i]);
          if (edge && !visible(p, r0 + i, key)) pr = 0.f;
          // dS = (u . dP - P . delta) * scale, u = P * keep / (1 - p)
          dSs[(ty * RM + i) * SP + tx + 16 * j] =
              (pr * kf[e] * dp[i][j] - pr * dl[i]) * p.scale;
        }
      }
    }
    __syncthreads();
    rt::nn<RM, RD, BK, SP, S>(dq, dSs + ty * RM * SP, Ks + tx * RD);
  }
  f32::cp_async_wait_all();
  rt::store_rows(static_cast<float*>(p.dq) + qoff, dq, p.ql, r0, p.Lq,
                 tx * RD);
}

// ------------------------------------------------ f32 backward: dK, dV
// One block per (b, h, BM-key tile); the query, dO, lse, delta and
// dropout-row-key tiles (BQ rows) stream through a double buffer.  The
// products are taken transposed: S^T = K.Q^T and dP^T = V.dO^T (thread:
// RM keys x BQ / 16 queries, queries tx + 16 j), U^T and dS^T into
// shared memory, dV += U^T.dO and dK += dS^T.Q (thread: RM keys x RD
// columns).  A thread's keys come in pairs (2m, 2m + 1), one hash each.
template <int D>
__global__ void __launch_bounds__(rt::kThreads, 1)
flash_bwd_dkv_f32_kernel(const Params p) {
  using C = rt::Bwd<D>;
  constexpr int BM = C::BM, BQ = C::BQ, S = C::S, RM = C::RM, RD = C::RD;
  constexpr int RQ = BQ / 16, SP = BQ + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BM * S;
  float* Qb = Vs + BM * S;             // two Q tiles, then two dO tiles
  float* dOb = Qb + 2 * BQ * S;
  float* Us = dOb + 2 * BQ * S;        // [BM][SP]
  float* dSs = Us + BM * SP;           // [BM][SP]
  float* lse_b = dSs + BM * SP;        // [2][BQ]
  float* delta_b = lse_b + 2 * BQ;     // [2][BQ]
  uint32_t* rk_b = reinterpret_cast<uint32_t*>(delta_b + 2 * BQ);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long qoff = b * p.qb + h * p.qh, koff = b * p.kb + h * p.kh;
  const float* q = static_cast<const float*>(p.q) + qoff;
  const float* dout = static_cast<const float*>(p.dout) + qoff;
  const bool drop = p.drop_t > 0;
  const uint32_t bh = (uint32_t)(b * p.H + h);
  const int nqt = (p.Lq + BQ - 1) / BQ;
  int start = 0;
  if (p.causal) {        // the first query that sees key k0
    const int first = k0 + p.k_off - p.q_off;
    start = first <= 0 ? 0 : first / BQ;
  }
  // query tile qt -> buffer `buf`: Q and dO by cp.async, the per-row
  // lse (log2 units), delta and dropout row keys by plain stores
  auto stage = [&](int qt, int buf) {
    rt::load_rows<D>(Qb + buf * BQ * S, q, p.ql, qt * BQ, p.Lq, BQ);
    rt::load_rows<D>(dOb + buf * BQ * S, dout, p.ql, qt * BQ, p.Lq, BQ);
    for (int i = tid; i < BQ; i += rt::kThreads) {
      const int qi = qt * BQ + i;
      const bool ok = qi < p.Lq;
      lse_b[buf * BQ + i] =
          ok ? p.lse[(long long)bh * p.Lq + qi] * kLog2e : 0.f;
      delta_b[buf * BQ + i] = ok ? p.delta[(long long)bh * p.Lq + qi] : 0.f;
      if (drop) rk_b[buf * BQ + i] = row_key(p.seed, bh, qi);
    }
  };
  rt::load_rows<D>(Ks, static_cast<const float*>(p.k) + koff, p.kl, k0, p.Lk,
                   BM);
  rt::load_rows<D>(Vs, static_cast<const float*>(p.v) + koff, p.kl, k0, p.Lk,
                   BM);
  if (start < nqt) stage(start, 0);
  f32::cp_async_commit();
  const int key0 = k0 + ty * RM;       // the thread's first key (even)
  float dk[RM][RD], dv[RM][RD];
  rt::zero(dk);
  rt::zero(dv);
  for (int qt = start; qt < nqt; ++qt) {
    const int buf = (qt - start) & 1;
    f32::cp_async_wait_all();
    __syncthreads();                   // tile qt is in; tile qt-1 is done
    if (qt + 1 < nqt) stage(qt + 1, buf ^ 1);
    f32::cp_async_commit();
    const float* Qs = Qb + buf * BQ * S;
    const float* dOs = dOb + buf * BQ * S;
    const float* lse_s = lse_b + buf * BQ;
    const float* delta_s = delta_b + buf * BQ;
    const uint32_t* rk_s = rk_b + buf * BQ;
    float s[RM][RQ], dp[RM][RQ];
    rt::zero(s);
    rt::zero(dp);
    rt::nt<RM, RQ, D, S, S>(s, Ks + ty * RM * S, Qs + tx * S);
    rt::nt<RM, RQ, D, S, S>(dp, Vs + ty * RM * S, dOs + tx * S);
    const int qb0 = qt * BQ;
    const bool edge = k0 + BM > p.Lk || qb0 + BQ > p.Lq ||
                      (p.causal && k0 + BM - 1 + p.k_off > qb0 + p.q_off);
#pragma unroll
    for (int j = 0; j < RQ; ++j) {
      const int c = tx + 16 * j, qi = qb0 + c;
      const float lq = lse_s[c], dq = delta_s[c];
#pragma unroll
      for (int i2 = 0; i2 < RM; i2 += 2) {
        const uint32_t x = drop ? pair_bits(rk_s[c],
                                            (uint32_t)(key0 + i2) >> 1)
                                : 0u;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = i2 + e;
          float pr = fast_exp2(s[i][j] * p.scale_log2 - lq);
          if (edge && !visible(p, qi, key0 + i)) pr = 0.f;
          const float u =
              drop ? pr * keep_factor(p, e ? x >> 16 : x & 0xFFFFu) : pr;
          Us[(ty * RM + i) * SP + c] = u;
          dSs[(ty * RM + i) * SP + c] = (u * dp[i][j] - pr * dq) * p.scale;
        }
      }
    }
    __syncthreads();
    rt::nn<RM, RD, BQ, SP, S>(dv, Us + ty * RM * SP, dOs + tx * RD);
    rt::nn<RM, RD, BQ, SP, S>(dk, dSs + ty * RM * SP, Qs + tx * RD);
  }
  f32::cp_async_wait_all();
  rt::store_rows(static_cast<float*>(p.dk) + koff, dk, p.kl, key0, p.Lk,
                 tx * RD);
  rt::store_rows(static_cast<float*>(p.dv) + koff, dv, p.kl, key0, p.Lk,
                 tx * RD);
}

// ======================================== bf16: wgmma, TMA, warpgroups
namespace wg {

// two warpgroups of 64 rows: 8 warps, two on each of the SM's four
// register files, so a thread may hold up to 255 registers (a ninth warp
// would put three on one file and cap every thread at 168)
constexpr int kThreads = 256;
// a stage is released by each warp once its wgmma.wait_group has seen
// the products that read it: the wait speaks for the warp's rows
constexpr int kReleasers = 8;

// A [rows][D] tile in shared memory is D / W boxes of [rows][W], one after
// the other: W = 64 columns (128-byte rows, 128-byte swizzle) where D is
// a multiple of 64, else 32 (64-byte rows, 64-byte swizzle), so every
// head dim is a whole number of boxes (D 96 is three) and no column is
// padded.
template <int D>
struct Tile {
  static constexpr int kCols = D % 64 == 0 ? 64 : 32;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kBoxes = D / kCols;
  static constexpr int kSteps = kCols / 16;          // k steps a box
  static constexpr uint64_t kSwizzle = kCols == 64 ? kSwizzle128
                                                   : kSwizzle64;
  static constexpr uint32_t kGroup = 8 * kRowBytes;  // 8 rows
  static constexpr uint32_t bytes(int rows) {
    return (uint32_t)rows * D * 2;
  }
};

// the tensor maps of q, k, v and dout over [B, L, H, D]
struct Maps {
  CUtensorMap q, k, v, dout;
};

// K-major operand: rows [row0, row0 + 64 or N) of a [rows][D] tile at
// `tile`, k step kk (16 columns) of the head dim
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                           int kk) {
  using T = Tile<D>;
  return wgmma_desc(tile + (kk / T::kSteps) * rows * T::kRowBytes +
                        row0 * T::kRowBytes + (kk % T::kSteps) * 32,
                    1, T::kGroup >> 4, T::kSwizzle);
}

// MN-major B operand: rows 16 kk .. 16 kk + 15 of a [rows][D] tile (the k
// of the product), all D columns (its N): one column block a box
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  using T = Tile<D>;
  return wgmma_desc(tile + kk * 16 * T::kRowBytes,
                    (uint32_t)(rows * T::kRowBytes) >> 4, T::kGroup >> 4,
                    T::kSwizzle);
}

// d += a . b for b MN-major, N = D
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 32) wgmma_rs_m64n32k16(d, a, b);
  else if constexpr (D == 64) wgmma_rs_m64n64k16(d, a, b);
  else if constexpr (D == 96) wgmma_rs_m64n96k16(d, a, b);
  else wgmma_rs_m64n128k16(d, a, b);
}

// 4 bytes global -> shared by cp.async; zeros when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// one arrival on `bar` once this thread's cp.async copies have landed
// (counted in the barrier's arrivals: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

// rows [l0, l0 + rows) of head h, batch b of a [B, L, H, D] map into the
// tile at `dst`, completing on `bar`
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map,
                                          int b, int h, int l0, int rows,
                                          uint32_t bar) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::kBoxes; ++c)
    tma_load_4d(dst + c * rows * T::kRowBytes, map, c * T::kCols, h, l0, b,
                bar);
}

__device__ __forceinline__ void advance(int& stage, uint32_t& phase,
                                        int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// an accumulator's 16 columns 16 kk .. 16 kk + 15, as wgmma's A operand
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

}  // namespace wg

// ------------------------------------------------------ bf16 forward
// One block per (b, h, 128 query rows); 128-key tiles stream through the
// ring.  Shared memory: Q, then each stage's K and V tiles, then the
// mbarriers (q_full, then k_full, v_full, empty a stage).
template <int D>
struct FwdWg {
  static constexpr int BM = 128, BN = 128, kStages = 3;
  static constexpr uint32_t kQ = wg::Tile<D>::bytes(BM);
  static constexpr uint32_t kKV = wg::Tile<D>::bytes(BN);
  static constexpr uint32_t kBars = kQ + kStages * 2 * kKV;
  static constexpr size_t kSmem = kBars + (1 + 3 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ wg::Maps maps,
                       const Params p) {
  using C = FwdWg<D>;
  constexpr int BM = C::BM, BN = C::BN, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + C::kBars;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;
  const int b = blockIdx.z, h = blockIdx.y;
  // causal blocks run the longest first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BM;
  const int nkt = key_tiles(p, q0, BM, BN);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, wg::kReleasers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;     // the warpgroup: rows 64 role..
  const uint32_t kv0 = base + C::kQ;
  // key tile n into its stage (n % kStages): thread 0 issues every load
  auto issue = [&](int n) {
    const int st = n % kStages;
    const uint32_t kd = kv0 + st * 2 * C::kKV;
    mbar_expect_tx(k_full + 8 * st, C::kKV);
    wg::load_rows<D>(kd, &maps.k, b, h, n * BN, BN, k_full + 8 * st);
    mbar_expect_tx(v_full + 8 * st, C::kKV);
    wg::load_rows<D>(kd + C::kKV, &maps.v, b, h, n * BN, BN,
                     v_full + 8 * st);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, C::kQ);
    wg::load_rows<D>(base, &maps.q, b, h, q0, BM, q_full);
    for (int n = 0; n < kStages && n < nkt; ++n) issue(n);
  }
  // ------------------------------------------- the consumers: 64 rows
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = q0 + role * 64;               // this warpgroup's rows
  const int row[2] = {wrow0 + warp * 16 + g, wrow0 + warp * 16 + g + 8};
  const bool drop = p.drop_t > 0;
  const uint32_t bh = (uint32_t)(b * p.H + h);
  uint32_t rk[2] = {0u, 0u};
  if (drop) {
    rk[0] = row_key(p.seed, bh, row[0]);
    rk[1] = row_key(p.seed, bh, row[1]);
  }
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    // the stage tile kt - 1 used takes tile kt - 1 + kStages, once both
    // warpgroups have let it go
    if (threadIdx.x == 0 && kt > 0 && kt - 1 + kStages < nkt) {
      mbar_wait(empty + 8 * ((kt - 1) % kStages), ((kt - 1) / kStages) & 1);
      issue(kt - 1 + kStages);
    }
    __syncwarp();
    const uint32_t kd = base + C::kQ + stage * 2 * C::kKV;
    mbar_wait(k_full + 8 * stage, phase);
    float s[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16<0>(s, wg::kmajor<D>(base, BM, role * 64, kk),
                          wg::kmajor<D>(kd, BN, 0, kk), kk > 0);
    wgmma_commit();
    const int k0 = kt * BN;
    // the dropout draws need no score: hashed while the product runs,
    // element 4j + e of the tile at bit (4j + e) % 32 of keep[j / 8]
    uint32_t keep[BN / 64] = {};
    if (drop) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t kp = (uint32_t)(k0 + 8 * j + 2 * t) >> 1;
        const uint32_t x0 = pair_bits(rk[0], kp), x1 = pair_bits(rk[1], kp);
        keep[j / 8] |= (keep_bit(p, x0 & 0xFFFFu) |
                        keep_bit(p, x0 >> 16) << 1 |
                        keep_bit(p, x1 & 0xFFFFu) << 2 |
                        keep_bit(p, x1 >> 16) << 3) << (4 * (j % 8));
      }
    }
    wgmma_wait<0>();
    // the mask only where the tile crosses the diagonal or the ragged end
    const bool edge = k0 + BN > p.Lk ||
        (p.causal && k0 + BN - 1 + p.k_off > wrow0 + p.q_off);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] *= p.scale_log2;
    if (edge) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = visible(p, row[e >> 1], k0 + 8 * j + 2 * t + (e & 1))
                             ? s[4 * j + e] : kNeg;
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], base2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = fast_exp2(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha[r];
      // a row that sees no key yet keeps m = -1e30: its masked scores
      // then give 2^(-1e30) = 0, not 2^0
      base2[r] = mn > 0.5f * kNeg ? mn : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = fast_exp2(s[4 * j + e] - base2[e >> 1]);
        l[e >> 1] += pr;     // the denominator is undropped
        s[4 * j + e] = pr;
      }
      if (drop) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] *= kept_factor(p, keep[j / 8], 4 * (j % 8) + e);
      }
    }
    uint32_t pa[BN / 16][4];
    wg::to_a<BN>(pa, s);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0]; o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1]; o[4 * j + 3] *= alpha[1];
    }
    mbar_wait(v_full + 8 * stage, phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wg::wgmma_rs<D>(o, pa[kk], wg::mnmajor<D>(kd + C::kKV, BN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    wg::advance(stage, phase, kStages);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + b * p.qb +
                       h * p.qh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (row[r] >= p.Lq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    __nv_bfloat16* dst = out + (long long)row[r] * p.ql + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + 8 * j, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t == 0)
      p.lse_out[(long long)bh * p.Lq + row[r]] =
          lr > 0.f ? m[r] * kLn2 + logf(lr) : kNeg;
  }
}

// --------------------------------------------------- bf16 backward: dQ
// One block per (b, h, 128 query rows); 64-key tiles of K and V stream
// through the ring.  Shared memory: Q, dO, each stage's K and V, then
// the mbarriers (q_full, then kv_full, empty a stage).
template <int D>
struct DqWg {
  static constexpr int BM = 128, BN = 64, kStages = 3;
  static constexpr uint32_t kQ = wg::Tile<D>::bytes(BM);
  static constexpr uint32_t kKV = wg::Tile<D>::bytes(BN);
  static constexpr uint32_t kBars = 2 * kQ + kStages * 2 * kKV;
  static constexpr size_t kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ wg::Maps maps,
                          const Params p) {
  using C = DqWg<D>;
  constexpr int BM = C::BM, BN = C::BN, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + C::kBars;
  const uint32_t kv_full = q_full + 8, empty = kv_full + 8 * kStages;
  const uint32_t do_tile = base + C::kQ, kv0 = base + 2 * C::kQ;
  const int b = blockIdx.z, h = blockIdx.y;
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BM;
  const int nkt = key_tiles(p, q0, BM, BN);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + 8 * s, 1);
      mbar_init(empty + 8 * s, wg::kReleasers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;     // the warpgroup: rows 64 role..
  // key tile n into its stage (n % kStages): thread 0 issues every load
  auto issue = [&](int n) {
    const int st = n % kStages;
    const uint32_t kd = kv0 + st * 2 * C::kKV, bar = kv_full + 8 * st;
    mbar_expect_tx(bar, 2 * C::kKV);
    wg::load_rows<D>(kd, &maps.k, b, h, n * BN, BN, bar);
    wg::load_rows<D>(kd + C::kKV, &maps.v, b, h, n * BN, BN, bar);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * C::kQ);
    wg::load_rows<D>(base, &maps.q, b, h, q0, BM, q_full);
    wg::load_rows<D>(do_tile, &maps.dout, b, h, q0, BM, q_full);
    for (int n = 0; n < kStages && n < nkt; ++n) issue(n);
  }
  // ------------------------------------------- the consumers: 64 rows
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = q0 + role * 64;
  const int row[2] = {wrow0 + warp * 16 + g, wrow0 + warp * 16 + g + 8};
  const bool drop = p.drop_t > 0;
  const uint32_t bh = (uint32_t)(b * p.H + h);
  uint32_t rk[2] = {0u, 0u};
  float lse2[2] = {0.f, 0.f}, delta[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] < p.Lq) {
      lse2[r] = p.lse[(long long)bh * p.Lq + row[r]] * kLog2e;
      delta[r] = p.delta[(long long)bh * p.Lq + row[r]];
    }
    if (drop) rk[r] = row_key(p.seed, bh, row[r]);
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < nkt; ++kt) {
    if (threadIdx.x == 0 && kt > 0 && kt - 1 + kStages < nkt) {
      mbar_wait(empty + 8 * ((kt - 1) % kStages), ((kt - 1) / kStages) & 1);
      issue(kt - 1 + kStages);
    }
    __syncwarp();
    const uint32_t kd = kv0 + stage * 2 * C::kKV;
    mbar_wait(kv_full + 8 * stage, phase);
    float s[BN / 2], dp[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(s, wg::kmajor<D>(base, BM, role * 64, kk),
                         wg::kmajor<D>(kd, BN, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(dp, wg::kmajor<D>(do_tile, BM, role * 64, kk),
                         wg::kmajor<D>(kd + C::kKV, BN, 0, kk), kk > 0);
    wgmma_commit();
    const int k0 = kt * BN;
    // the dropout draws, hashed while the products run (bit 4j + e)
    uint32_t keep = 0;
    if (drop) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const uint32_t kp = (uint32_t)(k0 + 8 * j + 2 * t) >> 1;
        const uint32_t x0 = pair_bits(rk[0], kp), x1 = pair_bits(rk[1], kp);
        keep |= (keep_bit(p, x0 & 0xFFFFu) | keep_bit(p, x0 >> 16) << 1 |
                 keep_bit(p, x1 & 0xFFFFu) << 2 |
                 keep_bit(p, x1 >> 16) << 3) << (4 * j);
      }
    }
    wgmma_wait<0>();
    const bool edge = k0 + BN > p.Lk ||
        (p.causal && k0 + BN - 1 + p.k_off > wrow0 + p.q_off);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i)
      s[i] = fast_exp2(s[i] * p.scale_log2 - lse2[(i >> 1) & 1]);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = visible(p, row[e >> 1], k0 + 8 * j + 2 * t + (e & 1))
                             ? s[4 * j + e] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kf = drop ? kept_factor(p, keep, 4 * j + e) : 1.f;
        // dS = (u . dP - P . delta) * scale, u = P * keep * 1/(1-p)
        const float pr = s[4 * j + e];
        s[4 * j + e] =
            (pr * kf * dp[4 * j + e] - pr * delta[e >> 1]) * p.scale;
      }
    }
    uint32_t da[BN / 16][4];
    wg::to_a<BN>(da, s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wg::wgmma_rs<D>(dq, da[kk], wg::mnmajor<D>(kd, BN, kk));
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    wg::advance(stage, phase, kStages);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.dq) + b * p.qb +
                       h * p.qh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
    __nv_bfloat16* dst = out + (long long)row[r] * p.ql + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + 8 * j, dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// ----------------------------------------------- bf16 backward: dK, dV
// One block per (b, h, 128 key rows); 64-query tiles of Q and dO stream
// through the ring, and the products are taken transposed (keys along
// the rows): S^T = K.Q^T, dP^T = V.dO^T, dV += U^T.dO, dK += dS^T.Q.
// Warp 0's lanes bring each tile's per-query lse, delta (cp.async) and
// dropout row keys into the stage's rows of shared memory, beside the TMA
// loads of Q and dO, and arrive on the stage's full barrier.  Shared
// memory: K, V, each stage's Q and dO, each stage's rows, then the
// mbarriers (kv_full, then q_full, empty a stage).
template <int D>
struct DkvWg {
  static constexpr int BM = 128, BQ = 64, kStages = 3;
  static constexpr uint32_t kKV = wg::Tile<D>::bytes(BM);
  static constexpr uint32_t kQ = wg::Tile<D>::bytes(BQ);
  static constexpr uint32_t kRowBuf = 2 * kKV + kStages * 2 * kQ;
  // [stage][lse, delta, row key][BQ]
  static constexpr uint32_t kBars = kRowBuf + kStages * 3 * BQ * 4;
  static constexpr size_t kSmem = kBars + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(wg::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ wg::Maps maps,
                           const Params p) {
  using C = DkvWg<D>;
  constexpr int BM = C::BM, BQ = C::BQ, kStages = C::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t kv_full = base + C::kBars;
  const uint32_t q_full = kv_full + 8, empty = q_full + 8 * kStages;
  const uint32_t v_tile = base + C::kKV, q0s = base + 2 * C::kKV;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BM;
  const int nqt = (p.Lq + BQ - 1) / BQ;
  int start = 0;
  if (p.causal) {        // the first query that sees key k0
    const int first = k0 + p.k_off - p.q_off;
    start = first <= 0 ? 0 : min(first / BQ, nqt);
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // expect_tx, then each loader lane twice: its copies, its stores
      mbar_init(q_full + 8 * s, 1 + 2 * 32);
      mbar_init(empty + 8 * s, wg::kReleasers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int role = threadIdx.x / 128;     // the warpgroup: keys 64 role..
  float* const rows0 = reinterpret_cast<float*>(gbase + C::kRowBuf);
  const bool drop = p.drop_t > 0;
  const uint32_t bh = (uint32_t)(b * p.H + h);
  const int ntiles = nqt - start;
  const bool loader = threadIdx.x < 32;   // warp 0 issues every load
  // query tile start + n into its stage (n % kStages): Q and dO by TMA
  // (lane 0), the tile's lse and delta by cp.async and its dropout row
  // keys by plain stores (each lane); the stage's full barrier completes
  // when all of them have landed
  auto issue = [&](int n) {
    const int st = n % kStages, qt = start + n, lane = threadIdx.x;
    const uint32_t qd = q0s + st * 2 * C::kQ, bar = q_full + 8 * st;
    if (lane == 0) {
      mbar_expect_tx(bar, 2 * C::kQ);
      wg::load_rows<D>(qd, &maps.q, b, h, qt * BQ, BQ, bar);
      wg::load_rows<D>(qd + C::kQ, &maps.dout, b, h, qt * BQ, BQ, bar);
    }
    float* lse_s = rows0 + st * 3 * BQ;
    float* delta_s = lse_s + BQ;
    uint32_t* rk_s = reinterpret_cast<uint32_t*>(delta_s + BQ);
    for (int i = lane; i < BQ; i += 32) {
      const int qi = qt * BQ + i;
      const bool ok = qi < p.Lq;
      const long long at = ok ? (long long)bh * p.Lq + qi : 0;
      wg::cp_async4(lse_s + i, p.lse + at, ok);
      wg::cp_async4(delta_s + i, p.delta + at, ok);
      if (drop) rk_s[i] = row_key(p.seed, bh, qi);
    }
    wg::cp_async_arrive(bar);       // when this lane's copies have landed
    mbar_arrive(bar);               // releases this lane's row keys
  };
  if (loader) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * C::kKV);
      wg::load_rows<D>(base, &maps.k, b, h, k0, BM, kv_full);
      wg::load_rows<D>(v_tile, &maps.v, b, h, k0, BM, kv_full);
    }
    for (int n = 0; n < kStages && n < ntiles; ++n) issue(n);
  }
  // ------------------------------------------- the consumers: 64 keys
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wkey0 = k0 + role * 64;               // this warpgroup's keys
  const int key[2] = {wkey0 + warp * 16 + g, wkey0 + warp * 16 + g + 8};
  const uint32_t kp[2] = {(uint32_t)key[0] >> 1, (uint32_t)key[1] >> 1};
  const int hi = key[0] & 1;          // key[1] = key[0] + 8: same parity
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int qt = start; qt < nqt; ++qt) {
    const int n = qt - start;
    if (loader && n > 0 && n - 1 + kStages < ntiles) {
      mbar_wait(empty + 8 * ((n - 1) % kStages), ((n - 1) / kStages) & 1);
      issue(n - 1 + kStages);
    }
    __syncwarp();
    const uint32_t qd = q0s + stage * 2 * C::kQ, dod = qd + C::kQ;
    mbar_wait(q_full + 8 * stage, phase);
    // this tile's per-query rows, as warp 0 brought them
    const float* lse_s = rows0 + stage * 3 * BQ;
    const float* delta_s = lse_s + BQ;
    const uint32_t* rk_s = reinterpret_cast<const uint32_t*>(delta_s + BQ);
    float s[BQ / 2], dp[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(s, wg::kmajor<D>(base, BM, role * 64, kk),
                         wg::kmajor<D>(qd, BQ, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16<0>(dp, wg::kmajor<D>(v_tile, BM, role * 64, kk),
                         wg::kmajor<D>(dod, BQ, 0, kk), kk > 0);
    wgmma_commit();
    // the dropout draws, hashed while the products run (bit 4j + e).
    // Keys 2m and 2m + 1 share a hash and sit in lanes 4 apart: each lane
    // hashes its own row pair `hi` for both columns and takes the other
    // pair's from its partner
    uint32_t keep = 0;
    if (drop) {
      const uint32_t kmine = hi ? kp[1] : kp[0];
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int cj = 8 * j + 2 * t;
        const uint32_t m0 = pair_bits(rk_s[cj], kmine);
        const uint32_t m1 = pair_bits(rk_s[cj + 1], kmine);
        const uint32_t o0 = __shfl_xor_sync(kFull, m0, 4);
        const uint32_t o1 = __shfl_xor_sync(kFull, m1, 4);
        const uint32_t x[4] = {hi ? o0 : m0, hi ? o1 : m1,
                               hi ? m0 : o0, hi ? m1 : o1};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          keep |= keep_bit(p, hi ? x[e] >> 16 : x[e] & 0xFFFFu)
                  << (4 * j + e);
      }
    }
    wgmma_wait<0>();
    const int c0 = qt * BQ;
    const bool edge = c0 + BQ > p.Lq ||
        (p.causal && wkey0 + 63 + p.k_off > c0 + p.q_off);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = fast_exp2(s[4 * j + e] * p.scale_log2 -
                                 lse_s[8 * j + 2 * t + (e & 1)] * kLog2e);
    if (edge) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * j + e] = visible(p, c0 + 8 * j + 2 * t + (e & 1), key[e >> 1])
                             ? s[4 * j + e] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = 8 * j + 2 * t + (e & 1);
        const float pr = s[4 * j + e];
        const float u = drop ? pr * kept_factor(p, keep, 4 * j + e) : pr;
        s[4 * j + e] = u;
        dp[4 * j + e] = (u * dp[4 * j + e] - pr * delta_s[ci]) * p.scale;
      }
    uint32_t ua[BQ / 16][4], da[BQ / 16][4];
    wg::to_a<BQ>(ua, s);
    wg::to_a<BQ>(da, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wg::wgmma_rs<D>(dv, ua[kk], wg::mnmajor<D>(dod, BQ, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wg::wgmma_rs<D>(dk, da[kk], wg::mnmajor<D>(qd, BQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    wg::advance(stage, phase, kStages);
  }
  const long long koff = b * p.kb + h * p.kh;
  __nv_bfloat16* dko = static_cast<__nv_bfloat16*>(p.dk) + koff;
  __nv_bfloat16* dvo = static_cast<__nv_bfloat16*>(p.dv) + koff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.Lk) continue;
    const long long o = (long long)key[r] * p.kl + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store2(dko + o + 8 * j, dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
      store2(dvo + o + 8 * j, dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------ launches
template <typename Kern>
int launch_f32(Kern kern, dim3 grid, size_t smem, const Params& p,
               cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, f32::kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename Kern>
int launch_rt(Kern kern, dim3 grid, size_t smem, const Params& p,
              cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, rt::kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_f32(const Params& p, cudaStream_t st) {
  using namespace f32;
  const size_t smem = (size_t)(kRows + 4 * kTile) * Smem<D>::S * 4;
  return launch_f32(flash_fwd_kernel<D>,
                    dim3((p.Lq + kRows - 1) / kRows, p.H, p.B), smem, p, st);
}

template <int D>
int bwd_dq_f32(const Params& p, cudaStream_t st) {
  using C = rt::Bwd<D>;
  return launch_rt(flash_bwd_dq_f32_kernel<D>,
                   dim3((p.Lq + C::BM - 1) / C::BM, p.H, p.B), C::kDqSmem, p,
                   st);
}

template <int D>
int bwd_dkv_f32(const Params& p, cudaStream_t st) {
  using C = rt::Bwd<D>;
  return launch_rt(flash_bwd_dkv_f32_kernel<D>,
                   dim3((p.Lk + C::BM - 1) / C::BM, p.H, p.B), C::kDkvSmem,
                   p, st);
}

// a [B, L, H, D] bf16 tensor with element strides (sb, sl, sh) as a rank-4
// map (D, H, L, B), moved in boxes of (cols, 1, rows, 1), swizzled as
// wg::Tile lays them out; out-of-bounds rows read as 0
template <int D>
bool map4(CUtensorMap* map, const void* ptr, int B, int H, int L,
          long long sb, long long sh, long long sl, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  constexpr int cols = wg::Tile<D>::kCols;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t steps[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q and dout at q_rows a box, k and v at k_rows
template <int D>
bool make_maps(wg::Maps* m, const Params& p, int q_rows, int k_rows) {
  return map4<D>(&m->q, p.q, p.B, p.H, p.Lq, p.qb, p.qh, p.ql, q_rows) &&
         map4<D>(&m->k, p.k, p.B, p.H, p.Lk, p.kb, p.kh, p.kl, k_rows) &&
         map4<D>(&m->v, p.v, p.B, p.H, p.Lk, p.kb, p.kh, p.kl, k_rows) &&
         (p.dout == nullptr ||
          map4<D>(&m->dout, p.dout, p.B, p.H, p.Lq, p.qb, p.qh, p.ql,
                  q_rows));
}

template <typename Kern>
int launch_wg(Kern kern, dim3 grid, size_t smem, const wg::Maps& maps,
              const Params& p, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, wg::kThreads, smem, st>>>(maps, p);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_bf16(const Params& p, cudaStream_t st) {
  using C = FwdWg<D>;
  wg::Maps maps = {};
  if (!make_maps<D>(&maps, p, C::BM, C::BN))
    return (int)cudaErrorInvalidValue;
  return launch_wg(flash_fwd_wgmma_kernel<D>,
                   dim3((p.Lq + C::BM - 1) / C::BM, p.H, p.B), C::kSmem,
                   maps, p, st);
}

template <int D>
int bwd_dq_bf16(const Params& p, cudaStream_t st) {
  using C = DqWg<D>;
  wg::Maps maps = {};
  if (!make_maps<D>(&maps, p, C::BM, C::BN))
    return (int)cudaErrorInvalidValue;
  return launch_wg(flash_bwd_dq_wgmma_kernel<D>,
                   dim3((p.Lq + C::BM - 1) / C::BM, p.H, p.B), C::kSmem,
                   maps, p, st);
}

template <int D>
int bwd_dkv_bf16(const Params& p, cudaStream_t st) {
  using C = DkvWg<D>;
  wg::Maps maps = {};
  if (!make_maps<D>(&maps, p, C::BQ, C::BM))
    return (int)cudaErrorInvalidValue;
  return launch_wg(flash_bwd_dkv_wgmma_kernel<D>,
                   dim3((p.Lk + C::BM - 1) / C::BM, p.H, p.B), C::kSmem,
                   maps, p, st);
}

#define PTT_DISPATCH(F32, BF16, dtype, D, p, st)                \
  do {                                                          \
    if (dtype == 0) {                                           \
      if (D == 32) return F32<32>(p, st);                       \
      if (D == 64) return F32<64>(p, st);                       \
      if (D == 96) return F32<96>(p, st);                       \
      if (D == 128) return F32<128>(p, st);                     \
    } else if (dtype == 1) {                                    \
      if (D == 32) return BF16<32>(p, st);                      \
      if (D == 64) return BF16<64>(p, st);                      \
      if (D == 96) return BF16<96>(p, st);                      \
      if (D == 128) return BF16<128>(p, st);                    \
    }                                                           \
    return -1;                                                  \
  } while (0)

Params make_params(const void* q, const void* k, const void* v, int B,
                   int H, int Lq, int Lk, long long qb, long long qh,
                   long long ql, long long kb, long long kh, long long kl,
                   float scale, int causal, int q_off, int k_off,
                   unsigned seed, int drop_t) {
  Params p = {};
  p.q = q; p.k = k; p.v = v;
  p.B = B; p.H = H; p.Lq = Lq; p.Lk = Lk;
  p.qb = qb; p.qh = qh; p.ql = ql;
  p.kb = kb; p.kh = kh; p.kl = kl;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.causal = causal; p.q_off = q_off; p.k_off = k_off;
  p.seed = seed;
  p.drop_t = drop_t < 0 ? 0 : (drop_t > 65536 ? 65536 : drop_t);
  p.drop_scale = p.drop_t >= 65536 ? 0.f
                                   : 65536.f / (float)(65536 - p.drop_t);
  return p;
}

}  // namespace

// Plain C entry points, bound from Python with ctypes
// (paddle_tpu_torch/ops/cuda/flash_attention.py).  dtype: 0 = float32,
// 1 = bfloat16; D in {32, 64, 96, 128}.  Strides are in elements: (b, h,
// l) of the query family (q, out, dout, dq) and of the key family (k, v,
// dk, dv); the last dimension is contiguous (and, at bf16, every stride
// a multiple of 8 elements, for TMA).  Return 0, -1 for a (dtype, D) this
// file has no instance for, or the cudaError_t of the launch
// (cudaErrorInvalidValue when no tensor map could be built).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, int B, int H, int Lq,
                             int Lk, int D, long long qb, long long qh,
                             long long ql, long long kb, long long kh,
                             long long kl, float scale, int causal,
                             int q_off, int k_off, unsigned seed,
                             int drop_t, int dtype, void* stream) {
  Params p = make_params(q, k, v, B, H, Lq, Lk, qb, qh, ql, kb, kh, kl,
                         scale, causal, q_off, k_off, seed, drop_t);
  p.out = out;
  p.lse_out = lse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(fwd_f32, fwd_bf16, dtype, D, p, st);
}

extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, void* dq, int B, int H,
                                int Lq, int Lk, int D, long long qb,
                                long long qh, long long ql, long long kb,
                                long long kh, long long kl, float scale,
                                int causal, int q_off, int k_off,
                                unsigned seed, int drop_t, int dtype,
                                void* stream) {
  Params p = make_params(q, k, v, B, H, Lq, Lk, qb, qh, ql, kb, kh, kl,
                         scale, causal, q_off, k_off, seed, drop_t);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(bwd_dq_f32, bwd_dq_bf16, dtype, D, p, st);
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* delta,
                                 void* dk, void* dv, int B, int H, int Lq,
                                 int Lk, int D, long long qb, long long qh,
                                 long long ql, long long kb, long long kh,
                                 long long kl, float scale, int causal,
                                 int q_off, int k_off, unsigned seed,
                                 int drop_t, int dtype, void* stream) {
  Params p = make_params(q, k, v, B, H, Lq, Lk, qb, qh, ql, kb, kh, kl,
                         scale, causal, q_off, k_off, seed, drop_t);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH(bwd_dkv_f32, bwd_dkv_bf16, dtype, D, p, st);
}
