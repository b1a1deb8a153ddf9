// Flash attention for Hopper (sm_90a): forward, and the backward as two
// kernels (dQ; dK and dV).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   _fwd (body _fwd_kernel)          -> flash_fwd_kernel
//   _bwd (body _bwd_dq_kernel)       -> flash_bwd_dq_kernel
//   _bwd (body _bwd_dkv_kernel)      -> flash_bwd_dkv_kernel
//
//   q [B, Lq, H, D] or [B, H, Lq, D]; k, v the same with Lk (the strides
//   of each family are arguments, so both layouts are read in place)
//   out = softmax(q.k^T * scale) . v, lse [B, H, Lq] f32 (natural log)
//   causal: key j is visible from query i iff q_off + i >= k_off + j
//   dropout on the probabilities with the denominator undropped:
//     keep iff bits16(seed, b*H + h, i, j) >= t, t = round(p * 65536),
//     kept values scaled by 65536 / (65536 - t); t = 0 keeps everything
//     (bit-equal to no dropout), t = 65536 drops everything
//   fully masked rows give out = 0 and lse = -1e30, as on the TPU.
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
// What the design does about it:
//   * one block of 4 warps per (b, h, 64-row tile); each warp owns 16
//     rows and keeps its scores, online-softmax state and f32
//     accumulators in registers in the mma.sync C-fragment layout, so
//     the [L, L] matrices never reach device memory;
//   * bf16 products run on the tensor cores (mma.sync m16n8k16, f32
//     accumulation); the probabilities and dS are fed to the next
//     product straight from registers (C fragment -> A fragment);
//   * f32 inputs take the same code with the products done by FMA on
//     the CUDA cores (exact f32; reads its operands from shared memory);
//   * the other operand streams through shared memory one 64-row tile
//     at a time, double-buffered: cp.async brings tile j + 1 while the
//     warps compute on tile j (rows padded by 16 bytes, so ldmatrix
//     reads them without bank conflicts); causal blocks stop at the
//     diagonal (forward, dQ) or start there (dK/dV);
//   * bf16 operand fragments come from shared memory by ldmatrix (with
//     .trans for the operand stored [k][n]);
//   * the row max, exp2 with log2(e) folded into the scale, and the
//     row sum over a quad of lanes by shuffles.
// Not done yet (later work): TMA, wgmma, warp specialisation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 16 * kWarps;   // rows one block owns
constexpr int kTile = 64;            // rows of a streamed tile
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

// smem row stride in elements: rows padded by 16 bytes
template <typename T, int D>
struct Smem {
  static constexpr int S = D + 16 / (int)sizeof(T);
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

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
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* sm, const T* g,
                                          long long row_stride, int row0,
                                          int valid, int rows) {
  constexpr int E = 16 / sizeof(T);   // elements per 16-byte vector
  constexpr int VPR = D / E;
  constexpr int S = Smem<T, D>::S;
  for (int i = threadIdx.x; i < rows * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * E;
    const bool ok = row0 + r < valid;
    cp_async16(sm + r * S + c,
               ok ? g + (long long)(row0 + r) * row_stride + c : g, ok);
  }
}

// -------------------------------------------------------- warp products
// The accumulators are mma.sync m16n8 C fragments: lane (g = lane / 4,
// t = lane % 4) holds c[n][0..1] at row g, cols 8n + 2t + {0, 1} and
// c[n][2..3] at row g + 8, the same cols.

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// C[16 x 8NT] += A[16 x KD] . B[8NT x KD]^T, A and B row-major in smem
// with row stride S (A: this warp's 16 rows).  NT is even.
template <int NT, int KD, int S>
__device__ __forceinline__ void gemm_nt(float (&c)[NT][4],
                                        const __nv_bfloat16* A,
                                        const __nv_bfloat16* B, int lane) {
  // ldmatrix row addresses: A as four 8x8 blocks (rows 0-7 / 8-15, cols
  // k0 / k0 + 8); B as two n-tiles of (cols k0, k0 + 8)
  const __nv_bfloat16* a = A + (lane & 15) * S + (lane >> 4) * 8;
  const __nv_bfloat16* b =
      B + ((lane & 7) + ((lane >> 4) << 3)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k0 = 0; k0 < KD; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + k0);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, b + n * 8 * S + k0);
      mma_bf16(c[n], af[0], af[1], af[2], af[3], bf[0], bf[1]);
      mma_bf16(c[n + 1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
    }
  }
}

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
// of an earlier product (held in registers), B row-major in smem.  NT
// is even.
template <int NT, int KT, int S>
__device__ __forceinline__ void gemm_nn(float (&c)[NT][4],
                                        const float (&p)[KT][4],
                                        const __nv_bfloat16* B, int lane) {
  // B is stored [k][n]: ldmatrix.trans of the 8x8 blocks (k0 / k0 + 8,
  // n0 / n0 + 8) gives the column-major fragments
  const __nv_bfloat16* b = B + (lane & 15) * S + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KT / 2; ++kk) {
    const uint32_t a0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    const uint32_t a1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    const uint32_t a2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b + 16 * kk * S + n * 8);
      mma_bf16(c[n], a0, a1, a2, a3, bf[0], bf[1]);
      mma_bf16(c[n + 1], a0, a1, a2, a3, bf[2], bf[3]);
    }
  }
}

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

// number of key tiles a query tile [q0, q0 + kRows) needs
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int n = (p.Lk + kTile - 1) / kTile;
  if (p.causal) {
    const int last = min(p.Lq, q0 + kRows) - 1 + p.q_off - p.k_off;
    n = min(n, last < 0 ? 0 : last / kTile + 1);
  }
  return n;
}

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  return kj < p.Lk && qi < p.Lq && (!p.causal || kj + p.k_off <= qi + p.q_off);
}

__device__ __forceinline__ float keep_factor(const Params& p, uint32_t bits) {
  return (int)bits >= p.drop_t ? p.drop_scale : 0.f;
}

// ------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Params p) {
  constexpr int S = Smem<T, D>::S, NK = kTile / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Kb = Qs + kRows * S;              // two K tiles, then two V tiles
  T* Vb = Kb + 2 * kTile * S;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* q = static_cast<const T*>(p.q) + b * p.qb + h * p.qh;
  const T* k = static_cast<const T*>(p.k) + b * p.kb + h * p.kh;
  const T* v = static_cast<const T*>(p.v) + b * p.kb + h * p.kh;
  const int nkt = key_tiles(p, q0);
  load_tile<T, D>(Qs, q, p.ql, q0, p.Lq, kRows);
  if (nkt > 0) {
    load_tile<T, D>(Kb, k, p.kl, 0, p.Lk, kTile);
    load_tile<T, D>(Vb, v, p.kl, 0, p.Lk, kTile);
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
      load_tile<T, D>(Kb + nb, k, p.kl, (kt + 1) * kTile, p.Lk, kTile);
      load_tile<T, D>(Vb + nb, v, p.kl, (kt + 1) * kTile, p.Lk, kTile);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const T* Ks = Kb + (kt & 1) * kTile * S;
    const T* Vs = Vb + (kt & 1) * kTile * S;
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
  T* out = static_cast<T*>(p.out) + b * p.qb + h * p.qh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (row[r] >= p.Lq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    T* o = out + (long long)row[r] * p.ql + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(o + n * 8, acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if (t == 0)
      p.lse_out[(long long)bh * p.Lq + row[r]] =
          lr > 0.f ? m[r] * kLn2 + logf(lr) : kNeg;
  }
}

// --------------------------------------------------------- backward: dQ
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Params p) {
  constexpr int S = Smem<T, D>::S, NK = kTile / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kRows * S;
  T* Kb = dOs + kRows * S;             // two K tiles, then two V tiles
  T* Vb = Kb + 2 * kTile * S;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qoff = b * p.qb + h * p.qh, koff = b * p.kb + h * p.kh;
  const T* k = static_cast<const T*>(p.k) + koff;
  const T* v = static_cast<const T*>(p.v) + koff;
  const int nkt = key_tiles(p, q0);
  load_tile<T, D>(Qs, static_cast<const T*>(p.q) + qoff, p.ql, q0, p.Lq,
                  kRows);
  load_tile<T, D>(dOs, static_cast<const T*>(p.dout) + qoff, p.ql, q0, p.Lq,
                  kRows);
  if (nkt > 0) {
    load_tile<T, D>(Kb, k, p.kl, 0, p.Lk, kTile);
    load_tile<T, D>(Vb, v, p.kl, 0, p.Lk, kTile);
  }
  cp_async_commit();
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
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
  float dq[ND][4];
  zero(dq);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      const int nb = ((kt + 1) & 1) * kTile * S;
      load_tile<T, D>(Kb + nb, k, p.kl, (kt + 1) * kTile, p.Lk, kTile);
      load_tile<T, D>(Vb + nb, v, p.kl, (kt + 1) * kTile, p.Lk, kTile);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const T* Ks = Kb + (kt & 1) * kTile * S;
    const T* Vs = Vb + (kt & 1) * kTile * S;
    float s[NK][4], dp[NK][4];
    zero(s);
    zero(dp);
    gemm_nt<NK, D, S>(s, Qs + warp * 16 * S, Ks, lane);
    gemm_nt<NK, D, S>(dp, dOs + warp * 16 * S, Vs, lane);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int col0 = kt * kTile + n * 8 + 2 * t;
      float kf[4] = {1.f, 1.f, 1.f, 1.f};
      if (drop) {
        const uint32_t x0 = pair_bits(rk[0], (uint32_t)col0 >> 1);
        const uint32_t x1 = pair_bits(rk[1], (uint32_t)col0 >> 1);
        kf[0] = keep_factor(p, x0 & 0xFFFFu);
        kf[1] = keep_factor(p, x0 >> 16);
        kf[2] = keep_factor(p, x1 & 0xFFFFu);
        kf[3] = keep_factor(p, x1 >> 16);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float pr = visible(p, row[r], col0 + (e & 1))
            ? exp2f(s[n][e] * p.scale_log2 - lse2[r]) : 0.f;
        // dS = (u . dP - P . delta) * scale, u = P * keep * 1/(1-p)
        s[n][e] = (pr * kf[e] * dp[n][e] - pr * delta[r]) * p.scale;
      }
    }
    gemm_nn<ND, NK, S>(dq, s, Ks, lane);
    __syncthreads();                   // this buffer is refilled next
  }
  cp_async_wait_all();
  T* out = static_cast<T*>(p.dq) + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= p.Lq) continue;
    T* o = out + (long long)row[r] * p.ql + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(o + n * 8, dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

// ------------------------------------------------------ backward: dK, dV
// One block per (b, h, 64-key tile); the warps own key rows and loop
// over query tiles of BQ rows, so the products are taken transposed:
// S^T = K.Q^T, dV += U^T.dO, dP^T = V.dO^T, dK += dS^T.Q.
template <typename T, int D, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const Params p) {
  constexpr int S = Smem<T, D>::S, NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kRows * S;
  T* Qb = Vs + kRows * S;              // two Q tiles, then two dO tiles
  T* dOb = Qb + 2 * BQ * S;
  float* lse_b = reinterpret_cast<float*>(dOb + 2 * BQ * S);   // [2][BQ]
  float* delta_b = lse_b + 2 * BQ;                             // [2][BQ]
  uint32_t* rk_b = reinterpret_cast<uint32_t*>(delta_b + 2 * BQ);
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long qoff = b * p.qb + h * p.qh, koff = b * p.kb + h * p.kh;
  const T* q = static_cast<const T*>(p.q) + qoff;
  const T* dout = static_cast<const T*>(p.dout) + qoff;
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
    load_tile<T, D>(Qb + buf * BQ * S, q, p.ql, qt * BQ, p.Lq, BQ);
    load_tile<T, D>(dOb + buf * BQ * S, dout, p.ql, qt * BQ, p.Lq, BQ);
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int qi = qt * BQ + i;
      const bool ok = qi < p.Lq;
      lse_b[buf * BQ + i] =
          ok ? p.lse[(long long)bh * p.Lq + qi] * kLog2e : 0.f;
      delta_b[buf * BQ + i] = ok ? p.delta[(long long)bh * p.Lq + qi] : 0.f;
      if (drop) rk_b[buf * BQ + i] = row_key(p.seed, bh, qi);
    }
  };
  load_tile<T, D>(Ks, static_cast<const T*>(p.k) + koff, p.kl, k0, p.Lk,
                  kRows);
  load_tile<T, D>(Vs, static_cast<const T*>(p.v) + koff, p.kl, k0, p.Lk,
                  kRows);
  if (start < nqt) stage(start, 0);
  cp_async_commit();
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const uint32_t kp[2] = {(uint32_t)key[0] >> 1, (uint32_t)key[1] >> 1};
  const int hi = key[0] & 1;          // key[1] = key[0] + 8: same parity
  float dk[ND][4], dv[ND][4];
  zero(dk);
  zero(dv);
  for (int qt = start; qt < nqt; ++qt) {
    const int buf = (qt - start) & 1;
    if (qt + 1 < nqt) stage(qt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const T* Qs = Qb + buf * BQ * S;
    const T* dOs = dOb + buf * BQ * S;
    const float* lse_s = lse_b + buf * BQ;
    const float* delta_s = delta_b + buf * BQ;
    const uint32_t* rk_s = rk_b + buf * BQ;
    float s[NQ][4], dp[NQ][4];
    zero(s);
    zero(dp);
    gemm_nt<NQ, D, S>(s, Ks + warp * 16 * S, Qs, lane);
    gemm_nt<NQ, D, S>(dp, Vs + warp * 16 * S, dOs, lane);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, ci = n * 8 + 2 * t + (e & 1);
        const float pr = visible(p, qt * BQ + ci, key[r])
            ? exp2f(s[n][e] * p.scale_log2 - lse_s[ci]) : 0.f;
        float u = pr;
        if (drop) {
          const uint32_t x = pair_bits(rk_s[ci], kp[r]);
          u *= keep_factor(p, hi ? x >> 16 : x & 0xFFFFu);
        }
        s[n][e] = u;
        dp[n][e] = (u * dp[n][e] - pr * delta_s[ci]) * p.scale;
      }
    gemm_nn<ND, NQ, S>(dv, s, dOs, lane);
    gemm_nn<ND, NQ, S>(dk, dp, Qs, lane);
    __syncthreads();                   // this buffer is refilled next
  }
  cp_async_wait_all();
  T* dko = static_cast<T*>(p.dk) + koff;
  T* dvo = static_cast<T*>(p.dv) + koff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= p.Lk) continue;
    const long long o = (long long)key[r] * p.kl + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      store2(dko + o + n * 8, dk[n][2 * r], dk[n][2 * r + 1]);
      store2(dvo + o + n * 8, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------ launches
template <typename Kern>
int launch(Kern kern, dim3 grid, size_t smem, const Params& p,
           cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int fwd(const Params& p, cudaStream_t st) {
  const size_t smem = (size_t)(kRows + 4 * kTile) * Smem<T, D>::S * sizeof(T);
  return launch(flash_fwd_kernel<T, D>,
                dim3((p.Lq + kRows - 1) / kRows, p.H, p.B), smem, p, st);
}

template <typename T, int D>
int bwd_dq(const Params& p, cudaStream_t st) {
  const size_t smem = (size_t)(2 * kRows + 4 * kTile) * Smem<T, D>::S *
                      sizeof(T);
  return launch(flash_bwd_dq_kernel<T, D>,
                dim3((p.Lq + kRows - 1) / kRows, p.H, p.B), smem, p, st);
}

template <typename T, int D>
int bwd_dkv(const Params& p, cudaStream_t st) {
  // fewer query rows per step at D = 128 keeps dK and dV in registers
  constexpr int BQ = D > 64 ? 32 : 64;
  const size_t smem = (size_t)(2 * kRows + 4 * BQ) * Smem<T, D>::S *
                      sizeof(T) + 6 * BQ * sizeof(float);
  return launch(flash_bwd_dkv_kernel<T, D, BQ>,
                dim3((p.Lk + kRows - 1) / kRows, p.H, p.B), smem, p, st);
}

#define PTT_DISPATCH(FN, dtype, D, p, st)                       \
  do {                                                          \
    if (dtype == 0) {                                           \
      if (D == 32) return FN<float, 32>(p, st);                 \
      if (D == 64) return FN<float, 64>(p, st);                 \
      if (D == 128) return FN<float, 128>(p, st);               \
    } else if (dtype == 1) {                                    \
      if (D == 32) return FN<__nv_bfloat16, 32>(p, st);         \
      if (D == 64) return FN<__nv_bfloat16, 64>(p, st);         \
      if (D == 128) return FN<__nv_bfloat16, 128>(p, st);       \
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
// 1 = bfloat16; D in {32, 64, 128}.  Strides are in elements: (b, h, l)
// of the query family (q, out, dout, dq) and of the key family (k, v,
// dk, dv); the last dimension is contiguous.  Return 0, -1 for a
// (dtype, D) this file has no instance for, or the cudaError_t of the
// launch.
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
  PTT_DISPATCH(fwd, dtype, D, p, st);
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
  PTT_DISPATCH(bwd_dq, dtype, D, p, st);
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
  PTT_DISPATCH(bwd_dkv, dtype, D, p, st);
}
